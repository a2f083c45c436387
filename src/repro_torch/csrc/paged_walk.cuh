// The key walk of the port's paged attention kernels, shared by the paged
// decode kernel (B2, csrc/paged_attention.cu) and the speculative-verify
// kernel (B3, csrc/spec_verify.cu).
//
// One block of kWarps warps serves a group of query rows of one (request,
// kv-cache head) pair. Row r of the group reads q and writes o at element
// offset off(r) + d and sees the keys at logical positions <= its own
// position; B2's rows are the rep q heads of a cache head, all at the
// request's position, B3's the (window lane, q head) pairs of a window,
// each at its lane's position. The block:
// - reads page_table[b, :] itself and walks only the positions 0 .. the
//   group's largest position (capped at M P): later keys contribute
//   exp(-1e30 - m) = 0 to every row, so skipping them is exact;
// - deals tiles of kTile keys (32; 16 in fp32, for shared memory) to its
//   warps in turn (`walk`): lane j computes key j's page and row once a
//   tile and the warp copies each K and V row as 16-byte cp.async vectors
//   into its own ring of two shared-memory stages, the next tile issued
//   before the current one is scored (`issue_tile`); page ids outside
//   [0, NP) and keys past the walk are masked (zero-filled, never read);
// - scores each tile with a Score policy that keeps its own online
//   softmax (m, l, acc) for every row of the group (`CoreScore`: CUDA
//   cores, fp32 dot products in index order; B3 adds a tensor-core
//   policy of its own);
// - combines the warps' partial states in shared memory
//   (combine_partials_plain in kernels/paged_attention.py is the same
//   arithmetic): a warp with no visible key for a row holds m = -1e30,
//   l = 0, acc = 0 and adds nothing; the denominator is clamped at 1e-20.
// Rows are padded to an odd number of 16-byte units, so the 8 or 32 rows
// a warp reads at once lie on distinct banks.

#pragma once

#include "hopper.cuh"

namespace paged_walk {

constexpr int kMaxD = 128;
constexpr int kWarps = 4;
constexpr int kStages = 2;
constexpr int kPairs = kMaxD / 64;    // column pairs a lane owns in P.V
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// One 16-byte shared-memory vector as fp32 values (8 of a 16-bit type, 4
// of fp32).
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_vec(const __half* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[i] & 0xffffu)));
    v[2 * i + 1] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[i] >> 16)));
  }
}

// Two consecutive shared-memory values as fp32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__host__ __device__ constexpr int tile_keys() {
  return sizeof(T) == 4 ? 16 : 32;
}

// Row geometry of a K/V tile in shared memory: `vpr` 16-byte vectors a
// row of D values, `lpr` lanes copying a row (vpr rounded up to a power of
// two), `rs` the row stride in elements (an odd number of 16-byte units).
struct Rows {
  int vpr, lpr, rs;
};

template <typename T>
inline Rows rows_of(int D) {
  Rows g;
  g.vpr = D * static_cast<int>(sizeof(T)) / 16;
  g.lpr = 1;
  while (g.lpr < g.vpr) g.lpr <<= 1;
  g.rs = (g.vpr | 1) * 16 / static_cast<int>(sizeof(T));
  return g;
}

// Dynamic shared memory of a walk: `lead` bytes the kernel keeps before
// the work area (its staged q), then the larger of the warps' K/V rings
// and the combine's [warp][row] m, l and [warp][row][D] acc.
template <typename T, int REPC>
inline size_t walk_smem(Rows g, int D, size_t lead) {
  const size_t ring = static_cast<size_t>(kWarps) * kStages * 2 *
                      tile_keys<T>() * g.rs * sizeof(T);
  const size_t combine = (2 * kWarps * REPC + kWarps * REPC * D) *
                         sizeof(float);
  return lead + (ring > combine ? ring : combine);
}

// Issue the cp.async copies of tile `t0` (keys t0 .. t0 + kTile - 1) of
// this warp into `kb` / `vb`; returns whether lane j's key is inside the
// walk and on a valid page.
template <typename T>
__device__ __forceinline__ bool issue_tile(
    T* kb, T* vb, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ tb, int t0, int n_keys, int P, int Hc, int hc,
    int D, int NP, Rows g, int lane) {
  constexpr int kTile = tile_keys<T>();
  constexpr int E = 16 / sizeof(T);   // values a vector
  const int kj = t0 + lane;
  long long off = 0;
  bool ok = false;
  if (lane < kTile && kj < n_keys) {
    const int page = tb[kj / P];             // once a key row
    if (page >= 0 && page < NP) {
      ok = true;
      off = ((static_cast<long long>(page) * P + kj % P) * Hc + hc) * D;
    }
  }
  const int rows_a_pass = 32 / g.lpr;
  const int sub = lane / g.lpr, v = lane % g.lpr;
  for (int r0 = 0; r0 < kTile; r0 += rows_a_pass) {
    const int r = r0 + sub;
    const long long roff = __shfl_sync(0xffffffffu, off, r & 31);
    const int rok = __shfl_sync(0xffffffffu, static_cast<int>(ok), r & 31);
    if (r < kTile && v < g.vpr) {
      T* dk = kb + r * g.rs + v * E;
      T* dv = vb + r * g.rs + v * E;
      if (rok) {
        hopper::cp_async16(dk, kp + roff + v * E);
        hopper::cp_async16(dv, vp + roff + v * E);
      } else {                                // masked: zero-fill
        hopper::cp_async16(dk, kp, 0);
        hopper::cp_async16(dv, vp, 0);
      }
    }
  }
  return ok;
}

// CUDA-core scoring: lane j scores key j of the tile for every row (q
// staged in shared memory as fp32, the dot an fma chain in index order),
// per-row online softmax with shuffle reductions over the tile, then P.V
// with lane l owning column pairs 2l and 2l + 64. kRowPos: rows have
// positions of their own (`pos_s`); otherwise every row sees the whole
// walk.
template <typename T, int REPC, bool kRowPos>
struct CoreScore {
  const float* q_s;     // [REPC][D]
  const int* pos_s;     // [REPC], read when kRowPos
  int rows, D;
  float scale;
  float m[REPC], l[REPC], acc[REPC][kPairs][2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < REPC; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kPairs; ++c) acc[r][c][0] = acc[r][c][1] = 0.f;
    }
  }

  // `ok`: lane's key is on a valid page inside the walk; key t0 + lane.
  __device__ __forceinline__ void tile(const T* kb, const T* vb, bool ok,
                                       int t0, int lane, Rows g) {
    constexpr int kTile = tile_keys<T>();
    constexpr int E = 16 / sizeof(T);
    // scores: lane j, key j, every row of the group
    float s[REPC];
#pragma unroll
    for (int r = 0; r < REPC; ++r) s[r] = 0.f;
    const T* krow = kb + (lane % kTile) * g.rs;
    for (int v = 0; v < g.vpr; ++v) {
      float kf[E];
      load_vec(krow + v * E, kf);
#pragma unroll
      for (int r = 0; r < REPC; ++r) {
        if (r < rows) {                                 // warp-uniform
          const float* qr = q_s + r * D + v * E;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            s[r] = fmaf(qv.x, kf[e], s[r]);
            s[r] = fmaf(qv.y, kf[e + 1], s[r]);
            s[r] = fmaf(qv.z, kf[e + 2], s[r]);
            s[r] = fmaf(qv.w, kf[e + 3], s[r]);
          }
        }
      }
    }
    // online softmax, per row
    float p[REPC];
#pragma unroll
    for (int r = 0; r < REPC; ++r) {
      p[r] = 0.f;
      if (r < rows) {
        const bool vis = kRowPos ? ok && t0 + lane <= pos_s[r] : ok;
        const float sr = vis ? s[r] * scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        p[r] = vis ? expf(sr - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          acc[r][c][0] *= alpha;
          acc[r][c][1] *= alpha;
        }
      }
    }
    // P.V: lane owns columns 2 (lane + 32 c) and the one after
    for (int j = 0; j < kTile; ++j) {
      float2 vv[kPairs];
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        const int col = 2 * (lane + 32 * c);
        vv[c] = col < D ? load_pair(vb + j * g.rs + col)
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < REPC; ++r) {
        if (r < rows) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int c = 0; c < kPairs; ++c) {
            acc[r][c][0] = fmaf(pj, vv[c].x, acc[r][c][0]);
            acc[r][c][1] = fmaf(pj, vv[c].y, acc[r][c][1]);
          }
        }
      }
    }
  }

  // This warp's partial state: m_s / l_s [warp][row], a_s [warp][row][D].
  __device__ __forceinline__ void store(float* m_s, float* l_s, float* a_s,
                                        int warp, int lane) const {
#pragma unroll
    for (int r = 0; r < REPC; ++r) {
      if (r < rows) {
        if (lane == 0) {
          m_s[warp * REPC + r] = m[r];
          l_s[warp * REPC + r] = l[r];
        }
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          const int col = 2 * (lane + 32 * c);
          if (col < D) {
            float* dst = a_s + (warp * REPC + r) * D + col;
            dst[0] = acc[r][c][0];
            dst[1] = acc[r][c][1];
          }
        }
      }
    }
  }
};

// The walk of one group. Group: `rows` (<= REPC), `n_keys` (the walk's
// length) and `off(r)`, row r's element offset in q and o. Score:
// `tile(kb, vb, ok, t0, lane, g)` and `store(m_s, l_s, a_s, warp, lane)`
// as CoreScore. Whatever the kernel staged in shared memory before the
// call is visible to every warp from the first tile on; `work` is the
// ring, then the combine's scratch.
template <typename T, int REPC, class Group, class Score>
__device__ __forceinline__ void walk(
    const Group& grp, Score& sc, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tb, T* __restrict__ o,
    int P, int Hc, int hc, int D, int NP, Rows g, unsigned char* work) {
  constexpr int kTile = tile_keys<T>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_keys = grp.n_keys;
  const int n_tiles = n_keys > 0 ? (n_keys + kTile - 1) / kTile : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                  : 0;
  T* ring = reinterpret_cast<T*>(work) + warp * kStages * 2 * kTile * g.rs;

  bool ok = false;
  if (mine > 0)
    ok = issue_tile(ring, ring + kTile * g.rs, kp, vp, tb, warp * kTile,
                    n_keys, P, Hc, hc, D, NP, g, lane);
  hopper::cp_async_commit();
  __syncthreads();   // the kernel's staging is visible

  for (int i = 0; i < mine; ++i) {
    bool ok_next = false;
    if (i + 1 < mine) {
      T* nb = ring + ((i + 1) % kStages) * 2 * kTile * g.rs;
      ok_next = issue_tile(nb, nb + kTile * g.rs, kp, vp, tb,
                           (warp + (i + 1) * kWarps) * kTile, n_keys, P, Hc,
                           hc, D, NP, g, lane);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();    // tile i has landed (this lane's part)
    __syncwarp();                  // ... and every lane's

    const T* kb = ring + (i % kStages) * 2 * kTile * g.rs;
    sc.tile(kb, kb + kTile * g.rs, ok, (warp + i * kWarps) * kTile, lane, g);
    __syncwarp();      // every lane is done with this stage
    ok = ok_next;
  }
  hopper::cp_async_wait<0>();
  __syncthreads();     // every warp is done with its ring: reuse it

  // combine the warps' partials: [warp][row] m and l, [warp][row][D] acc
  float* m_s = reinterpret_cast<float*>(work);
  float* l_s = m_s + kWarps * REPC;
  float* a_s = l_s + kWarps * REPC;
  sc.store(m_s, l_s, a_s, warp, lane);
  __syncthreads();
  for (int i = tid; i < grp.rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * REPC + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w * REPC + r] - mx);   // 0 for an empty warp
      den += f * l_s[w * REPC + r];                    // unless all are
      num += f * a_s[(w * REPC + r) * D + d];
    }
    o[grp.off(r) + d] = from_f<T>(num / fmaxf(den, 1e-20f));
  }
}

}  // namespace paged_walk
