// Paged decode attention for Hopper (sm_90a): one query token per request
// against its KV history stored in fixed-size pages, GQA folded in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> pl.pallas_call). Same function: fp32 scores and
// accumulation, key k of row b visible iff k <= pos[b], page ids outside
// [0, NP) treated as masked keys (a corrupt table cannot read outside the
// pool), denominator clamped at 1e-20, output in the input dtype. Pages
// are (NP, P, Hc, D) contiguous: one layer's slice of the pool's (layers,
// NP+1, P, Hc, D) buffer, scratch page included. Any page size, D a
// multiple of 8 up to 128, rep = Hq / Hc up to 16.
//
// What bounds it. Decode reads each visible key and value once per
// (row, cache head): 2 (pos+1) Hc D elements a row, against 4 Hq D (pos+1)
// flops, about one flop a byte: bound by bytes. At the paged run's
// geometry (8 rows, Hc = 16, D = 64, pos < 128) that is under 1 MB, a
// fraction of a microsecond at 3.35 TB/s, so what bounds a call is
// latency: how many dependent trips to device memory a block makes, and
// how many warps wait on them. The first version gave each warp its own
// q heads (warps 2 and 3 idle at rep = 2, granite's kv_repeat), loaded
// 32-key tiles as 2-byte scalar reads with a division and a modulo an
// element, and loaded no tile ahead of the one it scored.
//
// Design. One block of 4 warps per (cache head, row); the block reads
// page_table[b, :] itself (the TPU kernel had it scalar-prefetched) and
// walks only the logical positions 0..pos[b] (tail pages would contribute
// exp(-1e30 - m) = 0, so skipping them is exact).
// - Warps split the key walk, not the heads: tiles of kTile keys (32; 16
//   in fp32, for shared memory) go to the warps in turn, and each warp
//   scores all rep q heads of the group over its tiles with its own
//   online-softmax state (m, l, acc). At the end the block combines the
//   warps' partials in shared memory (combine_partials_plain in
//   kernels/paged_attention.py is the same arithmetic): a warp with no
//   visible key holds m = -1e30, l = 0, acc = 0 and adds nothing.
// - Loads: lane j computes key j's page id and row once a tile; each K and
//   V row is copied as 16-byte cp.async vectors into the warp's ring of
//   two shared-memory stages (masked rows zero-filled), the next tile
//   issued before the current one is scored. Rows are padded to an odd
//   number of 16-byte units, so lane j's 16-byte reads of row j are free
//   of bank conflicts.
// - Scores: lane j scores key j for every head (the q heads staged in
//   shared memory as fp32, the dot an fma chain in index order, as
//   before); P.V: lane l owns column pairs 2l and 2l + 64.

#include "hopper.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxRep = 16;
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

// Issue the cp.async copies of tile `t0` (keys t0 .. t0 + kTile - 1) of
// this warp into `kb` / `vb`; returns whether lane j's key is visible and
// on a valid page.
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

// REPC: rep rounded up to 2, 4, 8 or 16 (registers); rep the real one.
template <typename T, int REPC>
__global__ void __launch_bounds__(kWarps * 32)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ pos, T* __restrict__ o, int Hq,
                 int Hc, int P, int D, int M, int NP, float scale, Rows g) {
  constexpr int kTile = tile_keys<T>();
  constexpr int E = 16 / sizeof(T);   // values a vector
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);            // [REPC][D]
  unsigned char* work = smem + REPC * D * sizeof(float);  // ring / combine

  const int hc = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = Hq / Hc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + (static_cast<long long>(b) * Hq + hc * rep) * D;
  for (int i = tid; i < rep * D; i += blockDim.x) q_s[i] = to_f(qb[i]);

  const int n_keys = min(pos[b] + 1, M * P);
  const int n_tiles = n_keys > 0 ? (n_keys + kTile - 1) / kTile : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                  : 0;
  const int* tb = table + static_cast<long long>(b) * M;
  T* ring = reinterpret_cast<T*>(work) + warp * kStages * 2 * kTile * g.rs;

  float m[REPC], l[REPC], acc[REPC][kPairs][2];
#pragma unroll
  for (int r = 0; r < REPC; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) acc[r][c][0] = acc[r][c][1] = 0.f;
  }

  bool ok = false;
  if (mine > 0)
    ok = issue_tile(ring, ring + kTile * g.rs, kp, vp, tb, warp * kTile,
                    n_keys, P, Hc, hc, D, NP, g, lane);
  hopper::cp_async_commit();
  __syncthreads();   // q staged

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
    const T* vb = kb + kTile * g.rs;
    // scores: lane j, key j, every head of the group
    float s[REPC];
#pragma unroll
    for (int r = 0; r < REPC; ++r) s[r] = 0.f;
    const T* krow = kb + (lane % kTile) * g.rs;
    for (int v = 0; v < g.vpr; ++v) {
      float kf[E];
      load_vec(krow + v * E, kf);
#pragma unroll
      for (int r = 0; r < REPC; ++r) {
        if (r < rep) {                                  // warp-uniform
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
    // online softmax, per head
    float p[REPC];
#pragma unroll
    for (int r = 0; r < REPC; ++r) {
      p[r] = 0.f;
      if (r < rep) {
        const float sr = ok ? s[r] * scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        p[r] = ok ? expf(sr - m_new) : 0.f;
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
        if (r < rep) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int c = 0; c < kPairs; ++c) {
            acc[r][c][0] = fmaf(pj, vv[c].x, acc[r][c][0]);
            acc[r][c][1] = fmaf(pj, vv[c].y, acc[r][c][1]);
          }
        }
      }
    }
    __syncwarp();      // every lane is done with this stage
    ok = ok_next;
  }
  hopper::cp_async_wait<0>();
  __syncthreads();     // every warp is done with its ring: reuse it

  // combine the warps' partials: [warp][head] m and l, [warp][head][D] acc
  float* m_s = reinterpret_cast<float*>(work);
  float* l_s = m_s + kWarps * REPC;
  float* a_s = l_s + kWarps * REPC;
#pragma unroll
  for (int r = 0; r < REPC; ++r) {
    if (r < rep) {
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
  __syncthreads();
  T* ob = o + (static_cast<long long>(b) * Hq + hc * rep) * D;
  for (int i = tid; i < rep * D; i += blockDim.x) {
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
    ob[i] = from_f<T>(num / fmaxf(den, 1e-20f));
  }
}

template <typename T, int REPC>
int launch_r(const void* q, const void* kp, const void* vp, const int* table,
             const int* pos, void* o, int B, int Hq, int Hc, int P, int D,
             int M, int NP, float scale, cudaStream_t stream) {
  constexpr int kTile = tile_keys<T>();
  Rows g;
  g.vpr = D * static_cast<int>(sizeof(T)) / 16;
  g.lpr = 1;
  while (g.lpr < g.vpr) g.lpr <<= 1;
  g.rs = (g.vpr | 1) * 16 / static_cast<int>(sizeof(T));
  const size_t ring = static_cast<size_t>(kWarps) * kStages * 2 * kTile *
                      g.rs * sizeof(T);
  const size_t combine = (2 * kWarps * REPC + kWarps * REPC * D) *
                         sizeof(float);
  const size_t smem = REPC * D * sizeof(float) + (ring > combine ? ring
                                                                 : combine);
  static size_t allowed = 48 * 1024;         // per instantiation
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_fwd_kernel<T, REPC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  dim3 grid(Hc, B);
  paged_fwd_kernel<T, REPC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, pos, static_cast<T*>(o), Hq, Hc, P,
      D, M, NP, scale, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* pos, void* o, int B, int Hq, int Hc, int P, int D,
           int M, int NP, float scale, cudaStream_t stream) {
  const int rep = Hq / Hc;
  if (rep <= 2)
    return launch_r<T, 2>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                          scale, stream);
  if (rep <= 4)
    return launch_r<T, 4>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                          scale, stream);
  if (rep <= 8)
    return launch_r<T, 8>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                          scale, stream);
  return launch_r<T, 16>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                         scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. q (B, Hq, D), pages
// (NP, P, Hc, D), out (B, Hq, D) all contiguous and 16-byte aligned;
// table (B, M) and pos (B,) int32. Returns cudaGetLastError().
int paged_attention_fwd(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const int* table,
                        const int* pos, void* o, int B, int Hq, int Hc,
                        int P, int D, int M, int NP, float scale,
                        void* stream) {
  if (D > kMaxD || D < 8 || D % 8 != 0 || Hc <= 0 || Hq % Hc != 0 ||
      Hq / Hc > kMaxRep || B < 1 || B > 65535 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, table, pos, o, B, Hq, Hc, P,
                           D, M, NP, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, table, pos, o, B, Hq,
                                   Hc, P, D, M, NP, scale, s);
    case 2:
      return launch<__half>(q, k_pages, v_pages, table, pos, o, B, Hq, Hc, P,
                            D, M, NP, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
