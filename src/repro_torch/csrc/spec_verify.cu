// Speculative-verify window attention for Hopper (sm_90a): W query lanes
// per request (the last accepted token plus gamma draft proposals) against
// the request's KV history stored in fixed-size pages, GQA folded in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spec_verify.py
// (spec_verify -> pl.pallas_call). Same function: fp32 scores and
// accumulation, key k visible to lane i of row b iff k <= q_pos[b, i],
// page ids outside [0, NP) treated as masked keys (a corrupt table cannot
// read outside the pool), denominator clamped at 1e-20, output rounded
// once to the input dtype. Pages are (NP, P, Hc, D) contiguous and
// 16-byte aligned; any page size, D a multiple of 8 up to 128, rep up to
// 16, W up to 16.
//
// What bounds it. Each visible key and value is read once per (row, cache
// head, row group): (max q_pos + 1) Hc D 2 elements a request, against
// 4 D flops per (query row, visible key): W rep flops a byte, far below
// the card's ~295 flop/byte ridge, so the bound is bytes (3.35 TB/s). At
// the speculative run's geometry (8 rows, W = 5, Hc = 16, D = 64, walks of
// at most ~120 keys) that is under 1 MB, well under a microsecond: what
// sets the time is latency. Each warp holds about one 32-key tile of a
// walk, so a block costs one cp.async round trip, one warp's scoring of
// the group's W rep rows, and the combine. The first version staged tiles
// through shared memory as 2-byte scalar loads with a division an
// element, loaded no tile ahead, and scored each of a warp's rows one
// after another as a 64-deep dependent fma chain.
//
// Design. B2's key walk (csrc/paged_walk.cuh), with the window folded into
// the query group: a block serves one (cache head, request, group of up
// to kRows = 16 query rows); the rows of a (request, cache head) pair are
// its W rep (window lane, q head) pairs in lane-major order (not
// contiguous in o), each seeing the keys up to its lane's position, and
// the walk runs to the group's largest position. More rows take more
// groups on blockIdx.z. At full-width granite (W = 5, rep = 2) one block
// holds all 10. A window that crosses a page, scratch lanes (q_pos at the
// table's last, always-scratch column) and windows of different lengths
// need no special case. Scoring:
// - W = 1, and fp32 at any W: the walk's CUDA-core scoring (CoreScore),
//   rows = rep. At W = 1 every step is B2's, so the two are bitwise equal.
// - W >= 2 in bf16/fp16 (MmaScore): the group's <= 16 rows are one A
//   operand of mma.sync m16n8k16 (fp32 accumulation; wgmma would need 64
//   rows, 54 of them empty at 10 live rows). K comes from the cp.async
//   tile by ldmatrix, V by ldmatrix.trans; the score fragments become P's
//   A operand in registers, fed to P.V in two parts of the input dtype
//   (hi = P rounded, lo = P - hi, ~16 bits, as B1's forward does), so the
//   output keeps to the fp32-P plain version's tolerance.

#include "paged_walk.cuh"

namespace {

using namespace paged_walk;

constexpr int kMaxRep = 16;
constexpr int kMaxW = 16;
constexpr int kRows = 16;          // query rows per block

// The rows of group blockIdx.z of (request b, cache head hc): row r is
// window lane (row0 + r) / rep, q head hc rep + (row0 + r) % rep; q and o
// are (B, W, Hq, D).
struct WindowGroup {
  long long bw;     // b W: the request's first lane
  int Hq, hc, rep, row0, D, rows, n_keys;
  __device__ __forceinline__ long long off(int r) const {
    const int gr = row0 + r;
    return ((bw + gr / rep) * Hq + hc * rep + gr % rep) *
           static_cast<long long>(D);
  }
  __device__ __forceinline__ int lane_of(int r) const {
    return static_cast<int>(bw) + (row0 + r) / rep;
  }
};

// This block's group; the walk runs to its largest lane position.
__device__ __forceinline__ WindowGroup window_group(
    const int* __restrict__ q_pos, int W, int Hq, int Hc, int D, int M,
    int P) {
  const int hc = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = Hq / Hc;
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, W * rep - row0);
  int mx = -1;
  for (int i = row0 / rep; i <= (row0 + rows - 1) / rep; ++i)
    mx = max(mx, q_pos[b * W + i]);
  return {static_cast<long long>(b) * W, Hq, hc, rep, row0, D, rows,
          min(mx + 1, M * P)};
}

// ---- tensor-core scoring ----------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)) : "memory");
}

// d (16 x 8, fp32) += a (16 x 16) . b (16 x 8), 16-bit inputs.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Fragment layout of m16n8k16 (lane l, g = l / 4, t = l % 4): an A
// register pair-packs row g (registers 0, 2) or g + 8 (1, 3) at columns
// 2t, 2t + 1 (+ 8 for registers 2, 3); a B register k rows 2t, 2t + 1
// (+ 8 for the second) of column g; the accumulator row g (0, 1) or g + 8
// (2, 3) at columns 2t, 2t + 1. A thread thus owns rows g and g + 8 of
// the group, with their online-softmax state (m, and l over its own
// columns, summed over the 4 lanes of the row at the end).
template <typename T>
struct MmaScore {
  static constexpr int kKs = kMaxD / 16;   // k16 steps of Q.K^T
  static constexpr int kNt = kMaxD / 8;    // n8 tiles of P.V
  uint32_t qa[kKs][4];
  float acc[kNt][4];
  float m[2], l[2];
  int pos[2];                              // -1: a padding row
  int D;
  float scale;

  __device__ __forceinline__ void init(const T* __restrict__ q,
                                       const int* __restrict__ q_pos,
                                       const WindowGroup& grp, float sc,
                                       int lane) {
    const int g = lane >> 2, t = lane & 3;
    D = grp.D;
    scale = sc;
    bool live[2];
    long long off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      live[h] = r < grp.rows;
      off[h] = live[h] ? grp.off(r) : 0;
      pos[h] = live[h] ? q_pos[grp.lane_of(r)] : -1;
      m[h] = kNegInf;
      l[h] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, col = 16 * ks + 2 * t + 8 * (i >> 1);
        qa[ks][i] = live[h] && col < D
            ? *reinterpret_cast<const uint32_t*>(q + off[h] + col) : 0u;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  __device__ __forceinline__ void tile(const T* kb, const T* vb, bool ok,
                                       int t0, int lane, Rows g) {
    const uint32_t okm = __ballot_sync(0xffffffffu, ok);
    const int t = lane & 3, mq = lane >> 3, row8 = lane & 7;
    // S = Q K^T over the tile's 32 keys: n8 tiles j = keys 8j .. 8j + 7
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      if (16 * ks < D) {
        const bool full = 16 * ks + 8 < D;   // else the step's last 8 are 0
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          // matrix mq: keys of n-tile 2 jj + mq / 2, columns half mq % 2
          uint32_t b[4];
          ldsm_x4(b, kb + (16 * jj + 8 * (mq >> 1) + row8) * g.rs + 16 * ks +
                         (full ? 8 * (mq & 1) : 0));
          if (!full) b[1] = b[3] = 0u;
          mma16816<T>(s[2 * jj], qa[ks], b[0], b[1]);
          mma16816<T>(s[2 * jj + 1], qa[ks], b[2], b[3]);
        }
      }
    }
    // online softmax of rows g and g + 8 (elements 2h, 2h + 1 of a tile)
    float mx[2] = {kNegInf, kNegInf};
    bool vis[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        vis[j][e] = ((okm >> key) & 1u) && t0 + key <= pos[e >> 1];
        s[j][e] = vis[j][e] ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = vis[j][e] ? expf(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // O += P V: k16 step kk = keys 16 kk .. 16 kk + 15, P in two parts
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = s[2 * kk + (i >> 1)][2 * (i & 1)];
        const float x1 = s[2 * kk + (i >> 1)][2 * (i & 1) + 1];
        hi[i] = hopper::pack2<T>(x0, x1);
        const float2 h = hopper::unpack2<T>(hi[i]);
        lo[i] = hopper::pack2<T>(x0 - h.x, x1 - h.y);
      }
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        if (16 * np < D) {
          const bool two = 16 * np + 8 < D;
          // matrix mq: keys half mq % 2 of the step, columns of n-tile
          // 2 np + mq / 2
          uint32_t b[4];
          ldsm_x4_trans(b, vb + (16 * kk + 8 * (mq & 1) + row8) * g.rs +
                               16 * np + (two ? 8 * (mq >> 1) : 0));
          mma16816<T>(acc[2 * np], hi, b[0], b[1]);
          mma16816<T>(acc[2 * np], lo, b[0], b[1]);
          if (two) {
            mma16816<T>(acc[2 * np + 1], hi, b[2], b[3]);
            mma16816<T>(acc[2 * np + 1], lo, b[2], b[3]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* m_s, float* l_s, float* a_s,
                                        int warp, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int r = warp * kRows + g + 8 * h;
      if (t == 0) {
        m_s[r] = m[h];
        l_s[r] = lt;
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        if (8 * nt < D) {
          float* dst = a_s + r * D + 8 * nt + 2 * t;
          dst[0] = acc[nt][2 * h];
          dst[1] = acc[nt][2 * h + 1];
        }
      }
    }
  }
};

// ---- kernels ----------------------------------------------------------------

// CUDA-core scoring; REPC: the group's rows rounded up to 2, 4, 8 or 16.
template <typename T, int REPC>
__global__ void __launch_bounds__(kWarps * 32)
spec_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ q_pos, T* __restrict__ o, int W,
                   int Hq, int Hc, int P, int D, int M, int NP, float scale,
                   Rows g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);             // [REPC][D]
  int* pos_s = reinterpret_cast<int*>(q_s + REPC * D);      // [kRows]
  unsigned char* work = reinterpret_cast<unsigned char*>(pos_s + kRows);

  const WindowGroup grp = window_group(q_pos, W, Hq, Hc, D, M, P);
  for (int i = threadIdx.x; i < grp.rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    q_s[i] = to_f(q[grp.off(r) + d]);
  }
  const int tid = threadIdx.x;
  if (tid < grp.rows) pos_s[tid] = q_pos[grp.lane_of(tid)];

  CoreScore<T, REPC, true> sc{q_s, pos_s, grp.rows, D, scale};
  sc.init();
  walk<T, REPC>(grp, sc, kp, vp,
                table + static_cast<long long>(blockIdx.y) * M, o, P, Hc,
                grp.hc, D, NP, g, work);
}

// Tensor-core scoring (16-bit inputs, W >= 2).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spec_verify_mma_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ q_pos, T* __restrict__ o,
                       int W, int Hq, int Hc, int P, int D, int M, int NP,
                       float scale, Rows g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WindowGroup grp = window_group(q_pos, W, Hq, Hc, D, M, P);
  MmaScore<T> sc;
  sc.init(q, q_pos, grp, scale, threadIdx.x & 31);
  walk<T, kRows>(grp, sc, kp, vp,
                 table + static_cast<long long>(blockIdx.y) * M, o, P, Hc,
                 grp.hc, D, NP, g, smem);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit the first time it needs more than 48 KB.
template <typename T, typename K>
int launch_with(K kernel, size_t smem, size_t& allowed, const void* q,
                const void* kp, const void* vp, const int* table,
                const int* q_pos, void* o, int B, int W, int Hq, int Hc,
                int P, int D, int M, int NP, float scale, Rows g,
                cudaStream_t stream) {
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const int groups = (W * (Hq / Hc) + kRows - 1) / kRows;
  kernel<<<dim3(Hc, B, groups), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, q_pos, static_cast<T*>(o), W, Hq, Hc,
      P, D, M, NP, scale, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int REPC>
int launch_core(const void* q, const void* kp, const void* vp,
                const int* table, const int* q_pos, void* o, int B, int W,
                int Hq, int Hc, int P, int D, int M, int NP, float scale,
                cudaStream_t stream) {
  static size_t allowed = 48 * 1024;         // per instantiation
  const Rows g = rows_of<T>(D);
  const size_t lead = REPC * D * sizeof(float) + kRows * sizeof(int);
  return launch_with<T>(spec_verify_kernel<T, REPC>,
                        walk_smem<T, REPC>(g, D, lead), allowed, q, kp, vp,
                        table, q_pos, o, B, W, Hq, Hc, P, D, M, NP, scale, g,
                        stream);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* q_pos, void* o, int B, int W, int Hq, int Hc, int P,
           int D, int M, int NP, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (W >= 2) {
      static size_t allowed = 48 * 1024;
      const Rows g = rows_of<T>(D);
      return launch_with<T>(spec_verify_mma_kernel<T>,
                            walk_smem<T, kRows>(g, D, 0), allowed, q, kp, vp,
                            table, q_pos, o, B, W, Hq, Hc, P, D, M, NP, scale,
                            g, stream);
    }
  }
  const int rows = W * (Hq / Hc);   // the first group's, up to kRows
  if (rows <= 2)
    return launch_core<T, 2>(q, kp, vp, table, q_pos, o, B, W, Hq, Hc, P, D,
                             M, NP, scale, stream);
  if (rows <= 4)
    return launch_core<T, 4>(q, kp, vp, table, q_pos, o, B, W, Hq, Hc, P, D,
                             M, NP, scale, stream);
  if (rows <= 8)
    return launch_core<T, 8>(q, kp, vp, table, q_pos, o, B, W, Hq, Hc, P, D,
                             M, NP, scale, stream);
  return launch_core<T, 16>(q, kp, vp, table, q_pos, o, B, W, Hq, Hc, P, D,
                            M, NP, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. q (B, W, Hq, D), pages
// (NP, P, Hc, D), out (B, W, Hq, D) all contiguous and 16-byte aligned;
// table (B, M) and q_pos (B, W) int32. Returns cudaGetLastError().
int spec_verify_fwd(int dtype, const void* q, const void* k_pages,
                    const void* v_pages, const int* table, const int* q_pos,
                    void* o, int B, int W, int Hq, int Hc, int P, int D,
                    int M, int NP, float scale, void* stream) {
  if (D > kMaxD || D < 8 || D % 8 != 0 || Hc <= 0 || Hq % Hc != 0 ||
      Hq / Hc > kMaxRep || W < 1 || W > kMaxW || B < 1 || B > 65535 ||
      P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, table, q_pos, o, B, W, Hq,
                           Hc, P, D, M, NP, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, table, q_pos, o, B,
                                   W, Hq, Hc, P, D, M, NP, scale, s);
    case 2:
      return launch<__half>(q, k_pages, v_pages, table, q_pos, o, B, W, Hq,
                            Hc, P, D, M, NP, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
