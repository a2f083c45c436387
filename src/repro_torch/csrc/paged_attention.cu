// Paged decode attention for Hopper (sm_90a): one query token per request
// against its KV history stored in fixed-size pages, GQA folded in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> pl.pallas_call). Same arithmetic: fp32 scores and
// accumulation, key k of row b visible iff k <= pos[b], online softmax
// along the logical page walk, denominator clamped at 1e-20, output in
// the input dtype.
//
// Design. One block per (kv-cache head, request row). The block reads
// page_table[b, j] itself (the TPU kernel had it scalar-prefetched) and
// walks only the logical positions 0..pos[b]: tail pages past pos[b]
// would contribute exp(-1e30 - m) = 0, so skipping them is exact. Keys go
// through shared memory in tiles of 32 positions (a tile may span pages;
// any page size works), converted to fp32 and shared by the `rep` query
// heads of the group (q head h reads cache head h / rep). Each warp owns
// query heads warp, warp+4, ...; a lane scores one key of the tile and
// owns D/32 output columns for P.V, with shuffle reductions for the tile
// max and sum. Page ids outside [0, NP) are treated as masked keys, so a
// corrupt table cannot read outside the pool. Pages are (NP, P, Hc, D)
// contiguous: one layer's slice of the pool's (layers, NP+1, P, Hc, D)
// buffer, scratch page included.
//
// What bounds it. Decode reads each visible key and value once per
// (row, cache head): (pos+1)*Hc*D*2 elements per row, against
// 4*Hq*D*(pos+1) flops, about one flop per byte, so it is bound by bytes
// (3.35 TB/s). This first version loads with plain per-thread reads and
// leaves warps idle when rep < 4 (rep = 2 at full-width granite); vector
// loads, cp.async double buffering and splitting long walks across blocks
// are the later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxRep = 16;
constexpr int kTile = 32;
constexpr int kWarps = 4;
constexpr int kHeadsPerWarp = kMaxRep / kWarps;
constexpr int kCols = kMaxD / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ pos, T* __restrict__ o, int Hq,
                 int Hc, int P, int D, int M, int NP, float scale) {
  __shared__ float q_s[kMaxRep][kMaxD];
  __shared__ float k_s[kTile][kMaxD + 1];   // +1: conflict-free row reads
  __shared__ float v_s[kTile][kMaxD];
  __shared__ int ok_s[kTile];

  const int hc = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = Hq / Hc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + (static_cast<long long>(b) * Hq + hc * rep) * D;
  for (int i = tid; i < rep * D; i += blockDim.x) q_s[i / D][i % D] = to_f(qb[i]);

  float m[kHeadsPerWarp], l[kHeadsPerWarp], acc[kHeadsPerWarp][kCols];
#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[hh][c] = 0.f;
  }

  const int n_keys = min(pos[b] + 1, M * P);
  const int* tb = table + static_cast<long long>(b) * M;

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();   // previous tile fully consumed (and q staged)
    for (int i = tid; i < kTile * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const int kj = t0 + j;
      float kf = 0.f, vf = 0.f;
      bool ok = false;
      if (kj < n_keys) {
        const int page = tb[kj / P];
        if (page >= 0 && page < NP) {
          const long long off =
              ((static_cast<long long>(page) * P + kj % P) * Hc + hc) * D + d;
          kf = to_f(kp[off]);
          vf = to_f(vp[off]);
          ok = true;
        }
      }
      k_s[j][d] = kf;
      v_s[j][d] = vf;
      if (d == 0) ok_s[j] = ok;
    }
    __syncthreads();

    const bool valid = ok_s[lane] != 0;
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      const int r = warp + hh * kWarps;
      if (r >= rep) continue;           // warp-uniform
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r][d], k_s[lane][d], s);
      s = valid ? s * scale : kNegInf;
      const float m_new = fmaxf(m[hh], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[hh] - m_new);
      l[hh] = l[hh] * alpha + warp_sum(p);
      m[hh] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[hh][c] *= alpha;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[hh][c] = fmaf(pj, v_s[j][d], acc[hh][c]);
        }
      }
    }
  }

  T* ob = o + (static_cast<long long>(b) * Hq + hc * rep) * D;
#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
    const int r = warp + hh * kWarps;
    if (r >= rep) continue;
    const float denom = fmaxf(l[hh], 1e-20f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[r * D + d] = from_f<T>(acc[hh][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* pos, void* o, int B, int Hq, int Hc, int P, int D,
           int M, int NP, float scale, void* stream) {
  dim3 grid(Hc, B);
  paged_fwd_kernel<T><<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, pos, static_cast<T*>(o), Hq, Hc, P,
      D, M, NP, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. q (B, Hq, D), pages
// (NP, P, Hc, D), out (B, Hq, D) all contiguous; table (B, M) and pos (B,)
// int32. Returns cudaGetLastError().
int paged_attention_fwd(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const int* table,
                        const int* pos, void* o, int B, int Hq, int Hc,
                        int P, int D, int M, int NP, float scale,
                        void* stream) {
  if (D > kMaxD || D % 8 != 0 || Hc <= 0 || Hq % Hc != 0 ||
      Hq / Hc > kMaxRep)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, table, pos, o, B, Hq, Hc, P,
                           D, M, NP, scale, stream);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, table, pos, o, B, Hq,
                                   Hc, P, D, M, NP, scale, stream);
    case 2:
      return launch<__half>(q, k_pages, v_pages, table, pos, o, B, Hq, Hc, P,
                            D, M, NP, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
