// Prefill attention for Hopper (sm_90a): online-softmax attention,
// causal and/or sliding window, GQA-aware, forward only.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> pl.pallas_call). Same arithmetic: fp32 scores and
// accumulation, -1e30 masking, running max/denominator across kv tiles,
// denominator clamped at 1e-20, output in the input dtype. Causal and
// window masks align query and key *starts* (q_pos = k_pos = row index),
// as the TPU kernel and repro.models.layers.blockwise_attention do.
//
// Design. One block per (q tile of 16 rows, q head, batch row); a loop
// over kv tiles of 32 keys takes the place of the TPU kernel's sequential
// kv grid axis, and the running max, sum and output live in registers
// across it. K and V tiles are staged through shared memory as fp32 and
// shared by the block's 4 warps; each warp owns 4 query rows. For one row
// a lane scores one key of the tile (a D-long dot product against the
// padded K row, conflict-free), the warp reduces the tile max and sum with
// shuffles, and for P.V each lane owns D/32 output columns. The kernel
// computes its own GQA kv head (h / rep) and every offset from the strides
// it is given, so the wrapper passes model-layout (B, S, H, D) tensors as
// strided (B, H, S, D) views without copying. Ragged lengths (S or T not a
// multiple of the tile) are masked in both the q and the kv tile; kv tiles
// past the causal diagonal or before the window are skipped.
//
// What bounds it. At serving prefill shapes (S <= 512, D = 64) the bytes
// are small (q, k, v and out once each) and the work is ~4*S*S/2*D*H
// flops per row; this first version does that work in fp32 on the CUDA
// cores, not the tensor cores, so it is bound by operations, far above the
// bf16 tensor-core bound. mma/wgmma tiles with TMA staging are the later
// step (ROADMAP); this version is the simple, right one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kMaxD = 128;
constexpr int kBlockQ = 16;
constexpr int kBlockK = 32;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int T_len, int D, int rep,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 int causal, int window, float scale) {
  __shared__ float q_s[kBlockQ][kMaxD];
  __shared__ float k_s[kBlockK][kMaxD + 1];   // +1: conflict-free row reads
  __shared__ float v_s[kBlockK][kMaxD];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  T* ob = o + b * o_sb + h * o_sh;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    q_s[r][d] = qi < S ? to_f(qb[qi * q_ss + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[rr][c] = 0.f;
  }

  // kv range this q tile can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBlockQ, S) - 1;
  int k_hi = T_len;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_start = (k_lo / kBlockK) * kBlockK;

  for (int t0 = t_start; t0 < k_hi; t0 += kBlockK) {
    __syncthreads();   // previous tile fully consumed
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const int kj = t0 + j;
      const bool in = kj < T_len;
      k_s[j][d] = in ? to_f(kb[kj * k_ss + d]) : 0.f;
      v_s[j][d] = in ? to_f(vb[kj * v_ss + d]) : 0.f;
    }
    __syncthreads();

    const int kj = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi >= S) continue;            // warp-uniform
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r][d], k_s[lane][d], s);
      s *= scale;
      bool valid = kj < T_len;
      if (causal) valid = valid && kj <= qi;
      if (window > 0) valid = valid && kj > qi - window;
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = kj < T_len ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[rr][c] = fmaf(pj, v_s[j][d], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= S) continue;
    const float denom = fmaxf(l[rr], 1e-20f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[qi * o_ss + d] = from_f<T>(acc[rr][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int T_len, int D,
           const long long* qs, const long long* ks, const long long* vs,
           const long long* os, int causal, int window, float scale,
           void* stream) {
  dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T><<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, D, Hq / Hkv,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      os[0], os[1], os[2], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Strides are in elements, three
// per tensor (batch, head, sequence); the head_dim axis is contiguous.
// window <= 0 means no sliding window. Returns cudaGetLastError().
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int Hq, int Hkv,
                        int S, int T_len, int D, const long long* q_strides,
                        const long long* k_strides,
                        const long long* v_strides,
                        const long long* o_strides, int causal, int window,
                        float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, B, Hq, Hkv, S, T_len, D, q_strides,
                           k_strides, v_strides, o_strides, causal, window,
                           scale, stream);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T_len, D,
                                   q_strides, k_strides, v_strides,
                                   o_strides, causal, window, scale, stream);
    case 2:
      return launch<__half>(q, k, v, o, B, Hq, Hkv, S, T_len, D, q_strides,
                            k_strides, v_strides, o_strides, causal, window,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
