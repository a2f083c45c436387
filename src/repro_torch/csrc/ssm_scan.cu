// Mamba-1 selective scan for Hopper (sm_90a): the core recurrence of a
// Mamba-1 block over a whole prompt, from a zero state.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) (outer) B_t ;  y_t = h_t . C_t
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan ->
// pl.pallas_call). Same arithmetic as its oracle (repro.kernels.ref.
// ssm_scan_ref): fp32 state and products, a_bar = exp(dt * a) per (channel,
// state), y_t the sum over the N states, y and h_last in fp32. The D-skip
// and the SiLU gate stay outside the kernel, as in repro.
//
// Design. The TPU kernel walks the sequence as the innermost sequential grid
// axis with the (block_d, N) state in VMEM scratch. Here the grid is
// (B, ceil(D / 128)) blocks of 128 threads and each thread owns one channel
// d: its N fp32 states and its N values of A live in registers for the
// whole sequence, so the state never touches device memory until h_last is
// written once at the end. The block stages a chunk of 32 time steps of
// B_t and C_t (N values each, shared by all 128 channels) in shared memory
// as fp32, then every thread steps t sequentially through the chunk. Loads
// of x and dt and stores of y are coalesced along D in the model's
// (B, L, D) layout. Any L and D are taken: the ragged last channel tile is
// masked (no halving of the tile as the TPU wrapper's block sizes need),
// and N up to 64 is compiled as a fixed register array (the state count is
// a template parameter rounded up to 8, 16, 32 or 64; lanes past N are
// masked).
//
// What bounds it. Per (b, t, d) it reads x (2 bytes in bf16) and dt (4) and
// writes y (4); per (b, t) the N values of B and C; h_last once. It
// evaluates B * L * D * N exponentials and ~6 flops for each: at serving
// shapes (B = 8, L = 100, D = 8192, N = 16) 65.5 MB against 105 M exp, so
// it is bound by bytes (3.35 TB/s); the exponentials (Hopper's SFUs do 16
// per SM per clock) come second. The recurrence is sequential in t: the
// parallelism is B * D channels, 65536 threads at that shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;
constexpr int kMaxN = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// T: dtype of x, B and C (the model dtype); NT: state count rounded up
// (registers), N the real one.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ h_last, int L, int D, int N) {
  __shared__ float b_s[kChunk][NT];
  __shared__ float c_s[kChunk][NT];

  const int b = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  const bool live = d < D;

  float h[NT], av[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    h[n] = 0.f;
    av[n] = (live && n < N) ? a[static_cast<long long>(d) * N + n] : 0.f;
  }

  const long long row = static_cast<long long>(b) * L;
  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int tn = min(kChunk, L - t0);
    __syncthreads();   // previous chunk fully consumed
    for (int e = threadIdx.x; e < tn * N; e += kThreads) {
      const int tt = e / N, n = e - tt * N;
      const long long off = (row + t0 + tt) * N + n;
      b_s[tt][n] = to_f(bm[off]);
      c_s[tt][n] = to_f(cm[off]);
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tn; ++tt) {
      const long long off = (row + t0 + tt) * D + d;
      const float dtv = dt[off];
      const float dx = __fmul_rn(dtv, to_f(x[off]));
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < N) {
          // unfused, as the plain version's separate elementwise passes
          h[n] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dtv, av[n])), h[n]),
                           __fmul_rn(dx, b_s[tt][n]));
          acc = __fadd_rn(acc, __fmul_rn(h[n], c_s[tt][n]));
        }
      }
      y[off] = acc;
    }
  }
  if (live) {
    float* hb = h_last + (static_cast<long long>(b) * D + d) * N;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < N) hb[n] = h[n];
  }
}

template <typename T, int NT>
int launch_n(const void* x, const float* dt, const float* a, const void* bm,
             const void* cm, float* y, float* h_last, int B, int L, int D,
             int N, cudaStream_t stream) {
  dim3 grid(B, (D + kThreads - 1) / kThreads);
  ssm_scan_kernel<T, NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, h_last, L, D, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* h_last, int B, int L, int D,
           int N, cudaStream_t stream) {
  if (N <= 8)
    return launch_n<T, 8>(x, dt, a, bm, cm, y, h_last, B, L, D, N, stream);
  if (N <= 16)
    return launch_n<T, 16>(x, dt, a, bm, cm, y, h_last, B, L, D, N, stream);
  if (N <= 32)
    return launch_n<T, 32>(x, dt, a, bm, cm, y, h_last, B, L, D, N, stream);
  return launch_n<T, 64>(x, dt, a, bm, cm, y, h_last, B, L, D, N, stream);
}

}  // namespace

extern "C" {

// dtype of x, B and C: 0 float32, 1 bfloat16, 2 float16. x (B, L, D),
// dt (B, L, D) fp32, a (D, N) fp32, B/C (B, L, N), y (B, L, D) fp32,
// h_last (B, D, N) fp32, all contiguous. Returns cudaGetLastError().
int ssm_scan_fwd(int dtype, const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, float* y, float* h_last,
                 int B, int L, int D, int N, void* stream) {
  if (N < 1 || N > kMaxN || B < 1 || L < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, dt, a, bm, cm, y, h_last, B, L, D, N, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, h_last, B, L, D, N,
                                   s);
    case 2:
      return launch<__half>(x, dt, a, bm, cm, y, h_last, B, L, D, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
