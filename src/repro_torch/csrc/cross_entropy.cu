// Fused LM-head cross-entropy for Hopper (sm_90a): per-token NLL, logsumexp
// and argmax-correct flag (forward), and the gradients of the NLL with
// respect to the hidden states and the vocab matrix (backward).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cross_entropy.py
// (fused_cross_entropy -> pl.pallas_call), which streams vocab tiles with
// an online logsumexp so the (T, V) logits never reach HBM. Same
// arithmetic: fp32 products and accumulation, lse = m + log(l), the
// target logit picked from the tile that holds the label. The TPU kernel
// is forward only (the model differentiated chunked_xent in plain JAX);
// here the backward is a kernel as well, and the forward also returns the
// argmax-correct flag (first index on ties, as jnp.argmax) that
// chunked_xent feeds to the accuracy metric.
//
// Core. One register-tiled product C = A . B on the CUDA cores: a block
// of 256 threads owns a 64 x 64 tile of C, the K axis streams through
// shared memory 16 at a time (converted to fp32), and each thread keeps a
// 4 x 4 micro-tile of C in registers. A and B are read through two strides
// each, so the same code serves h . W, ds . W^T and h^T . ds without
// transposed copies. Every edge is masked: M, N and K need not be
// multiples of the tile (V = 49155 is odd; T may be anything).
//
// Forward. Grid (token tiles of 64, vocab splits). A block streams its
// split's vocab tiles: after each 64 x 64 logit tile it folds the tile
// into per-row running (max, sum of exp, best logit, its index, target
// logit) with half-warp shuffles; columns past V are left out. Splitting
// the vocab axis across blocks gives T = 2048 tokens 32 x 17 blocks
// instead of 32 (the TPU's sequential vocab axis); a second small kernel
// combines the splits in order, so the result does not depend on timing.
//
// Backward. ds = (exp(s - lse) - onehot(label)) * g, recomputed chunk by
// chunk of the vocab axis (chunk columns chosen by the wrapper so the
// fp32 ds scratch stays ~64 MB): one pass writes ds for the chunk, one
// product writes dW[:, chunk] = h^T . ds (each output element sums over
// all T tokens in one thread, rounded once to W's dtype), and one product
// accumulates dh += ds . W[:, chunk]^T into an fp32 buffer, rounded to
// h's dtype after the last chunk. No atomics: the result is deterministic.
//
// What bounds it. At T = 2048, d = 2048, V = 49155 the forward is
// 2*T*d*V = 4.12e11 flops against ~210 MB of bytes, the backward three
// times the flops: operations bound the card (0.42 ms forward at the bf16
// tensor-core peak). This first version runs fp32 on the CUDA cores, far
// from that bound; wgmma tiles fed by TMA are the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = 256;     // 16 x 16 threads, one 4 x 4 micro-tile each
constexpr int kPad = 4;           // keeps smem rows 16-byte aligned

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

struct Tiles {
  float a[BK][BM + kPad];
  float b[BK][BN + kPad];
};

// acc = A[m0:m0+64, :] . B[:, n0:n0+64] with A (M x K) element (m, k) at
// a[m*sam + k*sak] and B (K x N) element (k, n) at b[k*sbk + n*sbn].
// Thread (ty, tx) owns rows m0 + 4*ty + i and columns n0 + 4*tx + j.
// Out-of-range elements load as 0. Every thread of the block must call it.
template <typename TA, typename TB>
__device__ __forceinline__ void tile_product(
    const TA* __restrict__ a, long long sam, long long sak,
    const TB* __restrict__ b, long long sbk, long long sbn,
    int M, int N, int K, int m0, int n0, Tiles& sm, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      int m, k;
      if (sak == 1) { m = idx / BK; k = idx % BK; }   // neighbours along k
      else          { k = idx / BM; m = idx % BM; }   // neighbours along m
      const int gm = m0 + m, gk = k0 + k;
      sm.a[k][m] = (gm < M && gk < K) ? to_f(a[gm * sam + gk * sak]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      int n, k;
      if (sbn == 1) { k = idx / BN; n = idx % BN; }
      else          { n = idx / BK; k = idx % BK; }
      const int gn = n0 + n, gk = k0 + k;
      sm.b[k][n] = (gn < N && gk < K) ? to_f(b[gk * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk][4 * tx]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Reductions over the 16 threads that share a row (lanes with one ty are
// 16 neighbouring lanes of a warp: xor offsets below 16 stay among them).
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void half_warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// Partials of one (token, vocab split): 5 planes of nsplit x T floats.
enum { kPartM = 0, kPartL, kPartBest, kPartIdx, kPartTgt, kParts };

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                const int* __restrict__ labels, int Tn, int D, int V,
                int tiles_per_split, int nsplit, float* __restrict__ part) {
  __shared__ __align__(16) Tiles sm;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float run_m[TM], run_l[TM], best[TM], tgt[TM];
  int best_i[TM], lab[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + 4 * ty + i;
    run_m[i] = -INFINITY;
    run_l[i] = 0.f;
    best[i] = -INFINITY;
    best_i[i] = 0x7fffffff;
    tgt[i] = 0.f;
    lab[i] = row < Tn ? labels[row] : -1;
  }
  const int v_begin = split * tiles_per_split * BN;
  const int v_end = min(V, v_begin + tiles_per_split * BN);

  for (int n0 = v_begin; n0 < v_end; n0 += BN) {
    float acc[TM][TN];
    tile_product(h, D, 1, w, V, 1, Tn, V, D, m0, n0, sm, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = -INFINITY, tt = 0.f;
      int targ = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + 4 * tx + j;
        if (col < V) {
          const float s = acc[i][j];
          if (s > tmax) { tmax = s; targ = col; }
          if (col == lab[i]) tt += s;
        }
      }
      half_warp_argmax(tmax, targ);
      tt = half_warp_sum(tt);
      const float m_new = fmaxf(run_m[i], tmax);
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n0 + 4 * tx + j < V) se += expf(acc[i][j] - m_new);
      se = half_warp_sum(se);
      run_l[i] = run_l[i] * expf(run_m[i] - m_new) + se;
      run_m[i] = m_new;
      if (tmax > best[i]) { best[i] = tmax; best_i[i] = targ; }  // earlier tile wins ties
      tgt[i] += tt;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + 4 * ty + i;
      if (row >= Tn) continue;
      const long long base = static_cast<long long>(split) * Tn + row;
      const long long plane = static_cast<long long>(nsplit) * Tn;
      part[kPartM * plane + base] = run_m[i];
      part[kPartL * plane + base] = run_l[i];
      part[kPartBest * plane + base] = best[i];
      part[kPartIdx * plane + base] = __int_as_float(best_i[i]);
      part[kPartTgt * plane + base] = tgt[i];
    }
  }
}

// Combine the vocab splits of each token, in split order.
__global__ void xent_combine_kernel(const float* __restrict__ part,
                                    const int* __restrict__ labels, int Tn,
                                    int nsplit, float* __restrict__ nll,
                                    float* __restrict__ lse,
                                    int* __restrict__ correct) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  const long long plane = static_cast<long long>(nsplit) * Tn;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s)
    m = fmaxf(m, part[kPartM * plane + static_cast<long long>(s) * Tn + t]);
  float l = 0.f, tg = 0.f, best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int s = 0; s < nsplit; ++s) {
    const long long o = static_cast<long long>(s) * Tn + t;
    l += part[kPartL * plane + o] * expf(part[kPartM * plane + o] - m);
    tg += part[kPartTgt * plane + o];
    const float b = part[kPartBest * plane + o];
    if (b > best) { best = b; best_i = __float_as_int(part[kPartIdx * plane + o]); }
  }
  const float ls = m + logf(fmaxf(l, 1e-30f));
  lse[t] = ls;
  nll[t] = ls - tg;
  correct[t] = best_i == labels[t] ? 1 : 0;
}

// ds[t, c] = (exp(s - lse[t]) - [c0 + c == label[t]]) * g[t] for the chunk
// of columns [c0, c0 + cw); ds is (T, ld) fp32, row stride ld.
template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_ds_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const int* __restrict__ labels, const float* __restrict__ lse,
               const float* __restrict__ g, int Tn, int D, int V, int c0,
               int cw, int ld, float* __restrict__ ds) {
  __shared__ __align__(16) Tiles sm;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[TM][TN];
  tile_product(h, D, 1, w + c0, V, 1, Tn, cw, D, m0, n0, sm, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= Tn) continue;
    const float l = lse[row], gr = g[row];
    const int lab = labels[row];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c >= cw) continue;
      const float p = expf(acc[i][j] - l);
      ds[static_cast<long long>(row) * ld + c] =
          (p - (c0 + c == lab ? 1.f : 0.f)) * gr;
    }
  }
}

// C = A . B over a (M x N) output. With acc_buf: C (+ acc_buf when
// accumulate) is kept in fp32 there, or, when out is given, rounded once
// into out. Without acc_buf: C is rounded into out.
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ a, long long sam, long long sak,
            const TB* __restrict__ b, long long sbk, long long sbn, int M,
            int N, int K, float* __restrict__ acc_buf, long long s_acc,
            int accumulate, TO* __restrict__ out, long long s_out) {
  __shared__ __align__(16) Tiles sm;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[TM][TN];
  tile_product(a, sam, sak, b, sbk, sbn, M, N, K, m0, n0, sm, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col >= N) continue;
      float v = acc[i][j];
      if (acc_buf != nullptr && accumulate) v += acc_buf[row * s_acc + col];
      if (out != nullptr) out[row * s_out + col] = from_f<TO>(v);
      else acc_buf[row * s_acc + col] = v;
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int imin(int a, int b) { return a < b ? a : b; }

template <typename T>
int fwd(const void* h, const void* w, const int* labels, int Tn, int D, int V,
        int nsplit, float* part, float* nll, float* lse, int* correct,
        cudaStream_t stream) {
  const int vtiles = cdiv(V, BN);
  const int per = cdiv(vtiles, nsplit);
  nsplit = cdiv(vtiles, per);               // no empty split
  dim3 grid(cdiv(Tn, BM), nsplit);
  xent_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, Tn, D, V,
      per, nsplit, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_combine_kernel<<<cdiv(Tn, 256), 256, 0, stream>>>(
      part, labels, Tn, nsplit, nll, lse, correct);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* hv, const void* wv, const int* labels, const float* lse,
        const float* g, int Tn, int D, int V, int chunk, float* ds,
        float* dh_acc, void* dhv, void* dwv, cudaStream_t stream) {
  const T* h = static_cast<const T*>(hv);
  const T* w = static_cast<const T*>(wv);
  T* dh = static_cast<T*>(dhv);
  T* dw = static_cast<T*>(dwv);
  for (int c0 = 0; c0 < V; c0 += chunk) {
    const int cw = imin(chunk, V - c0);
    const bool last = c0 + cw >= V;
    xent_ds_kernel<T><<<dim3(cdiv(Tn, BM), cdiv(cw, BN)), kThreads, 0,
                        stream>>>(h, w, labels, lse, g, Tn, D, V, c0, cw,
                                  chunk, ds);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // dW[:, c0:c0+cw] = h^T . ds: A(m = i_d, k = t) = h[t*D + i_d]
    gemm_kernel<T, float, T><<<dim3(cdiv(D, BM), cdiv(cw, BN)), kThreads, 0,
                               stream>>>(
        h, 1, D, ds, chunk, 1, D, cw, Tn, nullptr, 0, 0, dw + c0, V);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // dh += ds . W[:, c0:c0+cw]^T: B(k = c, n = i_d) = W[i_d*V + c0 + c]
    gemm_kernel<float, T, T><<<dim3(cdiv(Tn, BM), cdiv(D, BN)), kThreads, 0,
                               stream>>>(
        ds, chunk, 1, w + c0, 1, V, Tn, D, cw, dh_acc, D, c0 > 0,
        last ? dh : nullptr, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (hidden and W alike). hidden
// (T, D) and W (D, V) contiguous; labels (T,) int32 in [0, V). part is
// fp32 scratch of 5 * nsplit * T; nll, lse (T,) fp32; correct (T,) int32.
// Returns cudaGetLastError().
int cross_entropy_fwd(int dtype, const void* h, const void* w,
                      const int* labels, int Tn, int D, int V, int nsplit,
                      float* part, float* nll, float* lse, int* correct,
                      void* stream) {
  if (Tn <= 0 || D <= 0 || V <= 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fwd<float>(h, w, labels, Tn, D, V, nsplit, part, nll, lse,
                              correct, s);
    case 1: return fwd<__nv_bfloat16>(h, w, labels, Tn, D, V, nsplit, part,
                                      nll, lse, correct, s);
    case 2: return fwd<__half>(h, w, labels, Tn, D, V, nsplit, part, nll,
                               lse, correct, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g (T,) fp32 = dLoss/dnll. ds is fp32 scratch of T * chunk, dh_acc fp32
// scratch of T * D; dh (T, D) and dW (D, V) come out in the input dtype.
int cross_entropy_bwd(int dtype, const void* h, const void* w,
                      const int* labels, const float* lse, const float* g,
                      int Tn, int D, int V, int chunk, float* ds,
                      float* dh_acc, void* dh, void* dw, void* stream) {
  if (Tn <= 0 || D <= 0 || V <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd<float>(h, w, labels, lse, g, Tn, D, V, chunk, ds,
                              dh_acc, dh, dw, s);
    case 1: return bwd<__nv_bfloat16>(h, w, labels, lse, g, Tn, D, V, chunk,
                                      ds, dh_acc, dh, dw, s);
    case 2: return bwd<__half>(h, w, labels, lse, g, Tn, D, V, chunk, ds,
                               dh_acc, dh, dw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
