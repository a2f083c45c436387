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
// Core (float32). One register-tiled product C = A . B on the CUDA
// cores: a block of 256 threads owns a 64 x 64 tile of C, the K axis
// streams through shared memory 16 at a time (converted to fp32), and
// each thread keeps a 4 x 4 micro-tile of C in registers. A and B are
// read through two strides each, so the same code serves h . W, ds . W^T
// and h^T . ds without transposed copies. Every edge is masked: M, N and
// K need not be multiples of the tile (V = 49155 is odd; T may be
// anything).
//
// Forward. The dtype picks the kernel in cross_entropy_fwd (a plain
// dispatch, as in the backward). What bounds it: 2*T*d*V = 4.12e11 flops
// at T = 2048, d = 2048, V = 49155 against ~210 MB of bytes, so operations
// bound the card (0.42 ms at the bf16 tensor-core peak).
//
// bf16 / fp16: tensor cores (tc::xent_fwd_tc_kernel). The logits tile
// h[m0:m0+128] . W[:, n0:n0+128] is the backward's product (wgmma
// m64n128k16, fp32 accumulators, h K-major and W MN-major fed by TMA
// through the 4-stage ring by a producer warp). A block walks a run of
// vocab tiles (a split) for its 128 tokens, and the ring runs on across
// tiles, so the next tile's loads overlap this tile's epilogue. The
// epilogue folds the tile into per-row running (max, sum of exp, best
// logit, its index, label logit) in registers: a row's 128 columns sit
// in the 4 lanes lane & 3 of one warp, so the row reduction is two
// shuffles. Columns past V (zero-filled by TMA) are left out. The splits
// (one wave of blocks: SMs / token tiles) are combined in split order by
// xent_combine_kernel, so the result does not depend on timing. W is read
// through a tensor map: its rows must start 16-byte aligned (the wrapper
// hands over a row-padded copy at odd V, made once a step and kept for
// the backward).
//
// float32: CUDA cores (xent_fwd_kernel). Grid (token tiles of 64, vocab
// splits); a block streams its split's 64 x 64 logit tiles (tile_product)
// and folds each into the same running state with half-warp shuffles.
// wgmma in fp32 would be TF32 and break the fp32 tolerances.
//
// Vocab-parallel (tensor-parallel over `model`: W is one rank's slice of
// the vocab columns). cross_entropy_partials runs the same split kernels
// on the slice, with local labels (-1 for a label outside it), and writes
// the splits' combined partials instead of (nll, lse, correct):
// xent_partials_kernel. The ranks all-gather those (5, T) planes and
// combine them in rank order with xent_combine_kernel's arithmetic
// (repro_torch.kernels.cross_entropy.combine_partials), so every rank
// holds the same bits. The backward takes the slice, the local labels and
// the global lse: a label of -1 adds no one-hot part, and dh comes out
// partial, in fp32 (dh null: left in dh_acc), for the caller to sum over
// the ranks and round once, as one card rounds its dh once.
//
// Backward. ds = (exp(s - lse) - onehot(label)) * g, recomputed chunk by
// chunk of the vocab axis (chunk columns chosen by the wrapper so the ds
// scratch stays bounded): one product writes ds for the chunk, one writes
// dW[:, chunk] = h^T . ds (rounded once to W's dtype), and one
// accumulates dh += ds . W[:, chunk]^T into an fp32 buffer, rounded to h's
// dtype after the last chunk. No atomics: the result is deterministic.
// The dtype picks the kernels in cross_entropy_bwd (a plain dispatch):
//
// bf16 / fp16: tensor-core products (namespace tc). What bounds it: at
// T = 2048, d = 2048, V = 49155 the three products are 1.24e12 flops
// (1.25 ms at the 989 TFLOP/s bf16 peak) against ~0.5 GB of bytes, so
// operations bound the card. Design: every product is wgmma m64n128k16
// with fp32 accumulators, 128 x 128 tiles, fed by TMA (128-byte swizzle)
// through a 4-stage mbarrier ring by a producer warp, so loads overlap
// the products. Each operand is read as it lies: h is K-major for ds and
// MN-major (h^T) for dW, W MN-major for ds and K-major (W^T) for dh, ds
// MN-major for dW and K-major for dh. ds is staged in the input dtype,
// half the bytes of fp32, and is then directly a wgmma operand
// (jax.grad of repro's chunked_xent rounds ds to bf16 as well). A tensor
// map needs rows 16-byte aligned: at an odd V the wrapper hands over a
// copy of W with its rows padded to a multiple of 8 (the map still
// stops at V, so the padding is never read), and dW is written with
// element stores straight into the unpadded (d, V) output.
//
// float32: the CUDA-core products below (tile_product), with ds staged in
// fp32; wgmma in fp32 would be TF32 and break the fp32 tolerances.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "hopper.cuh"

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

// The vocab splits of token t combined in split order: the running max,
// the sum of exp(s - max), the label logit, the best logit and its index
// (the first on ties: a later split wins only with a larger logit).
struct Combined {
  float m, l, tgt, best;
  int best_i;
};

__device__ __forceinline__ Combined combine_splits(const float* __restrict__ part,
                                                   int Tn, int nsplit, int t) {
  const long long plane = static_cast<long long>(nsplit) * Tn;
  Combined c{-INFINITY, 0.f, 0.f, -INFINITY, 0x7fffffff};
  for (int s = 0; s < nsplit; ++s)
    c.m = fmaxf(c.m, part[kPartM * plane + static_cast<long long>(s) * Tn + t]);
  for (int s = 0; s < nsplit; ++s) {
    const long long o = static_cast<long long>(s) * Tn + t;
    c.l += part[kPartL * plane + o] * expf(part[kPartM * plane + o] - c.m);
    c.tgt += part[kPartTgt * plane + o];
    const float b = part[kPartBest * plane + o];
    if (b > c.best) {
      c.best = b;
      c.best_i = __float_as_int(part[kPartIdx * plane + o]);
    }
  }
  return c;
}

// Combine the vocab splits of each token, in split order.
__global__ void xent_combine_kernel(const float* __restrict__ part,
                                    const int* __restrict__ labels, int Tn,
                                    int nsplit, float* __restrict__ nll,
                                    float* __restrict__ lse,
                                    int* __restrict__ correct) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  const Combined c = combine_splits(part, Tn, nsplit, t);
  const float ls = c.m + logf(fmaxf(c.l, 1e-30f));
  lse[t] = ls;
  nll[t] = ls - c.tgt;
  correct[t] = c.best_i == labels[t] ? 1 : 0;
}

// The vocab-parallel forward's output: the splits of each token combined
// as above, written as five (T,) fp32 planes in the order of kPart* (the
// best index as a value, offset by v0, the slice's first column) for the
// cross-rank combine, which repeats xent_combine_kernel's arithmetic over
// the slices of all ranks.
__global__ void xent_partials_kernel(const float* __restrict__ part, int Tn,
                                     int nsplit, int v0,
                                     float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  const Combined c = combine_splits(part, Tn, nsplit, t);
  out[kPartM * Tn + t] = c.m;
  out[kPartL * Tn + t] = c.l;
  out[kPartBest * Tn + t] = c.best;
  out[kPartIdx * Tn + t] = static_cast<float>(c.best_i + v0);
  out[kPartTgt * Tn + t] = c.tgt;
}

// Either the combined (nll, lse, correct) or, with partials given, the
// vocab-parallel partials of the splits in part.
inline int finish(const float* part, const int* labels, int Tn, int nsplit,
                  int v0, float* partials, float* nll, float* lse,
                  int* correct, cudaStream_t stream) {
  const int blocks = (Tn + 255) / 256;
  if (partials != nullptr)
    xent_partials_kernel<<<blocks, 256, 0, stream>>>(part, Tn, nsplit, v0,
                                                     partials);
  else
    xent_combine_kernel<<<blocks, 256, 0, stream>>>(part, labels, Tn, nsplit,
                                                    nll, lse, correct);
  return static_cast<int>(cudaGetLastError());
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
        int nsplit, int v0, float* part, float* partials, float* nll,
        float* lse, int* correct, cudaStream_t stream) {
  const int vtiles = cdiv(V, BN);
  const int per = cdiv(vtiles, nsplit);
  nsplit = cdiv(vtiles, per);               // no empty split
  dim3 grid(cdiv(Tn, BM), nsplit);
  xent_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, Tn, D, V,
      per, nsplit, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return finish(part, labels, Tn, nsplit, v0, partials, nll, lse, correct,
                stream);
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
        last ? dh : nullptr, D);          // dh null: fp32 dh in dh_acc
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}


// ---------------------------------------------------------------------------
// Backward on the tensor cores (bf16 and fp16 inputs; see the note at the
// top of the file). One product kernel, xent_tc_gemm, serves the three
// products of a vocab chunk: C (M x N) = A (M x K) . B (K x N) in 128 x 128
// tiles, two consumer warpgroups of 64 rows each and one producer warp
// that keeps kStages K-steps of 64 in flight by TMA. A and B are read
// K-major or MN-major as they lie in memory (template flags), so no
// operand is ever transposed in memory. The epilogue is the product's:
// ds (softmax minus one-hot, times g, rounded to the input dtype), dW
// (rounded once into the unpadded (d, V) output) or dh (summed in fp32
// across chunks, rounded after the last).
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4, kConsumers = 2;
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kTileBytes = kBM * kBK * 2;     // one stage of A, and of B
constexpr int kSmem = 1024 + 2 * kStages * kTileBytes + 8 * 2 * kStages;

enum { kEpiDs = 0, kEpiDw = 1, kEpiDh = 2 };

// The ring of kStages K-steps in dynamic shared memory (1024-aligned
// for the 128-byte swizzle): A tiles, B tiles, then a "full" and an
// "empty" mbarrier per stage. Every thread calls it; it initialises the
// barriers and syncs the block.
struct Ring {
  unsigned char* a;
  unsigned char* b;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring make_ring(unsigned char* smem_raw) {
  Ring r;
  r.a = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  r.b = r.a + kStages * kTileBytes;
  r.full = reinterpret_cast<uint64_t*>(r.b + kStages * kTileBytes);
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4 * kConsumers);    // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// One K-step (kBK deep) of a 128 x 128 tile into ring stage `stage`,
// issued by the producer: A rows m0.. from column k0, B columns bn.. from
// row bk. MN-major A (AMN) is two atoms of 64 rows of M, K-major A one
// box of 128 rows; B alike.
template <int AMN, int BMN>
__device__ __forceinline__ void load_kstep(const Ring& r, int stage,
                                           const CUtensorMap* amap,
                                           const CUtensorMap* bmap, int m0,
                                           int k0, int bn, int bk) {
  uint64_t* bar = &r.full[stage];
  unsigned char* a_dst = r.a + stage * kTileBytes;
  unsigned char* b_dst = r.b + stage * kTileBytes;
  mbar_expect_tx(bar, 2 * kTileBytes);
  if (AMN) {
    tma_load_2d(a_dst, amap, bar, m0, k0);
    tma_load_2d(a_dst + kAtomBytes, amap, bar, m0 + 64, k0);
  } else {
    tma_load_2d(a_dst, amap, bar, k0, m0);
  }
  if (BMN) {
    tma_load_2d(b_dst, bmap, bar, bn, bk);
    tma_load_2d(b_dst + kAtomBytes, bmap, bar, bn + 64, bk);
  } else {
    tma_load_2d(b_dst, bmap, bar, bk, bn);
  }
}

// Consumer warpgroup g's products of one K-step in ring stage `stage`:
// acc (64 x 128) += A (its 64 rows) . B, four wgmma k16 steps committed
// as one group.
template <typename T, int AMN, int BMN>
__device__ __forceinline__ void mma_kstep(float (&acc)[64], const Ring& r,
                                          int stage, int g) {
  const uint32_t a_addr = smem_u32(r.a + stage * kTileBytes + g * kAtomBytes);
  const uint32_t b_addr = smem_u32(r.b + stage * kTileBytes);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    const uint64_t da = AMN ? make_desc(a_addr + ks * 2048, kAtomBytes)
                            : make_desc(a_addr + ks * 32, 16);
    const uint64_t db = BMN ? make_desc(b_addr + ks * 2048, kAtomBytes)
                            : make_desc(b_addr + ks * 32, 16);
    wgmma_ss_n128<T, AMN, BMN>(acc, da, db, 1);
  }
  wgmma_commit();
}

struct Epi {
  const int* labels;      // labels, lse, g of each token
  const float* lse;
  const float* g;
  int c0;                 // first vocab column of the chunk
  void* out;              // ds (T x ld), dW (d x ld, from column c0), dh
  long long ld;
  float* acc;             // dh: fp32 running sum (T x ld)
  int first, last;        // dh: first / last chunk
  const void* src;        // the one-hot part's operand: W (dh), h (dW)
  long long src_ld;
  const int* order;       // dW: tokens sorted by label (stable) and the
  const int* starts;      // first sorted position of each label (V + 1)
};

template <typename T, int AMN, int BMN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
xent_tc_gemm(const __grid_constant__ CUtensorMap amap,
             const __grid_constant__ CUtensorMap bmap, int M, int N, int K,
             int b_n_off, int b_k_off, Epi ep) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4 * kConsumers) {            // producer
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&ring.empty[stage], phase ^ 1);
        load_kstep<AMN, BMN>(ring, stage, &amap, &bmap, m0, kt * kBK,
                             b_n_off + n0, b_k_off + kt * kBK);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  const int g = warp >> 2, w = warp & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0, phase = 0, prev = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&ring.full[stage], phase);
    mma_kstep<T, AMN, BMN>(acc, ring, stage, g);
    wgmma_wait<1>();          // this warp's previous products are done
    if (kt > 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
    prev = stage;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: register 4c + e is row rl + 8(e/2), column 8c + 2(l%4) + e%2
  const int rl = m0 + 64 * g + 16 * w + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = rl + 8 * half;
    if (EPI == kEpiDw || row >= M) continue;
    if (EPI == kEpiDs) {
      const float lr = ep.lse[row], gr = ep.g[row];
      T* out = static_cast<T*>(ep.out) + row * ep.ld;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = n0 + 8 * c + 2 * (lane & 3);
        if (col >= N) continue;
        const float v0 = expf(acc[4 * c + 2 * half] - lr) * gr;
        const float v1 = expf(acc[4 * c + 2 * half + 1] - lr) * gr;
        if (col + 1 < N)
          *reinterpret_cast<uint32_t*>(out + col) = pack2<T>(v0, v1);
        else
          out[col] = from_f<T>(v0);
      }
    } else if (EPI == kEpiDh) {
      const long long base = row * ep.ld;
      // the one-hot part, once: dh[t, i] -= g[t] W[i, label[t]]; a label
      // of -1 (outside this vocab slice) has none
      const int lab = ep.labels[row];
      const T* w_lab = static_cast<const T*>(ep.src) + (lab < 0 ? 0 : lab);
      const float gr = ep.g[row];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = n0 + 8 * c + 2 * (lane & 3);
        if (col >= N) continue;       // N (= d) is even: col + 1 < N too
        float2 v = make_float2(acc[4 * c + 2 * half],
                               acc[4 * c + 2 * half + 1]);
        if (!ep.first) {
          const float2 old =
              *reinterpret_cast<const float2*>(ep.acc + base + col);
          v.x += old.x;
          v.y += old.y;
        }
        if (ep.last && lab >= 0) {
          v.x -= gr * to_f(w_lab[col * ep.src_ld]);
          v.y -= gr * to_f(w_lab[(col + 1) * ep.src_ld]);
        }
        if (ep.last && ep.out != nullptr) {
          *reinterpret_cast<uint32_t*>(static_cast<T*>(ep.out) + base + col) =
              pack2<T>(v.x, v.y);
        } else {       // a running sum, or the fp32 dh (no out given)
          *reinterpret_cast<float2*>(ep.acc + base + col) = v;
        }
      }
    }
  }
  if (EPI != kEpiDw) return;

  // dW: the tile goes through shared memory (the pipeline's, now idle)
  // in fp32, where the one-hot part is applied exactly, then out in rows.
  constexpr int kLd = kBN + 4;
  float* tile = reinterpret_cast<float*>(ring.a);
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
  const int tr = 64 * g + 16 * w + (lane >> 2);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    tile[tr * kLd + col] = acc[4 * c];
    tile[tr * kLd + col + 1] = acc[4 * c + 1];
    tile[(tr + 8) * kLd + col] = acc[4 * c + 2];
    tile[(tr + 8) * kLd + col + 1] = acc[4 * c + 3];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
  // dW[i, c] -= g[t] h[t, i] for each token t labelled c, in sorted order;
  // thread r owns row r, so no two threads touch one element
  const int tid = threadIdx.x;
  const int v_lo = ep.c0 + n0, v_hi = ep.c0 + min(n0 + kBN, N);
  const int j_end = ep.starts[v_hi];
  if (tid < kBM && m0 + tid < M) {
    const T* hcol = static_cast<const T*>(ep.src) + m0 + tid;
    for (int j = ep.starts[v_lo]; j < j_end; ++j) {
      const int t = ep.order[j];
      tile[tid * kLd + ep.labels[t] - v_lo] -=
          ep.g[t] * to_f(hcol[t * ep.src_ld]);
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
  for (int idx = tid; idx < kBM * kBN; idx += 128 * kConsumers) {
    const int r = idx / kBN, c = idx % kBN;
    if (m0 + r < M && n0 + c < N)
      static_cast<T*>(ep.out)[(m0 + r) * ep.ld + ep.c0 + n0 + c] =
          from_f<T>(tile[r * kLd + c]);
  }
}

// Forward on the tensor cores: block (token tile m0, split) walks vocab
// tiles [vt_begin, vt_end) of 128 columns. The producer runs the ring
// over every (tile, K-step) of the walk without a break; a consumer
// releases each stage once its products are done, and after a tile's
// last K-step folds the tile into its rows' running state (fold_tile).
constexpr float kLog2e = 1.4426950408889634f;

struct RowState {
  float m, l, best, tgt;      // running max, sum of exp(s - m), best logit,
  int best_i, label;          // label logit; best's index; the row's label
};

// Fold one 64 x 128 logit tile (this warpgroup's rows) into the state of
// the thread's two rows (register 4c + 2 half + e: row + 8 half, column
// n0 + 8c + 2(lane & 3) + e). Columns at or past V are left out; the
// argmax keeps the first index on ties (columns ascend within a lane,
// lanes compare indices, tiles ascend and replace only a larger logit).
__device__ __forceinline__ void fold_tile(const float (&acc)[64], int n0,
                                          int V, int lane,
                                          RowState (&st)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    RowState& r = st[half];
    float tmax = -INFINITY, tt = 0.f;
    int targ = 0x7fffffff;
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * c + 2 * (lane & 3) + e;
        const float x = acc[4 * c + 2 * half + e];
        if (col < V) {
          if (x > tmax) { tmax = x; targ = col; }
          if (col == r.label) tt += x;
        }
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {      // the row's 4 lanes
      const float ov = __shfl_xor_sync(0xffffffffu, tmax, o);
      const int oi = __shfl_xor_sync(0xffffffffu, targ, o);
      if (ov > tmax || (ov == tmax && oi < targ)) { tmax = ov; targ = oi; }
      tt += __shfl_xor_sync(0xffffffffu, tt, o);
    }
    const float m_new = fmaxf(r.m, tmax);
    float se = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (n0 + 8 * c + 2 * (lane & 3) + e < V)
          se += exp2f((acc[4 * c + 2 * half + e] - m_new) * kLog2e);
    se += __shfl_xor_sync(0xffffffffu, se, 1);
    se += __shfl_xor_sync(0xffffffffu, se, 2);
    r.l = r.l * exp2f((r.m - m_new) * kLog2e) + se;
    r.m = m_new;
    if (tmax > r.best) { r.best = tmax; r.best_i = targ; }
    r.tgt += tt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
xent_fwd_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const int* __restrict__ labels, int Tn, int D, int V,
                   int tiles_per_split, int nsplit,
                   float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw);
  const int m0 = blockIdx.x * kBM, split = blockIdx.y;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min((V + kBN - 1) / kBN, vt_begin + tiles_per_split);
  const int ktiles = (D + kBK - 1) / kBK;
  const int steps = (vt_end - vt_begin) * ktiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4 * kConsumers) {            // producer
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int it = 0; it < steps; ++it) {
        const int n0 = (vt_begin + it / ktiles) * kBN;
        const int k0 = (it % ktiles) * kBK;
        mbar_wait(&ring.empty[stage], phase ^ 1);
        load_kstep<0, 1>(ring, stage, &hmap, &wmap, m0, k0, n0, k0);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  const int g = warp >> 2, w = warp & 3;
  const int rl = m0 + 64 * g + 16 * w + (lane >> 2);
  RowState st[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = rl + 8 * half;
    st[half] = RowState{-INFINITY, 0.f, -INFINITY, 0.f, 0x7fffffff,
                        row < Tn ? labels[row] : -1};
  }
  float acc[64];
  int stage = 0, phase = 0, prev = -1;
  for (int it = 0; it < steps; ++it) {
    const int kt = it % ktiles;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
    mbar_wait(&ring.full[stage], phase);
    mma_kstep<T, 0, 1>(acc, ring, stage, g);
    wgmma_wait<1>();          // this warp's previous products are done
    if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
    prev = stage;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
    if (kt == ktiles - 1) {   // the tile is complete: fold it
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&ring.empty[prev]);
      prev = -1;
      fold_tile(acc, (vt_begin + it / ktiles) * kBN, V, lane, st);
    }
  }
  if ((lane & 3) != 0) return;
  const long long plane = static_cast<long long>(nsplit) * Tn;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = rl + 8 * half;
    if (row >= Tn) continue;
    const long long base = static_cast<long long>(split) * Tn + row;
    part[kPartM * plane + base] = st[half].m;
    part[kPartL * plane + base] = st[half].l;
    part[kPartBest * plane + base] = st[half].best;
    part[kPartIdx * plane + base] = __int_as_float(st[half].best_i);
    part[kPartTgt * plane + base] = st[half].tgt;
  }
}

// A 2-D map over a row-major (rows x cols) 16-bit matrix with row stride
// ld elements and a box of box_cols x box_rows (the encoder refuses a row
// stride or address that is not a 16-byte multiple).
template <typename T>
int map2d(CUtensorMap* map, const void* ptr, int rows, int cols, long long ld,
          int box_cols, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld * 2)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols),
                           static_cast<uint32_t>(box_rows)};
  return hopper_host::encode(map, std::is_same<T, __nv_bfloat16>::value, 2,
                             ptr, dims, strides, box);
}

template <typename T, int AMN, int BMN, int EPI>
int gemm(const CUtensorMap& a, const CUtensorMap& b, int M, int N, int K,
         int b_n_off, int b_k_off, const Epi& ep, cudaStream_t stream) {
  static bool sized = false;            // once per kernel and process
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        xent_tc_gemm<T, AMN, BMN, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  xent_tc_gemm<T, AMN, BMN, EPI><<<grid, kThreads, kSmem, stream>>>(
      a, b, M, N, K, b_n_off, b_k_off, ep);
  return static_cast<int>(cudaGetLastError());
}

// h (Tn, D) contiguous; w (D, V) with row stride ldw (a multiple of 8).
// The splits come out of the kernel into part and are combined in order.
template <typename T>
int fwd(const void* h, const void* w, int ldw, const int* labels, int Tn,
        int D, int V, int nsplit, int v0, float* part, float* partials,
        float* nll, float* lse, int* correct, cudaStream_t stream) {
  CUtensorMap h_k, w_mn;
  int err = map2d<T>(&h_k, h, Tn, D, D, 64, kBM);       // A: K = D
  if (err == 0) err = map2d<T>(&w_mn, w, D, V, ldw, 64, 64);   // B
  if (err != 0) return err;
  const int vtiles = cdiv(V, kBN);
  const int per = cdiv(vtiles, nsplit);
  nsplit = cdiv(vtiles, per);               // no empty split
  static bool sized = false;                // once per kernel and process
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        xent_fwd_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  xent_fwd_tc_kernel<T><<<dim3(cdiv(Tn, kBM), nsplit), kThreads, kSmem,
                          stream>>>(h_k, w_mn, labels, Tn, D, V, per, nsplit,
                                    part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish(part, labels, Tn, nsplit, v0, partials, nll, lse, correct,
                stream);
}

// h (Tn, D) contiguous; w (D, V) with row stride ldw (a multiple of 8);
// ds (Tn, chunk) in T.
template <typename T>
int bwd(const void* h, const void* w, int ldw, const int* labels,
        const int* order, const int* starts, const float* lse,
        const float* g, int Tn, int D, int V, int chunk, void* ds,
        float* dh_acc, void* dh, void* dw, cudaStream_t stream) {
  CUtensorMap h_k, h_mn, w_mn, w_k;
  int err = map2d<T>(&h_k, h, Tn, D, D, 64, kBM);     // A of ds: K = D
  if (err == 0) err = map2d<T>(&h_mn, h, Tn, D, D, 64, 64);   // A of dW
  if (err == 0) err = map2d<T>(&w_mn, w, D, V, ldw, 64, 64);  // B of ds
  if (err == 0) err = map2d<T>(&w_k, w, D, V, ldw, 64, kBN);  // B of dh
  if (err != 0) return err;
  for (int c0 = 0; c0 < V; c0 += chunk) {
    const int cw = imin(chunk, V - c0);
    CUtensorMap ds_mn, ds_k;
    err = map2d<T>(&ds_mn, ds, Tn, cw, chunk, 64, 64);        // B of dW
    if (err == 0) err = map2d<T>(&ds_k, ds, Tn, cw, chunk, 64, kBM);
    if (err != 0) return err;
    // ds (Tn x cw) = softmax(h . W[:, c0:c0+cw]) * g, the softmax part
    Epi e_ds{labels, lse, g, c0, ds, chunk, nullptr, 0, 0, nullptr, 0,
             nullptr, nullptr};
    err = gemm<T, 0, 1, kEpiDs>(h_k, w_mn, Tn, cw, D, c0, 0, e_ds, stream);
    if (err != 0) return err;
    // dW[:, c0:c0+cw] = h^T . ds, less g h of each token labelled there
    Epi e_dw{labels, lse, g, c0, dw, V, nullptr, 0, 0, h, D, order, starts};
    err = gemm<T, 1, 1, kEpiDw>(h_mn, ds_mn, D, cw, Tn, 0, 0, e_dw, stream);
    if (err != 0) return err;
    // dh (+)= ds . W[:, c0:c0+cw]^T; after the last chunk less g W[:, label]
    Epi e_dh{labels, lse, g, c0, dh, D, dh_acc, c0 == 0, c0 + cw >= V, w, ldw,
             nullptr, nullptr};
    err = gemm<T, 0, 0, kEpiDh>(ds_k, w_k, Tn, D, cw, 0, c0, e_dh, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (hidden and W alike). hidden
// (T, D) contiguous; W (D, V) with row stride ldw (V for float32; for
// 16-bit inputs a multiple of 8, so rows start 16-byte aligned); labels
// (T,) int32 in [0, V), or -1 (no label logit). part is fp32 scratch of
// 5 * nsplit * T; nll, lse (T,) fp32; correct (T,) int32. float32 runs
// the CUDA-core kernel, bf16 and fp16 the tensor-core one. Returns
// cudaGetLastError().
int cross_entropy_fwd(int dtype, const void* h, const void* w, int ldw,
                      const int* labels, int Tn, int D, int V, int nsplit,
                      float* part, float* nll, float* lse, int* correct,
                      void* stream) {
  if (Tn <= 0 || D <= 0 || V <= 0 || nsplit <= 0 || ldw < V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (ldw != V) return static_cast<int>(cudaErrorInvalidValue);
      return fwd<float>(h, w, labels, Tn, D, V, nsplit, 0, part, nullptr,
                        nll, lse, correct, s);
    case 1: return tc::fwd<__nv_bfloat16>(h, w, ldw, labels, Tn, D, V,
                                          nsplit, 0, part, nullptr, nll, lse,
                                          correct, s);
    case 2: return tc::fwd<__half>(h, w, ldw, labels, Tn, D, V, nsplit, 0,
                                   part, nullptr, nll, lse, correct, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The vocab-parallel forward over one slice of the vocab: W (D, V) holds
// columns v0 .. v0 + V - 1 of the whole matrix, labels (T,) int32 are
// local (label - v0, or -1 for a label outside the slice). Runs the same
// split kernels as cross_entropy_fwd, then writes out (5, T) fp32, the
// planes in kPart* order: row max, sum of exp(s - max), best logit, its
// index in the whole vocab (a value, < 2^24), label logit (0 outside).
int cross_entropy_partials(int dtype, const void* h, const void* w, int ldw,
                           const int* labels, int Tn, int D, int V,
                           int nsplit, int v0, float* part, float* out,
                           void* stream) {
  if (Tn <= 0 || D <= 0 || V <= 0 || nsplit <= 0 || ldw < V || v0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (ldw != V) return static_cast<int>(cudaErrorInvalidValue);
      return fwd<float>(h, w, labels, Tn, D, V, nsplit, v0, part, out,
                        nullptr, nullptr, nullptr, s);
    case 1: return tc::fwd<__nv_bfloat16>(h, w, ldw, labels, Tn, D, V,
                                          nsplit, v0, part, out, nullptr,
                                          nullptr, nullptr, s);
    case 2: return tc::fwd<__half>(h, w, ldw, labels, Tn, D, V, nsplit, v0,
                                   part, out, nullptr, nullptr, nullptr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g (T,) fp32 = dLoss/dnll; a label of -1 (outside W's vocab slice) adds
// no one-hot part. 16-bit inputs also take order (T,) int32,
// the tokens sorted by label (stable), and starts (V + 1,) int32, the
// first sorted position of each label (unused for float32; may be null).
// w is (D, V) with row stride ldw (V for
// float32; for 16-bit inputs a multiple of 8, so rows start 16-byte
// aligned). ds is scratch of T * chunk in the input dtype (fp32 for
// float32), dh_acc fp32 scratch of T * D; dh (T, D) and dW (D, V), unpadded,
// come out in the input dtype. With dh null, dh is left in dh_acc in fp32,
// unrounded (the vocab-parallel backward sums it over ranks first).
// float32 runs the CUDA-core kernels, bf16 and fp16 the tensor-core ones
// (the dispatch rule noted at the top).
int cross_entropy_bwd(int dtype, const void* h, const void* w, int ldw,
                      const int* labels, const int* order,
                      const int* starts, const float* lse, const float* g,
                      int Tn, int D, int V, int chunk, void* ds,
                      float* dh_acc, void* dh, void* dw, void* stream) {
  if (Tn <= 0 || D <= 0 || V <= 0 || chunk <= 0 || ldw < V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (ldw != V) return static_cast<int>(cudaErrorInvalidValue);
      return bwd<float>(h, w, labels, lse, g, Tn, D, V, chunk,
                        static_cast<float*>(ds), dh_acc, dh, dw, s);
    case 1: return tc::bwd<__nv_bfloat16>(h, w, ldw, labels, order, starts,
                                          lse, g, Tn, D, V, chunk, ds,
                                          dh_acc, dh, dw, s);
    case 2: return tc::bwd<__half>(h, w, ldw, labels, order, starts, lse, g,
                                   Tn, D, V, chunk, ds, dh_acc, dh, dw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
