// Flash attention for Hopper (sm_90a): online-softmax attention, causal
// and/or sliding window, GQA-aware; forward (prefill and training, with an
// optional per-row logsumexp) and backward (training).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> pl.pallas_call). Same arithmetic: fp32 scores and
// accumulation, -1e30 masking, running max/denominator across kv tiles,
// denominator clamped at 1e-20, output in the input dtype (the bf16/fp16
// kernel feeds P to the tensor cores as two 16-bit parts, so it keeps
// ~16 of fp32's 24 mantissa bits; see below). Causal and
// window masks align query and key *starts* (q_pos = k_pos = row index),
// as the TPU kernel and repro.models.layers.blockwise_attention do.
//
// Two forward kernels and two backward kernel pairs, chosen by the input
// dtype in flash_attention_fwd / flash_attention_bwd (a plain dispatch,
// not a fallback: nothing catches a failed launch): bf16 and fp16 run on
// the tensor cores (namespace tc), float32 on the CUDA cores. The
// tensor-core backward is described where it is defined, below the
// forward.
//
// bf16 / fp16: the tensor-core kernel (namespace tc). What bounds it: at
// B = 16, S = 512, Hq = 32, Hkv = 8, D = 64 causal the work is 17.2 GFLOP
// (17 us at the 989 TFLOP/s bf16 peak) against 25 us of bytes (q, k, v
// and out once each at 3.35 TB/s), so bytes bound the card and the
// products have to run on the tensor cores to come near it. Design: one
// block per (128 query rows, q head, batch row); two consumer warpgroups
// own 64 rows each and one producer warp streams K/V tiles of 64 keys by
// TMA (128-byte swizzle, mbarrier ring of 2-3 stages) while the
// consumers compute, so loads overlap compute. TMA, not cp.async: one
// thread issues a whole tile, the hardware zero-fills rows past S or T and
// columns past D (head_dim 8..56 runs as 64, 72..120 as 128), and a 4-D
// tensor map reads the model layout (B, S, H, D) through its strides (a
// multiple of 16 bytes for any head_dim that is a multiple of 8; the
// wrapper refuses other strides). S = Q K^T is a wgmma m64n64k16 with
// both operands K-major in shared memory; the online softmax runs on the
// fp32 accumulator fragment (row max and sum over the 4 lanes that share
// a row); P is fed as the register A operand of O += P V (wgmma
// m64nDk16, V MN-major with the transpose bit) in two parts of the input
// dtype, hi = P rounded and lo = P - hi, so P keeps ~16 of fp32's 24
// mantissa bits for twice the P.V products. Rounding P once, as
// repro.models.layers.blockwise_attention does, moved the 4-layer
// gradient check of chip_smoke.py to 0.023 (limit 0.02; 0.013 with
// scores computed exactly): see PERF.md. Tiles past the causal diagonal
// or before the window are skipped; only a tile that straddles an edge
// is masked. lse is m + log l of the fp32 scores, what the backward
// reads.
//
// float32: the CUDA-core kernel (wgmma in fp32 would be TF32 and break
// the fp32 tolerances). One block per (q tile of 16 rows, q head, batch
// row); a loop over kv tiles of 32 keys takes the place of the TPU
// kernel's sequential kv grid axis, and the running max, sum and output
// live in registers across it. K and V tiles are staged through shared memory as fp32 and
// shared by the block's 4 warps; each warp owns 4 query rows. For one row
// a lane scores one key of the tile (a D-long dot product against the
// padded K row, conflict-free), the warp reduces the tile max and sum with
// shuffles, and for P.V each lane owns D/32 output columns. The kernel
// computes its own GQA kv head (h / rep) and every offset from the strides
// it is given, so the wrapper passes model-layout (B, S, H, D) tensors as
// strided (B, H, S, D) views without copying. Ragged lengths (S or T not a
// multiple of the tile) are masked in both the q and the kv tile; kv tiles
// past the causal diagonal or before the window are skipped. It does its
// work in fp32 on the CUDA cores and is bound by operations.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

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
                 float* __restrict__ lse, int causal, int window,
                 float scale) {
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
    // lse (B, Hq, S) fp32, contiguous: what the backward recomputes P from
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * S + qi] =
          m[rr] + logf(denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int T_len, int D,
           const long long* qs, const long long* ks, const long long* vs,
           const long long* os, float* lse, int causal, int window,
           float scale, void* stream) {
  dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T><<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, D, Hq / Hkv,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      os[0], os[1], os[2], lse, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward (training): the counterpart of repro.models.layers._bw_attn_bwd.
// P is recomputed from q, k and the forward's lse; delta = rowsum(dO * out).
// The float32 kernels (bf16/fp16 run the tensor-core pair, namespace tc).
// Two passes, both deterministic (no atomics):
//   dq   — one block per (q tile of 16 rows, q head, batch row), as the
//          forward: warp w owns 4 rows, a lane scores one key of each
//          32-key tile (s and dP), and owns D/32 columns of dq. It also
//          writes delta for the second pass.
//   dk,dv — one block per (kv tile of 32 keys, kv head, batch row): warp w
//          owns 8 keys (D/32 columns each of dk and dv in registers), a
//          lane is one query row of each 32-row q tile (it scores all 8
//          keys; the rows' p and dS then reach every lane by shuffles),
//          and the block sums the rep = Hq / Hkv query heads of its kv
//          head itself.
// Tiles live in dynamic shared memory sized to D (above 48 KB at D = 128).
// What bounds it: at training shapes (B = 16, S = 128, D = 64) the bytes
// (q, k, v, out, dO in; dq, dk, dv out) are ~42 MB against ~2.7 GFLOP of
// work, so bytes bound the card; in fp32 on the CUDA cores (wgmma in fp32
// would be TF32) these kernels are bound by operations well above that.
// ---------------------------------------------------------------------------

struct Str {
  long long b, h, s;
};

constexpr int kKeysPerWarp = kBlockK / kWarps;
constexpr int kRowsKV = 32;        // q rows per tile in the dk/dv pass

template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int S, int T_len, int D, int rep,
                    Str qs, Str ks, Str vs, Str os, Str dos, Str dqs,
                    int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                         // [kBlockQ][D]
  float* do_s = q_s + kBlockQ * D;           // [kBlockQ][D]
  float* k_s = do_s + kBlockQ * D;           // [kBlockK][D + 1]
  float* v_s = k_s + kBlockK * (D + 1);      // [kBlockK][D + 1]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * S;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* ob = o + b * os.b + h * os.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* dqb = dq + b * dqs.b + h * dqs.h;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    q_s[i] = qi < S ? to_f(qb[qi * qs.s + d]) : 0.f;
    do_s[i] = qi < S ? to_f(dob[qi * dos.s + d]) : 0.f;
  }
  __syncthreads();

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
  float acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int qi = q0 + r;
    float dsum = 0.f;
    if (qi < S)
      for (int d = lane; d < D; d += 32)
        dsum = fmaf(do_s[r * D + d], to_f(ob[qi * os.s + d]), dsum);
    dsum = warp_sum(dsum);
    delta_r[rr] = dsum;
    lse_r[rr] = qi < S ? lse[row0 + qi] : 0.f;
    if (qi < S && lane == 0) delta[row0 + qi] = dsum;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

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
      k_s[j * (D + 1) + d] = in ? to_f(kb[kj * ks.s + d]) : 0.f;
      v_s[j * (D + 1) + d] = in ? to_f(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    const int kj = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi >= S) continue;            // warp-uniform
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[r * D + d], k_s[lane * (D + 1) + d], s);
        dp = fmaf(do_s[r * D + d], v_s[lane * (D + 1) + d], dp);
      }
      bool valid = kj < T_len;
      if (causal) valid = valid && kj <= qi;
      if (window > 0) valid = valid && kj > qi - window;
      const float p = valid ? expf(s * scale - lse_r[rr]) : 0.f;
      const float ds = p * (dp - delta_r[rr]);
      for (int j = 0; j < kBlockK; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[rr][c] = fmaf(dsj, k_s[j * (D + 1) + d], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqb[qi * dqs.s + d] = from_f<T>(acc[rr][c] * scale);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int T_len, int D, int rep,
                      Str qs, Str ks, Str vs, Str dos, Str dks, Str dvs,
                      int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kRowsKV][D + 1]
  float* do_s = q_s + kRowsKV * (D + 1);      // [kRowsKV][D + 1]
  float* k_s = do_s + kRowsKV * (D + 1);      // [kBlockK][D]
  float* v_s = k_s + kBlockK * D;             // [kBlockK][D]
  float* lse_s = v_s + kBlockK * D;           // [kRowsKV]
  float* delta_s = lse_s + kRowsKV;           // [kRowsKV]

  const int k0 = blockIdx.x * kBlockK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = gridDim.y * rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < kBlockK * D; i += blockDim.x) {
    const int j = i / D, d = i - j * D;
    const int kj = k0 + j;
    const bool in = kj < T_len;
    k_s[i] = in ? to_f(kb[kj * ks.s + d]) : 0.f;
    v_s[i] = in ? to_f(vb[kj * vs.s + d]) : 0.f;
  }

  float adk[kKeysPerWarp][NC], adv[kKeysPerWarp][NC];
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[jj][c] = adv[jj][c] = 0.f;

  // q rows that can see this kv tile: [q_lo, q_hi)
  const int k_last = min(k0 + kBlockK, T_len) - 1;
  const int q_lo = causal ? (k0 / kRowsKV) * kRowsKV : 0;
  int q_hi = S;
  if (window > 0) q_hi = min(S, k_last + window);

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long row0 = (static_cast<long long>(b) * Hq + h) * S;
    for (int qt = q_lo; qt < q_hi; qt += kRowsKV) {
      __syncthreads();   // previous q tile fully consumed
      for (int i = tid; i < kRowsKV * D; i += blockDim.x) {
        const int rr = i / D, d = i - rr * D;
        const int qi = qt + rr;
        q_s[rr * (D + 1) + d] = qi < S ? to_f(qb[qi * qs.s + d]) : 0.f;
        do_s[rr * (D + 1) + d] = qi < S ? to_f(dob[qi * dos.s + d]) : 0.f;
      }
      if (tid < kRowsKV) {
        const int qi = qt + tid;
        lse_s[tid] = qi < S ? lse[row0 + qi] : 0.f;
        delta_s[tid] = qi < S ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();

      // s and dP of this lane's query row against the warp's 8 keys
      const int qi = qt + lane;
      float s_r[kKeysPerWarp], dp_r[kKeysPerWarp];
#pragma unroll
      for (int jj = 0; jj < kKeysPerWarp; ++jj) s_r[jj] = dp_r[jj] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qd = q_s[lane * (D + 1) + d];
        const float od = do_s[lane * (D + 1) + d];
#pragma unroll
        for (int jj = 0; jj < kKeysPerWarp; ++jj) {
          const int j = warp * kKeysPerWarp + jj;     // warp-uniform
          s_r[jj] = fmaf(qd, k_s[j * D + d], s_r[jj]);
          dp_r[jj] = fmaf(od, v_s[j * D + d], dp_r[jj]);
        }
      }
      float p_r[kKeysPerWarp], ds_r[kKeysPerWarp];
#pragma unroll
      for (int jj = 0; jj < kKeysPerWarp; ++jj) {
        const int kj = k0 + warp * kKeysPerWarp + jj;
        bool valid = qi < S && kj < T_len;
        if (causal) valid = valid && kj <= qi;
        if (window > 0) valid = valid && kj > qi - window;
        p_r[jj] = valid ? expf(s_r[jj] * scale - lse_s[lane]) : 0.f;
        ds_r[jj] = p_r[jj] * (dp_r[jj] - delta_s[lane]);
      }
      // dv[j] += sum_i p_ij dO_i, dk[j] += sum_i ds_ij q_i: each row's
      // dO and q columns are read once for all 8 keys
#pragma unroll 2
      for (int i = 0; i < kRowsKV; ++i) {
        float od[NC], qv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          od[c] = d < D ? do_s[i * (D + 1) + d] : 0.f;
          qv[c] = d < D ? q_s[i * (D + 1) + d] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kKeysPerWarp; ++jj) {
          const float pi = __shfl_sync(0xffffffffu, p_r[jj], i);
          const float dsi = __shfl_sync(0xffffffffu, ds_r[jj], i);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[jj][c] = fmaf(pi, od[c], adv[jj][c]);
            adk[jj][c] = fmaf(dsi, qv[c], adk[jj][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int jj = 0; jj < kKeysPerWarp; ++jj) {
    const int kj = k0 + warp * kKeysPerWarp + jj;
    if (kj >= T_len) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkb[kj * dks.s + d] = from_f<T>(adk[jj][c] * scale);
        dvb[kj * dvs.s + d] = from_f<T>(adv[jj][c]);
      }
    }
  }
}

inline Str str3(const long long* p) { return Str{p[0], p[1], p[2]}; }

template <typename T, int NC>
int launch_bwd_nc(const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                  int Hkv, int S, int T_len, int D, const long long* const* st,
                  int causal, int window, float scale, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const int dq_smem = static_cast<int>(
      sizeof(float) * (2 * kBlockQ * D + 2 * kBlockK * (D + 1)));
  const int kv_smem = static_cast<int>(
      sizeof(float) * (2 * kRowsKV * (D + 1) + 2 * kBlockK * D + 2 * kRowsKV));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // st: q, k, v, o, dO, dq, dk, dv strides (three each)
  flash_bwd_dq_kernel<T, NC>
      <<<dim3((S + kBlockQ - 1) / kBlockQ, Hq, B), kWarps * 32, dq_smem,
         stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(o),
          static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S,
          T_len, D, rep, str3(st[0]), str3(st[1]), str3(st[2]), str3(st[3]),
          str3(st[4]), str3(st[5]), causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, NC>
      <<<dim3((T_len + kBlockK - 1) / kBlockK, Hkv, B), kWarps * 32,
         kv_smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), S, T_len, D, rep,
          str3(st[0]), str3(st[1]), str3(st[2]), str3(st[4]), str3(st[6]),
          str3(st[7]), causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int S, int T_len,
               int D, const long long* const* st, int causal, int window,
               float scale, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1:
      return launch_bwd_nc<T, 1>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, S, T_len, D, st, causal, window,
                                 scale, stream);
    case 2:
      return launch_bwd_nc<T, 2>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, S, T_len, D, st, causal, window,
                                 scale, stream);
    case 3:
      return launch_bwd_nc<T, 3>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, S, T_len, D, st, causal, window,
                                 scale, stream);
    case 4:
      return launch_bwd_nc<T, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                 Hq, Hkv, S, T_len, D, st, causal, window,
                                 scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// Forward on the tensor cores (bf16 and fp16 inputs; see the note at the
// top of the file). One block per (128 query rows, q head, batch row):
// two consumer warpgroups own 64 query rows each, and one producer warp
// keeps K/V tiles of 64 keys in flight by TMA in a ring of kStages
// stages (mbarriers "full" and "empty" per stage). Both consumers see the
// same K/V tiles (one head); a consumer skips, but still releases, a
// tile its own rows cannot see.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kRows = 64;                  // query rows of a warpgroup
constexpr int kKeys = 64;                  // keys of a kv tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers + 32;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
__host__ __device__ constexpr int stages() { return DP == 64 ? 3 : 2; }
template <int DP>
__host__ __device__ constexpr int tile_bytes() { return kRows * DP * 2; }
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + (kConsumers + 2 * stages<DP>()) * tile_bytes<DP>() +
         8 * (2 * stages<DP>() + 1);
}

// A map's dims are (D, then the head, sequence and batch axes ordered by
// stride); perm holds the position (1..3) of the head axis in bits 0-1,
// of the sequence axis in bits 2-3 (the batch axis takes the third).
__device__ __forceinline__ void coords(int perm, int h, int s, int b,
                                       int& c1, int& c2, int& c3) {
  const int ph = perm & 3, ps = (perm >> 2) & 3;
  c1 = ph == 1 ? h : ps == 1 ? s : b;
  c2 = ph == 2 ? h : ps == 2 ? s : b;
  c3 = ph == 3 ? h : ps == 3 ? s : b;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, int qperm,
                    int kperm, int vperm, T* __restrict__ o, long long o_sb,
                    long long o_sh, long long o_ss, int S, int T_len, int D,
                    int rep, float* __restrict__ lse, int causal, int window,
                    float scale_log2) {
  constexpr int ST = stages<DP>();
  constexpr int TB = tile_bytes<DP>();
  constexpr int kAtoms = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + kConsumers * TB;
  unsigned char* v_s = k_s + ST * TB;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + ST * TB);
  uint64_t* empty = full + ST;
  uint64_t* q_full = empty + ST;

  const int q_blk = blockIdx.x * (kRows * kConsumers);
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // kv tiles some row of the block can see: [t_first, t_end)
  const int blk_last = min(q_blk + kRows * kConsumers, S) - 1;
  const int k_hi = causal ? min(T_len, blk_last + 1) : T_len;
  const int k_lo = window > 0 ? max(0, q_blk - window + 1) : 0;
  const int t_first = k_lo / kKeys;
  const int t_end = (k_hi + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);    // one arrival a warp
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {            // producer
    if (lane == 0) {
      int c1, c2, c3;
      mbar_expect_tx(q_full, kConsumers * TB);
      for (int g = 0; g < kConsumers; ++g) {
        coords(qperm, h, q_blk + kRows * g, b, c1, c2, c3);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(q_s + g * TB + a * kAtomBytes, &qmap, q_full, 64 * a,
                      c1, c2, c3);
      }
      int stage = 0, phase = 0;
      for (int t = t_first; t < t_end; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * TB);
        coords(kperm, hk, t * kKeys, b, c1, c2, c3);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(k_s + stage * TB + a * kAtomBytes, &kmap, &full[stage],
                      64 * a, c1, c2, c3);
        coords(vperm, hk, t * kKeys, b, c1, c2, c3);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(v_s + stage * TB + a * kAtomBytes, &vmap, &full[stage],
                      64 * a, c1, c2, c3);
        if (++stage == ST) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows [q0, q0 + 64); this thread rows r0, r1
  const int g = warp >> 2, w = warp & 3;
  const int q0 = q_blk + kRows * g;
  const int r0 = q0 + 16 * w + (lane >> 2), r1 = r0 + 8;
  const bool active = q0 < S;
  const int g_last = min(q0 + kRows, S) - 1;
  const int my_hi = causal ? min(T_len, g_last + 1) : T_len;
  const int my_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint32_t q_addr = smem_u32(q_s + g * TB);
  mbar_wait(q_full, 0);

  int stage = 0, phase = 0;
  for (int t = t_first; t < t_end; ++t) {
    mbar_wait(&full[stage], phase);
    const int k0 = t * kKeys;
    if (active && k0 < my_hi && k0 + kKeys > my_lo) {
      const uint32_t k_addr = smem_u32(k_s + stage * TB);
      const uint32_t v_addr = smem_u32(v_s + stage * TB);
      // S = Q K^T: both K-major, D along the swizzled rows
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t off = (ks / 4) * kAtomBytes + (ks % 4) * 32;
        wgmma_ss_n64<T, 0, 0>(s, make_desc(q_addr + off, 16),
                              make_desc(k_addr + off, 16), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scores in log2 units; mask only a tile that straddles an edge
      const bool edge = k0 + kKeys > T_len ||
                        (causal && k0 + kKeys - 1 > q0) ||
                        (window > 0 && k0 <= g_last - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale_log2;
        if (edge) {
          const int kj = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int qi = (i & 2) ? r1 : r0;
          const bool valid = (!causal || kj <= qi) &&
                             (window <= 0 || kj > qi - window);
          x = kj >= T_len ? -INFINITY : (valid ? x : kNegInf);
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] - ((i & 2) ? mn1 : mn0));
        s[i] = p;
        if (i & 2) ps1 += p; else ps0 += p;
      }
      l0 = l0 * al0 + ps0;          // this thread's share; summed at the end
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;
      // O += P V with P as the register A operand in two parts of the
      // input dtype, hi = P rounded and lo = P - hi, so P keeps ~16
      // mantissa bits (V is MN-major: D contiguous, one atom per 64
      // columns)
      uint32_t pa[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
          pa[kk][j] = pack2<T>(x0, x1);
          const float2 hi = unpack2<T>(pa[kk][j]);
          pl[kk][j] = pack2<T>(x0 - hi.x, x1 - hi.y);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = make_desc(v_addr + kk * 2048, kAtomBytes);
        if constexpr (DP == 64) {
          wgmma_rs_n64<T, 1>(acc, pa[kk], dv, 1);
          wgmma_rs_n64<T, 1>(acc, pl[kk], dv, 1);
        } else {
          wgmma_rs_n128<T, 1>(acc, pa[kk], dv, 1);
          wgmma_rs_n128<T, 1>(acc, pl[kk], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      fence_regs(pl);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with it
    if (++stage == ST) { stage = 0; phase ^= 1; }
  }
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  const float inv0 = 1.f / d0, inv1 = 1.f / d1;
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    if (col >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
          pack2<T>(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
          pack2<T>(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * S;
    if (r0 < S) lse[row0 + r0] = (m0 + log2f(d0)) * kLn2;
    if (r1 < S) lse[row0 + r1] = (m1 + log2f(d1)) * kLn2;
  }
}

// Tensor map of one (B, H, S, D) operand with element strides st (batch,
// head, sequence; D contiguous) and a box of 64 rows x 64 columns.
// Size-1 axes get a harmless stride. Returns 0, or non-zero where the
// encoder refuses strides or an address that are not 16-byte multiples.
template <typename T>
int make_map(CUtensorMap* map, int* perm, const void* ptr, int D, int H,
             int S, int B, const long long* st) {
  const long long size[3] = {H, S, B};          // head, seq, batch
  long long stride[3] = {st[1], st[2], st[0]};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = 0;            // any stride will do
  for (int i = 1; i < 3; ++i)                   // sort axes by stride
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  uint64_t dims[4] = {static_cast<uint64_t>(D)}, strides[3];
  uint32_t box[4] = {64, 1, 1, 1};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    const int ax = order[i];
    dims[i + 1] = static_cast<uint64_t>(size[ax]);
    strides[i] = static_cast<uint64_t>(2 * (stride[ax] == 0 ? D : stride[ax]));
    if (ax == 1) box[i + 1] = 64;
    if (ax == 0) *perm |= i + 1;
    if (ax == 1) *perm |= (i + 1) << 2;
  }
  return hopper_host::encode(map, std::is_same<T, __nv_bfloat16>::value, 4,
                             ptr, dims, strides, box);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int T_len, int D, const long long* qs,
           const long long* ks, const long long* vs, const long long* os,
           float* lse, int causal, int window, float scale,
           cudaStream_t stream) {
  if (hopper_host::encode_fn() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  int qp, kp, vp;
  // out is written in pairs of 16-bit values: 4-byte aligned
  bool ok = reinterpret_cast<uintptr_t>(o) % 4 == 0 &&
            os[0] % 2 == 0 && os[1] % 2 == 0 && os[2] % 2 == 0;
  ok = ok && make_map<T>(&qm, &qp, q, D, Hq, S, B, qs) == 0 &&
       make_map<T>(&km, &kp, k, D, Hkv, T_len, B, ks) == 0 &&
       make_map<T>(&vm, &vp, v, D, Hkv, T_len, B, vs) == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidPitchValue);
  constexpr int smem = smem_bytes<DP>();
  static bool sized = false;            // once per kernel and process
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  dim3 grid((S + kRows * kConsumers - 1) / (kRows * kConsumers), Hq, B);
  flash_fwd_tc_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, qp, kp, vp, static_cast<T*>(o), os[0], os[1], os[2], S,
      T_len, D, Hq / Hkv, lse, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward on the tensor cores (bf16 and fp16 inputs). Two passes, both
// deterministic (no atomics), one kernel body (bwd_body) in two modes:
//   dq   — block (128 query rows, q head, batch row). Own tiles X = Q and
//          Y = dO of each consumer's 64 rows; streamed U = K, W = V over
//          the kv tiles the rows can see. It also writes
//          delta = rowsum(dO * O) for the second pass.
//   dk,dv — block (128 keys, kv head, batch row). Own X = K, Y = V;
//          streamed U = Q, W = dO over the q tiles of all rep q heads of
//          the kv head, so the GQA sum stays in registers.
// Per streamed tile, a consumer warpgroup computes
//   S = X U^T and dP = Y W^T     (wgmma m64n64k16, both K-major),
//   P = exp(S scale - lse), dS = P (dP - delta)   (fp32 fragments; lse and
//          delta are per row in the dq pass, per column in the dk/dv pass),
//   dq:   dQ += dS U             (register A, U = K MN-major),
//   dk,dv: dV += P W, dK += dS U (register A, W = dO and U = Q MN-major),
// with P and dS fed to the tensor cores in two parts of the input dtype
// (hi = rounded, lo = the remainder), as the forward feeds P: rounding
// them once moved chip_smoke.py's gradient check towards its limit (see
// PERF.md and tools/grad_conditioning.py). The producer warp streams U
// and W by TMA through an mbarrier ring, as in the forward; tiles past
// the causal diagonal or before the window are skipped, and only tiles
// that straddle an edge are masked. In the dk/dv pass the producer warp
// also stages the streamed q rows' lse and delta in shared memory beside
// each tile, once for both consumers, instead of 16 columns' worth of
// global loads by every consumer thread. What bounds it: at the training shape
// (B = 16, S = 128, Hq = 32, Hkv = 8, D = 64) the bytes are ~42 MB and the
// work ~2.7 GFLOP, so bytes bound the card (0.013 ms).
// ---------------------------------------------------------------------------

struct BwdParams {
  int xperm, yperm, uperm, wperm;   // the four maps' axis orders (coords)
  const void* o;                    // dq pass: O and dO for delta
  const void* dout;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  const float* lse;                 // (B, Hq, S) fp32
  float* delta;                     // (B, Hq, S) fp32: dq pass writes it
  void* g0;                         // dQ (dq pass) or dK (dk/dv pass)
  long long g0_sb, g0_sh, g0_ss;
  void* g1;                         // dV (dk/dv pass)
  long long g1_sb, g1_sh, g1_ss;
  int S, T_len, D, rep, Hq, causal, window;
  float scale, scale_log2;
};

// Shared memory of a backward block: own X, Y tiles of both consumers,
// the ring's U, W tiles, its barriers, and per stage the streamed q
// rows' lse and delta (dk/dv pass).
template <int DP>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 1024 + (2 * kConsumers + 2 * stages<DP>()) * tile_bytes<DP>() +
         8 * (2 * stages<DP>() + 1) + 2 * stages<DP>() * kKeys * 4;
}

// acc (64 x DP) += A (64 x 16, registers) . B (16 x DP, MN-major smem)
template <typename T, int DP>
__device__ __forceinline__ void mma_rs(float (&acc)[DP / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64<T, 1>(acc, a, db, 1);
  else wgmma_rs_n128<T, 1>(acc, a, db, 1);
}

// A 64 x 64 fp32 fragment as the register A operand of four k16 steps, in
// two parts of the input dtype: hi = x rounded, lo = x - hi rounded.
template <typename T>
__device__ __forceinline__ void split2(const float (&x)[32],
                                       uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = x[8 * kk + 2 * j], x1 = x[8 * kk + 2 * j + 1];
      hi[kk][j] = pack2<T>(x0, x1);
      const float2 h = unpack2<T>(hi[kk][j]);
      lo[kk][j] = pack2<T>(x0 - h.x, x1 - h.y);
    }
}

// Rows ra and rb (< n) of a 64 x DP fp32 fragment, times `scale`, into
// out (row stride ss), columns below D, in pairs of 16-bit values.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           float scale, T* out, long long ss,
                                           int ra, int rb, int n, int D,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    if (col >= D) continue;
    if (ra < n)
      *reinterpret_cast<uint32_t*>(out + ra * ss + col) =
          pack2<T>(acc[4 * c] * scale, acc[4 * c + 1] * scale);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(out + rb * ss + col) =
          pack2<T>(acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
  }
}

template <typename T, int DP, bool KV>
__device__ __forceinline__ void bwd_body(const CUtensorMap* xmap,
                                         const CUtensorMap* ymap,
                                         const CUtensorMap* umap,
                                         const CUtensorMap* wmap,
                                         const BwdParams& p) {
  constexpr int ST = stages<DP>();
  constexpr int TB = tile_bytes<DP>();
  constexpr int kAtoms = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* x_s = smem;
  unsigned char* y_s = x_s + kConsumers * TB;
  unsigned char* u_s = y_s + kConsumers * TB;
  unsigned char* w_s = u_s + ST * TB;
  uint64_t* full = reinterpret_cast<uint64_t*>(w_s + ST * TB);
  uint64_t* empty = full + ST;
  uint64_t* own_full = empty + ST;
  float* lse_s = reinterpret_cast<float*>(own_full + 1);   // [ST][kKeys]
  float* del_s = lse_s + ST * kKeys;                       // [ST][kKeys]

  const int S = p.S, T_len = p.T_len, causal = p.causal, window = p.window;
  const int blk = blockIdx.x * (kRows * kConsumers);   // first own row
  const int hb = blockIdx.y, b = blockIdx.z;   // q head (dq), kv head (kv)
  const int n_own = KV ? T_len : S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // streamed tiles of 64: dq — kv tiles [s_first, s_end); dk/dv — for
  // each of the rep q heads, q tiles [s_first, s_end)
  const int blk_last = min(blk + kRows * kConsumers, n_own) - 1;
  int lo, hi;
  if (KV) {
    lo = causal ? blk : 0;
    hi = window > 0 ? min(S, blk_last + window) : S;
  } else {
    lo = window > 0 ? max(0, blk - window + 1) : 0;
    hi = causal ? min(T_len, blk_last + 1) : T_len;
  }
  const int s_first = lo / kKeys;
  const int per_head = max(0, (hi + kKeys - 1) / kKeys - s_first);
  const int n_stream = KV ? p.rep * per_head : per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      // dk/dv pass: the TMA's arrival and one a producer lane (lse, delta)
      mbar_init(&full[s], KV ? 1 + 32 : 1);
      mbar_init(&empty[s], 4 * kConsumers);    // one arrival a warp
    }
    mbar_init(own_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {            // producer
    int c1, c2, c3;
    if (lane == 0) {
      mbar_expect_tx(own_full, 2 * kConsumers * TB);
      for (int g = 0; g < kConsumers; ++g) {
        coords(p.xperm, hb, blk + kRows * g, b, c1, c2, c3);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(x_s + g * TB + a * kAtomBytes, xmap, own_full, 64 * a,
                      c1, c2, c3);
        coords(p.yperm, hb, blk + kRows * g, b, c1, c2, c3);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(y_s + g * TB + a * kAtomBytes, ymap, own_full, 64 * a,
                      c1, c2, c3);
      }
    }
    if (!KV && lane != 0) return;
    // the ring: lane 0 issues the tiles; in the dk/dv pass every lane
    // also stages two of the tile's q rows' lse (log2 units) and delta
    int stage = 0, phase = 0;
    for (int i = 0; i < n_stream; ++i) {
      const int head = KV ? hb * p.rep + i / per_head : hb / p.rep;
      const int pos = kKeys * (s_first + (KV ? i % per_head : i));
      mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[stage], 2 * TB);
        coords(p.uperm, head, pos, b, c1, c2, c3);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(u_s + stage * TB + a * kAtomBytes, umap, &full[stage],
                      64 * a, c1, c2, c3);
        coords(p.wperm, head, pos, b, c1, c2, c3);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(w_s + stage * TB + a * kAtomBytes, wmap, &full[stage],
                      64 * a, c1, c2, c3);
      }
      if constexpr (KV) {
        const long long row0 = (static_cast<long long>(b) * p.Hq + head) * S;
        for (int j = lane; j < kKeys; j += 32) {
          const int qi = pos + j;
          lse_s[stage * kKeys + j] = qi < S ? p.lse[row0 + qi] * kLog2e : 0.f;
          del_s[stage * kKeys + j] = qi < S ? p.delta[row0 + qi] : 0.f;
        }
        mbar_arrive(&full[stage]);     // release: the stores above
      }
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // consumers: warpgroup g owns rows [r_first, r_first + 64) (queries in
  // the dq pass, keys in the dk/dv pass); this thread rows ra, rb
  const int g = warp >> 2, w = warp & 3;
  const int r_first = blk + kRows * g;
  const int ra = r_first + 16 * w + (lane >> 2), rb = ra + 8;
  const bool active = r_first < n_own;

  // dq pass: lse (log2 units) and delta of the thread's two rows
  float lse_a = 0.f, lse_b = 0.f, del_a = 0.f, del_b = 0.f;
  if (!KV && active) {
    const long long row0 = (static_cast<long long>(b) * p.Hq + hb) * S;
    const T* ob = static_cast<const T*>(p.o) + b * p.o_sb + hb * p.o_sh;
    const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + hb * p.do_sh;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * (lane & 3);
      if (col >= p.D) continue;
      if (ra < S) {
        const float2 x = unpack2<T>(
            *reinterpret_cast<const uint32_t*>(ob + ra * p.o_ss + col));
        const float2 y = unpack2<T>(
            *reinterpret_cast<const uint32_t*>(dob + ra * p.do_ss + col));
        del_a = fmaf(x.x, y.x, fmaf(x.y, y.y, del_a));
      }
      if (rb < S) {
        const float2 x = unpack2<T>(
            *reinterpret_cast<const uint32_t*>(ob + rb * p.o_ss + col));
        const float2 y = unpack2<T>(
            *reinterpret_cast<const uint32_t*>(dob + rb * p.do_ss + col));
        del_b = fmaf(x.x, y.x, fmaf(x.y, y.y, del_b));
      }
    }
    del_a += __shfl_xor_sync(0xffffffffu, del_a, 1);
    del_a += __shfl_xor_sync(0xffffffffu, del_a, 2);
    del_b += __shfl_xor_sync(0xffffffffu, del_b, 1);
    del_b += __shfl_xor_sync(0xffffffffu, del_b, 2);
    if (ra < S) lse_a = p.lse[row0 + ra] * kLog2e;
    if (rb < S) lse_b = p.lse[row0 + rb] * kLog2e;
    if ((lane & 3) == 0) {
      if (ra < S) p.delta[row0 + ra] = del_a;
      if (rb < S) p.delta[row0 + rb] = del_b;
    }
  }

  float acc0[DP / 2], acc1[KV ? DP / 2 : 1];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (KV ? DP / 2 : 1); ++i) acc1[i] = 0.f;
  const uint32_t x_addr = smem_u32(x_s + g * TB);
  const uint32_t y_addr = smem_u32(y_s + g * TB);
  mbar_wait(own_full, 0);

  int stage = 0, phase = 0;
  for (int i = 0; i < n_stream; ++i) {
    const int c0 = kKeys * (s_first + (KV ? i % per_head : i));
    const int q_lo = KV ? c0 : r_first, k_lo = KV ? r_first : c0;
    mbar_wait(&full[stage], phase);
    if (active && (!causal || k_lo <= q_lo + kKeys - 1) &&
        (window <= 0 || k_lo + kKeys - 1 > q_lo - window)) {
      const uint32_t u_addr = smem_u32(u_s + stage * TB);
      const uint32_t w_addr = smem_u32(w_s + stage * TB);
      // S = X U^T and dP = Y W^T: all K-major, D along the swizzled rows
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t off = (ks / 4) * kAtomBytes + (ks % 4) * 32;
        wgmma_ss_n64<T, 0, 0>(s, make_desc(x_addr + off, 16),
                              make_desc(u_addr + off, 16), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t off = (ks / 4) * kAtomBytes + (ks % 4) * 32;
        wgmma_ss_n64<T, 0, 0>(dp, make_desc(y_addr + off, 16),
                              make_desc(w_addr + off, 16), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P and dS on the fragments (register j: row ra or rb by j & 2,
      // column c0 + 8(j / 4) + 2(lane % 4) + j % 2); mask only a tile that
      // straddles an edge
      const bool edge = k_lo + kKeys > T_len || q_lo + kKeys > S ||
                        (causal && k_lo + kKeys - 1 > q_lo) ||
                        (window > 0 && k_lo <= q_lo + kKeys - 1 - window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int row = (j & 2) ? rb : ra;
        const int col = c0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        float l2, dl;
        if constexpr (KV) {             // the column's, staged by the producer
          l2 = lse_s[stage * kKeys + col - c0];
          dl = del_s[stage * kKeys + col - c0];
        } else {
          l2 = (j & 2) ? lse_b : lse_a;
          dl = (j & 2) ? del_b : del_a;
        }
        float pv = exp2f(s[j] * p.scale_log2 - l2);
        if (edge) {
          const int qi = KV ? col : row, kj = KV ? row : col;
          const bool valid = qi < S && kj < T_len &&
                             (!causal || kj <= qi) &&
                             (window <= 0 || kj > qi - window);
          if (!valid) pv = 0.f;
        }
        s[j] = pv;
        dp[j] = pv * (dp[j] - dl);
      }
      uint32_t dsh[4][4], dsl[4][4], ph[4][4], pl[4][4];
      split2<T>(dp, dsh, dsl);
      if constexpr (KV) split2<T>(s, ph, pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t du = make_desc(u_addr + kk * 2048, kAtomBytes);
        mma_rs<T, DP>(acc0, dsh[kk], du);
        mma_rs<T, DP>(acc0, dsl[kk], du);
        if constexpr (KV) {
          const uint64_t dw = make_desc(w_addr + kk * 2048, kAtomBytes);
          mma_rs<T, DP>(acc1, ph[kk], dw);
          mma_rs<T, DP>(acc1, pl[kk], dw);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(dsh);
      fence_regs(dsl);
      if constexpr (KV) {
        fence_regs(acc1);
        fence_regs(ph);
        fence_regs(pl);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with it
    if (++stage == ST) { stage = 0; phase ^= 1; }
  }
  if (!active) return;

  // dQ or dK (times the scale) and dV, in pairs of 16-bit values
  store_rows<T, DP>(acc0, p.scale, static_cast<T*>(p.g0) + b * p.g0_sb +
                    hb * p.g0_sh, p.g0_ss, ra, rb, n_own, p.D, lane);
  if constexpr (KV)
    store_rows<T, DP>(acc1, 1.f, static_cast<T*>(p.g1) + b * p.g1_sb +
                      hb * p.g1_sh, p.g1_ss, ra, rb, n_own, p.D, lane);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const BwdParams p) {
  bwd_body<T, DP, false>(&qmap, &domap, &kmap, &vmap, p);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const BwdParams p) {
  bwd_body<T, DP, true>(&kmap, &vmap, &qmap, &domap, p);
}

inline bool pairs_ok(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && st[0] % 2 == 0 &&
         st[1] % 2 == 0 && st[2] % 2 == 0;
}

template <typename T, int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int S, int T_len,
               int D, const long long* const* st, int causal, int window,
               float scale, cudaStream_t stream) {
  if (hopper_host::encode_fn() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  // st: q, k, v, o, dO, dq, dk, dv strides (three each). q, k, v and dO
  // are read by TMA; o is read and dq, dk, dv written in 4-byte pairs.
  CUtensorMap qm, km, vm, dom;
  BwdParams p{};
  bool ok = pairs_ok(o, st[3]) && pairs_ok(dq, st[5]) && pairs_ok(dk, st[6]) &&
            pairs_ok(dv, st[7]);
  ok = ok && make_map<T>(&qm, &p.xperm, q, D, Hq, S, B, st[0]) == 0 &&
       make_map<T>(&dom, &p.yperm, dout, D, Hq, S, B, st[4]) == 0 &&
       make_map<T>(&km, &p.uperm, k, D, Hkv, T_len, B, st[1]) == 0 &&
       make_map<T>(&vm, &p.wperm, v, D, Hkv, T_len, B, st[2]) == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidPitchValue);
  constexpr int smem = bwd_smem_bytes<DP>();
  static bool sized = false;            // once per kernel pair and process
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  p.o = o;
  p.dout = dout;
  p.o_sb = st[3][0]; p.o_sh = st[3][1]; p.o_ss = st[3][2];
  p.do_sb = st[4][0]; p.do_sh = st[4][1]; p.do_ss = st[4][2];
  p.lse = lse;
  p.delta = delta;
  p.S = S; p.T_len = T_len; p.D = D; p.rep = Hq / Hkv; p.Hq = Hq;
  p.causal = causal; p.window = window;
  p.scale = scale; p.scale_log2 = scale * kLog2e;
  // pass 1: dq (and delta); maps X = Q, Y = dO, U = K, W = V
  p.g0 = dq; p.g0_sb = st[5][0]; p.g0_sh = st[5][1]; p.g0_ss = st[5][2];
  p.g1 = nullptr;
  const int rows = kRows * kConsumers;
  flash_bwd_dq_tc_kernel<T, DP><<<dim3((S + rows - 1) / rows, Hq, B),
                                  kThreads, smem, stream>>>(qm, dom, km, vm,
                                                            p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // pass 2: dk, dv; maps X = K, Y = V, U = Q, W = dO
  const int qperm = p.xperm, doperm = p.yperm;
  p.xperm = p.uperm; p.yperm = p.wperm; p.uperm = qperm; p.wperm = doperm;
  p.g0 = dk; p.g0_sb = st[6][0]; p.g0_sh = st[6][1]; p.g0_ss = st[6][2];
  p.g1 = dv; p.g1_sb = st[7][0]; p.g1_sh = st[7][1]; p.g1_ss = st[7][2];
  flash_bwd_dkdv_tc_kernel<T, DP><<<dim3((T_len + rows - 1) / rows, Hkv,
                                         B), kThreads, smem, stream>>>(
      km, vm, qm, dom, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int B, int Hq, int Hkv, int S,
                  int T_len, int D, const long long* const* st, int causal,
                  int window, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, S, T_len, D, st, causal, window, scale,
                             stream);
  return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                            Hkv, S, T_len, D, st, causal, window, scale,
                            stream);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int S, int T_len, int D, const long long* qs,
               const long long* ks, const long long* vs, const long long* os,
               float* lse, int causal, int window, float scale,
               cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, T_len, D, qs, ks, vs, os,
                         lse, causal, window, scale, stream);
  return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, T_len, D, qs, ks, vs, os,
                        lse, causal, window, scale, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Strides are in elements, three
// per tensor (batch, head, sequence); the head_dim axis is contiguous.
// window <= 0 means no sliding window. lse, when not null, is a contiguous
// (B, Hq, S) fp32 output. Returns cudaGetLastError().
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int Hq, int Hkv,
                        int S, int T_len, int D, const long long* q_strides,
                        const long long* k_strides,
                        const long long* v_strides,
                        const long long* o_strides, float* lse, int causal,
                        int window, float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, B, Hq, Hkv, S, T_len, D, q_strides,
                           k_strides, v_strides, o_strides, lse, causal,
                           window, scale, stream);
    case 1:
      return tc::launch_fwd<__nv_bfloat16>(
          q, k, v, o, B, Hq, Hkv, S, T_len, D, q_strides, k_strides,
          v_strides, o_strides, lse, causal, window, scale,
          static_cast<cudaStream_t>(stream));
    case 2:
      return tc::launch_fwd<__half>(
          q, k, v, o, B, Hq, Hkv, S, T_len, D, q_strides, k_strides,
          v_strides, o_strides, lse, causal, window, scale,
          static_cast<cudaStream_t>(stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward. q, o, dO, dq (B, Hq, S, D) and k, v, dk, dv (B, Hkv, T, D),
// strided as in the forward (strides: q, k, v, o, dO, dq, dk, dv, three
// each). lse (B, Hq, S) fp32 from the forward; delta is (B, Hq, S) fp32
// scratch. Returns the first CUDA error, or 0.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* dout,
                        const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Hq, int Hkv, int S, int T_len,
                        int D, const long long* q_strides,
                        const long long* k_strides,
                        const long long* v_strides,
                        const long long* o_strides,
                        const long long* do_strides,
                        const long long* dq_strides,
                        const long long* dk_strides,
                        const long long* dv_strides, int causal, int window,
                        float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st[8] = {q_strides,  k_strides,  v_strides,
                            o_strides,  do_strides, dq_strides,
                            dk_strides, dv_strides};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               Hq, Hkv, S, T_len, D, st, causal, window,
                               scale, s);
    case 1:
      return tc::launch_bwd_tc<__nv_bfloat16>(q, k, v, o, dout, lse, delta,
                                              dq, dk, dv, B, Hq, Hkv, S,
                                              T_len, D, st, causal, window,
                                              scale, s);
    case 2:
      return tc::launch_bwd_tc<__half>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, Hq, Hkv, S, T_len, D, st,
                                       causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
