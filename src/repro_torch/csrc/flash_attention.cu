// Flash attention for Hopper (sm_90a): online-softmax attention, causal
// and/or sliding window, GQA-aware; forward (prefill and training, with an
// optional per-row logsumexp) and backward (training).
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
// work, so bytes bound the card; this first version recomputes in fp32 on
// the CUDA cores and is bound by operations well above that.
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
      return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T_len, D,
                                   q_strides, k_strides, v_strides,
                                   o_strides, lse, causal, window, scale,
                                   stream);
    case 2:
      return launch<__half>(q, k, v, o, B, Hq, Hkv, S, T_len, D, q_strides,
                            k_strides, v_strides, o_strides, lse, causal,
                            window, scale, stream);
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
      return launch_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, Hq, Hkv, S, T_len, D, st,
                                       causal, window, scale, s);
    case 2:
      return launch_bwd<__half>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Hq, Hkv, S, T_len, D, st, causal, window,
                                scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
