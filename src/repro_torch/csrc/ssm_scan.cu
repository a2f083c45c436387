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
// What bounds it. Per (b, t, d) it reads x (2 bytes in bf16) and dt (4)
// and writes y (4); per (b, t) the N values of B and C; h_last once. It
// evaluates B L D N exponentials, one MUFU.EX2 each at 16 a clock an SM.
// At the serving path's shapes (B in {1, 4}, L in {32, 100}, D = 8192,
// N = 16) that is 3.7-13 MB against 4-17 M exponentials: a few
// microseconds either way, so what bounds it there is latency and issue.
// The recurrence is sequential in t, and at B = 1 the only parallelism is
// the D N = 131072 (channel, state) pairs: 1024 warps at 4 states a lane,
// two a scheduler. Each step costs a warp its 4 states' exps (expf is 8
// instructions of each state's 14) and products, shared-memory reads,
// conversions and two shuffles, along a dependent chain. The first version gave one thread a
// channel (64 blocks at B = 1: half the SMs idle) and loaded dt and x from
// device memory inside the step loop, exposing a load latency at every
// step.
//
// Design.
// - A channel's N states are split across NT / 4 adjacent lanes, 4 states
//   a lane (NT: N rounded up to 8, 16, 32 or 64, a template parameter;
//   states past N have a = 0 and B = C = 0, so they stay 0). y_t is each
//   lane's sum of its 4 products in index order, then summed across the
//   lanes by xor shuffles (a pairwise tree): ssm_scan_plain sums in the
//   same order (sum_states). A block is 128 threads over 512 / NT channels
//   (32 at N = 16): B = 1, D = 8192 is 256 blocks on the 132 SMs.
// - Loads off the recurrence's path: chunks of kChunk time steps of x, dt,
//   B and C are staged in a ring of kStages shared-memory stages by
//   cp.async (16-byte copies where rows are 16-byte aligned, else 4-byte
//   copies, or plain loads for a 16-bit x), issued kStages - 1 chunks
//   ahead. A step reads only shared memory and registers.
// - Steps go in runs of kRun: the run's exps and (dt x) B first, then the
//   serial h updates, then the run's shuffle trees side by side, so the
//   latency of one step's chain overlaps the next one's.
// - y is staged a chunk at a time in shared memory and written with
//   16-byte stores along D; h_last is written once at the end.
// - exp and the products are the first version's: expf and unfused
//   __fmul_rn / __fadd_rn, as the plain version's separate elementwise
//   passes, so kernel and plain version agree bitwise where the device's
//   expf and torch.exp agree (SCAN_TOL, atol = rtol = 1e-5, is held).
// Any L and D are taken: the ragged last channel tile and chunk are
// masked.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;     // time steps a stage
constexpr int kStages = 3;     // chunks k + 1 and k + 2 load while k runs
constexpr int kPerLane = 4;    // states a lane owns
constexpr int kMaxN = 64;
// Time steps a run: a run's exps and inputs are computed before its
// serial h updates, and its shuffle trees side by side.
constexpr int kRun = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ __half zero<__half>() {
  return __float2half(0.f);
}

// Four consecutive values of a shared-memory row as fp32 (one 16- or
// 8-byte read).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[2 * i] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[i] & 0xffffu)));
    v[2 * i + 1] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[i] >> 16)));
  }
}

// One ring stage: kChunk time steps of a block's CW channels of x and dt,
// and of B and C (row stride NT; states past N zero).
template <typename T, int NT, int CW>
struct __align__(16) Stage {
  T x[kChunk][CW];
  float dt[kChunk][CW];
  T b[kChunk][NT];
  T c[kChunk][NT];
};

struct Flags {
  bool vec_xdt;   // x and dt rows 16-byte aligned: 16-byte copies
  bool vec_bc;    // N == NT and B, C rows 16-byte aligned
  bool vec_y;     // y rows 16-byte aligned: 16-byte stores
};

// Issue the copies of time steps t0 .. t0 + tn - 1 into `st`.
template <typename T, int NT, int CW>
__device__ __forceinline__ void load_chunk(
    Stage<T, NT, CW>& st, const T* __restrict__ x,
    const float* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, long long row, int t0, int tn, int d0, int D,
    int N, Flags f) {
  const int tid = threadIdx.x;
  if (f.vec_xdt) {
    constexpr int XV = 16 / sizeof(T);         // x values a 16-byte copy
    constexpr int XR = CW / XV;                // copies a row of x
    for (int i = tid; i < kChunk * XR; i += kThreads) {
      const int r = i / XR, d = d0 + (i % XR) * XV;
      if (r < tn && d < D)
        hopper::cp_async16(&st.x[r][d - d0], x + (row + t0 + r) * D + d);
    }
    constexpr int DR = CW / 4;                 // copies a row of dt
    for (int i = tid; i < kChunk * DR; i += kThreads) {
      const int r = i / DR, d = d0 + (i % DR) * 4;
      if (r < tn && d < D)
        hopper::cp_async16(&st.dt[r][d - d0], dt + (row + t0 + r) * D + d);
    }
  } else {
    for (int i = tid; i < kChunk * CW; i += kThreads) {
      const int r = i / CW, cc = i % CW;
      if (r < tn && d0 + cc < D) {
        const long long off = (row + t0 + r) * D + d0 + cc;
        hopper::cp_async4(&st.dt[r][cc], dt + off);
        if constexpr (sizeof(T) == 4)
          hopper::cp_async4(&st.x[r][cc], x + off);
        else
          st.x[r][cc] = x[off];
      }
    }
  }
  if (f.vec_bc) {
    constexpr int BV = 16 / sizeof(T);
    const long long off = (row + t0) * N;
    for (int i = tid; i < tn * NT / BV; i += kThreads) {
      hopper::cp_async16(&st.b[0][0] + i * BV, bm + off + i * BV);
      hopper::cp_async16(&st.c[0][0] + i * BV, cm + off + i * BV);
    }
  } else {
    for (int i = tid; i < kChunk * NT; i += kThreads) {
      const int r = i / NT, n = i % NT;
      if (r >= tn) continue;
      if (n < N) {
        const long long off = (row + t0 + r) * N + n;
        if constexpr (sizeof(T) == 4) {
          hopper::cp_async4(&st.b[r][n], bm + off);
          hopper::cp_async4(&st.c[r][n], cm + off);
        } else {
          st.b[r][n] = bm[off];
          st.c[r][n] = cm[off];
        }
      } else {
        st.b[r][n] = zero<T>();
        st.c[r][n] = zero<T>();
      }
    }
  }
}

// T: dtype of x, B and C (the model dtype); NT: state count rounded up,
// N the real one. Grid (ceil(D / CW), B).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ h_last, int L, int D, int N, Flags f) {
  constexpr int S = NT / kPerLane;     // lanes a channel
  constexpr int CW = kThreads / S;     // channels a block
  __shared__ Stage<T, NT, CW> ring[kStages];
  __shared__ __align__(16) float ys[kChunk][CW];

  const int tid = threadIdx.x;
  const int c = tid / S, s = tid % S;  // channel in the block, its lane
  const int d0 = blockIdx.x * CW;
  const int d = d0 + c;
  const bool live = d < D;
  const long long row = static_cast<long long>(blockIdx.y) * L;

  float h[kPerLane], av[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = s * kPerLane + j;
    h[j] = 0.f;
    av[j] = (live && n < N) ? a[static_cast<long long>(d) * N + n] : 0.f;
  }

  const int chunks = (L + kChunk - 1) / kChunk;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < chunks)
      load_chunk(ring[k], x, dt, bm, cm, row, k * kChunk,
                 min(kChunk, L - k * kChunk), d0, D, N, f);
    hopper::cp_async_commit();
  }

  for (int k = 0; k < chunks; ++k) {
    hopper::cp_async_wait<kStages - 2>();   // chunk k has landed
    __syncthreads();   // for every thread; chunk k - 1's stage is free
    const int kn = k + kStages - 1;
    if (kn < chunks)
      load_chunk(ring[kn % kStages], x, dt, bm, cm, row, kn * kChunk,
                 min(kChunk, L - kn * kChunk), d0, D, N, f);
    hopper::cp_async_commit();

    const Stage<T, NT, CW>& st = ring[k % kStages];
    const int t0 = k * kChunk;
    const int tn = min(kChunk, L - t0);
    // A run of R time steps in three phases: every step's a_bar and
    // (dt x) B first (they do not depend on h), then the serial updates of
    // h with each step's products with C, then the R shuffle trees side
    // by side. Only h carries from one step to the next.
    auto run = [&](int t, auto r_count) {
      constexpr int R = decltype(r_count)::value;
      float ab[R][kPerLane], u[R][kPerLane], cv[R][kPerLane], p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dtv = st.dt[t + r][c];
        const float dx = __fmul_rn(dtv, to_f(st.x[t + r][c]));
        float bv[kPerLane];
        load4(&st.b[t + r][s * kPerLane], bv);
        load4(&st.c[t + r][s * kPerLane], cv[r]);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          ab[r][j] = expf(__fmul_rn(dtv, av[j]));
          u[r][j] = __fmul_rn(dx, bv[j]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          // unfused, as the plain version's separate elementwise passes
          h[j] = __fadd_rn(__fmul_rn(ab[r][j], h[j]), u[r][j]);
          const float hc = __fmul_rn(h[j], cv[r][j]);
          p[r] = j == 0 ? hc : __fadd_rn(p[r], hc);
        }
      }
#pragma unroll
      for (int o = 1; o < S; o <<= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          p[r] = __fadd_rn(p[r], __shfl_xor_sync(0xffffffffu, p[r], o));
      if (s == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) ys[t + r][c] = p[r];
      }
    };
    int tt = 0;
#pragma unroll 1
    for (; tt + kRun <= tn; tt += kRun)
      run(tt, std::integral_constant<int, kRun>());
    for (; tt < tn; ++tt) run(tt, std::integral_constant<int, 1>());
    __syncthreads();
    if (f.vec_y) {
      constexpr int YR = CW / 4;
      for (int i = tid; i < tn * YR; i += kThreads) {
        const int r = i / YR, dd = d0 + (i % YR) * 4;
        if (dd < D)
          *reinterpret_cast<float4*>(y + (row + t0 + r) * D + dd) =
              *reinterpret_cast<const float4*>(&ys[r][dd - d0]);
      }
    } else {
      for (int i = tid; i < tn * CW; i += kThreads) {
        const int r = i / CW, cc = i % CW;
        if (d0 + cc < D) y[(row + t0 + r) * D + d0 + cc] = ys[r][cc];
      }
    }
  }
  hopper::cp_async_wait<0>();   // no copy outlives the block

  if (live) {
    float* hb = h_last + (static_cast<long long>(blockIdx.y) * D + d) * N;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int n = s * kPerLane + j;
      if (n < N) hb[n] = h[j];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int NT>
int launch_n(const void* x, const float* dt, const float* a, const void* bm,
             const void* cm, float* y, float* h_last, int B, int L, int D,
             int N, cudaStream_t stream) {
  constexpr int CW = kThreads / (NT / kPerLane);
  Flags f;
  f.vec_xdt = D % 8 == 0 && aligned16(x) && aligned16(dt);
  f.vec_bc = N == NT && (N * sizeof(T)) % 16 == 0 && aligned16(bm) &&
             aligned16(cm);
  f.vec_y = D % 4 == 0 && aligned16(y);
  dim3 grid((D + CW - 1) / CW, B);
  ssm_scan_kernel<T, NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, h_last, L, D, N, f);
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

// ---------------------------------------------------------------------------
// B4-bwd: the selective scan's backward. Replaces no TPU kernel: the TPU had
// no backward for B4, and repro differentiates its plain-JAX chunked scan
// (src/repro/models/layers.py _chunked_ssm_scan) with jax.grad. With g_t
// the adjoint of h_t (fp32 throughout):
//
//   g_{L-1} = dh_last + dy_{L-1} C_{L-1}
//   g_t     = dy_t C_t + exp(dt_{t+1} a) g_{t+1}
//   dx_t[d]  = dt_t[d] sum_n g_t[d,n] B_t[n]
//   ddt_t[d] = sum_n g_t[d,n] (x_t[d] B_t[n] + a[d,n] exp(dt_t[d] a[d,n])
//                              h_{t-1}[d,n])
//   dB_t[n]  = sum_d g_t[d,n] dt_t[d] x_t[d]
//   dC_t[n]  = sum_d dy_t[d] h_t[d,n]
//   da[d,n]  = sum_{b,t} g_t[d,n] dt_t[d] exp(dt_t[d] a[d,n]) h_{t-1}[d,n]
//
// What bounds it. Per (b, t, d) it reads x, dt and dy and writes dx and
// ddt; per (b, t) B, C, dB and dC; a and da once. At the training shapes
// (B 16, L 128; falcon-mamba D 8192 N 16, zamba2 D 5120 N 64) that is
// ~0.1-0.3 GB against 0.27-0.67 G (b, t, d, n) elements, each needing one
// exp(dt a) and ~15 fp32 operations: the exponentials at the SFUs' rate
// bound it on paper. This first version evaluates each exponential three
// times (below) and spends shuffles on the reductions over D.
//
// Design.
// - h_{t-1} is recomputed, never recovered by dividing by exp(dt a) (which
//   underflows). The forward saves nothing (serving is untouched, and the
//   training graph holds no (B, L/16, D, N) states: 9 GB over zamba2's 54
//   layers). The backward first runs the forward recurrence over a tile's
//   channels and writes h at each chunk boundary (every kChunk = 16 steps)
//   to a scratch the block alone reads, 512 floats a chunk; then walks the
//   chunks in reverse, recomputing each chunk's 16 states into registers
//   from its checkpoint and walking them backward.
// - Threads own states as in the forward (NT / 4 lanes a channel, 4 states
//   a lane). dx and ddt sum the N states across a channel's lanes by xor
//   shuffles in sum_states' order; dB and dC sum over the channels: across
//   a warp's channels by xor shuffles, then across the 4 warps in shared
//   memory in warp order, then over a group of tiles_per_block channel
//   tiles that the block walks one after the other (block-private partial
//   sums in device memory, first tile stores, later tiles add), and last
//   over the groups and, for da, over the batch rows, in a second kernel
//   (ssm_bwd_reduce) in index order. Every sum has a fixed order: the
//   gradients are deterministic. The scratch is (groups, B, L, N) twice,
//   and the wrapper picks tiles_per_block to keep it near 64 MiB.
// - Loads go through the forward's cp.async ring of kChunk-step stages
//   (x, dt, B, C), plus dy, one chunk ahead, in both passes.
// - Channels past D and states past N enter as zeros (dt = x = dy = 0,
//   a = B = C = 0), so their gradients and contributions are exactly 0.
// - exp and the products are unfused (__fmul_rn / __fadd_rn), as in the
//   plain version (ssm_scan_bwd_plain) and the forward: the recomputed
//   states equal the forward's bit for bit.

constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

template <typename T, int NT, int CW>
struct __align__(16) BwdSmem {
  Stage<T, NT, CW> ring[kStages];
  float dy[kStages][kChunk][CW];
  float red_b[kWarps][kChunk][NT];   // a warp's dB / dC sums a chunk
  float red_c[kWarps][kChunk][NT];
  float dxs[kChunk][CW];
  float ddts[kChunk][CW];
};

struct BwdFlags {
  Flags f;
  bool vec_dy;    // dy rows 16-byte aligned: 16-byte copies
};

// dy for time steps t0 .. t0 + tn - 1 of the block's CW channels.
template <int CW>
__device__ __forceinline__ void load_dy(float (&dst)[kChunk][CW],
                                        const float* __restrict__ dy,
                                        long long row, int t0, int tn,
                                        int d0, int D, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int R = CW / 4;
    for (int i = tid; i < kChunk * R; i += kThreads) {
      const int r = i / R, d = d0 + (i % R) * 4;
      if (r < tn && d < D)
        hopper::cp_async16(&dst[r][d - d0], dy + (row + t0 + r) * D + d);
    }
  } else {
    for (int i = tid; i < kChunk * CW; i += kThreads) {
      const int r = i / CW, cc = i % CW;
      if (r < tn && d0 + cc < D)
        hopper::cp_async4(&dst[r][cc], dy + (row + t0 + r) * D + d0 + cc);
    }
  }
}

// Grid (groups, B): block (g, b) walks channel tiles g * G .. g * G + G - 1
// (G = tiles_per_block; the last group may hold fewer) of batch row b.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
ssm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dy,
               const float* __restrict__ dh_last, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ db_part,
               float* __restrict__ dc_part, float* __restrict__ da_part,
               float* __restrict__ ckpt, int L, int D, int N, int G,
               BwdFlags bf) {
  constexpr int S = NT / kPerLane;     // lanes a channel
  constexpr int CW = kThreads / S;     // channels a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<BwdSmem<T, NT, CW>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = tid / S, s = tid % S;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const long long row = static_cast<long long>(b) * L;
  const int chunks = (L + kChunk - 1) / kChunk;
  const int tiles = (D + CW - 1) / CW;
  const int tile0 = blockIdx.x * G;
  const int tile1 = min(tiles, tile0 + G);
  // this block's checkpoints: chunks - 1 of 512 floats (h before chunk k)
  float* ck = ckpt + (static_cast<long long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * (chunks - 1) * (kThreads * kPerLane) +
              tid * kPerLane;
  const long long part_row =
      (static_cast<long long>(blockIdx.x) * B + b) * L;   // (g, b) rows

  for (int tile = tile0; tile < tile1; ++tile) {
    const int d0 = tile * CW;
    const int d = d0 + c;
    const bool live = d < D;
    float av[kPerLane], h[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int n = s * kPerLane + j;
      av[j] = (live && n < N) ? a[static_cast<long long>(d) * N + n] : 0.f;
      h[j] = 0.f;
    }

    // Pass 1: the forward recurrence over chunks 0 .. chunks - 2, writing
    // h at the end of each (the state before chunk k + 1).
    const int fchunks = chunks - 1;
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < fchunks)
        load_chunk(sm.ring[k], x, dt, bm, cm, row, k * kChunk, kChunk, d0,
                   D, N, bf.f);
      hopper::cp_async_commit();
    }
    for (int k = 0; k < fchunks; ++k) {
      hopper::cp_async_wait<kStages - 2>();
      __syncthreads();
      const int kn = k + kStages - 1;
      if (kn < fchunks)
        load_chunk(sm.ring[kn % kStages], x, dt, bm, cm, row, kn * kChunk,
                   kChunk, d0, D, N, bf.f);
      hopper::cp_async_commit();
      const Stage<T, NT, CW>& st = sm.ring[k % kStages];
#pragma unroll 4
      for (int r = 0; r < kChunk; ++r) {
        const float dtv = live ? st.dt[r][c] : 0.f;
        const float xdt = __fmul_rn(dtv, live ? to_f(st.x[r][c]) : 0.f);
        float bv[kPerLane];
        load4(&st.b[r][s * kPerLane], bv);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          h[j] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dtv, av[j])), h[j]),
                           __fmul_rn(xdt, bv[j]));
      }
      *reinterpret_cast<float4*>(ck + k * (kThreads * kPerLane)) =
          make_float4(h[0], h[1], h[2], h[3]);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();

    // Pass 2: the chunks in reverse.
    float gc[kPerLane], da[kPerLane];   // carry: exp(dt_{t+1} a) g_{t+1}
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int n = s * kPerLane + j;
      gc[j] = (dh_last != nullptr && live && n < N)
                  ? dh_last[(static_cast<long long>(b) * D + d) * N + n]
                  : 0.f;
      da[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      const int k = chunks - 1 - i;
      if (k >= 0) {
        const int tn = min(kChunk, L - k * kChunk);
        load_chunk(sm.ring[i], x, dt, bm, cm, row, k * kChunk, tn, d0, D,
                   N, bf.f);
        load_dy(sm.dy[i], dy, row, k * kChunk, tn, d0, D, bf.vec_dy);
      }
      hopper::cp_async_commit();
    }
    for (int i = 0; i < chunks; ++i) {
      const int k = chunks - 1 - i;
      hopper::cp_async_wait<kStages - 2>();
      __syncthreads();
      const int in = i + kStages - 1, kn = chunks - 1 - in;
      if (kn >= 0) {
        const int tn = min(kChunk, L - kn * kChunk);
        load_chunk(sm.ring[in % kStages], x, dt, bm, cm, row, kn * kChunk,
                   tn, d0, D, N, bf.f);
        load_dy(sm.dy[in % kStages], dy, row, kn * kChunk, tn, d0, D,
                bf.vec_dy);
      }
      hopper::cp_async_commit();
      const Stage<T, NT, CW>& st = sm.ring[i % kStages];
      const float (&dys)[kChunk][CW] = sm.dy[i % kStages];
      const int t0 = k * kChunk;
      const int tn = min(kChunk, L - t0);

      float h0[kPerLane];
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) h0[j] = 0.f;
      } else {
        const float4 v = *reinterpret_cast<const float4*>(
            ck + (k - 1) * (kThreads * kPerLane));
        h0[0] = v.x; h0[1] = v.y; h0[2] = v.z; h0[3] = v.w;
      }
      // the chunk's states h_{t0} .. h_{t0 + tn - 1}, as the forward has them
      float hist[kChunk][kPerLane];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        if (r < tn) {
          const float dtv = live ? st.dt[r][c] : 0.f;
          const float xdt = __fmul_rn(dtv, live ? to_f(st.x[r][c]) : 0.f);
          float bv[kPerLane];
          load4(&st.b[r][s * kPerLane], bv);
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            const float hp = r == 0 ? h0[j] : hist[r > 0 ? r - 1 : 0][j];
            hist[r][j] = __fadd_rn(
                __fmul_rn(expf(__fmul_rn(dtv, av[j])), hp),
                __fmul_rn(xdt, bv[j]));
          }
        }
      }
#pragma unroll
      for (int r = kChunk - 1; r >= 0; --r) {
        if (r >= tn) continue;
        const float dtv = live ? st.dt[r][c] : 0.f;
        const float xv = live ? to_f(st.x[r][c]) : 0.f;
        const float dyv = live ? dys[r][c] : 0.f;
        const float xdt = __fmul_rn(dtv, xv);
        float bv[kPerLane], cv[kPerLane];
        load4(&st.b[r][s * kPerLane], bv);
        load4(&st.c[r][s * kPerLane], cv);
        float pdx = 0.f, pddt = 0.f, db[kPerLane], dc[kPerLane];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const float ab = expf(__fmul_rn(dtv, av[j]));
          const float hp = r == 0 ? h0[j] : hist[r > 0 ? r - 1 : 0][j];
          const float g = __fadd_rn(gc[j], __fmul_rn(dyv, cv[j]));
          const float tx = __fmul_rn(g, bv[j]);
          const float tdt = __fmul_rn(
              g, __fadd_rn(__fmul_rn(xv, bv[j]),
                           __fmul_rn(__fmul_rn(av[j], ab), hp)));
          pdx = j == 0 ? tx : __fadd_rn(pdx, tx);
          pddt = j == 0 ? tdt : __fadd_rn(pddt, tdt);
          db[j] = __fmul_rn(g, xdt);
          dc[j] = __fmul_rn(dyv, hist[r][j]);
          da[j] = __fadd_rn(da[j], __fmul_rn(__fmul_rn(g, dtv),
                                             __fmul_rn(ab, hp)));
          gc[j] = __fmul_rn(ab, g);
        }
        // over the channel's lanes (its states), in sum_states' order
#pragma unroll
        for (int o = 1; o < S; o <<= 1) {
          pdx = __fadd_rn(pdx, __shfl_xor_sync(0xffffffffu, pdx, o));
          pddt = __fadd_rn(pddt, __shfl_xor_sync(0xffffffffu, pddt, o));
        }
        // over the warp's channels
#pragma unroll
        for (int o = S; o < 32; o <<= 1)
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            db[j] = __fadd_rn(db[j], __shfl_xor_sync(0xffffffffu, db[j], o));
            dc[j] = __fadd_rn(dc[j], __shfl_xor_sync(0xffffffffu, dc[j], o));
          }
        if (s == 0) {
          sm.dxs[r][c] = __fmul_rn(dtv, pdx);
          sm.ddts[r][c] = pddt;
        }
        if (lane < S) {
          *reinterpret_cast<float4*>(&sm.red_b[warp][r][s * kPerLane]) =
              make_float4(db[0], db[1], db[2], db[3]);
          *reinterpret_cast<float4*>(&sm.red_c[warp][r][s * kPerLane]) =
              make_float4(dc[0], dc[1], dc[2], dc[3]);
        }
      }
      __syncthreads();
      for (int e = tid; e < tn * CW; e += kThreads) {
        const int r = e / CW, cc = e % CW;
        if (d0 + cc < D) {
          const long long off = (row + t0 + r) * D + d0 + cc;
          dx[off] = from_f<T>(sm.dxs[r][cc]);
          ddt[off] = sm.ddts[r][cc];
        }
      }
      for (int e = tid; e < tn * N; e += kThreads) {
        const int r = e / N, n = e % N;
        float sb = sm.red_b[0][r][n], sc = sm.red_c[0][r][n];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          sb = __fadd_rn(sb, sm.red_b[w][r][n]);
          sc = __fadd_rn(sc, sm.red_c[w][r][n]);
        }
        const long long off = (part_row + t0 + r) * N + n;
        if (tile == tile0) {
          db_part[off] = sb;
          dc_part[off] = sc;
        } else {
          db_part[off] = __fadd_rn(db_part[off], sb);
          dc_part[off] = __fadd_rn(dc_part[off], sc);
        }
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();   // the ring, dxs and red are free for the next tile
    if (live) {
      float* out = da_part + (static_cast<long long>(b) * D + d) * N;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int n = s * kPerLane + j;
        if (n < N) out[n] = da[j];
      }
    }
  }
}

// dB, dC = the sums of the groups' partials in group order, in the input
// dtype; da = the sum of the batch rows' partials in row order.
template <typename T>
__global__ void ssm_bwd_reduce(const float* __restrict__ db_part,
                               const float* __restrict__ dc_part,
                               const float* __restrict__ da_part,
                               T* __restrict__ db, T* __restrict__ dc,
                               float* __restrict__ da, int groups, int B,
                               int L, int D, int N) {
  const long long rows = static_cast<long long>(B) * L * N;
  const long long cols = static_cast<long long>(D) * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < rows + cols; i += stride) {
    if (i < rows) {
      float sb = db_part[i], sc = dc_part[i];
      for (int g = 1; g < groups; ++g) {
        sb = __fadd_rn(sb, db_part[g * rows + i]);
        sc = __fadd_rn(sc, dc_part[g * rows + i]);
      }
      db[i] = from_f<T>(sb);
      dc[i] = from_f<T>(sc);
    } else {
      const long long j = i - rows;
      float sa = da_part[j];
      for (int r = 1; r < B; ++r) sa = __fadd_rn(sa, da_part[r * cols + j]);
      da[j] = sa;
    }
  }
}

template <typename T, int NT>
int launch_bwd_n(const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, const float* dy,
                 const float* dh_last, void* dx, float* ddt, void* db,
                 void* dc, float* da, float* db_part, float* dc_part,
                 float* da_part, float* ckpt, int B, int L, int D, int N,
                 int G, cudaStream_t stream) {
  constexpr int CW = kThreads / (NT / kPerLane);
  constexpr int smem = static_cast<int>(sizeof(BwdSmem<T, NT, CW>));
  BwdFlags bf;
  bf.f.vec_xdt = D % 8 == 0 && aligned16(x) && aligned16(dt);
  bf.f.vec_bc = N == NT && (N * sizeof(T)) % 16 == 0 && aligned16(bm) &&
                aligned16(cm);
  bf.f.vec_y = false;
  bf.vec_dy = D % 4 == 0 && aligned16(dy);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_bwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (D + CW - 1) / CW;
  const int groups = (tiles + G - 1) / G;
  ssm_bwd_kernel<T, NT><<<dim3(groups, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), dy, dh_last, static_cast<T*>(dx), ddt,
      db_part, dc_part, da_part, ckpt, L, D, N, G, bf);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = static_cast<long long>(B) * L * N +
                         static_cast<long long>(D) * N;
  const int blocks = static_cast<int>(
      std::min<long long>((work + 255) / 256, 132LL * 8));
  ssm_bwd_reduce<T><<<blocks, 256, 0, stream>>>(
      db_part, dc_part, da_part, static_cast<T*>(db), static_cast<T*>(dc),
      da, groups, B, L, D, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, const float* dy,
               const float* dh_last, void* dx, float* ddt, void* db,
               void* dc, float* da, float* db_part, float* dc_part,
               float* da_part, float* ckpt, int B, int L, int D, int N,
               int G, cudaStream_t s) {
#define SSM_BWD_ARGS x, dt, a, bm, cm, dy, dh_last, dx, ddt, db, dc, da, \
    db_part, dc_part, da_part, ckpt, B, L, D, N, G, s
  if (N <= 8) return launch_bwd_n<T, 8>(SSM_BWD_ARGS);
  if (N <= 16) return launch_bwd_n<T, 16>(SSM_BWD_ARGS);
  if (N <= 32) return launch_bwd_n<T, 32>(SSM_BWD_ARGS);
  return launch_bwd_n<T, 64>(SSM_BWD_ARGS);
#undef SSM_BWD_ARGS
}

}  // namespace

extern "C" {

// dtype of x, B and C: 0 float32, 1 bfloat16, 2 float16. x (B, L, D),
// dt (B, L, D) fp32, a (D, N) fp32, B/C (B, L, N), y (B, L, D) fp32,
// h_last (B, D, N) fp32, all contiguous. Returns cudaGetLastError().
int ssm_scan_fwd(int dtype, const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, float* y, float* h_last,
                 int B, int L, int D, int N, void* stream) {
  if (N < 1 || N > kMaxN || B < 1 || B > 65535 || L < 1 || D < 1)
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

// B4-bwd. Inputs as ssm_scan_fwd's, dy (B, L, D) fp32, dh_last (B, D, N)
// fp32 or null (zero). Outputs dx (B, L, D) and dB, dC (B, L, N) in x's
// dtype, ddt (B, L, D) and da (D, N) fp32. Scratch, fp32: db_part and
// dc_part (groups, B, L, N), da_part (B, D, N), ckpt (groups * B,
// ceil(L / 16) - 1, 512), with groups = ceil(ceil(D / CW) /
// tiles_per_block) and CW = 512 / NT the channels a tile (NT: N rounded
// up to 8, 16, 32 or 64). All contiguous. Launches ssm_bwd_kernel, then
// ssm_bwd_reduce; returns cudaGetLastError().
int ssm_scan_bwd(int dtype, const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, const float* dy,
                 const float* dh_last, void* dx, float* ddt, void* db,
                 void* dc, float* da, float* db_part, float* dc_part,
                 float* da_part, float* ckpt, int B, int L, int D, int N,
                 int tiles_per_block, void* stream) {
  if (N < 1 || N > kMaxN || B < 1 || B > 65535 || L < 1 || D < 1 ||
      tiles_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSM_BWD_CALL(T) launch_bwd<T>(x, dt, a, bm, cm, dy, dh_last, dx, \
    ddt, db, dc, da, db_part, dc_part, da_part, ckpt, B, L, D, N, \
    tiles_per_block, s)
  switch (dtype) {
    case 0: return SSM_BWD_CALL(float);
    case 1: return SSM_BWD_CALL(__nv_bfloat16);
    case 2: return SSM_BWD_CALL(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSM_BWD_CALL
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
