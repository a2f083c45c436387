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
#include <type_traits>

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
// the adjoint of h_t and e_t = exp(dt_t[d] a[d, n]) (fp32 throughout):
//
//   g_{L-1} = dh_last + dy_{L-1} C_{L-1}
//   g_t     = dy_t C_t + e_{t+1} g_{t+1}
//   dx_t[d]  = dt_t[d] sum_n g_t[d,n] B_t[n]
//   ddt_t[d] = sum_n g_t[d,n] (x_t[d] B_t[n] + (a[d,n] e_t) h_{t-1}[d,n])
//   dB_t[n]  = sum_d g_t[d,n] dt_t[d] x_t[d]
//   dC_t[n]  = sum_d dy_t[d] h_t[d,n]
//   da[d,n]  = sum_{b,t} (g_t[d,n] dt_t[d]) (e_t h_{t-1}[d,n])
//
// What bounds it. Per (b, t, d) it reads x, dt and dy and writes dx and
// ddt; per (b, t) B, C, dB and dC; a and da once: ~0.3 GB at falcon-mamba's
// training shape (B 16, L 128, D 8192, N 16), 0.08 ms. Against that, 268 M
// (b, t, d, n) state-steps, each needing one exp(dt a) and 22 fp32
// operations (chip_smoke.py's scan_bwd_bound): 0.088 ms at the fp32 peak.
// The decay differs per (channel, state), so the exponentials cannot be
// shared as in Mamba-2's layout (csrc/mamba2_bwd.cu); what a design can
// save is how often each is evaluated again. The first version of this
// kernel evaluated three a state-step (a forward pass, a chunk's recompute and
// the reverse step), held a chunk's 16 x 4 states in 244 registers (two
// blocks of 4 warps an SM) and spent 28 shuffles a step on its sums.
//
// Design (Mamba-2's backward, csrc/mamba2_bwd.cu, carried over).
// - Layout: channels across lanes, states across warps. A block walks
//   tiles of 32 channels (lane l owns channel d0 + l) of one batch row;
//   warp w owns states 4w .. 4w + 3, so a thread owns 4 (channel, state)
//   pairs and the block (NT / 4 warps, NT = N rounded up to 8, 16, 32 or
//   64) every state: 4 warps at falcon-mamba's N 16. Channels past D and
//   states past N enter as zeros (dt = x = dy = 0, a = B = C = 0) and stay
//   exactly 0.
// - States are recomputed, never recovered by dividing by e_t (which
//   underflows): a first pass runs the recurrence over the tile and writes
//   h every kSub = 4 steps to a block-private scratch (~62 KB a block at
//   falcon-mamba's L 128, L2-resident); the second walks 8-step chunks in
//   reverse, each in its two sub-chunks: a sub-chunk's 4 states
//   recomputed from its checkpoint (staged in shared memory one chunk
//   ahead by cp.async), each state and its e_t kept in shared memory
//   (every thread its own slots), and the 4 steps walked backward,
//   reusing those e_t. So a (channel, state) pair evaluates
//       4 (ceil(L / 4) - 1) + L
//   exponentials, 252 at L 128 (1.97 a state-step), and the kernel's count
//   is B * D * N times that: 528.5 M at falcon-mamba's shape, where the
//   first version evaluated 771.8 M. (Checkpoints every 8 steps, with each
//   second sub-chunk's start recomputed, took 2.44 a state-step and ran
//   0.1 ms slower on the H100.) Given a counter (exp_count, null on the
//   training path), each thread adds its evaluations to it once.
// - Registers: a thread keeps 4 states, a, the carry g and da; its
//   sub-chunk's history is in shared memory, so a sub-chunk's steps and
//   its two halves run as rolled loops. At most 128 registers a thread
//   (__launch_bounds__ caps every instantiation there) and no spill: 4
//   blocks of 4 warps an SM, where the first version had 2 (it held a
//   chunk's 16 x 4 states in 244 registers). Unrolled, the same steps
//   spilled and ran ~10% slower on the H100.
// - Reductions, each in a fixed order (no atomics: two launches give the
//   same bits):
//   - dx, ddt (over a channel's states, so across warps): a thread sums
//     its 4 states in index order; the warps' partials go through shared
//     memory and are summed pairwise when the chunk ends: sum_states'
//     order, the plain version's (ssm_scan_bwd_plain). The reverse step's
//     products are fused (fmaf): the gradients are held to the plain
//     version at tolerances.
//   - dB, dC (over channels, so across lanes): three transposing xor levels
//     (7 shuffles for 8 values, where the first version spent 24) leave
//     each lane one of four partial sums of one value, which are summed
//     in lane order when the chunk ends; the block's sums are added to a
//     (groups, B, L, N) partial (its first tile stores, later tiles add),
//     which ssm_bwd_reduce sums over the groups in order.
//   - da: each thread's pairs over the tile's steps in registers, written
//     per batch row to a (B, D, N) partial that ssm_bwd_reduce sums over
//     the rows in order.
//   A chunk's sums run after the next chunk's first barrier; a second
//   frees the (single) partial buffers for its walk.
// - Loads: a 3-stage cp.async ring of 8-step chunks (x, dt, dy, and B and
//   C interleaved by quads of states, so one read gives a thread its 4
//   states of both), two chunks ahead, 16-byte copies where rows are
//   aligned.
// - The recomputed states use B4's exp and products, unfused (expf,
//   __fmul_rn / __fadd_rn): they equal the forward's bit for bit.

namespace bwd {

constexpr int kChunk = 8;      // steps a stage
constexpr int kSub = 4;        // steps between checkpoints (a sub-chunk)
constexpr int kStages = 3;     // chunks k + 1 and k + 2 load while k runs
constexpr int kNPer = 4;       // states a thread (and a warp) owns
constexpr int kCT = 32;        // channels a tile: one a lane

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// One ring stage: kChunk steps of the tile's channels of x, dt and dy, and
// B and C interleaved by quads of states (row: B[0..3], C[0..3], B[4..7],
// ...; states past N zero).
template <typename T, int NT>
struct __align__(16) Stage {
  T x[kChunk][kCT];
  float dt[kChunk][kCT];
  float dy[kChunk][kCT];
  T bc[kChunk][2 * NT];
};

template <typename T, int NT>
struct __align__(16) Smem {
  static constexpr int W = NT / kNPer;
  static constexpr int NTH = 32 * W;
  Stage<T, NT> ring[kStages];
  float ckb[2][2][NTH * kNPer];      // each thread's checkpoint slices
  float4 abs[kSub][NTH];             // a sub-chunk's e_t, each thread's 4
  float4 hsm[kSub][NTH];             // and its states after each step
  float2 part[W][kChunk][kCT];       // each warp's (dx, ddt) partial
  float dbp[kChunk][W][32];          // each lane's dB / dC partial
  float dtb[kChunk][kCT];            // the chunk's dt, kept for its end
};

struct Flags {
  bool vec_x;     // x rows 16-byte aligned: 16-byte copies
  bool vec_dt;    // dt alike
  bool vec_dy;    // dy alike
  bool vec_bc;    // N == NT and B, C rows aligned: quad copies
};

// Rows t0 .. t0 + tn - 1 of the tile's channels d0 .. d0 + cw - 1 of a
// (B, L, D) tensor, channels past cw zero.
template <typename E, int NTH>
__device__ __forceinline__ void load_rows(E (&dst)[kChunk][kCT],
                                          const E* __restrict__ src,
                                          long long row, int t0, int tn,
                                          int d0, int cw, int D, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int V = 16 / sizeof(E);
    constexpr int R = kCT / V;
    for (int i = tid; i < tn * R; i += NTH) {
      const int r = i / R, cc = (i % R) * V;
      if (cc < cw)
        hopper::cp_async16(&dst[r][cc], src + (row + t0 + r) * D + d0 + cc);
      else
        hopper::cp_async16(&dst[r][cc], src, 0);     // zeros
    }
  } else {
    for (int i = tid; i < tn * kCT; i += NTH) {
      const int r = i / kCT, cc = i % kCT;
      if (cc < cw) {
        const E* p = src + (row + t0 + r) * D + d0 + cc;
        if constexpr (sizeof(E) == 4)
          hopper::cp_async4(&dst[r][cc], p);
        else
          dst[r][cc] = *p;
      } else {
        dst[r][cc] = from_f<E>(0.f);
      }
    }
  }
}

template <typename T, int NT, int NTH>
__device__ __forceinline__ void load_stage(
    Stage<T, NT>& st, const T* __restrict__ x,
    const float* __restrict__ dt, const float* __restrict__ dy,
    const T* __restrict__ bm, const T* __restrict__ cm, long long row,
    int t0, int tn, int d0, int cw, int D, int N, bool with_dy_c, Flags f) {
  load_rows<T, NTH>(st.x, x, row, t0, tn, d0, cw, D, f.vec_x);
  load_rows<float, NTH>(st.dt, dt, row, t0, tn, d0, cw, D, f.vec_dt);
  if (with_dy_c)
    load_rows<float, NTH>(st.dy, dy, row, t0, tn, d0, cw, D, f.vec_dy);
  // B (and C): quad q of row r to bc[r][8 q] (and bc[r][8 q + 4])
  const int tid = threadIdx.x;
  const int nmat = with_dy_c ? 2 : 1;
  if (f.vec_bc) {
    constexpr int Q = NT / 4;
    for (int i = tid; i < tn * Q * nmat; i += NTH) {
      const int m = i / (tn * Q), rq = i % (tn * Q);
      const int r = rq / Q, q = rq % Q;
      const T* src = (m ? cm : bm) + (row + t0 + r) * N + 4 * q;
      T* dst = &st.bc[r][8 * q + 4 * m];
      if constexpr (sizeof(T) == 4)
        hopper::cp_async16(dst, src);
      else
        hopper::cp_async8(dst, src);
    }
  } else {
    for (int i = tid; i < tn * NT * nmat; i += NTH) {
      const int m = i / (tn * NT), rn = i % (tn * NT);
      const int r = rn / NT, n = rn % NT;
      T* dst = &st.bc[r][8 * (n / 4) + 4 * m + n % 4];
      if (n < N) {
        const T* src = (m ? cm : bm) + (row + t0 + r) * N + n;
        if constexpr (sizeof(T) == 4)
          hopper::cp_async4(dst, src);
        else
          *dst = *src;
      } else {
        *dst = from_f<T>(0.f);
      }
    }
  }
}

// A quad of B (load_b), or of B and C (load_bc), from an interleaved B/C
// row of the stage, as fp32.
__device__ __forceinline__ void load_b(const float* p, float (&bv)[4]) {
  load4(p, bv);
}
template <typename T>
__device__ __forceinline__ void load_b(const T* p, float (&bv)[4]) {
  load4(p, bv);
}
template <typename T>
__device__ __forceinline__ void load_bc(const T* p, float (&bv)[4],
                                        float (&cv)[4]) {
  load_b(p, bv);
  load_b(p + 4, cv);
}

// Grid (groups, B): block (g, b) walks channel tiles g * G .. g * G + G - 1
// (G = tiles_per_block; the last group may hold fewer) of batch row b.
// T: dtype of x, B, C, dx, dB, dC; NT: N rounded up.
template <typename T, int NT>
__global__ void __launch_bounds__(8 * NT, 512 / (8 * NT))
ssm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dy,
               const float* __restrict__ dh_last, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ db_part,
               float* __restrict__ dc_part, float* __restrict__ da_part,
               float* __restrict__ ckpt,
               unsigned long long* __restrict__ exp_count, int L, int D,
               int N, int G, Flags f) {
  constexpr int W = NT / kNPer;          // warps: states 4w .. 4w + 3
  constexpr int NTH = 32 * W;
  using Sm = Smem<T, NT>;
  using St = Stage<T, NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, B = gridDim.y;
  const long long row = static_cast<long long>(b) * L;
  const int tiles = (D + kCT - 1) / kCT;
  const int chunks = (L + kChunk - 1) / kChunk;
  const int tile0 = blockIdx.x * G, tile1 = min(tiles, tile0 + G);
  // this block's checkpoints, the states before sub-chunks 1 .. subs -
  // 1: subs - 1 of NTH * 4 floats
  const int subs = (L + kSub - 1) / kSub;
  float* ck = ckpt + (static_cast<long long>(b) * gridDim.x + blockIdx.x) *
                         (subs - 1) * (NTH * kNPer) + tid * kNPer;
  const long long part_row = (static_cast<long long>(blockIdx.x) * B + b) * L;
  const int n0 = warp * kNPer;           // this thread's states
  unsigned evaluated = 0;              // exponentials, real pairs

  for (int tile = tile0; tile < tile1; ++tile) {
    const bool first_item = tile == tile0;
    const int d0 = tile * kCT;
    const int cw = min(kCT, D - d0);
    const int d = d0 + lane;
    const bool live = lane < cw;
    float av[kNPer];
    int nlive = 0;                       // this thread's real pairs
#pragma unroll
    for (int i = 0; i < kNPer; ++i) {
      const bool ok = live && n0 + i < N;
      av[i] = ok ? a[static_cast<long long>(d) * N + n0 + i] : 0.f;
      nlive += ok;
    }
    auto stage = [&](St& st, int k, bool with_dy_c) {
      const int t0 = k * kChunk;
      load_stage<T, NT, NTH>(st, x, dt, dy, bm, cm, row, t0,
                             min(kChunk, L - t0), d0, cw, D, N, with_dy_c,
                             f);
    };
    // One forward step of this thread's states, with each state's e_t.
    auto fwd = [&](float (&hh)[kNPer], float (&ab)[kNPer], const St& st,
                   int r) {
      const float dtv = st.dt[r][lane];
      const float xdt = __fmul_rn(dtv, to_f(st.x[r][lane]));
      float bv[kNPer];
      load_b(&st.bc[r][2 * n0], bv);
#pragma unroll
      for (int i = 0; i < kNPer; ++i) {
        ab[i] = expf(__fmul_rn(dtv, av[i]));
        hh[i] = __fadd_rn(__fmul_rn(ab[i], hh[i]), __fmul_rn(xdt, bv[i]));
      }
      evaluated += nlive;
    };

    // Pass 1: the recurrence over every sub-chunk but the last, writing h
    // at the end of each (the state before sub-chunk j + 1 into slot j).
    float hf[kNPer];
#pragma unroll
    for (int i = 0; i < kNPer; ++i) hf[i] = 0.f;
    const int fsteps = kSub * (subs - 1);
    const int fchunks = (fsteps + kChunk - 1) / kChunk;
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < fchunks) stage(sm.ring[k], k, false);
      hopper::cp_async_commit();
    }
    for (int k = 0; k < fchunks; ++k) {
      hopper::cp_async_wait<kStages - 2>();
      __syncthreads();
      const int kn = k + kStages - 1;
      if (kn < fchunks) stage(sm.ring[kn % kStages], kn, false);
      hopper::cp_async_commit();
      const St& st = sm.ring[k % kStages];
#pragma unroll 1
      for (int half = 0; half < kChunk / kSub; ++half) {
        const int j = k * (kChunk / kSub) + half;   // this sub-chunk
        if (half > 0 && j >= subs - 1) break;
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          float ab[kNPer];
          fwd(hf, ab, st, half * kSub + q);
        }
        *reinterpret_cast<float4*>(ck + static_cast<long long>(j) *
                                            (NTH * kNPer)) =
            make_float4(hf[0], hf[1], hf[2], hf[3]);
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();   // the ring is free; the checkpoints are written

    // Pass 2: the chunks in reverse. Iteration i walks chunk k = chunks -
    // 1 - i backward into the partial buffers of parity i & 1; the block
    // sums chunk i - 1's buffers (its "end") after iteration i's barrier.
    float gc[kNPer], da[kNPer];          // carry: e_{t+1} g_{t+1}
#pragma unroll
    for (int i = 0; i < kNPer; ++i) {
      const int n = n0 + i;
      gc[i] = (dh_last != nullptr && live && n < N)
                  ? dh_last[(static_cast<long long>(b) * D + d) * N + n]
                  : 0.f;
      da[i] = 0.f;
    }
    // this thread's checkpoints before iteration i's sub-chunks, staged
    // one iteration ahead in its own slices of ckb (no barrier needed)
    auto load_ck = [&](int i) {
      const int k = chunks - 1 - i;
#pragma unroll
      for (int h = 0; h < kChunk / kSub; ++h) {
        const int j = k * (kChunk / kSub) + h;   // its sub-chunk
        float* dst = &sm.ckb[i & 1][h][tid * kNPer];
        if (j > 0 && j < subs)
          hopper::cp_async16(dst, ck + static_cast<long long>(j - 1) *
                                           (NTH * kNPer));
        else
          hopper::cp_async16(dst, ck, 0);     // zeros
      }
    };
    // The end of iteration j's chunk: dx and ddt, and the dB / dC partial
    // (pb, pc: its earlier value, read at that iteration).
    auto chunk_end = [&](int j, float pb, float pc) {
      const int t0 = (chunks - 1 - j) * kChunk;
      const int tn = min(kChunk, L - t0);
      // over the warps (states) pairwise, in sum_states' order
      for (int e = tid; e < tn * kCT; e += NTH) {
        const int r = e / kCT, c = e % kCT;
        if (c < cw) {
          float2 p[W];
#pragma unroll
          for (int w = 0; w < W; ++w) p[w] = sm.part[w][r][c];
#pragma unroll
          for (int m = W; m > 1; m >>= 1)
#pragma unroll
            for (int i = 0; i < m / 2; ++i)
              p[i] = make_float2(__fadd_rn(p[2 * i].x, p[2 * i + 1].x),
                                 __fadd_rn(p[2 * i].y, p[2 * i + 1].y));
          const long long off = (row + t0 + r) * D + d0 + c;
          dx[off] = from_f<T>(__fmul_rn(sm.dtb[r][c], p[0].x));
          ddt[off] = p[0].y;
        }
      }
      // dB, dC: the four lane partials in order; the block's first tile
      // stores, later tiles add
      if (tid < tn * N) {
        const int pr = tid / N, pn = tid % N;
        const float4 pbv = *reinterpret_cast<const float4*>(
            &sm.dbp[pr][pn / kNPer][4 * (pn % kNPer)]);
        const float4 pcv = *reinterpret_cast<const float4*>(
            &sm.dbp[pr][pn / kNPer][4 * (kNPer + pn % kNPer)]);
        const float sb =
            __fadd_rn(__fadd_rn(__fadd_rn(pbv.x, pbv.y), pbv.z), pbv.w);
        const float sc =
            __fadd_rn(__fadd_rn(__fadd_rn(pcv.x, pcv.y), pcv.z), pcv.w);
        const long long off = (part_row + t0 + pr) * N + pn;
        db_part[off] = first_item ? sb : __fadd_rn(pb, sb);
        dc_part[off] = first_item ? sc : __fadd_rn(pc, sc);
      }
    };

    load_ck(0);
    hopper::cp_async_commit();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      const int k = chunks - 1 - i;
      if (k >= 0) stage(sm.ring[i], k, true);
      hopper::cp_async_commit();
    }
    float pb = 0.f, pc = 0.f;            // chunk i - 1's dB / dC partial
    // iteration i walks chunk chunks - 1 - i and ends chunk i - 1; the
    // last (i == chunks) only ends the last chunk
    for (int i = 0; i <= chunks; ++i) {
      const int k = chunks - 1 - i;
      // everything but the latest group: iteration i's stage and
      // checkpoint
      if (i < chunks)
        hopper::cp_async_wait<1>();
      else
        hopper::cp_async_wait<0>();
      __syncthreads();
      if (i == chunks) {
        chunk_end(i - 1, pb, pc);
        break;
      }
      if (i + 1 < chunks) load_ck(i + 1);
      hopper::cp_async_commit();
      const int in = i + kStages - 1, kn = chunks - 1 - in;
      if (kn >= 0) stage(sm.ring[in % kStages], kn, true);
      hopper::cp_async_commit();
      const St& st = sm.ring[i % kStages];
      const int buf = i & 1;
      const int t0 = k * kChunk;
      const int tn = min(kChunk, L - t0);
      if (i > 0) {
        chunk_end(i - 1, pb, pc);
        __syncthreads();     // the partial buffers are free
      }
      for (int e = tid; e < kChunk * kCT; e += NTH)
        sm.dtb[e / kCT][e % kCT] = st.dt[e / kCT][e % kCT];
      // this chunk's dB / dC partial, read now for its end
      if (tid < tn * N && !first_item) {
        const long long off = (part_row + t0 + tid / N) * N + tid % N;
        pb = db_part[off];
        pc = dc_part[off];
      }
      // One sub-chunk, steps r0 .. r0 + kSub - 1 (those below tn): its
      // states from its checkpoint, kept with their e_t in shared memory
      // (each thread its own slots), then the steps backward. FULL:
      // every step is there.
      auto sub_walk = [&](int r0, auto full) {
        constexpr bool FULL = decltype(full)::value;
        const float* ckp = &sm.ckb[buf][r0 / kSub][tid * kNPer];
        float h[kNPer];
        load4(ckp, h);
#pragma unroll 1
        for (int q = 0; q < kSub; ++q) {
          if (!FULL && r0 + q >= tn) break;
          float ab[kNPer];
          fwd(h, ab, st, r0 + q);
          sm.abs[q][tid] = make_float4(ab[0], ab[1], ab[2], ab[3]);
          sm.hsm[q][tid] = make_float4(h[0], h[1], h[2], h[3]);
        }
#pragma unroll 1
        for (int q = kSub - 1; q >= 0; --q) {
          const int r = r0 + q;
          if (!FULL && r >= tn) continue;
          const float dtv = st.dt[r][lane];
          const float xv = to_f(st.x[r][lane]);
          const float dyv = st.dy[r][lane];
          const float xdt = __fmul_rn(dtv, xv);
          float bv[kNPer], cv[kNPer], abq[kNPer], hp[kNPer], ht[kNPer];
          load_bc(&st.bc[r][2 * n0], bv, cv);
          load4(&sm.abs[q][tid].x, abq);
          load4(q == 0 ? ckp : &sm.hsm[q > 0 ? q - 1 : 0][tid].x, hp);
          load4(&sm.hsm[q][tid].x, ht);
          float pdx = 0.f, pddt = 0.f, v[2 * kNPer];
#pragma unroll
          for (int i2 = 0; i2 < kNPer; ++i2) {
            // fused: the gradients are held to the plain version at
            // tolerances, the recomputed states bit for bit
            const float ab = abq[i2];
            const float g = fmaf(dyv, cv[i2], gc[i2]);
            pdx = fmaf(g, bv[i2], pdx);
            pddt = fmaf(g, fmaf(av[i2] * ab, hp[i2], xv * bv[i2]), pddt);
            v[i2] = g * xdt;                                 // dB
            v[kNPer + i2] = dyv * ht[i2];                    // dC
            da[i2] = fmaf(g * dtv, ab * hp[i2], da[i2]);
            gc[i2] = ab * g;
          }
          sm.part[warp][r][lane] = make_float2(pdx, pddt);
          // dB, dC over the warp's lanes (its channels), three of five
          // levels: lane l holds one of four partial sums of value l / 4
          sm.dbp[r][warp][lane] =
              hopper::warp_transpose_sum<2 * kNPer, false>(v, lane);
        }
      };
      if (tn == kChunk) {
#pragma unroll 1
        for (int sub = kChunk / kSub - 1; sub >= 0; --sub)
          sub_walk(sub * kSub, std::true_type());
      } else {
#pragma unroll 1
        for (int sub = (tn + kSub - 1) / kSub - 1; sub >= 0; --sub)
          sub_walk(sub * kSub, std::false_type());
      }
    }
    __syncthreads();   // the ring and the partial buffers are free
    if (live) {
      float* out = da_part + (static_cast<long long>(b) * D + d) * N;
#pragma unroll
      for (int i = 0; i < kNPer; ++i)
        if (n0 + i < N) out[n0 + i] = da[i];
    }
  }
  if (exp_count != nullptr && evaluated != 0)
    atomicAdd(exp_count, static_cast<unsigned long long>(evaluated));
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

struct Args {
  const void* x; const float* dt; const float* a; const void* bm;
  const void* cm; const float* dy; const float* dh_last; void* dx;
  float* ddt; void* db; void* dc; float* da; float* db_part;
  float* dc_part; float* da_part; float* ckpt;
  unsigned long long* exp_count;
  int B, L, D, N, G;
};

template <typename T, int NT>
int launch_n(const Args& p, cudaStream_t stream) {
  constexpr int NTH = 8 * NT;
  constexpr int smem = static_cast<int>(sizeof(Smem<T, NT>));
  Flags f;
  f.vec_x = p.D % (16 / sizeof(T)) == 0 && aligned16(p.x);
  f.vec_dt = p.D % 4 == 0 && aligned16(p.dt);
  f.vec_dy = p.D % 4 == 0 && aligned16(p.dy);
  f.vec_bc = p.N == NT && aligned16(p.bm) && aligned16(p.cm);
  auto kern = ssm_bwd_kernel<T, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (p.D + kCT - 1) / kCT;
  const int groups = (tiles + p.G - 1) / p.G;
  kern<<<dim3(groups, p.B), NTH, smem, stream>>>(
      static_cast<const T*>(p.x), p.dt, p.a, static_cast<const T*>(p.bm),
      static_cast<const T*>(p.cm), p.dy, p.dh_last, static_cast<T*>(p.dx),
      p.ddt, p.db_part, p.dc_part, p.da_part, p.ckpt, p.exp_count, p.L,
      p.D, p.N, p.G, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = static_cast<long long>(p.B) * p.L * p.N +
                         static_cast<long long>(p.D) * p.N;
  const int blocks = static_cast<int>(
      std::min<long long>((work + 255) / 256, 132LL * 8));
  ssm_bwd_reduce<T><<<blocks, 256, 0, stream>>>(
      p.db_part, p.dc_part, p.da_part, static_cast<T*>(p.db),
      static_cast<T*>(p.dc), p.da, groups, p.B, p.L, p.D, p.N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& p, cudaStream_t s) {
  if (p.N <= 8) return launch_n<T, 8>(p, s);
  if (p.N <= 16) return launch_n<T, 16>(p, s);
  if (p.N <= 32) return launch_n<T, 32>(p, s);
  return launch_n<T, 64>(p, s);
}

}  // namespace bwd

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
// ceil(L / 4) - 1, 32 * NT), with groups = ceil(ceil(D / 32) /
// tiles_per_block) and NT = N rounded up to 8, 16, 32 or 64. All
// contiguous. exp_count: null, or a uint64 on the device to which the
// kernel adds the exponentials it evaluates. Launches ssm_bwd_kernel, then
// ssm_bwd_reduce; returns cudaGetLastError().
int ssm_scan_bwd(int dtype, const void* x, const float* dt, const float* a,
                 const void* bm, const void* cm, const float* dy,
                 const float* dh_last, void* dx, float* ddt, void* db,
                 void* dc, float* da, float* db_part, float* dc_part,
                 float* da_part, float* ckpt, unsigned long long* exp_count,
                 int B, int L, int D, int N, int tiles_per_block,
                 void* stream) {
  if (N < 1 || N > kMaxN || B < 1 || B > 65535 || L < 1 || D < 1 ||
      tiles_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bwd::Args p{x, dt, a, bm, cm, dy, dh_last, dx, ddt, db, dc, da,
                    db_part, dc_part, da_part, ckpt, exp_count, B, L, D, N,
                    tiles_per_block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd::launch<float>(p, s);
    case 1: return bwd::launch<__nv_bfloat16>(p, s);
    case 2: return bwd::launch<__half>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
