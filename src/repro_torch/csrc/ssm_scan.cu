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

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
