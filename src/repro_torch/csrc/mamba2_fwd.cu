// B4 per head for Hopper (sm_90a): the selective scan's forward in
// Mamba-2's layout, where the decay is one scalar a head (SSD with one
// group), from a zero state.
//
//   e_t = exp(dt_t a)  (one per batch row, step and head)
//   h_t[c, n] = e_t h_{t-1}[c, n] + (dt_t x_t[c]) B_t[n]
//   y_t[c] = h_t[c] . C_t
//
// over the hd channels c of each head. Replaces no TPU kernel of its own:
// repro's mamba2_apply (src/repro/models/layers.py) runs this scan in
// plain JAX (_chunked_ssm_scan on a_full = exp(dt a) broadcast over (hd,
// N)), and the port ran it through B4 (csrc/ssm_scan.cu, the port of the
// Pallas kernel src/repro/kernels/ssm_scan.py) with dt repeated over each
// head's channels and a over its channels and states
// (kernels.ssm_scan.expand_heads). This kernel gives B4's bits there: the
// same expf(dt * a), the same unfused __fmul_rn / __fadd_rn steps, and y
// summed over the states in B4's order (4 states in index order, then the
// pairwise tree: sum_states). Its output is B4's on expand_heads' inputs,
// bit for bit.
//
// What bounds it. At zamba2's training shape (B 16, L 128, D 5120 in 80
// heads of 64, N 64) the function reads x (2 bytes in bf16) and writes y
// (4) per (b, t, c), reads dt per (b, t, head) and B, C per (b, t, n):
// ~64 MB, 0.019 ms. It needs 163,840 exponentials (B L nh) and 5 fp32
// operations per (b, t, c, n) state-step, 671 M of them: 0.050 ms at the
// fp32 peak, which bounds it (chip_smoke.py's mamba2_scan_bound). Unfused,
// as B4's bits require, those are 5 issued instructions a state-step, so
// the issue floor is twice that. B4 fed expand_heads' inputs evaluated
// expf per (channel, state) step (671 M, ~8 of a state-step's ~14
// instructions) and read dt per channel, 42 MB in fp32, which the wrapper
// had built by repeat_interleave.
//
// Design.
// - Exponentials. A chunk's dt arrives per (step, head); the block
//   computes e = expf(dt * a) once per (step, head) it owns, and every
//   state-step reads it from shared memory: no expf in a per-state loop.
//   A block owns CW channels: G = min(CW / hd, 32) whole heads (hd <=
//   CW), or a tile of one head (hd > CW: ceil(hd / CW) tiles a head), so
//   the kernel evaluates
//       B * L * nh * (hd > CW ? ceil(hd / CW) : 1)
//   exponentials, CW = 128 at N <= 32; at N > 32 CW = 64 (B L nh at
//   zamba2's training shape), or 16 where 64 would give the card fewer
//   than two blocks an SM (kWideBlocks; 4 B L nh at a B = 1 prefill).
//   Given a counter (exp_count, null on the model's path), each thread
//   adds its evaluations to it once.
// - States. A lane owns 8 states of CPL adjacent channels (4 at N > 16,
//   1 on the small grids above), LPC = NT / 8 lanes a channel group (NT:
//   N rounded up to 8, 16, 32 or 64): 32 states at zamba2's N 64, where
//   B4 gives a lane 4 states of one channel. Each 16-byte shared read of
//   B or C then serves 16 state-steps (B4's 4), and B and C sit in shared
//   memory by quads in lane-major order, so a channel group's 8 lanes
//   read 8 words on distinct banks (a first layout, 16 states of one
//   channel a lane, read them 2-way bank-conflicted and ran at 0.418
//   device ms on the H100 at the training shape, bound by those reads).
//   On a small grid (a B = 1 prefill) a lane's step is cut to one
//   channel, for 4 times the blocks: 0.031 device ms on the H100 at (1,
//   100) where 4 channels took 0.041.
// - y's sum keeps B4's order: each quad of states in index order, a
//   lane's two quads, then the LPC lanes pairwise by xor levels. Those
//   levels transpose (a lane sends half its channels' partial sums to its
//   partner and keeps the other half): 4 shuffles a step for a lane's 4
//   channels where plain levels would take 12. The lane left with a
//   channel's sum stores its y; h_last is written once at the end.
// - Inputs. Chunks of kChunk = 16 steps of x, dt, B and C arrive by
//   cp.async into a two-deep raw ring, issued two chunks ahead. Between
//   barriers a chunk's end converts the next chunk once for the block:
//   e per (step, head), then dt x and e per (step, channel) in fp32 (B4's
//   dx), B and C to fp32 (states past N zero), so the step loop does no
//   conversion and reads only fp32 shared memory.
// Any L is taken, any hd (D = nh hd), 1 <= N <= 64; ragged chunks and
// tiles are masked.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;     // time steps a chunk
constexpr int kMaxN = 64;
constexpr int kMaxHeads = 32;  // whole heads a block owns at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// The block's geometry for state count NT: a lane owns SPL states of CPL
// adjacent channels (WIDE: the most, else one), LPC lanes a channel
// group.
template <int NT, bool WIDE>
struct Geo {
  static constexpr int SPL = 8;                    // states a lane
  static constexpr int LPC = NT / SPL;             // lanes a channel
  static constexpr int CPL = !WIDE ? 1 : LPC >= 4 ? 4 : LPC;  // channels a lane
  static constexpr int CW = kThreads / LPC * CPL;  // channels a block
  static constexpr int QL = SPL / 4;               // quads of states a lane
};

// One chunk as it arrives: x of the block's channels, dt of its heads,
// B and C (row stride NT).
template <typename T, int NT, int CW>
struct __align__(16) Raw {
  T x[kChunk][CW];
  T b[kChunk][NT];
  T c[kChunk][NT];
  float dt[kChunk][kMaxHeads];
};

// One chunk in fp32, as the steps read it. B and C are stored by quads in
// lane-major order: quad q of lane s (states 4 (s QL + q) ..) at quad
// position q LPC + s, so the lanes of a channel group read 16-byte words
// on distinct banks.
template <int NT, int CW>
struct __align__(16) Work {
  float b[kChunk][NT];       // states past N zero
  float c[kChunk][NT];
  float dx[kChunk][CW];      // dt_head * x, per channel
  float e[kChunk][CW];       // exp(dt a) of the channel's head
  float eh[kChunk][kMaxHeads];   // exp(dt a) per head
};

template <typename T, int NT, int CW>
struct __align__(16) Smem {
  Raw<T, NT, CW> raw[2];
  Work<NT, CW> work;
  float as[kMaxHeads];
};

struct Flags {
  bool vec_x;     // x rows and tiles 16-byte aligned: 16-byte copies
  bool vec_bc;    // N == NT and B, C rows 16-byte aligned
};

// What the block owns: channels chan0 .. chan0 + cw - 1, which are heads
// h0 .. h0 + nheads - 1 (whole heads) or one tile of head h0.
struct Own {
  long long row;    // b * L
  int chan0, cw, h0, nheads;
};

// Issue the copies of steps t0 .. t0 + tn - 1 into `st`.
template <typename T, int NT, int CW>
__device__ __forceinline__ void load_chunk(
    Raw<T, NT, CW>& st, const T* __restrict__ x,
    const float* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const Own& o, int t0, int tn, int D, int N,
    int nh, Flags f) {
  const int tid = threadIdx.x;
  if (f.vec_x) {
    constexpr int XV = 16 / sizeof(T);
    constexpr int XR = CW / XV;
    for (int i = tid; i < tn * XR; i += kThreads) {
      const int r = i / XR, cc = (i % XR) * XV;
      if (cc < o.cw)
        hopper::cp_async16(&st.x[r][cc],
                           x + (o.row + t0 + r) * D + o.chan0 + cc);
    }
  } else {
    for (int i = tid; i < tn * CW; i += kThreads) {
      const int r = i / CW, cc = i % CW;
      if (cc < o.cw) {
        const T* src = x + (o.row + t0 + r) * D + o.chan0 + cc;
        if constexpr (sizeof(T) == 4)
          hopper::cp_async4(&st.x[r][cc], src);
        else
          st.x[r][cc] = *src;
      }
    }
  }
  if (f.vec_bc) {
    constexpr int BV = 16 / sizeof(T);
    const long long off = (o.row + t0) * N;
    for (int i = tid; i < tn * NT / BV; i += kThreads) {
      hopper::cp_async16(&st.b[0][0] + i * BV, bm + off + i * BV);
      hopper::cp_async16(&st.c[0][0] + i * BV, cm + off + i * BV);
    }
  } else {
    for (int i = tid; i < tn * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const long long off = (o.row + t0 + r) * N + n;
      if constexpr (sizeof(T) == 4) {
        hopper::cp_async4(&st.b[r][n], bm + off);
        hopper::cp_async4(&st.c[r][n], cm + off);
      } else {
        st.b[r][n] = bm[off];
        st.c[r][n] = cm[off];
      }
    }
  }
  for (int i = tid; i < tn * o.nheads; i += kThreads) {
    const int r = i / o.nheads, g = i % o.nheads;
    hopper::cp_async4(&st.dt[r][g], dt + (o.row + t0 + r) * nh + o.h0 + g);
  }
}

// CPL-wide reads of a shared-memory row (16, 8 or 4 bytes).
template <int CPL>
__device__ __forceinline__ void loadc(const float* p, float (&v)[CPL]) {
  if constexpr (CPL == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (CPL == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

// The sums over a channel's LPC lanes, pairwise (xor levels 1, 2, 4, ...),
// of K values (one a channel) by transposing levels while a lane holds
// more than one (it sends half to its partner and keeps the other half),
// then plain ones. Lane s ends with max(1, K / LPC) sums, of channels
// chan_of(s) + 0, 1, ...
template <int K, int LPC>
__device__ __forceinline__ void lane_tree(float (&v)[K], int s) {
  int cnt = K;
#pragma unroll
  for (int m = 1; m < LPC; m <<= 1) {
    if (cnt > 1) {
      const int half = cnt / 2;
      const bool up = (s & m) != 0;
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        if (i < half) {
          const float send = up ? v[i] : v[i + half];
          const float keep = up ? v[i + half] : v[i];
          v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, m));
        }
      }
      cnt = half;
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], m));
    }
  }
}

template <int K, int LPC>
__device__ __forceinline__ int chan_of(int s) {
  int cnt = K, off = 0;
#pragma unroll
  for (int m = 1; m < LPC; m <<= 1) {
    if (cnt > 1) {
      cnt /= 2;
      if (s & m) off += cnt;
    }
  }
  return off;
}

// T: dtype of x, B and C; NT: state count rounded up, N the real one.
// Grid (blocks a batch row, B).
template <typename T, int NT, bool WIDE>
__global__ void __launch_bounds__(kThreads)
mamba2_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ h_last,
                  unsigned long long* __restrict__ exp_count, int L, int D,
                  int N, int nh, Flags f) {
  using G_ = Geo<NT, WIDE>;
  constexpr int SPL = G_::SPL, LPC = G_::LPC, CPL = G_::CPL, CW = G_::CW;
  constexpr int QL = G_::QL;
  constexpr int NOUT = CPL / LPC > 1 ? CPL / LPC : 1;   // sums a lane ends with
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<T, NT, CW>*>(smem_raw);

  const int tid = threadIdx.x;
  const int s = tid % LPC;                    // lane in the channel group
  const int ci0 = tid / LPC * CPL;            // its first channel
  const int hd = D / nh;
  Own o;
  o.row = static_cast<long long>(blockIdx.y) * L;
  if (hd <= CW) {
    const int g = min(CW / hd, kMaxHeads);
    o.h0 = blockIdx.x * g;
    o.nheads = min(g, nh - o.h0);
    o.chan0 = o.h0 * hd;
    o.cw = o.nheads * hd;
  } else {
    const int tiles = (hd + CW - 1) / CW;
    const int tile = blockIdx.x % tiles;
    o.h0 = blockIdx.x / tiles;
    o.nheads = 1;
    o.chan0 = o.h0 * hd + tile * CW;
    o.cw = min(CW, hd - tile * CW);
  }
  const int cout = ci0 + chan_of<CPL, LPC>(s);   // first channel it writes
  const bool writer = s < CPL;                   // one lane a sum
  if (tid < o.nheads) sm.as[tid] = a[o.h0 + tid];
  unsigned evaluated = 0;

  float h[CPL][SPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int j = 0; j < SPL; ++j) h[c][j] = 0.f;

  const int chunks = (L + kChunk - 1) / kChunk;
  auto issue = [&](int k) {
    if (k < chunks)
      load_chunk(sm.raw[k & 1], x, dt, bm, cm, o, k * kChunk,
                 min(kChunk, L - k * kChunk), D, N, nh, f);
    hopper::cp_async_commit();
  };
  // chunk k's raw stage (landed and published) into the work buffer, in
  // fp32: e once per (step, head), then per channel beside dt x; B and C
  // in the steps' order
  auto convert = [&](int k) {
    const Raw<T, NT, CW>& st = sm.raw[k & 1];
    Work<NT, CW>& w = sm.work;
    const int tn = min(kChunk, L - k * kChunk);
#pragma unroll 1
    for (int i = tid; i < tn * o.nheads; i += kThreads) {
      const int r = i / o.nheads, g = i % o.nheads;
      w.eh[r][g] = expf(__fmul_rn(st.dt[r][g], sm.as[g]));
      ++evaluated;
    }
    for (int i = tid; i < tn * NT; i += kThreads) {
      const int r = i / NT, n = i % NT;
      const int q = n / 4 % QL, ls = n / 4 / QL;
      const int at = 4 * (q * LPC + ls) + n % 4;
      w.b[r][at] = n < N ? to_f(st.b[r][n]) : 0.f;
      w.c[r][at] = n < N ? to_f(st.c[r][n]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < tn * CW; i += kThreads) {
      const int r = i / CW, cc = i % CW;
      float u = 0.f, e = 0.f;
      if (cc < o.cw) {
        const int g = hd <= CW ? cc / hd : 0;
        u = __fmul_rn(st.dt[r][g], to_f(st.x[r][cc]));
        e = w.eh[r][g];
      }
      w.dx[r][cc] = u;
      w.e[r][cc] = e;
    }
  };
  // one step: the lane's CPL x SPL states, y's sums in B4's order
  int t0 = 0;
  auto step = [&](int r) {
    const Work<NT, CW>& w = sm.work;
    float e[CPL], u[CPL];
    loadc<CPL>(&w.e[r][ci0], e);
    loadc<CPL>(&w.dx[r][ci0], u);
    float p[CPL][QL];
#pragma unroll
    for (int q = 0; q < QL; ++q) {
      const int at = 4 * (q * LPC + s);
      const float4 b4 = *reinterpret_cast<const float4*>(&w.b[r][at]);
      const float4 c4 = *reinterpret_cast<const float4*>(&w.c[r][at]);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& hh = h[c][4 * q + j];
          // unfused, as B4 and the plain version's separate passes
          hh = __fadd_rn(__fmul_rn(e[c], hh), __fmul_rn(u[c], bv[j]));
          const float hc = __fmul_rn(hh, cv[j]);
          p[c][q] = j == 0 ? hc : __fadd_rn(p[c][q], hc);
        }
      }
    }
    float v[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
#pragma unroll
      for (int m = QL; m > 1; m >>= 1)
#pragma unroll
        for (int i = 0; i < m / 2; ++i)
          p[c][i] = __fadd_rn(p[c][2 * i], p[c][2 * i + 1]);
      v[c] = p[c][0];
    }
    lane_tree<CPL, LPC>(v, s);
    if (writer) {
      float* yr = y + (o.row + t0 + r) * D + o.chan0;
#pragma unroll
      for (int i = 0; i < NOUT; ++i)
        if (cout + i < o.cw) yr[cout + i] = v[i];
    }
  };

  issue(0);
  issue(1);
  hopper::cp_async_wait<1>();     // chunk 0 has landed
  __syncthreads();
  convert(0);
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    issue(k + 2);                 // into chunk k's raw stage, converted
    t0 = k * kChunk;
    const int tn = min(kChunk, L - t0);
    if (tn == kChunk) {
#pragma unroll 4
      for (int r = 0; r < kChunk; ++r) step(r);
    } else {
#pragma unroll 1
      for (int r = 0; r < tn; ++r) step(r);
    }
    hopper::cp_async_wait<1>();   // chunk k + 1 has landed
    __syncthreads();              // the work buffer is free
    if (k + 1 < chunks) convert(k + 1);
    __syncthreads();
  }
  hopper::cp_async_wait<0>();     // no copy outlives the block

  float* hb = h_last + (static_cast<long long>(blockIdx.y) * D + o.chan0 +
                        ci0) * N;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int n = s * SPL + j;
      if (ci0 + c < o.cw && n < N) hb[c * N + n] = h[c][j];
    }
  }
  if (exp_count != nullptr && evaluated != 0)
    atomicAdd(exp_count, static_cast<unsigned long long>(evaluated));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  const void* x; const float* dt; const float* a; const void* bm;
  const void* cm; float* y; float* h_last; unsigned long long* exp_count;
  int B, L, D, N, nh;
};

// Blocks a batch row for CW channels a block.
int row_blocks(int cw, int hd, int nh) {
  if (hd <= cw) {
    const int g = std::min(cw / hd, kMaxHeads);
    return (nh + g - 1) / g;
  }
  return nh * ((hd + cw - 1) / cw);
}

template <typename T, int NT, bool WIDE>
int launch_g(const Args& p, cudaStream_t stream) {
  constexpr int CW = Geo<NT, WIDE>::CW;
  const int hd = p.D / p.nh;
  Flags f;
  f.vec_x = hd % (16 / sizeof(T)) == 0 && aligned16(p.x);
  f.vec_bc = p.N == NT && (p.N * sizeof(T)) % 16 == 0 && aligned16(p.bm) &&
             aligned16(p.cm);
  constexpr int smem = static_cast<int>(sizeof(Smem<T, NT, CW>));
  auto kern = mamba2_fwd_kernel<T, NT, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(row_blocks(CW, hd, p.nh), p.B), kThreads, smem, stream>>>(
      static_cast<const T*>(p.x), p.dt, p.a, static_cast<const T*>(p.bm),
      static_cast<const T*>(p.cm), p.y, p.h_last, p.exp_count, p.L, p.D,
      p.N, p.nh, f);
  return static_cast<int>(cudaGetLastError());
}

// At N > 32 a lane takes 4 channels when that still gives the card two
// blocks an SM (kWideBlocks), else one (a B = 1 prefill: 4 times the
// blocks, each lane's step a quarter as long).
constexpr int kWideBlocks = 2 * 132;

template <typename T, int NT>
int launch_n(const Args& p, cudaStream_t s) {
  if constexpr (NT == 64) {
    if (static_cast<long long>(p.B) *
            row_blocks(Geo<NT, true>::CW, p.D / p.nh, p.nh) < kWideBlocks)
      return launch_g<T, NT, false>(p, s);
  }
  return launch_g<T, NT, true>(p, s);
}

template <typename T>
int launch(const Args& p, cudaStream_t s) {
  if (p.N <= 8) return launch_n<T, 8>(p, s);
  if (p.N <= 16) return launch_n<T, 16>(p, s);
  if (p.N <= 32) return launch_n<T, 32>(p, s);
  return launch_n<T, 64>(p, s);
}

}  // namespace

extern "C" {

// B4 per head. dtype of x, B and C: 0 float32, 1 bfloat16, 2 float16.
// x (B, L, D), dt (B, L, nh) fp32, a (nh,) fp32, B/C (B, L, N); y (B, L, D)
// fp32, h_last (B, D, N) fp32; D = nh * hd; all contiguous. exp_count:
// null, or a uint64 on the device to which the kernel adds the
// exponentials it evaluates. Returns cudaGetLastError().
int ssm_scan_heads_fwd(int dtype, const void* x, const float* dt,
                       const float* a, const void* bm, const void* cm,
                       float* y, float* h_last,
                       unsigned long long* exp_count, int B, int L, int D,
                       int N, int nh, void* stream) {
  if (N < 1 || N > kMaxN || B < 1 || B > 65535 || L < 1 || D < 1 ||
      nh < 1 || D % nh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{x, dt, a, bm, cm, y, h_last, exp_count, B, L, D, N, nh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, s);
    case 1: return launch<__nv_bfloat16>(p, s);
    case 2: return launch<__half>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
