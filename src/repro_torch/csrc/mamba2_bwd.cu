// B4-bwd in Mamba-2's layout for Hopper (sm_90a): the backward of the
// selective scan when the decay is one scalar a head, as Mamba-2 (SSD with
// one group) has it.
//
//   e_t = exp(dt_t a)  (one per batch row, step and head)
//   h_t[c, n] = e_t h_{t-1}[c, n] + dt_t x_t[c] B_t[n];  y_t[c] = h_t[c] . C_t
//
// over the hd channels c of a head, from h_{-1} = 0. Replaces no TPU kernel:
// repro differentiates its plain-JAX chunked scan (src/repro/models/
// layers.py _chunked_ssm_scan on mamba2_apply's a_full and bx) with
// jax.grad. With g_t the adjoint of h_t (fp32 throughout):
//
//   g_{L-1} = dh_last + dy_{L-1} C_{L-1};  g_t = dy_t C_t + e_{t+1} g_{t+1}
//   dx_t[c] = dt_t gb_t[c],  gb_t[c] = sum_n g_t[c, n] B_t[n]
//   S_t     = sum_{c, n} g_t[c, n] h_{t-1}[c, n]
//   ddt_t   = sum_c x_t[c] gb_t[c] + a e_t S_t          (per head)
//   da      = sum_{b, t} dt_t e_t S_t                    (per head)
//   dB_t[n] = sum_c g_t[c, n] dt_t x_t[c];  dC_t[n] = sum_c dy_t[c] h_t[c, n]
//
// (the last two over every channel of every head).
//
// What bounds it. At zamba2's training shape (B 16, L 128, D 5120 in 80
// heads of 64, N 64) the function reads ~64 MB and does 14 fp32 operations
// per (b, t, c, n) state-step, 671 M of them: the state again (3), g_t
// (2), the carry e_{t+1} g_{t+1} (1), and a product and a sum each for gb,
// S, dB and dC (8); ddt's and da's other terms are per (b, t, c) or per
// (b, t, head). That is 0.14 ms of fp32 issue on the H100 against 0.03 ms
// of memory, so issue bounds it. It needs one exponential per (b, t,
// head), 0.16 M. The per-channel B4-bwd
// (ssm_scan.cu, ssm_bwd_kernel), fed this layout expanded, evaluates
// exp(dt a) per (channel, state), three times a state-step (1929 M),
// holds a chunk's states in 244 registers a thread (two blocks of 4
// warps an SM), and writes ddt per channel and da per (channel, state)
// for autograd to sum again.
//
// Design.
// - A block owns one (b, head) at a time (it walks G heads of one batch
//   row in turn, G = heads_per_block; a head wider than 64 channels is
//   walked in tiles of 64). Its threads lay the head's states out with the
//   channels across the lanes and the states across the warps: lane l
//   holds channels 2l and 2l + 1 (CPL = 2; CPL = 1 and channel l for
//   hd <= 32), warp w states 4w .. 4w + 3. So a thread owns CPL x 4
//   states, a warp every channel of 4 states, and the block (NT / 4
//   warps, NT = N rounded up to 8, 16, 32 or 64) every state: 16 warps
//   of 32 at zamba2's shape. Padded channels (past hd) and states (past
//   N) hold x = dy = B = C = 0 and stay exactly 0. This layout puts the
//   sum over the states (dx) inside a thread and across warps, through
//   shared memory, and the sum over the channels (dB, dC) across lanes.
// - Exponentials. When a chunk's stage lands in the first pass (below),
//   its exp(dt_t a) is computed once per step into the stage and into a
//   (B, nh, L) scratch that the second pass stages beside dt; every
//   state-step reads it from shared memory as a broadcast. No expf is
//   left in a per-state loop. Given a counter (exp_count, null on the
//   training path), each evaluation adds one to it.
// - States are recomputed, never recovered by dividing by e_t (which
//   underflows at a = -80): a first pass runs the recurrence and writes h
//   at every kChunk = 8 steps to a block-private scratch (~16 KB a chunk
//   a head, L2-resident); the second walks the chunks in reverse, each
//   in two sub-chunks of kSub = 4 steps: the sub-chunk's start is
//   recomputed from the chunk's checkpoint (staged in shared memory one
//   chunk ahead by cp.async), its 4 steps' states kept in registers, and
//   the 4 steps walked backward. A thread holds 4 x 8 history values,
//   not the per-channel kernel's 16 x 4 with the whole chunk unrolled,
//   so it stays at 128 registers with no spills: one block of 512
//   threads (16 warps) an SM at zamba2's shape, twice the per-channel
//   kernel's 8 warps. The price is 1.5 forward recomputes a chunk.
//   (Checkpoints every 4 steps instead, with no recompute of a chunk's
//   start, measured slower: twice the scratch traffic.)
// - Reductions, each in a fixed order (no atomics: two launches give the
//   same bits). Cross-lane shuffles are the step loop's dearest
//   instructions on this card (dropping the 8 a step that remain saves
//   ~15% of the kernel's time), so the sums that can go through shared
//   memory do:
//   - dB, dC: a thread sums its channels; three transposing xor levels
//     over the warp's lanes (7 shuffles for 8 values) leave each lane one
//     of four partial sums of one value, which are summed in lane order
//     when the chunk ends; the block's sums are added to a (groups, B, L,
//     N) partial (the block's first head stores, later heads add), which
//     a second kernel (mamba2_bwd_reduce) sums over the groups in order:
//     at most ~64 MiB, the wrapper's heads_per_block sees to it.
//   - gb (dx): a thread sums its 4 states; the warps' partials are summed
//     in warp order when the chunk ends.
//   - ddt, da: a thread's x . gb and g . h_{t-1} of a step (one
//     transposing level, 1 shuffle) are summed over the block's lanes in
//     order when the chunk ends; ddt_t is written per head, da summed over
//     the chunk's steps and over the chunks in order, once per (b, head)
//     into a (B, nh) partial that the second kernel sums over the batch
//     rows. Neither a per-channel ddt nor a per-state da is written.
//   A chunk's sums run after the next chunk's barrier, beside the other
//   warps' walk of that chunk, from double partial buffers: one barrier
//   a chunk.
// - Loads: a 3-stage cp.async ring of 8-step chunks (x, dy, (dt, e), and
//   B and C interleaved by quads of states so that one 16-byte read gives
//   a thread its 4 states of both), two chunks ahead, 16-byte copies where
//   rows are aligned.
// - Products are fused (fmaf): the kernel is held to its plain version
//   (ssm_scan_heads_bwd_plain) at tolerances, not bitwise. e_t is B4's
//   own expf(dt * a), bit for bit.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 8;      // steps between checkpoints (a stage)
constexpr int kSub = 4;        // steps whose states a thread keeps at once
constexpr int kStages = 3;     // chunks k + 1 and k + 2 load while k runs
constexpr int kNPer = 4;       // states a thread owns for each channel
constexpr int kMaxN = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// A lane's CPL adjacent channels of a shared-memory row as fp32 (one
// 2-, 4- or 8-byte read).
template <int CPL>
__device__ __forceinline__ void loadc(const float* p, float (&v)[CPL]) {
  if constexpr (CPL == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *p;
  }
}
template <int CPL>
__device__ __forceinline__ void loadc(const __nv_bfloat16* p,
                                      float (&v)[CPL]) {
  if constexpr (CPL == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(u << 16);
    v[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int CPL>
__device__ __forceinline__ void loadc(const __half* p, float (&v)[CPL]) {
  if constexpr (CPL == 2) {
    const __half2 h = *reinterpret_cast<const __half2*>(p);
    v[0] = __low2float(h); v[1] = __high2float(h);
  } else {
    v[0] = __half2float(*p);
  }
}

// One ring stage: kChunk steps of the tile's CT channels of x and dy, the
// head's (dt, e), and B and C interleaved by quads of states (row: B[0..3],
// C[0..3], B[4..7], ...; states past N zero).
template <typename T, int NT, int CT>
struct __align__(16) Stage {
  T x[kChunk][CT];
  float dy[kChunk][CT];
  T bc[kChunk][2 * NT];
  float2 dte[kChunk];
};

// The second pass's partial buffers are double: iteration i writes those
// of parity i & 1 while the block sums those of iteration i - 1.
template <typename T, int NT, int CPL>
struct __align__(16) Smem {
  static constexpr int W = NT / kNPer;
  static constexpr int CT = 32 * CPL;
  static constexpr int NTH = 32 * W;
  Stage<T, NT, CT> ring[kStages];
  float ckb[2][NT * CT];           // each thread's checkpoint slice
  float gred[2][W][kChunk][CT];    // each warp's gb partial (its 4 states)
  float dbp[2][kChunk][W][32];     // each lane's dB / dC partial
  float sp[2][kChunk][NTH];        // each lane's x . gb or g . h_{t-1}
  float2 dteb[2][kChunk];          // the chunk's (dt, e), kept for its end
  float dterm[2][kChunk];          // da's terms of a chunk
};

struct Flags {
  bool vec_x;     // x rows and tiles 16-byte aligned: 16-byte copies
  bool vec_dy;    // dy alike
  bool vec_bc;    // N == NT and B, C rows aligned: quad copies
};

// What a stage loads: steps t0 .. t0 + tn - 1 of one (b, head, tile).
struct Slice {
  long long row;    // b * L
  long long erow;   // (b * nh + h) * L: the head's row of e
  int t0, tn;
  int d0, cw;       // the tile's first channel and its width (<= CT)
  int h;
};

template <typename T, int NT, int CT, int NTH>
__device__ __forceinline__ void load_stage(
    Stage<T, NT, CT>& st, const T* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ escr, const T* __restrict__ bm,
    const T* __restrict__ cm, const Slice& s, int D, int N, int nh,
    bool with_dy_c, bool copy_e, Flags f) {
  const int tid = threadIdx.x;
  if (f.vec_x) {
    constexpr int XV = 16 / sizeof(T);
    constexpr int XR = CT / XV;
    for (int i = tid; i < s.tn * XR; i += NTH) {
      const int r = i / XR, cc = (i % XR) * XV;
      if (cc < s.cw)
        hopper::cp_async16(&st.x[r][cc],
                           x + (s.row + s.t0 + r) * D + s.d0 + cc);
      else
        hopper::cp_async16(&st.x[r][cc], x, 0);     // zeros
    }
  } else {
    for (int i = tid; i < s.tn * CT; i += NTH) {
      const int r = i / CT, cc = i % CT;
      if (cc < s.cw) {
        const T* src = x + (s.row + s.t0 + r) * D + s.d0 + cc;
        if constexpr (sizeof(T) == 4)
          hopper::cp_async4(&st.x[r][cc], src);
        else
          st.x[r][cc] = *src;
      } else {
        st.x[r][cc] = from_f<T>(0.f);
      }
    }
  }
  if (with_dy_c) {
    if (f.vec_dy) {
      constexpr int R = CT / 4;
      for (int i = tid; i < s.tn * R; i += NTH) {
        const int r = i / R, cc = (i % R) * 4;
        if (cc < s.cw)
          hopper::cp_async16(&st.dy[r][cc],
                             dy + (s.row + s.t0 + r) * D + s.d0 + cc);
        else
          hopper::cp_async16(&st.dy[r][cc], dy, 0);
      }
    } else {
      for (int i = tid; i < s.tn * CT; i += NTH) {
        const int r = i / CT, cc = i % CT;
        if (cc < s.cw)
          hopper::cp_async4(&st.dy[r][cc],
                            dy + (s.row + s.t0 + r) * D + s.d0 + cc);
        else
          st.dy[r][cc] = 0.f;
      }
    }
  }
  // B (and C): quad q of row r to bc[r][8 q] (and bc[r][8 q + 4])
  const int nmat = with_dy_c ? 2 : 1;
  if (f.vec_bc) {
    constexpr int Q = NT / 4;
    for (int i = tid; i < s.tn * Q * nmat; i += NTH) {
      const int m = i / (s.tn * Q), rq = i % (s.tn * Q);
      const int r = rq / Q, q = rq % Q;
      const T* src = (m ? cm : bm) + (s.row + s.t0 + r) * N + 4 * q;
      T* dst = &st.bc[r][8 * q + 4 * m];
      if constexpr (sizeof(T) == 4)
        hopper::cp_async16(dst, src);
      else
        hopper::cp_async8(dst, src);
    }
  } else {
    for (int i = tid; i < s.tn * NT * nmat; i += NTH) {
      const int m = i / (s.tn * NT), rn = i % (s.tn * NT);
      const int r = rn / NT, n = rn % NT;
      T* dst = &st.bc[r][8 * (n / 4) + 4 * m + n % 4];
      if (n < N) {
        const T* src = (m ? cm : bm) + (s.row + s.t0 + r) * N + n;
        if constexpr (sizeof(T) == 4)
          hopper::cp_async4(dst, src);
        else
          *dst = *src;
      } else {
        *dst = from_f<T>(0.f);
      }
    }
  }
  if (tid < s.tn) {
    hopper::cp_async4(&st.dte[tid].x, dt + (s.row + s.t0 + tid) * nh + s.h);
    if (copy_e) hopper::cp_async4(&st.dte[tid].y, escr + s.erow + s.t0 + tid);
  }
}

// Four 16-bit values (two 32-bit words) as fp32.
__device__ __forceinline__ void unpack4(uint2 u, const __nv_bfloat16*,
                                        float (&v)[4]) {
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack4(uint2 u, const __half*,
                                        float (&v)[4]) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[2 * i] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[i] & 0xffffu)));
    v[2 * i + 1] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(w[i] >> 16)));
  }
}

// A quad of B (load_b), or of B and C (load_bc), from an interleaved
// B/C row of the stage, as fp32 (one 8- or 16-byte read a matrix in
// fp32, one 8- or 16-byte read in all in 16 bits).
__device__ __forceinline__ void load_b(const float* p, float (&bv)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  bv[0] = f.x; bv[1] = f.y; bv[2] = f.z; bv[3] = f.w;
}
template <typename T>
__device__ __forceinline__ void load_b(const T* p, float (&bv)[4]) {
  unpack4(*reinterpret_cast<const uint2*>(p), p, bv);
}
template <typename T>
__device__ __forceinline__ void load_bc(const T* p, float (&bv)[4],
                                        float (&cv)[4]) {
  if constexpr (sizeof(T) == 4) {
    load_b(p, bv);
    load_b(p + 4, cv);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);   // 8 values
    unpack4(make_uint2(u.x, u.y), p, bv);
    unpack4(make_uint2(u.z, u.w), p, cv);
  }
}

// Grid (groups, B): block (g, b) walks heads g * G .. g * G + G - 1 (the
// last group may hold fewer) of batch row b. T: dtype of x, B, C, dx, dB,
// dC; NT: N rounded up; CPL: channels a lane (a tile is 32 * CPL
// channels; lane l owns channels CPL l .. CPL l + CPL - 1).
template <typename T, int NT, int CPL>
__global__ void __launch_bounds__(32 * NT / kNPer, 1)
mamba2_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ dy,
                  const float* __restrict__ dh_last, T* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ db_part,
                  float* __restrict__ dc_part, float* __restrict__ da_part,
                  float* __restrict__ escr, float* __restrict__ ckpt,
                  unsigned long long* __restrict__ exp_count, int L, int D,
                  int N, int nh, int G, Flags f) {
  constexpr int W = NT / kNPer;          // warps: states 4w .. 4w + 3
  constexpr int NTH = 32 * W;
  constexpr int CT = 32 * CPL;           // channels a tile
  constexpr int S = CPL * kNPer;         // states a thread
  using Sm = Smem<T, NT, CPL>;
  using St = Stage<T, NT, CT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, B = gridDim.y;
  const long long row = static_cast<long long>(b) * L;
  const int hd = D / nh;
  const int tiles = (hd + CT - 1) / CT;
  const int chunks = (L + kChunk - 1) / kChunk;
  const int h_begin = blockIdx.x * G, h_end = min(nh, h_begin + G);
  // this block's checkpoints: chunks - 1 of NTH * S floats
  float* ck = ckpt + (static_cast<long long>(b) * gridDim.x + blockIdx.x) *
                         (chunks - 1) * (NTH * S) + tid * S;
  const long long part_row = (static_cast<long long>(blockIdx.x) * B + b) * L;
  const int n0 = warp * kNPer;           // this thread's states
  const int c0 = CPL * lane;             // and channels

  bool first_item = true;
  for (int h = h_begin; h < h_end; ++h) {
    const float av = a[h];
    const long long erow = (static_cast<long long>(b) * nh + h) * L;
    float da_acc = 0.f;                  // thread 0
    for (int tile = 0; tile < tiles; ++tile) {
      const bool first_tile = tile == 0;
      Slice sl;
      sl.row = row;
      sl.erow = erow;
      sl.h = h;
      sl.d0 = h * hd + tile * CT;
      sl.cw = min(CT, hd - tile * CT);
      auto slice = [&](int k) {
        Slice s = sl;
        s.t0 = k * kChunk;
        s.tn = min(kChunk, L - s.t0);
        return s;
      };
      // One forward step of this thread's states.
      auto fwd = [&](float (&hh)[CPL][kNPer], const St& st, int r) {
        const float2 de = st.dte[r];
        float bv[kNPer], xv[CPL];
        load_b(&st.bc[r][2 * n0], bv);
        loadc<CPL>(&st.x[r][c0], xv);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const float u = __fmul_rn(de.x, xv[j]);
#pragma unroll
          for (int i = 0; i < kNPer; ++i)
            hh[j][i] = fmaf(de.y, hh[j][i], __fmul_rn(u, bv[i]));
        }
      };

      // Pass 1: every chunk's e (the head's first tile), and the
      // recurrence over chunks 0 .. chunks - 2, writing h at the end of
      // each (the state before chunk k + 1).
      float hf[CPL][kNPer];              // the state, forward
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int i = 0; i < kNPer; ++i) hf[j][i] = 0.f;
#pragma unroll
      for (int k = 0; k < kStages - 1; ++k) {
        if (k < chunks)
          load_stage<T, NT, CT, NTH>(sm.ring[k], x, dy, dt, escr, bm, cm,
                                     slice(k), D, N, nh, false, !first_tile,
                                     f);
        hopper::cp_async_commit();
      }
      // e of chunk k, by thread r < tn, from the dt it copied itself (its
      // copies of chunk k have landed once at most one later group is in
      // flight); the next barrier publishes it
      auto chunk_e = [&](int k) {
        if (first_tile && k < chunks && tid < min(kChunk, L - k * kChunk)) {
          hopper::cp_async_wait<1>();
          St& st = sm.ring[k % kStages];
          const float ev = expf(__fmul_rn(st.dte[tid].x, av));
          st.dte[tid].y = ev;
          escr[erow + k * kChunk + tid] = ev;
          if (exp_count != nullptr) atomicAdd(exp_count, 1ULL);
        }
      };
      chunk_e(0);
      for (int k = 0; k < chunks; ++k) {
        hopper::cp_async_wait<kStages - 2>();
        __syncthreads();
        const int kn = k + kStages - 1;
        if (kn < chunks)
          load_stage<T, NT, CT, NTH>(sm.ring[kn % kStages], x, dy, dt, escr,
                                     bm, cm, slice(kn), D, N, nh, false,
                                     !first_tile, f);
        hopper::cp_async_commit();
        const St& st = sm.ring[k % kStages];
        if (k == chunks - 1) break;
#pragma unroll
        for (int r = 0; r < kChunk; ++r) fwd(hf, st, r);
        float* dst = ck + static_cast<long long>(k) * (NTH * S);
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          *reinterpret_cast<float4*>(dst + 4 * j) =
              make_float4(hf[j][0], hf[j][1], hf[j][2], hf[j][3]);
        chunk_e(k + 1);
      }
      hopper::cp_async_wait<0>();
      __syncthreads();   // e and the checkpoints are visible to the block

      // Pass 2: the chunks in reverse. Iteration i walks chunk k =
      // chunks - 1 - i backward into the partial buffers of parity i & 1;
      // the block sums chunk i - 1's buffers (its "end") after iteration
      // i's barrier, beside the other warps' walk of chunk i, so one
      // barrier a chunk serves both.
      float gc[CPL][kNPer];              // carry: e_{t+1} g_{t+1}
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = c0 + j;
#pragma unroll
        for (int i = 0; i < kNPer; ++i) {
          const int n = n0 + i;
          gc[j][i] = (dh_last != nullptr && c < sl.cw && n < N)
                         ? dh_last[(static_cast<long long>(b) * D + sl.d0 +
                                    c) * N + n]
                         : 0.f;
        }
      }
      // this thread's checkpoint before iteration i's chunk, staged one
      // iteration ahead in its own slice of ckb (no barrier needed)
      auto load_ck = [&](int i) {
        const int k = chunks - 1 - i;
        float* dst = &sm.ckb[i & 1][tid * S];
#pragma unroll
        for (int j = 0; j < S; j += 4) {
          if (k > 0)
            hopper::cp_async16(dst + j, ck + static_cast<long long>(k - 1) *
                                                 (NTH * S) + j);
          else
            hopper::cp_async16(dst + j, ck, 0);    // zeros
        }
      };
      // The end of iteration j's chunk: dx, the dB / dC partial (pb, pc:
      // its earlier value, read at that iteration), ddt and da's terms.
      auto chunk_end = [&](int j, float pb, float pc) {
        const int buf = j & 1;
        const int t0 = (chunks - 1 - j) * kChunk;
        const int tn = min(kChunk, L - t0);
        if (tid == 0 && j > 0) {         // da: the chunk before's terms
#pragma unroll
          for (int r = 0; r < kChunk; ++r) da_acc += sm.dterm[buf ^ 1][r];
        }
        // dx = dt * gb, gb summed over the warps in order
        for (int e = tid; e < tn * CT; e += NTH) {
          const int r = e / CT, c = e % CT;
          if (c < sl.cw) {
            float s = sm.gred[buf][0][r][c];
#pragma unroll
            for (int w = 1; w < W; ++w) s += sm.gred[buf][w][r][c];
            dx[(row + t0 + r) * D + sl.d0 + c] =
                from_f<T>(__fmul_rn(sm.dteb[buf][r].x, s));
          }
        }
        // dB, dC: the four lane partials in order; the block's first item
        // stores, later items add
        if (tid < tn * N) {
          const int pr = tid / N, pn = tid % N;
          const float4 pbv = *reinterpret_cast<const float4*>(
              &sm.dbp[buf][pr][pn / kNPer][4 * (pn % kNPer)]);
          const float4 pcv = *reinterpret_cast<const float4*>(
              &sm.dbp[buf][pr][pn / kNPer][4 * (kNPer + pn % kNPer)]);
          const float sb = ((pbv.x + pbv.y) + pbv.z) + pbv.w;
          const float sc = ((pcv.x + pcv.y) + pcv.z) + pcv.w;
          const long long off = (part_row + t0 + pr) * N + pn;
          db_part[off] = first_item ? sb : pb + sb;
          dc_part[off] = first_item ? sc : pc + sc;
        }
        // ddt per head (a later tile adds) and da's terms: warp w takes
        // steps w, w + W, ...: lane l sums the partials of lane l of every
        // warp (lanes < 16 hold x . gb, the rest g . h_{t-1}), then an xor
        // tree over 16 lanes
        for (int r = warp; r < kChunk; r += W) {
          float part = 0.f;
          if (r < tn) {
#pragma unroll
            for (int w = 0; w < W; ++w) part += sm.sp[buf][r][32 * w + lane];
          }
#pragma unroll
          for (int o = 8; o >= 1; o >>= 1)
            part += __shfl_xor_sync(kFull, part, o);
          const float s2 = __shfl_sync(kFull, part, 16);
          if (lane == 0) {
            float term = 0.f;
            if (r < tn) {
              const float2 de = sm.dteb[buf][r];
              const float dv = fmaf(__fmul_rn(av, de.y), s2, part);
              float* p = ddt + (row + t0 + r) * nh + h;
              *p = first_tile ? dv : *p + dv;
              term = __fmul_rn(__fmul_rn(de.x, de.y), s2);
            }
            sm.dterm[buf][r] = term;
          }
        }
      };

      load_ck(0);
      hopper::cp_async_commit();
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        const int k = chunks - 1 - i;
        if (k >= 0)
          load_stage<T, NT, CT, NTH>(sm.ring[i], x, dy, dt, escr, bm, cm,
                                     slice(k), D, N, nh, true, true, f);
        hopper::cp_async_commit();
      }
      float pb = 0.f, pc = 0.f;          // chunk i - 1's dB / dC partial
      for (int i = 0; i < chunks; ++i) {
        const int k = chunks - 1 - i;
        // everything but the latest group: iteration i's stage and
        // checkpoint
        hopper::cp_async_wait<1>();
        __syncthreads();
        if (i + 1 < chunks) load_ck(i + 1);
        hopper::cp_async_commit();
        const int in = i + kStages - 1, kn = chunks - 1 - in;
        if (kn >= 0)
          load_stage<T, NT, CT, NTH>(sm.ring[in % kStages], x, dy, dt, escr,
                                     bm, cm, slice(kn), D, N, nh, true, true,
                                     f);
        hopper::cp_async_commit();
        const St& st = sm.ring[i % kStages];
        const int buf = i & 1;
        const int t0 = k * kChunk;
        const int tn = min(kChunk, L - t0);
        if (tid < kChunk) sm.dteb[buf][tid] = st.dte[tid];
        if (i > 0) chunk_end(i - 1, pb, pc);
        // this chunk's dB / dC partial, read now for its end
        if (tid < tn * N && !first_item) {
          const long long off = (part_row + t0 + tid / N) * N + tid % N;
          pb = db_part[off];
          pc = dc_part[off];
        }
        const int nsub = (tn + kSub - 1) / kSub;
#pragma unroll 1
        for (int sub = nsub - 1; sub >= 0; --sub) {
          const int r0 = sub * kSub;
          // the state before the sub-chunk (from the chunk's checkpoint,
          // read again for each sub-chunk rather than held), then its
          // states
          float hs[CPL][kNPer];
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const float4 c4 = *reinterpret_cast<const float4*>(
                &sm.ckb[buf][tid * S + 4 * j]);
            hs[j][0] = c4.x; hs[j][1] = c4.y;
            hs[j][2] = c4.z; hs[j][3] = c4.w;
          }
#pragma unroll
          for (int r = 0; r < kChunk - kSub; ++r)
            if (r < r0) fwd(hs, st, r);
          float hist[kSub][CPL][kNPer];
#pragma unroll
          for (int q = 0; q < kSub; ++q) {
#pragma unroll
            for (int j = 0; j < CPL; ++j)
#pragma unroll
              for (int i2 = 0; i2 < kNPer; ++i2)
                hist[q][j][i2] = q == 0 ? hs[j][i2]
                                        : hist[q > 0 ? q - 1 : 0][j][i2];
            if (r0 + q < tn) fwd(hist[q], st, r0 + q);
          }
#pragma unroll
          for (int q = kSub - 1; q >= 0; --q) {
            const int r = r0 + q;
            if (r >= tn) continue;
            const float2 de = st.dte[r];
            float bv[kNPer], cv[kNPer], xv[CPL], dyv[CPL], gb[CPL];
            load_bc(&st.bc[r][2 * n0], bv, cv);
            loadc<CPL>(&st.x[r][c0], xv);
            loadc<CPL>(&st.dy[r][c0], dyv);
            float v[2 * kNPer], s2 = 0.f;
#pragma unroll
            for (int i2 = 0; i2 < 2 * kNPer; ++i2) v[i2] = 0.f;
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              const float u = __fmul_rn(de.x, xv[j]);
              gb[j] = 0.f;
#pragma unroll
              for (int i2 = 0; i2 < kNPer; ++i2) {
                const float hp = q == 0 ? hs[j][i2]
                                        : hist[q > 0 ? q - 1 : 0][j][i2];
                const float g = fmaf(dyv[j], cv[i2], gc[j][i2]);
                gb[j] = fmaf(g, bv[i2], gb[j]);
                s2 = fmaf(g, hp, s2);
                v[i2] = fmaf(g, u, v[i2]);                    // dB
                v[kNPer + i2] = fmaf(dyv[j], hist[q][j][i2],  // dC
                                     v[kNPer + i2]);
                gc[j][i2] = __fmul_rn(de.y, g);
              }
            }
            float s1 = 0.f;
#pragma unroll
            for (int j = 0; j < CPL; ++j) s1 = fmaf(xv[j], gb[j], s1);
            if constexpr (CPL == 2)
              *reinterpret_cast<float2*>(&sm.gred[buf][warp][r][c0]) =
                  make_float2(gb[0], gb[1]);
            else
              sm.gred[buf][warp][r][c0] = gb[0];
            // (x . gb, g . h_{t-1}): one transposing level, lanes < 16
            // keep the first summed over lane pairs, the rest the second
            float p2[2] = {s1, s2};
            sm.sp[buf][r][tid] =
                hopper::warp_transpose_sum<2, false>(p2, lane);
            // dB, dC over the warp's lanes (its channels), three of five
            // levels: lane l holds one of four partial sums of value l / 4
            sm.dbp[buf][r][warp][lane] =
                hopper::warp_transpose_sum<2 * kNPer, false>(v, lane);
          }
        }
      }
      hopper::cp_async_wait<0>();
      __syncthreads();
      chunk_end(chunks - 1, pb, pc);
      __syncthreads();   // the ring and the partial buffers are free
      if (tid == 0) {
#pragma unroll
        for (int r = 0; r < kChunk; ++r)
          da_acc += sm.dterm[(chunks - 1) & 1][r];
      }
      first_item = false;
    }
    if (tid == 0) da_part[static_cast<long long>(b) * nh + h] = da_acc;
  }
}

// dB, dC = the groups' partials summed in group order, in the input dtype;
// da = the batch rows' partials summed in row order.
template <typename T>
__global__ void mamba2_bwd_reduce(const float* __restrict__ db_part,
                                  const float* __restrict__ dc_part,
                                  const float* __restrict__ da_part,
                                  T* __restrict__ db, T* __restrict__ dc,
                                  float* __restrict__ da, int groups, int B,
                                  int L, int N, int nh) {
  const long long rows = static_cast<long long>(B) * L * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < rows + nh; i += stride) {
    if (i < rows) {
      float sb = db_part[i], sc = dc_part[i];
      for (int g = 1; g < groups; ++g) {
        sb += db_part[g * rows + i];
        sc += dc_part[g * rows + i];
      }
      db[i] = from_f<T>(sb);
      dc[i] = from_f<T>(sc);
    } else {
      const int h = static_cast<int>(i - rows);
      float sa = da_part[h];
      for (int r = 1; r < B; ++r) sa += da_part[r * nh + h];
      da[h] = sa;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  const void* x; const float* dt; const float* a; const void* bm;
  const void* cm; const float* dy; const float* dh_last; void* dx;
  float* ddt; void* db; void* dc; float* da; float* db_part;
  float* dc_part; float* da_part; float* escr; float* ckpt;
  unsigned long long* exp_count;
  int B, L, D, N, nh, G;
};

template <typename T, int NT, int CPL>
int launch_n(const Args& p, cudaStream_t stream) {
  constexpr int NTH = 32 * NT / kNPer;
  constexpr int smem = static_cast<int>(sizeof(Smem<T, NT, CPL>));
  const int hd = p.D / p.nh;
  Flags f;
  f.vec_x = p.D % 8 == 0 && hd % 8 == 0 && aligned16(p.x);
  f.vec_dy = p.D % 4 == 0 && hd % 4 == 0 && aligned16(p.dy);
  f.vec_bc = p.N == NT && aligned16(p.bm) && aligned16(p.cm);
  auto kern = mamba2_bwd_kernel<T, NT, CPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int groups = (p.nh + p.G - 1) / p.G;
  kern<<<dim3(groups, p.B), NTH, smem, stream>>>(
      static_cast<const T*>(p.x), p.dt, p.a, static_cast<const T*>(p.bm),
      static_cast<const T*>(p.cm), p.dy, p.dh_last, static_cast<T*>(p.dx),
      p.ddt, p.db_part, p.dc_part, p.da_part, p.escr, p.ckpt, p.exp_count,
      p.L, p.D, p.N, p.nh, p.G, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = static_cast<long long>(p.B) * p.L * p.N + p.nh;
  const int blocks = static_cast<int>(
      std::min<long long>((work + 255) / 256, 132LL * 8));
  mamba2_bwd_reduce<T><<<blocks, 256, 0, stream>>>(
      p.db_part, p.dc_part, p.da_part, static_cast<T*>(p.db),
      static_cast<T*>(p.dc), p.da, groups, p.B, p.L, p.N, p.nh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPL>
int launch_c(const Args& p, cudaStream_t s) {
  if (p.N <= 8) return launch_n<T, 8, CPL>(p, s);
  if (p.N <= 16) return launch_n<T, 16, CPL>(p, s);
  if (p.N <= 32) return launch_n<T, 32, CPL>(p, s);
  return launch_n<T, 64, CPL>(p, s);
}

template <typename T>
int launch(const Args& p, cudaStream_t s) {
  return p.D / p.nh > 32 ? launch_c<T, 2>(p, s) : launch_c<T, 1>(p, s);
}

}  // namespace

extern "C" {

// B4-bwd in Mamba-2's layout. dtype of x, B, C (and dx, dB, dC): 0
// float32, 1 bfloat16, 2 float16. x (B, L, D), dt (B, L, nh) fp32, a (nh,)
// fp32, B/C (B, L, N), dy (B, L, D) fp32, dh_last (B, D, N) fp32 or null
// (zero); D = nh * hd. Outputs dx (B, L, D), dB, dC (B, L, N), ddt
// (B, L, nh) fp32, da (nh,) fp32. Scratch, fp32: db_part and dc_part
// (groups, B, L, N), da_part (B, nh), escr (B, nh, L), ckpt (groups * B,
// ceil(L / 8) - 1, (NT / 4) * 32 * 4 * CPL) with groups = ceil(nh /
// heads_per_block), NT = N rounded up to 8, 16, 32 or 64 and CPL = 2 if
// hd > 32 else 1. All contiguous. exp_count: null, or a uint64 on the
// device to which each exp(dt a) the kernel evaluates adds one. Launches
// mamba2_bwd_kernel, then mamba2_bwd_reduce; returns cudaGetLastError().
int ssm_scan_heads_bwd(int dtype, const void* x, const float* dt,
                       const float* a, const void* bm, const void* cm,
                       const float* dy, const float* dh_last, void* dx,
                       float* ddt, void* db, void* dc, float* da,
                       float* db_part, float* dc_part, float* da_part,
                       float* escr, float* ckpt,
                       unsigned long long* exp_count, int B, int L, int D,
                       int N, int nh, int heads_per_block, void* stream) {
  if (N < 1 || N > kMaxN || B < 1 || B > 65535 || L < 1 || D < 1 ||
      nh < 1 || D % nh != 0 || heads_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{x, dt, a, bm, cm, dy, dh_last, dx, ddt, db, dc, da, db_part,
               dc_part, da_part, escr, ckpt, exp_count, B, L, D, N, nh,
               heads_per_block};
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
