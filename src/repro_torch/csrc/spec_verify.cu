// Speculative-verify window attention for Hopper (sm_90a): W query lanes
// per request (the last accepted token plus gamma draft proposals) against
// the request's KV history stored in fixed-size pages, GQA folded in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spec_verify.py
// (spec_verify -> pl.pallas_call). Same arithmetic: fp32 scores and
// accumulation, key k visible to lane i of row b iff k <= q_pos[b, i],
// online softmax along the logical page walk, denominator clamped at
// 1e-20, output rounded once to the input dtype.
//
// Design. B2's structure (csrc/paged_attention.cu) with the window folded
// into the query group. A block serves one (kv-cache head, request row,
// group of up to 16 query rows); the rows of a (row, cache head) pair are
// the W x rep (window lane, q head of the group) pairs in lane-major
// order, so at full-width granite (W = 5, rep = 2) one block holds all 10.
// The block reads page_table[b, j] itself and walks the logical positions
// 0..max over its rows of q_pos only: keys past a lane's q_pos contribute
// exp(-1e30 - m) = 0, so skipping the tail is exact. Keys go through shared
// memory in tiles of 32 positions (a tile may span pages; any page size
// works), converted to fp32 once and shared by every row of the group.
// Each warp owns rows warp, warp+4, ...; a lane scores one key of the tile
// against its row and owns D/32 output columns for P.V, with shuffle
// reductions for the tile max and sum. The per-row mask is the lane's
// q_pos, so a window that crosses a page boundary, scratch lanes (q_pos at
// the table's last, always-scratch column) and rows of different window
// lengths need no special case. Page ids outside [0, NP) are masked keys,
// so a corrupt table cannot read outside the pool. With W = 1 every step
// (tiling, dot order, online softmax) is B2's, so the two agree bitwise.
//
// What bounds it. Each visible key and value is read once per (row, cache
// head, row group): (max q_pos + 1) * Hc * D * 2 elements per request,
// against 4 * D per (query row, visible key): W * rep flops per byte, still
// far below the card's ~295 flop/byte ridge, so it is bound by bytes
// (3.35 TB/s). This first version shares B2's plain per-thread loads and
// leaves warps idle when a group has fewer than 16 rows; vector loads,
// cp.async double buffering and tensor-core scores are the later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxRep = 16;
constexpr int kMaxW = 16;
constexpr int kRows = 16;          // query rows per block
constexpr int kTile = 32;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;
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
spec_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ q_pos, T* __restrict__ o, int W,
                   int Hq, int Hc, int P, int D, int M, int NP,
                   float scale) {
  __shared__ float q_s[kRows][kMaxD];
  __shared__ float k_s[kTile][kMaxD + 1];   // +1: conflict-free row reads
  __shared__ float v_s[kTile][kMaxD];
  __shared__ int ok_s[kTile];
  __shared__ int qp_s[kRows];
  __shared__ int nkeys_s;

  const int hc = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = Hq / Hc;
  const int row0 = blockIdx.z * kRows;
  const int nrows = min(kRows, W * rep - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Row r of the group is window lane i = (row0 + r) / rep, q head
  // hc * rep + (row0 + r) % rep; q is (B, W, Hq, D).
  for (int e = tid; e < nrows * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    const int gr = row0 + r;
    const int i = gr / rep, h = hc * rep + gr % rep;
    q_s[r][d] = to_f(q[((static_cast<long long>(b) * W + i) * Hq + h) * D + d]);
  }
  if (tid < nrows) qp_s[tid] = q_pos[b * W + (row0 + tid) / rep];
  if (tid == 0) {
    int mx = -1;
    for (int r = 0; r < nrows; ++r)
      mx = max(mx, q_pos[b * W + (row0 + r) / rep]);
    nkeys_s = min(mx + 1, M * P);
  }
  __syncthreads();
  const int n_keys = nkeys_s;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[rr][c] = 0.f;
  }

  const int* tb = table + static_cast<long long>(b) * M;

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();   // previous tile fully consumed
    for (int e = tid; e < kTile * D; e += blockDim.x) {
      const int j = e / D, d = e - j * D;
      const int kj = t0 + j;
      float kf = 0.f, vf = 0.f;
      bool ok = false;
      if (kj < n_keys) {
        const int page = tb[kj / P];
        if (page >= 0 && page < NP) {
          const long long off =
              ((static_cast<long long>(page) * P + kj % P) * Hc + hc) * D + d;
          kf = to_f(kp[off]);
          vf = to_f(vp[off]);
          ok = true;
        }
      }
      k_s[j][d] = kf;
      v_s[j][d] = vf;
      if (d == 0) ok_s[j] = ok;
    }
    __syncthreads();

    const bool key_ok = ok_s[lane] != 0;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= nrows) continue;         // warp-uniform
      const bool valid = key_ok && (t0 + lane) <= qp_s[r];
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r][d], k_s[lane][d], s);
      s = valid ? s * scale : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < kTile; ++j) {
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
    const int r = warp + rr * kWarps;
    if (r >= nrows) continue;
    const int gr = row0 + r;
    const int i = gr / rep, h = hc * rep + gr % rep;
    T* ob = o + ((static_cast<long long>(b) * W + i) * Hq + h) * D;
    const float denom = fmaxf(l[rr], 1e-20f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[d] = from_f<T>(acc[rr][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* q_pos, void* o, int B, int W, int Hq, int Hc, int P,
           int D, int M, int NP, float scale, void* stream) {
  const int groups = (W * (Hq / Hc) + kRows - 1) / kRows;
  dim3 grid(Hc, B, groups);
  spec_verify_kernel<T><<<grid, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, q_pos, static_cast<T*>(o), W, Hq,
      Hc, P, D, M, NP, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. q (B, W, Hq, D), pages
// (NP, P, Hc, D), out (B, W, Hq, D) all contiguous; table (B, M) and q_pos
// (B, W) int32. Returns cudaGetLastError().
int spec_verify_fwd(int dtype, const void* q, const void* k_pages,
                    const void* v_pages, const int* table, const int* q_pos,
                    void* o, int B, int W, int Hq, int Hc, int P, int D,
                    int M, int NP, float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0 || Hc <= 0 || Hq % Hc != 0 ||
      Hq / Hc > kMaxRep || W < 1 || W > kMaxW)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, table, q_pos, o, B, W, Hq,
                           Hc, P, D, M, NP, scale, stream);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, table, q_pos, o, B,
                                   W, Hq, Hc, P, D, M, NP, scale, stream);
    case 2:
      return launch<__half>(q, k_pages, v_pages, table, q_pos, o, B, W, Hq,
                            Hc, P, D, M, NP, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
