// Paged decode attention for Hopper (sm_90a): one query token per request
// against its KV history stored in fixed-size pages, GQA folded in.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> pl.pallas_call). Same function: fp32 scores and
// accumulation, key k of row b visible iff k <= pos[b], page ids outside
// [0, NP) treated as masked keys (a corrupt table cannot read outside the
// pool), denominator clamped at 1e-20, output in the input dtype. Pages
// are (NP, P, Hc, D) contiguous: one layer's slice of the pool's (layers,
// NP+1, P, Hc, D) buffer, scratch page included. Any page size, D a
// multiple of 8 up to 128, rep = Hq / Hc up to 16.
//
// What bounds it. Decode reads each visible key and value once per
// (row, cache head): 2 (pos+1) Hc D elements a row, against 4 Hq D (pos+1)
// flops, about one flop a byte: bound by bytes. At the paged run's
// geometry (8 rows, Hc = 16, D = 64, pos < 128) that is under 1 MB, a
// fraction of a microsecond at 3.35 TB/s, so what bounds a call is
// latency: how many dependent trips to device memory a block makes, and
// how many warps wait on them. The first version gave each warp its own
// q heads (warps 2 and 3 idle at rep = 2, granite's kv_repeat), loaded
// 32-key tiles as 2-byte scalar reads with a division and a modulo an
// element, and loaded no tile ahead of the one it scored.
//
// Design. One block of 4 warps per (cache head, row), its rep q heads one
// group of the shared key walk of csrc/paged_walk.cuh (B3 walks the same
// way): the block reads page_table[b, :] itself (the TPU kernel had it
// scalar-prefetched) and walks only the logical positions 0..pos[b].
// - Warps split the key walk, not the heads: tiles go to the warps in
//   turn, each warp scoring all rep heads of the group over its tiles with
//   its own online-softmax state; the block combines the warps' partials
//   in shared memory at the end.
// - Loads: 16-byte cp.async K/V rows into a two-stage ring for each warp,
//   the next tile issued before the current one is scored.
// - Scores (CoreScore): lane j scores key j for every head (the q heads
//   staged in shared memory as fp32, the dot an fma chain in index order);
//   P.V: lane l owns column pairs 2l and 2l + 64.

#include "paged_walk.cuh"

namespace {

using namespace paged_walk;

constexpr int kMaxRep = 16;

// The rep q heads of cache head hc of row b: contiguous in q and o, all at
// position pos[b].
struct DecodeGroup {
  long long base;   // element offset of the group's first row
  int D, rows, n_keys;
  __device__ __forceinline__ long long off(int r) const {
    return base + static_cast<long long>(r) * D;
  }
};

// REPC: rep rounded up to 2, 4, 8 or 16 (registers); rep the real one.
template <typename T, int REPC>
__global__ void __launch_bounds__(kWarps * 32)
paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ pos, T* __restrict__ o, int Hq,
                 int Hc, int P, int D, int M, int NP, float scale, Rows g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);            // [REPC][D]
  unsigned char* work = smem + REPC * D * sizeof(float);  // ring / combine

  const int hc = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = Hq / Hc;
  const DecodeGroup grp{(static_cast<long long>(b) * Hq + hc * rep) * D, D,
                        rep, min(pos[b] + 1, M * P)};
  const T* qb = q + grp.base;
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x)
    q_s[i] = to_f(qb[i]);

  CoreScore<T, REPC, false> sc{q_s, nullptr, rep, D, scale};
  sc.init();
  walk<T, REPC>(grp, sc, kp, vp, table + static_cast<long long>(b) * M, o, P,
                Hc, hc, D, NP, g, work);
}

template <typename T, int REPC>
int launch_r(const void* q, const void* kp, const void* vp, const int* table,
             const int* pos, void* o, int B, int Hq, int Hc, int P, int D,
             int M, int NP, float scale, cudaStream_t stream) {
  const Rows g = rows_of<T>(D);
  const size_t smem = walk_smem<T, REPC>(g, D, REPC * D * sizeof(float));
  static size_t allowed = 48 * 1024;         // per instantiation
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_fwd_kernel<T, REPC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  dim3 grid(Hc, B);
  paged_fwd_kernel<T, REPC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, pos, static_cast<T*>(o), Hq, Hc, P,
      D, M, NP, scale, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* pos, void* o, int B, int Hq, int Hc, int P, int D,
           int M, int NP, float scale, cudaStream_t stream) {
  const int rep = Hq / Hc;
  if (rep <= 2)
    return launch_r<T, 2>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                          scale, stream);
  if (rep <= 4)
    return launch_r<T, 4>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                          scale, stream);
  if (rep <= 8)
    return launch_r<T, 8>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                          scale, stream);
  return launch_r<T, 16>(q, kp, vp, table, pos, o, B, Hq, Hc, P, D, M, NP,
                         scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. q (B, Hq, D), pages
// (NP, P, Hc, D), out (B, Hq, D) all contiguous and 16-byte aligned;
// table (B, M) and pos (B,) int32. Returns cudaGetLastError().
int paged_attention_fwd(int dtype, const void* q, const void* k_pages,
                        const void* v_pages, const int* table,
                        const int* pos, void* o, int B, int Hq, int Hc,
                        int P, int D, int M, int NP, float scale,
                        void* stream) {
  if (D > kMaxD || D < 8 || D % 8 != 0 || Hc <= 0 || Hq % Hc != 0 ||
      Hq / Hc > kMaxRep || B < 1 || B > 65535 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pages, v_pages, table, pos, o, B, Hq, Hc, P,
                           D, M, NP, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pages, v_pages, table, pos, o, B, Hq,
                                   Hc, P, D, M, NP, scale, s);
    case 2:
      return launch<__half>(q, k_pages, v_pages, table, pos, o, B, Hq, Hc, P,
                            D, M, NP, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
