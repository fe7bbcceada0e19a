// Hot/cold routing of the hybrid-placement pull:
//   out[k, :] = occ[k] < H ? hot[occ[k], :] : cold[k, :].
//
// Replaces pallas_hot_cold_select (paddlebox_tpu/ops/pallas_sparse.py:393,
// body _hot_select_kernel :369), which appends a zero sink row to the
// replicated hot block, DMAs one hot row per occurrence of a tile into VMEM
// (the sink for cold occurrences) and selects against the tile of cold
// rows.  Here no sink row is needed: occ == H simply keeps the cold row, so
// the caller skips the reference's per-step concat of the sink, and the
// result is bit-identical to the select over the extended block.
//
// Bound: bytes.  The select does no arithmetic; it reads K int32 slots, the
// cold rows of the cold occurrences and the distinct hot rows the hot
// occurrences name, and writes K rows.  At the main path's shape
// (K = 131072, W = 10) that is about 6 to 11 MB, a few microseconds.
//
// Design: one thread per output element, as pull_rows.cu: a group of W
// consecutive threads serves one output row, stores coalesce fully, and
// each thread loads only the source it selects (a hot occurrence never
// touches its cold row).  Rows of 40 bytes rule out 16-byte vectors.
//
// Slots must lie in [0, H]: the planner writes H for cold and padding
// occurrences.  An entry outside traps, and the launch fails with an error
// at the next synchronize instead of reading foreign memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

__global__ void hot_cold_select_kernel(const float* __restrict__ hot,
                                       const int32_t* __restrict__ occ,
                                       const float* __restrict__ cold,
                                       float* __restrict__ out,
                                       int64_t n_elems, int w, int64_t h) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    const int64_t k = e / w;
    const int64_t c = e - k * w;
    const int64_t slot = __ldg(occ + k);
    if (slot < 0 || slot > h) __trap();
    out[e] = slot < h ? __ldg(hot + slot * w + c) : __ldg(cold + e);
  }
}

}  // namespace

// hot [h, w] float32, occ [k] int32 in [0, h], cold [k, w] float32, out
// [k, w] float32; all contiguous device pointers (hot may be empty when
// h == 0).  Launches on `stream` and returns cudaGetLastError().
extern "C" int pbt_hot_cold_select(const void* hot, const void* occ,
                                   const void* cold, void* out, long long k,
                                   int w, long long h, void* stream) {
  const int64_t n = static_cast<int64_t>(k) * w;
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hot_cold_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hot), static_cast<const int32_t*>(occ),
      static_cast<const float*>(cold), static_cast<float*>(out), n, w,
      static_cast<int64_t>(h));
  return static_cast<int>(cudaGetLastError());
}
