// Cache-slot gather: out[k, :] = table[slots[k], :], the zero row where
// slots[k] < 0.
//
// Replaces pallas_gather_slots (paddlebox_tpu/ops/pallas_sparse.py:274, body
// _gather_slots_kernel :253), which DMAs a tile of rows from HBM into VMEM
// per grid step, clamping a negative slot to row 0 for the copy and masking
// the row to zero afterwards.  On Hopper the blocks run in parallel and the
// hardware overlaps the loads of many warps, so there is no tile to stage:
// a thread whose slot is negative simply loads nothing and stores zero.
//
// Bound: bytes.  No arithmetic; it reads K int32 slots and the distinct
// rows they name, and writes K rows.  On the cached pass it serves the hit
// fill of begin_pass, the victim read and the row reads of end_pass, and the
// drain at a barrier, at most a cache's worth (65 536 rows of 44 bytes,
// 2.9 MB) per call: a microsecond of HBM time.
//
// Design: one thread per output element, as pull_rows.cu, so consecutive
// threads store consecutive addresses (fully coalesced) and read
// consecutive addresses inside a row.  A cache row is W+1 = 11 floats, 44
// bytes, not a multiple of 16, which rules out 16-byte vector loads; the
// same caveat pull_rows.cu records.
//
// A slot at or past the table's end traps, and the launch fails with an
// error at the next synchronize instead of reading foreign memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

__global__ void gather_slots_kernel(const float* __restrict__ table,
                                    const int32_t* __restrict__ slots,
                                    float* __restrict__ out, int64_t n_elems,
                                    int w, int64_t rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    const int64_t k = e / w;
    const int64_t c = e - k * w;
    const int64_t slot = __ldg(slots + k);
    float v = 0.0f;
    if (slot >= 0) {
      if (slot >= rows) __trap();
      v = __ldg(table + slot * w + c);
    }
    out[e] = v;
  }
}

}  // namespace

// table [rows, w] float32, slots [k] int32, out [k, w] float32; all
// contiguous device pointers.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pbt_gather_slots(const void* table, const void* slots,
                                void* out, long long k, int w,
                                long long rows, void* stream) {
  const int64_t n = static_cast<int64_t>(k) * w;
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_slots_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(slots),
      static_cast<float*>(out), n, w, static_cast<int64_t>(rows));
  return static_cast<int>(cudaGetLastError());
}
