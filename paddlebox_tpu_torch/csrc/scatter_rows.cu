// Cache-slot row replace, in place: table[slots[k], :] = rows[k, :].
// Negative slots store nothing; a slot named more than once takes the row
// of its LAST occurrence.
//
// Replaces pallas_scatter_rows (paddlebox_tpu/ops/pallas_sparse.py:335, body
// _scatter_rows_kernel :305).  The Pallas kernel gets last-occurrence-wins
// from two facts of the TPU: its grid runs in order, so a later tile stores
// after an earlier one, and inside a tile an explicit last-of-group mask
// keeps all but the last duplicate from storing.  CUDA blocks run in no
// order, so two stores to one row would race and either could land.
//
// Design: the winner of each slot is decided before any row moves, with no
// race left to the hardware, in two launches:
//   1. elect: atomicMax(&tag[slot], k + 1) for every occurrence k with a
//      valid slot; the highest occurrence wins, whatever order the atomics
//      land in;
//   2. store: each block stages its tile's targets in shared memory (the
//      slot where tag[slot] == k + 1, else -1), and copies the tile's rows
//      as one coalesced stream of floats, each table row receiving one
//      store.  The winner sets tag[slot] back to 0 once it has read it; a
//      loser that reads the 0 instead still loses.
// So `tag` is all zeros again when a call ends.  It is int32 scratch of at
// least the table's length that the wrapper zeroes once and keeps across
// calls: no reset pass, no generation counter to wrap, and a CUDA graph
// that replays a captured call finds it zeroed.  Calls that share it must
// be ordered (one stream, or streams that wait on each other).  A call
// whose store launch fails after elect ran leaves tags set: it returns the
// error, and the wrapper drops that scratch.
//
// The store launch is a programmatic dependent launch (Hopper): elect lets
// it start at once, and before it waits for elect to finish
// (griddepcontrol.wait) it loads its slots and has the L2 prefetch its
// tile of rows (one bulk prefetch a block), so the first device-memory
// reads of the two launches overlap, and so does the second launch's
// start-up.  After the wait it reads tags and rows from the L2.  (Loading
// the rows into registers before the wait measured slower: the compiler
// may sink such loads past the wait; the prefetch is an ordered asm.)
//
// Two launches and not one cooperative launch with grid barriers: such a
// kernel was built and measured, and its two barriers cost more than the
// launch they save (PERF.md, PR 5).
//
// Bound: bytes.  It reads K slots and K rows and writes the winning rows;
// the tags add 2 x 4 bytes per occurrence, kept in the L2.  At the cache
// path's shape (about 58 000 unique slots, 44-byte rows) that is about
// 2.6 MB each way, under a microsecond at 3.35 TB/s, so fixed costs rule:
// launches, and the latency of the first reads from device memory.  Rows of
// 11 floats are only 4-byte aligned, so 16-byte vector moves do not apply,
// and neither does TMA: a tensor map needs global strides that are
// multiples of 16 bytes, and a 44-byte row stride is not one.
//
// A slot at or past the table's end traps (launch error at the next
// synchronize) instead of writing foreign memory.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block = occurrences per tile
constexpr int kBatch = 4;      // row loads a thread has in flight

// Asks the L2 to fetch [p, p + bytes) from device memory, trimmed to the
// 16-byte boundaries inside it (the bulk prefetch's alignment rule).
__device__ void prefetch_l2(const void* p, int64_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = (a + 15) & ~uintptr_t{15};
  const uintptr_t hi = (a + bytes) & ~uintptr_t{15};
  if (hi > lo) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(lo), "r"(static_cast<unsigned>(hi - lo)) : "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
elect_kernel(const int32_t* __restrict__ slots, int32_t* __restrict__ tag,
             int k, long long rows) {
  // the store launch may start now; it waits for this grid before it
  // reads a tag
  asm volatile("griddepcontrol.launch_dependents;");
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  const int32_t slot = __ldg(slots + i);
  if (slot < 0) return;
  if (slot >= rows) __trap();
  atomicMax(tag + slot, i + 1);
}

__global__ void __launch_bounds__(kThreads)
store_kernel(float* __restrict__ table, const int32_t* __restrict__ slots,
             const float* __restrict__ rows_in, int32_t* tag, int k, int w) {
  __shared__ int32_t s_dst[kThreads];
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int i = tile * kThreads + t;
  const int n = min(kThreads, k - tile * kThreads) * w;
  const float* src = rows_in + static_cast<int64_t>(tile) * kThreads * w;
  // before the wait, only what elect does not write: the tile's rows
  // (prefetched into the L2) and the slot
  if (t == 0) prefetch_l2(src, static_cast<int64_t>(n) * sizeof(float));
  const int32_t slot = i < k ? __ldg(slots + i) : -1;
  asm volatile("griddepcontrol.wait;" ::: "memory");

  int32_t dst = -1;
  if (slot >= 0 && __ldcg(tag + slot) == i + 1) {
    dst = slot;
    tag[slot] = 0;
  }
  s_dst[t] = dst;
  __syncthreads();
  for (int e0 = t; e0 < n; e0 += kBatch * kThreads) {
    float v[kBatch];
    int32_t d[kBatch];
    int c[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      d[j] = -1;
      if (e < n) {
        const int r = e / w;
        d[j] = s_dst[r];
        c[j] = e - r * w;
        if (d[j] >= 0) v[j] = __ldg(src + e);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (d[j] >= 0) table[static_cast<int64_t>(d[j]) * w + c[j]] = v[j];
    }
  }
}

}  // namespace

// table [rows, w] float32 (updated in place), slots [k] int32, rows_in
// [k, w] float32, tag [>= rows] int32 scratch, all zero on entry and on
// return; all contiguous device pointers, k < 2^31 - 256.  Launches on
// `stream` and returns the first error of a launch.
extern "C" int pbt_scatter_rows(void* table, const void* slots,
                                const void* rows_in, void* tag, long long k,
                                int w, long long rows, void* stream) {
  if (k <= 0 || w <= 0) return 0;
  if (k > INT_MAX - kThreads || w > INT_MAX / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k32 = static_cast<int>(k);
  const int blocks = (k32 + kThreads - 1) / kThreads;
  elect_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(slots), static_cast<int32_t*>(tag), k32,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, store_kernel, static_cast<float*>(table),
                           static_cast<const int32_t*>(slots),
                           static_cast<const float*>(rows_in),
                           static_cast<int32_t*>(tag), k32, w);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
