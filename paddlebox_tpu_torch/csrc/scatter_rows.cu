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
// race left to the hardware.  Three launches on one stream:
//   1. for every occurrence with a valid slot, winner[slot] = -1 (every
//      thread that writes a slot writes the same value);
//   2. atomicMax(&winner[slot], k): the highest occurrence index wins,
//      whatever order the atomics land in;
//   3. one thread per element copies rows[k] into table[slot] only where
//      winner[slot] == k, so each table row receives exactly one store.
// `winner` is int32 scratch of the table's length that the wrapper
// allocates uninitialised; only the entries the slots name are written and
// read, so the reset costs O(K), not O(rows).
//
// Bound: bytes.  It reads K slots and K rows and writes the winning rows;
// the scratch adds 3 x 4 bytes per occurrence.  On the main path (hits and
// admits, slots unique) that is at most a cache's worth of 44-byte rows per
// call.  Rows of 11 floats rule out 16-byte vector moves (see
// gather_slots.cu).
//
// A slot at or past the table's end traps (launch error at the next
// synchronize) instead of writing foreign memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

__global__ void reset_winner_kernel(const int32_t* __restrict__ slots,
                                    int32_t* __restrict__ winner, int64_t k,
                                    int64_t rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < k; i += stride) {
    const int64_t slot = __ldg(slots + i);
    if (slot < 0) continue;
    if (slot >= rows) __trap();
    winner[slot] = -1;
  }
}

__global__ void elect_winner_kernel(const int32_t* __restrict__ slots,
                                    int32_t* __restrict__ winner, int64_t k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < k; i += stride) {
    const int32_t slot = __ldg(slots + i);
    if (slot >= 0) atomicMax(winner + slot, static_cast<int32_t>(i));
  }
}

__global__ void store_winner_kernel(float* __restrict__ table,
                                    const int32_t* __restrict__ slots,
                                    const float* __restrict__ rows_in,
                                    const int32_t* __restrict__ winner,
                                    int64_t n_elems, int w) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    const int64_t k = e / w;
    const int64_t c = e - k * w;
    const int32_t slot = __ldg(slots + k);
    if (slot < 0 || winner[slot] != k) continue;
    table[static_cast<int64_t>(slot) * w + c] = __ldg(rows_in + e);
  }
}

unsigned blocks_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// table [rows, w] float32 (updated in place), slots [k] int32, rows_in
// [k, w] float32, winner [rows] int32 scratch; all contiguous device
// pointers, k < 2^31.  Launches on `stream` and returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int pbt_scatter_rows(void* table, const void* slots,
                                const void* rows_in, void* winner,
                                long long k, int w, long long rows,
                                void* stream) {
  if (k <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  int32_t* win = static_cast<int32_t*>(winner);
  reset_winner_kernel<<<blocks_for(k), kThreads, 0, s>>>(
      sl, win, static_cast<int64_t>(k), static_cast<int64_t>(rows));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  elect_winner_kernel<<<blocks_for(k), kThreads, 0, s>>>(
      sl, win, static_cast<int64_t>(k));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(k) * w;
  store_winner_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<float*>(table), sl, static_cast<const float*>(rows_in), win,
      n, w);
  return static_cast<int>(cudaGetLastError());
}
