// Cache-slot gather: out[k, :] = table[slots[k], :], the zero row where
// slots[k] < 0.
//
// Replaces pallas_gather_slots (paddlebox_tpu/ops/pallas_sparse.py:274, body
// _gather_slots_kernel :253), which DMAs a tile of rows from HBM into VMEM
// per grid step, clamping a negative slot to row 0 for the copy and masking
// the row to zero afterwards.  On Hopper the blocks run in parallel and the
// hardware overlaps the loads of many warps, so there is no tile to stage:
// a negative slot simply loads nothing and yields zeros.
//
// Bound: bytes.  No arithmetic; it reads K int32 slots and the distinct
// rows they name, and writes K rows.  On the cached pass it serves the hit
// fill of begin_pass, the victim read and the row reads of end_pass, and the
// drain at a barrier, at most a cache's worth (65 536 rows of 44 bytes,
// 2.9 MB) per call from the cache, or the pass's rows at end_pass: a
// microsecond of HBM time.  What holds it back is two dependent round trips
// (the slots, then the rows they name), random 44-byte rows that straddle
// two or three 32-byte sectors each, and the output stores.
//
// Design: each thread gathers 4 consecutive output floats.  Their rows and
// columns follow from one 32-bit division; the thread issues its slot loads
// (a row's slot is shared by about 11 neighbouring threads, so the L1
// serves most of them), checks them, issues its 4 row loads before using
// any, and stores the 4 floats as one 16-byte streaming store (a ragged
// tail of K * W mod 4 as 4-byte ones).  The grid is the blocks the SMs hold
// at once; past that the threads walk grid-stride.  Index math is 32-bit
// below 2^30 output floats.
// Tried and not kept: the tiled gather of pull_rows.cu at 4-byte
// granularity (slots staged in shared memory by cp.async one tile ahead,
// the tile staged and stored as 16-byte vectors) was faster than a thread
// per output float with the L2 cold but slower warm: its two barriers a
// tile and fewer threads in flight cost more than the slot reloads it
// saves.  A thread per row (its 11 loads in flight, staged in
// shared memory) and aligned 16-byte windows over each row were slower
// than 4 floats a thread, both cold and warm, as were 8 floats a thread
// and elements interleaved a block apart with 4-byte stores.
//
// A slot at or past the table's end traps before the thread reads any row,
// and the launch fails with an error at the next synchronize instead of
// reading foreign memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;  // output floats a thread: one 16-byte store

// I is int, or long long where the output passes 2^30 floats.
template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_slots_kernel(const float* __restrict__ table,
                    const int32_t* __restrict__ slots,
                    float* __restrict__ out, I n, int w, long long rows) {
  const I stride = static_cast<I>(gridDim.x) * kThreads * kVec;
  for (I e0 = (static_cast<I>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
       e0 < n; e0 += stride) {
    I r = e0 / w;
    int c = static_cast<int>(e0 - r * w);
    I row[kVec];
    int col[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      row[j] = r;
      col[j] = c;
      if (++c == w) {
        c = 0;
        ++r;
      }
    }
    int32_t slot[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      slot[j] = e0 + j < n ? __ldg(slots + row[j]) : -1;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (slot[j] >= rows) __trap();
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v[j] = slot[j] >= 0
                 ? __ldg(table + static_cast<long long>(slot[j]) * w + col[j])
                 : 0.0f;
    if (e0 + kVec <= n) {
      __stcs(reinterpret_cast<float4*>(out + e0),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (e0 + j < n) __stcs(out + e0 + j, v[j]);
    }
  }
}

template <typename I>
int launch(const void* table, const void* slots, void* out, I n, int w,
           long long rows, cudaStream_t stream) {
  // blocks the SMs hold at once, cached per device
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_slots_kernel<I>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = per_sm * sms;
  }
  const I need = (n + kThreads * kVec - 1) / (kThreads * kVec);
  const int blocks = need < cached[dev] ? static_cast<int>(need) : cached[dev];
  gather_slots_kernel<I><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(slots),
      static_cast<float*>(out), n, w, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [rows, w] float32 (4-byte aligned), slots [k] int32, out [k, w]
// float32 (16-byte aligned); all contiguous device pointers.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int pbt_gather_slots(const void* table, const void* slots,
                                void* out, long long k, int w,
                                long long rows, void* stream) {
  if (k <= 0 || w <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = k * w;
  if (n <= (1LL << 30))
    return launch<int>(table, slots, out, static_cast<int>(n), w, rows, s);
  return launch<long long>(table, slots, out, n, w, rows, s);
}
