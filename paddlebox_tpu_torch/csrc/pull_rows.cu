// Row gather of the sparse-table pull: out[k, :] = values[idx[k], :].
//
// Replaces pallas_pull_rows (paddlebox_tpu/ops/pallas_sparse.py:129, body
// _gather_kernel :95), which DMAs a tile of table rows from HBM into VMEM
// per grid step and double-buffers the next tile's row copies, with the
// indices brought ahead by scalar prefetch.  On Hopper the blocks run in
// parallel, so what carries over is the idea, not the loop: keep the next
// indices and many row loads in flight.
//
// Bound: bytes.  The gather does no arithmetic; it reads K int32 indices
// and the distinct rows of W floats they name, and writes K rows.  At the
// main path's shape (K = 131072, W = 10, about 64 000 distinct rows of a
// 2 M-row table) that is about 8 MB, 2.5 us at 3.35 TB/s.  With the L2
// cold the rows are random 40-byte reads from device memory, so what the
// kernel can do is have few dependent round trips and many loads in flight.
//
// Where the width is even and the table starts 8-byte aligned (the main
// path's 10-float rows, also a shard's view values[o] on the hybrid path),
// the float2 path: a row of 40 bytes is 8-byte aligned wherever the table
// starts, so it moves as 5 float2.  The grid is the blocks the SMs hold at
// once, and each block walks tiles of consecutive output rows (8 KB of
// output a tile: 204 rows at W = 10, so the step's gather is 643 tiles, one
// round for the card):
//   1. the tile's indices come into shared memory by cp.async, issued one
//      tile ahead, so the next tile's index trip overlaps this tile's row
//      loads; the thread that copied an index checks its range, once a row;
//   2. each thread issues all its row loads (4 float2 through the
//      read-only path) before it uses any, and stages them in shared
//      memory;
//   3. the tile leaves as 16-byte streaming stores (a tile is an even
//      number of float2, so every tile starts 16-byte aligned).
// Index math inside a tile is 32-bit; only the table offset is 64-bit.
// No division by the width per element beyond one 32-bit one, and each
// index is loaded once, not once per element.
//
// Any other width or alignment (odd widths such as the cache's 11-float
// rows, a view that starts 4 bytes in) takes the scalar path: a thread per
// element, each reloading its row's index, with 32-bit index math up to
// 2^30 elements.  No caller of the main paths takes it.
//
// Indices must lie in [0, P): the planner points padding at the dead row.
// The host cannot check that without waiting for the device, so the kernel
// does: an index out of range traps before any row of its block is read,
// and the launch fails with an error at the next synchronize instead of
// reading foreign memory.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileVecs = 1024;              // float2 of output a tile stages
constexpr int kLoads = kTileVecs / kThreads;  // row loads a thread has in flight
constexpr int kMaxBlocks = 1 << 20;          // the scalar path grid-strides past it

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// Starts the copy of rows [r0, r0 + nr)'s indices into s, as one group
// (empty when nr <= 0); thread t copies entries t, t + kThreads, ...
__device__ __forceinline__ void stage_indices(int32_t* s,
                                              const int32_t* idx, int r0,
                                              int nr) {
  for (int r = threadIdx.x; r < nr; r += kThreads) cp_async4(s + r, idx + r0 + r);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The float2 path; wv is the row width in float2, tile_rows * wv is even
// and at most kTileVecs.
__global__ void __launch_bounds__(kThreads)
pull_rows_kernel(const float2* __restrict__ values,
                 const int32_t* __restrict__ idx, float2* __restrict__ out,
                 int k, int wv, int tile_rows, long long rows) {
  __shared__ int32_t s_idx[2][kTileVecs];
  __shared__ __align__(16) float2 s_out[kTileVecs];
  const int t = threadIdx.x;
  const int n_tiles = (k + tile_rows - 1) / tile_rows;
  int tile = blockIdx.x;
  int buf = 0;
  stage_indices(s_idx[0], idx, tile * tile_rows,
                min(tile_rows, k - tile * tile_rows));
  for (; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int r0 = tile * tile_rows;
    const int nr = min(tile_rows, k - r0);
    const int next = tile + gridDim.x;
    // the next tile's indices travel while this tile's rows load; its
    // buffer was last read before the previous tile's staging barrier
    const int n0 = next < n_tiles ? next * tile_rows : k;
    stage_indices(s_idx[buf ^ 1], idx, n0, min(tile_rows, k - n0));
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    for (int r = t; r < nr; r += kThreads) {  // the entries this thread copied
      const int32_t row = s_idx[buf][r];
      if (row < 0 || row >= rows) __trap();
    }
    __syncthreads();  // every index of the tile landed and checked

    const int n = nr * wv;
    float2 v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = t + j * kThreads;
      if (e < n) {
        const int r = e / wv;
        v[j] = __ldg(values + static_cast<int64_t>(s_idx[buf][r]) * wv +
                     (e - r * wv));
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = t + j * kThreads;
      if (e < n) s_out[e] = v[j];
    }
    __syncthreads();  // the tile is staged

    float2* dst = out + static_cast<int64_t>(r0) * wv;
    const float4* src = reinterpret_cast<const float4*>(s_out);
    for (int q = t; q < n / 2; q += kThreads)
      __stcs(reinterpret_cast<float4*>(dst) + q, src[q]);
    if ((n & 1) && t == 0) __stcs(dst + n - 1, s_out[n - 1]);
    // s_out is rewritten only after the next tile's first barrier, which
    // every thread reaches after these stores
  }
}

// The scalar path: a thread per element, grid-stride; I is int, or
// int64_t where the elements pass 2^30.
template <typename I>
__global__ void __launch_bounds__(kThreads)
pull_rows_scalar_kernel(const float* __restrict__ values,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out, I n, int w, long long rows) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I e = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += stride) {
    const I r = e / w;
    const int32_t row = __ldg(idx + r);
    if (row < 0 || row >= rows) __trap();
    out[e] = __ldg(values + static_cast<int64_t>(row) * w + (e - r * w));
  }
}

int launch_float2(const void* values, const void* idx, void* out, int k,
                  int wv, long long rows, cudaStream_t stream) {
  // blocks the SMs hold at once, cached per device
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pull_rows_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = per_sm * sms;
  }
  int tile_rows = kTileVecs / wv;
  if ((tile_rows * wv) & 1) --tile_rows;  // tiles start 16-byte aligned
  const int n_tiles = (k + tile_rows - 1) / tile_rows;
  const int blocks = n_tiles < cached[dev] ? n_tiles : cached[dev];
  pull_rows_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float2*>(values), static_cast<const int32_t*>(idx),
      static_cast<float2*>(out), k, wv, tile_rows, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_scalar(const void* values, const void* idx, void* out, I n, int w,
                  long long rows, cudaStream_t stream) {
  const I need = (n + kThreads - 1) / kThreads;
  const int blocks = need < kMaxBlocks ? static_cast<int>(need) : kMaxBlocks;
  pull_rows_scalar_kernel<I><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n, w, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values [rows, w] float32, idx [k] int32, out [k, w] float32; all
// contiguous device pointers, k < 2^31 - 2048.  Takes the float2 path when
// w is even and at most kTileVecs floats, values is 8-byte and out 16-byte
// aligned; else the scalar one.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pbt_pull_rows(const void* values, const void* idx, void* out,
                             long long k, int w, long long rows,
                             void* stream) {
  if (k <= 0 || w <= 0) return 0;
  if (k > INT_MAX - 2 * kTileVecs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(values) & 7) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (w % 2 == 0 && w / 2 <= kTileVecs / 2 && aligned)
    return launch_float2(values, idx, out, static_cast<int>(k), w / 2, rows,
                         s);
  const long long n = k * w;
  if (n <= (1LL << 30))
    return launch_scalar<int>(values, idx, out, static_cast<int>(n), w, rows,
                              s);
  return launch_scalar<int64_t>(values, idx, out, static_cast<int64_t>(n), w,
                                rows, s);
}
