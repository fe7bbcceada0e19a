// In-place row scatter-add of the sparse-table push:
// values[idx[u], :] += delta[u, :], duplicate indices accumulating.
//
// Replaces pallas_scatter_add (paddlebox_tpu/ops/pallas_sparse.py:215, body
// _scatter_kernel :156).  The Pallas kernel stays deterministic because its
// grid runs in order on one TPU core: inside a tile an equality-matrix
// matmul gives every duplicate the same summed row, and tiles follow each
// other.  CUDA blocks run in no order, so that design does not carry over.
//
// Design: every element of delta is added into the table by one atomic
// reduction in the L2 (fire and forget: the SM does not wait for it).
// Chosen over a sort and segment reduce because of the main path's data:
// plan_keys makes push targets unique, except dead-row entries whose delta
// push_and_update zeroes first.  There each element receives exactly one
// add, or only adds of zero, and the result is bit-identical to
// values.index_add_(0, idx, delta).  With real duplicates the sum is right
// but its rounding depends on the order the atomics land, which changes
// from run to run: for a row hit n times the result can differ from a
// sequential sum by up to about 2 * n * 2^-24 * (|v| + sum |delta|).  The
// tests and chip_smoke.py hold that case to a stated tolerance.
//
// Where the row width is even and both tables start 8-byte aligned (the
// main path's 10-float rows), the reductions are Hopper's vector ones: an
// atomicAdd of a float2 is one red.global.add.v2.f32, so a 40-byte row
// takes 5 reductions instead of 10.  Each component still receives one
// add, so the bit-exactness above holds.  A float4 reduction does not
// apply: a 40-byte row starts 16-byte aligned only every other row.  TMA
// does not either: it moves tiles, and these rows are scattered.
//
// On the float2 path each block walks tiles of kThreads pushed rows.  It
// loads each row's index once into shared memory (checking it) and
// streams the tile's deltas as coalesced float2 loads through the
// read-only path, a thread holding kBatch loads in flight before it
// issues their reductions, with 32-bit index math inside the tile.  The
// first batch of delta loads is issued before the indices are staged: it
// needs no index, so the two reads from device memory overlap.  The grid
// is sized to the blocks the SMs hold at once.
//
// Any other width or alignment (the cache's 11-float rows, a view that
// starts 4 bytes in) takes the scalar path: a thread per element, each
// reloading its row's index, with 32-bit index math up to 2^30 elements.
// No caller of the main paths takes it: their rows are 10 floats.
//
// Bound: bytes.  Per pushed row it reads one index, one delta row and the
// table row, and writes the table row back: about 16 MB at the main path's
// shape (U = 131072, W = 10); the U * W float adds are negligible.  With
// the L2 cold each reduction waits for its target's two 32-byte sectors to
// come from device memory, so what the kernel can cover is that latency:
// enough reductions outstanding across the card.
//
// An index outside [0, P) traps (launch error at the next synchronize).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block = pushed rows per tile
constexpr int kBatch = 8;      // delta loads a thread has in flight
constexpr int kMaxBlocks = 1 << 20;  // the scalar path grid-strides past it

// Loads the kBatch delta elements e0, e0 + kThreads, ... below n.
__device__ __forceinline__ void load_batch(float2 (&d)[kBatch],
                                           const float2* src, int e0, int n) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int e = e0 + j * kThreads;
    if (e < n) d[j] = __ldg(src + e);
  }
}

// The float2 path; wv is the row width in float2.
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(float2* __restrict__ values,
                        const int32_t* __restrict__ idx,
                        const float2* __restrict__ delta, int u, int wv,
                        long long rows) {
  __shared__ int32_t s_row[kThreads];
  const int n_tiles = (u + kThreads - 1) / kThreads;
  const int t = threadIdx.x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kThreads;
    const int nr = min(kThreads, u - r0);
    const float2* src = delta + static_cast<int64_t>(r0) * wv;
    const int n = nr * wv;
    float2 d[kBatch];
    load_batch(d, src, t, n);  // in flight while the indices load
    if (t < nr) {
      const int32_t row = __ldg(idx + r0 + t);
      if (row < 0 || row >= rows) __trap();
      s_row[t] = row;
    }
    __syncthreads();
    for (int e0 = t; e0 < n; e0 += kBatch * kThreads) {
      if (e0 != t) load_batch(d, src, e0, n);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads;
        if (e < n) {
          const int r = e / wv;
          atomicAdd(values + static_cast<int64_t>(s_row[r]) * wv +
                        (e - r * wv), d[j]);
        }
      }
    }
    __syncthreads();  // s_row is rewritten by the next tile
  }
}

// The scalar path: a thread per element, grid-stride; I is int, or
// int64_t where the elements pass 2^30.
template <typename I>
__global__ void __launch_bounds__(kThreads)
scatter_add_scalar_kernel(float* __restrict__ values,
                          const int32_t* __restrict__ idx,
                          const float* __restrict__ delta, I n, int w,
                          long long rows) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I e = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += stride) {
    const I r = e / w;
    const int32_t row = __ldg(idx + r);
    if (row < 0 || row >= rows) __trap();
    atomicAdd(values + static_cast<int64_t>(row) * w + (e - r * w),
              __ldg(delta + e));
  }
}

int launch_float2(void* values, const void* idx, const void* delta, int u,
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
        &per_sm, scatter_add_rows_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = per_sm * sms;
  }
  const int n_tiles = (u + kThreads - 1) / kThreads;
  const int blocks = n_tiles < cached[dev] ? n_tiles : cached[dev];
  scatter_add_rows_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<float2*>(values), static_cast<const int32_t*>(idx),
      static_cast<const float2*>(delta), u, wv, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_scalar(void* values, const void* idx, const void* delta, I n,
                  int w, long long rows, cudaStream_t stream) {
  const I need = (n + kThreads - 1) / kThreads;
  const int blocks = need < kMaxBlocks ? static_cast<int>(need) : kMaxBlocks;
  scatter_add_scalar_kernel<I><<<blocks, kThreads, 0, stream>>>(
      static_cast<float*>(values), static_cast<const int32_t*>(idx),
      static_cast<const float*>(delta), n, w, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values [rows, w] float32 (updated in place), idx [u] int32, delta
// [u, w] float32; all contiguous device pointers, u < 2^31 - 256.  Takes
// the float2 path when w is even and values and delta are 8-byte aligned,
// else the scalar one.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pbt_scatter_add_rows(void* values, const void* idx,
                                    const void* delta, long long u, int w,
                                    long long rows, void* stream) {
  if (u <= 0 || w <= 0) return 0;
  if (u > INT_MAX - kThreads || w > INT_MAX / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned8 = ((reinterpret_cast<uintptr_t>(values) |
                          reinterpret_cast<uintptr_t>(delta)) & 7) == 0;
  if (w % 2 == 0 && aligned8)
    return launch_float2(values, idx, delta, static_cast<int>(u), w / 2,
                         rows, s);
  const long long n = u * w;
  if (n <= (1LL << 30))
    return launch_scalar<int>(values, idx, delta, static_cast<int>(n), w,
                              rows, s);
  return launch_scalar<int64_t>(values, idx, delta, n, w, rows, s);
}
