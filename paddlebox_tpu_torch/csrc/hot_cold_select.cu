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
// occurrences name, and writes K rows.  At the hybrid path's shape
// (K = 131072, W = 10, H = 4096, about 6 % of the occurrences hot) that is
// about 11 MB, 3.2 us at 3.35 TB/s.  The hot block (160 KB) stays in the L2.
//
// Output, cold rows and slots are all contiguous, so this is a streaming
// copy with a few patched elements.  Where the width is at least 2 and cold
// and out start 16-byte aligned (the hybrid path's), the float4 path makes
// one pass over the flat [K * W] output in 16-byte vectors.  A vector spans
// at most two rows (W >= 2); each thread of a block handles 2 vectors and
// issues, for both, the slot loads of their rows and the cold vector loads
// before it uses any; then it fetches each hot element from the L2-resident
// block and writes each vector with a 16-byte streaming store.  32-bit
// index math throughout; the grid is the blocks the SMs hold at once,
// walking tiles of 512 vectors (640 tiles at the hybrid shape, one round
// for the card).  1, 4 and 8 vectors a thread, and blocks of 128 and 512
// threads, were no faster L2-cold (PERF.md).  The last K * W mod 4
// elements take a scalar tail in block 0.
//
// The cold vector is loaded whether or not some element of it belongs to a
// cold occurrence.  Loading it only where needed would skip the vectors
// that lie wholly inside hot rows (a few percent of the cold bytes at this
// shape; chip_smoke.py logs the count), but the load would then wait for
// the slot load: two device-memory round trips in a row instead of one.
// Tiles of slots and cold rows brought into shared memory by bulk copy,
// with hot rows patched in, would read the same bytes in the same one
// round trip, through shared memory and an mbarrier, with more alignment
// rules for the copies: no gain over registers for a copy this simple.
//
// Any other width or alignment (W = 1, a cold view that starts 4 bytes in)
// takes the scalar path: a thread per element, with 32-bit index math up to
// 2^30 elements.  No caller of the hybrid path takes it.
//
// Slots must lie in [0, H]: the planner writes H for cold and padding
// occurrences.  An entry outside traps, and the launch fails with an error
// at the next synchronize instead of reading foreign memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // float4 vectors a thread has in flight
constexpr int kMaxBlocks = 1 << 20;  // the scalar path grid-strides past it

__device__ __forceinline__ void check_slot(int32_t s, long long h) {
  if (s < 0 || s > h) __trap();
}

// The float4 path: n = k * w elements, n4 = n / 4 full vectors, w >= 2.
__global__ void __launch_bounds__(kThreads)
hot_cold_select_kernel(const float* __restrict__ hot,
                       const int32_t* __restrict__ occ,
                       const float4* __restrict__ cold,
                       float4* __restrict__ out, int n, int w, long long h) {
  const int n4 = n / 4;
  const int n_tiles = (n4 + kThreads * kVecs - 1) / (kThreads * kVecs);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int v0 = tile * kThreads * kVecs + threadIdx.x;
    float4 c[kVecs];
    int32_t s0[kVecs], s1[kVecs];
    int col0[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int v = v0 + j * kThreads;
      if (v < n4) {
        const int r = 4 * v / w;
        col0[j] = 4 * v - r * w;
        s0[j] = __ldg(occ + r);
        // the vector reaches into row r + 1, which exists: 4 * v + 3 < n
        s1[j] = col0[j] + 3 >= w ? __ldg(occ + r + 1) : s0[j];
        c[j] = __ldg(cold + v);
      }
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int v = v0 + j * kThreads;
      if (v < n4) {
        check_slot(s0[j], h);
        check_slot(s1[j], h);
        float x[4] = {c[j].x, c[j].y, c[j].z, c[j].w};
        if (s0[j] < h || s1[j] < h) {
          int col = col0[j];
          int32_t s = s0[j];
#pragma unroll
          for (int q = 0; q < 4; ++q, ++col) {
            if (col == w) {
              col = 0;
              s = s1[j];
            }
            if (s < h) x[q] = __ldg(hot + static_cast<int64_t>(s) * w + col);
          }
        }
        __stcs(out + v, make_float4(x[0], x[1], x[2], x[3]));
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {  // the ragged tail
    const int e = 4 * n4 + threadIdx.x;
    const int r = e / w;
    const int32_t s = __ldg(occ + r);
    check_slot(s, h);
    reinterpret_cast<float*>(out)[e] =
        s < h ? __ldg(hot + static_cast<int64_t>(s) * w + (e - r * w))
              : __ldg(reinterpret_cast<const float*>(cold) + e);
  }
}

// The scalar path: a thread per element, grid-stride; I is int, or
// int64_t where the elements pass 2^30.
template <typename I>
__global__ void __launch_bounds__(kThreads)
hot_cold_select_scalar_kernel(const float* __restrict__ hot,
                              const int32_t* __restrict__ occ,
                              const float* __restrict__ cold,
                              float* __restrict__ out, I n, int w,
                              long long h) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I e = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += stride) {
    const I r = e / w;
    const int32_t s = __ldg(occ + r);
    check_slot(s, h);
    out[e] = s < h ? __ldg(hot + static_cast<int64_t>(s) * w + (e - r * w))
                   : __ldg(cold + e);
  }
}

int launch_float4(const void* hot, const void* occ, const void* cold,
                  void* out, int n, int w, long long h, cudaStream_t stream) {
  // blocks the SMs hold at once, cached per device
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hot_cold_select_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = per_sm * sms;
  }
  const int n_tiles = (n / 4 + kThreads * kVecs - 1) / (kThreads * kVecs);
  int blocks = n_tiles < cached[dev] ? n_tiles : cached[dev];
  if (blocks < 1) blocks = 1;  // block 0 also writes the ragged tail
  hot_cold_select_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(hot), static_cast<const int32_t*>(occ),
      static_cast<const float4*>(cold), static_cast<float4*>(out), n, w, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_scalar(const void* hot, const void* occ, const void* cold,
                  void* out, I n, int w, long long h, cudaStream_t stream) {
  const I need = (n + kThreads - 1) / kThreads;
  const int blocks = need < kMaxBlocks ? static_cast<int>(need) : kMaxBlocks;
  hot_cold_select_scalar_kernel<I><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(hot), static_cast<const int32_t*>(occ),
      static_cast<const float*>(cold), static_cast<float*>(out), n, w, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hot [h, w] float32, occ [k] int32 in [0, h], cold [k, w] float32, out
// [k, w] float32; all contiguous device pointers (hot may be empty when
// h == 0).  Takes the float4 path when w >= 2, k * w <= 2^30 and cold and
// out are 16-byte aligned, else the scalar one.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int pbt_hot_cold_select(const void* hot, const void* occ,
                                   const void* cold, void* out, long long k,
                                   int w, long long h, void* stream) {
  const long long n = k * w;
  if (k <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned16 = ((reinterpret_cast<uintptr_t>(cold) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (w >= 2 && n <= (1LL << 30) && aligned16)
    return launch_float4(hot, occ, cold, out, static_cast<int>(n), w, h, s);
  if (n <= (1LL << 30))
    return launch_scalar<int>(hot, occ, cold, out, static_cast<int>(n), w, h,
                              s);
  return launch_scalar<int64_t>(hot, occ, cold, out, static_cast<int64_t>(n),
                                w, h, s);
}
