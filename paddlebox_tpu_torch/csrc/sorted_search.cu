// Key -> position resolve of the HBM cache directory: for each uint64 query,
// its position in a sorted haystack of unique uint64 keys, or -1.
//
// Replaces pallas_sorted_search (paddlebox_tpu/ops/pallas_sparse.py:464, body
// _sorted_search_kernel :436).  JAX runs with x64 off, so the Pallas kernel
// carries each key as a (hi, lo) uint32 pair (split_u64 :506) and compares
// pairs; a CUDA thread compares 64-bit keys directly, so the port passes the
// keys as int64 tensors (the bits of the uint64 keys) and compares them
// here as unsigned long long.  Kept from the reference: the haystack is
// padded to a power of two C with all-ones sentinels and searched by the
// branchless bit-descent of log2(C) steps, and a match counts only below
// n_real, so a real all-ones key is found and a missing all-ones query does
// not match the padding.
//
// Bound: bytes.  The function reads the haystack (8 C bytes) and the Q
// queries (8 Q) and writes Q int32 positions; its Q log2(C) 64-bit
// compares are a few million operations, far under the card's rate.  What
// holds a search back on this card is latency: each step of the descent is
// a load that depends on the one before, so a query at C = 65 536 waits on
// 17 round trips (16 steps and the membership probe).  The top steps hit
// few keys, which stay in each SM's L1 after the first warps touch them;
// the bottom ones go to the L2, or to device memory when it is cold.
//
// Design: the top of the implicit tree in shared memory, the rest of the
// descent in device memory.
//   1. The grid is the blocks the SMs hold at once, of 1024 threads, and
//      each block stages a splitter sample s[j] = hay[(j + 1) * stride - 1]
//      of S = min(C, kSample) keys, stride = C / S: independent loads
//      issued together, after the block's first query load, so the two
//      trips overlap.  Bit-exact: while the descent's step 2^b is at least
//      the stride, pos is a multiple of 2^(b+1) and the probe
//      hay[pos + 2^b - 1] is s[(pos + 2^b) / stride - 1], so descending
//      through s takes exactly the reference's first log2(S) steps and ends
//      on the same pos.  With C <= kSample the whole haystack is the sample
//      and the membership probe reads shared memory too.
//   2. The remaining log2(stride) steps and the probe run as in the
//      reference, on the haystack in device memory, with 32-bit positions
//      (C <= 2^31).
//   3. Each thread walks its queries grid-stride and loads its next query
//      while it resolves this one.  Nothing assumes the queries are
//      sorted; when they are (the census is), the threads of a warp probe
//      the same lines and their loads merge.
// Of samples of 0 to 2048 keys, 256 (2 KB) measured best at the cached
// path's shape, cold and warm: a larger one costs more to stage than the
// steps it saves.  Tried and not kept: a sample of 4096 keys, slower warm
// than a plain descent with no sample, because every block reads the
// sample's 4096 scattered 32-byte sectors from the L2; and spans of 4, 8
// or 16 keys loaded whole and counted in registers (or steps of up to 15
// independent probes), no faster, because the compares and selects of a
// wide span cost more issue slots than the round trips they save.  Below
// any design lies the cost of reading the queries and writing the
// positions, which chip_smoke.py times as a cast beside this kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kSampleBits = 8;  // the splitter sample: 256 keys, 2 KB

__global__ void __launch_bounds__(kThreads)
sorted_search_kernel(const u64* __restrict__ hay, int cbits, unsigned n_real,
                     const u64* __restrict__ q, int32_t* __restrict__ out,
                     long long nq) {
  __shared__ u64 s[1 << kSampleBits];
  const int sbits = cbits < kSampleBits ? cbits : kSampleBits;
  const int rest = cbits - sbits;  // log2 of the stride
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  u64 key = i < nq ? __ldg(q + i) : 0;
  for (int j = threadIdx.x; j < (1 << sbits); j += kThreads)
    s[j] = __ldg(hay + (static_cast<long long>(j + 1) << rest) - 1);
  __syncthreads();
  for (; i < nq; i += step) {
    const u64 next = i + step < nq ? __ldg(q + i + step) : 0;
    unsigned pos = 0;
    for (int b = sbits - 1; b >= 0; --b) {
      const unsigned cand = pos + (1u << b);
      if (s[cand - 1] < key) pos = cand;
    }
    pos <<= rest;
    for (int b = rest - 1; b >= 0; --b) {
      const unsigned cand = pos + (1u << b);
      if (__ldg(hay + cand - 1) < key) pos = cand;
    }
    // pos <= C - 1 here, so the probe stays inside the haystack
    const u64 at = rest == 0 ? s[pos] : __ldg(hay + pos);
    out[i] = pos < n_real && at == key ? static_cast<int32_t>(pos) : -1;
    key = next;
  }
}

}  // namespace

// hay [c] uint64 (c a power of two up to 2^31, sorted, valid below
// n_real), q [nq] uint64, out [nq] int32; all contiguous device pointers.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int pbt_sorted_search(const void* hay, long long c,
                                 long long n_real, const void* q, void* out,
                                 long long nq, void* stream) {
  if (nq <= 0 || c <= 0) return 0;
  if (c > (1LL << 31) || (c & (c - 1)) || n_real < 0 || n_real > c)
    return static_cast<int>(cudaErrorInvalidValue);
  int cbits = 0;
  while ((1LL << cbits) < c) ++cbits;
  // blocks the SMs hold at once, cached per device
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sorted_search_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = per_sm * sms;
  }
  const long long need = (nq + kThreads - 1) / kThreads;
  const int blocks = need < cached[dev] ? static_cast<int>(need) : cached[dev];
  sorted_search_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(hay), cbits, static_cast<unsigned>(n_real),
      static_cast<const u64*>(q), static_cast<int32_t*>(out), nq);
  return static_cast<int>(cudaGetLastError());
}
