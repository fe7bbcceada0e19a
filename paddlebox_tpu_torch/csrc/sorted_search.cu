// Key -> position resolve of the HBM cache directory: for each uint64 query,
// its position in a sorted haystack of unique uint64 keys, or -1.
//
// Replaces pallas_sorted_search (paddlebox_tpu/ops/pallas_sparse.py:464, body
// _sorted_search_kernel :436).  JAX runs with x64 off, so the Pallas kernel
// carries each key as a (hi, lo) uint32 pair (split_u64 :506) and compares
// pairs; a CUDA thread compares 64-bit keys directly, so the port passes the
// keys as int64 tensors (the bits of the uint64 keys) and compares them
// here as unsigned long long.  Kept from the reference: the haystack is
// padded to a power of two C with all-ones sentinels, so the search is a
// branchless bit-descent of log2(C) steps, and a match counts only below
// n_real, so a real all-ones key is found and a missing all-ones query does
// not match the padding.
//
// Bound: bytes.  The function reads the haystack (8 C bytes) and the Q
// queries (8 Q) and writes Q int32 positions; its Q log2(C) 64-bit
// compares are a few million operations, far under the card's rate.  In
// practice each step of a query is one dependent load, so a query costs
// log2(C) cache latencies; the haystack (512 KB at the 65 536-slot default
// cache) stays in the 50 MB L2 after the first queries touch it, and many
// queries in flight hide the latency.
//
// Design: one thread per query running the log2(C)-step bit-descent; no
// shared memory (a 512 KB haystack does not fit a block's 227 KB).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

__global__ void sorted_search_kernel(const unsigned long long* __restrict__ hay,
                                     int cbits, long long n_real,
                                     const unsigned long long* __restrict__ q,
                                     int32_t* __restrict__ out, int64_t nq) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nq; i += stride) {
    const unsigned long long key = __ldg(q + i);
    int64_t pos = 0;
    for (int b = cbits - 1; b >= 0; --b) {
      const int64_t cand = pos + (static_cast<int64_t>(1) << b);
      if (__ldg(hay + cand - 1) < key) pos = cand;
    }
    // pos <= C - 1 here, so the probe stays inside the haystack
    const bool found = pos < n_real && __ldg(hay + pos) == key;
    out[i] = found ? static_cast<int32_t>(pos) : -1;
  }
}

}  // namespace

// hay [c] uint64 (c a power of two, sorted, valid below n_real), q [nq]
// uint64, out [nq] int32; all contiguous device pointers.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int pbt_sorted_search(const void* hay, long long c,
                                 long long n_real, const void* q, void* out,
                                 long long nq, void* stream) {
  if (nq <= 0 || c <= 0) return 0;
  int cbits = 0;
  while ((1LL << cbits) < c) ++cbits;
  int64_t blocks = (nq + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sorted_search_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(hay), cbits, n_real,
      static_cast<const unsigned long long*>(q), static_cast<int32_t*>(out),
      static_cast<int64_t>(nq));
  return static_cast<int>(cudaGetLastError());
}
