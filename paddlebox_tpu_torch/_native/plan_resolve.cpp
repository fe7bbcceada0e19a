// Native batch planner: resolve a padded key buffer against the pass
// census — the host half of the sparse pull/push (the analog of the
// reference's CopyKeys + DedupKeysAndFillIdx staging,
// box_wrapper_impl.h:95-122, which runs in CUDA because its keys live on
// device; ours live on the host).
//
// The numpy implementation (sparse/table.py plan_keys: np.unique +
// np.searchsorted) costs ~6-15ms per 131k-key batch, dominated by the
// sort inside np.unique.  This version is sort-free:
//
//   * per PASS: one open-addressing hash index over the sorted census
//     (splitmix64 probe; built once in pbx_census_index_build, amortized
//     over every batch of the pass);
//   * per BATCH: one O(K) walk — a local hash dedups occurrences into
//     FIRST-SEEN slot order while each new key does an O(1) census
//     lookup.
//
// Slot numbering therefore differs from numpy's sorted order, but every
// training-visible quantity is identical: idx (per-occurrence pull rows)
// is order-free, and the push's segment-sum -> scatter pipeline permutes
// rows consistently through inverse/uniq_idx, so training results match
// the numpy path BIT-FOR-BIT (pinned end-to-end by tests/test_torch_native.py).
//
// Contract (order-insensitive form of plan_keys):
//   idx[occ]      = found ? census_row : dead        (occ < n_real)
//                 = dead                             (padding)
//   uniq_idx[j]   = found ? census_row : min(scratch_base + j, dead)
//   inverse[occ]  = first-seen slot of the occurrence; K-1 for padding
//   key_mask[occ] = 1.0 real / 0.0 padding
//   returns n_missing (unique keys absent from the census)
//
// The same source as the JAX package's _native/plan_resolve.cpp, so the
// two packages' native plans are bit-exact; the port builds it into
// paddlebox_tpu_torch/_build/ (_native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline unsigned long long splitmix64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline unsigned long long pow2_at_least(unsigned long long n) {
  unsigned long long c = 64;
  while (c < n) c <<= 1;
  return c;
}

constexpr unsigned int kEmpty = 0xFFFFFFFFu;

struct CensusIndex {
  const unsigned long long* keys;  // borrowed (the table's census array)
  long long n;
  unsigned long long mask;
  std::vector<unsigned int> slot;  // census row per hash cell, kEmpty free
};

}  // namespace

extern "C" {

// Build the per-pass census index.  ``census`` must outlive the handle
// (the table owns its sorted pass-key array for the whole pass).
void* pbx_census_index_build(const unsigned long long* census,
                             long long n_pass) {
  auto* ix = new CensusIndex();
  ix->keys = census;
  ix->n = n_pass;
  unsigned long long cap = pow2_at_least(
      (unsigned long long)(n_pass > 0 ? 2 * n_pass : 1));
  ix->mask = cap - 1;
  ix->slot.assign(cap, kEmpty);
  for (long long i = 0; i < n_pass; ++i) {
    unsigned long long h = splitmix64(census[i]) & ix->mask;
    while (ix->slot[h] != kEmpty) h = (h + 1) & ix->mask;
    ix->slot[h] = (unsigned int)i;
  }
  return ix;
}

void pbx_census_index_free(void* handle) {
  delete static_cast<CensusIndex*>(handle);
}

// Resolve one batch against a built census index.  Outputs are
// preallocated by the caller; see the contract above.
long long pbx_plan_resolve(
    void* handle,
    const unsigned long long* keys, long long K, long long n_real,
    int dead, int scratch_base,
    int* idx, int* uniq_idx, int* inverse, float* key_mask) {
  if (n_real < 0 || n_real > K) return -1;
  const CensusIndex* ix = static_cast<CensusIndex*>(handle);

  // padding defaults (tail slots + tail occurrences)
  for (long long j = 0; j < K; ++j) {
    long long scratch = (long long)scratch_base + j;
    uniq_idx[j] = (int)(scratch < dead ? scratch : dead);
  }
  for (long long o = n_real; o < K; ++o) {
    idx[o] = dead;
    inverse[o] = (int)(K - 1);
    key_mask[o] = 0.0f;
  }
  if (n_real == 0) return 0;

  // local dedup hash: cell -> slot; keys of the slots live in uniq_key
  unsigned long long lmask = pow2_at_least((unsigned long long)(2 * n_real)) - 1;
  std::vector<unsigned int> lslot((size_t)lmask + 1, kEmpty);
  std::vector<unsigned long long> uniq_key((size_t)n_real);
  std::vector<int> pull_row((size_t)n_real);  // per slot

  long long n_uniq = 0;
  long long n_missing = 0;
  for (long long o = 0; o < n_real; ++o) {
    const unsigned long long k = keys[o];
    unsigned long long h = splitmix64(k) & lmask;
    long long slot = -1;
    while (true) {
      unsigned int s = lslot[h];
      if (s == kEmpty) break;
      if (uniq_key[s] == k) {
        slot = (long long)s;
        break;
      }
      h = (h + 1) & lmask;
    }
    if (slot < 0) {  // first occurrence: census lookup
      slot = n_uniq++;
      lslot[h] = (unsigned int)slot;
      uniq_key[(size_t)slot] = k;
      long long row = -1;
      unsigned long long ch = splitmix64(k) & ix->mask;
      while (true) {
        unsigned int c = ix->slot[ch];
        if (c == kEmpty) break;
        if (ix->keys[c] == k) {
          row = (long long)c;
          break;
        }
        ch = (ch + 1) & ix->mask;
      }
      if (row >= 0) {
        pull_row[(size_t)slot] = (int)row;
        uniq_idx[slot] = (int)row;
      } else {
        pull_row[(size_t)slot] = dead;
        ++n_missing;  // uniq_idx keeps the slot's scratch default
      }
    }
    idx[o] = pull_row[(size_t)slot];
    inverse[o] = (int)slot;
    key_mask[o] = 1.0f;
  }
  return n_missing;
}

}  // extern "C"

extern "C" {

// Sharded-path resolve: dedup occurrences (first-seen slot order) and look
// every unique key up in the census index — WITHOUT the single-chip plan's
// scratch/dead semantics (the sharded planner derives owner shards and
// within-shard rows itself from the census position).
//
// Outputs (preallocated, length K):
//   inverse[occ]   = slot of the occurrence (occ < n_real; tail untouched)
//   uniq_key[j]    = the slot's key                     (j < n_uniq)
//   uniq_pos[j]    = census position or -1 when absent  (j < n_uniq)
// Returns n_uniq (or -1 on bad arguments).
long long pbx_census_lookup_unique(
    void* handle,
    const unsigned long long* keys, long long K, long long n_real,
    int* inverse, unsigned long long* uniq_key, long long* uniq_pos) {
  if (n_real < 0 || n_real > K) return -1;
  const CensusIndex* ix = static_cast<CensusIndex*>(handle);
  if (n_real == 0) return 0;

  unsigned long long lmask =
      pow2_at_least((unsigned long long)(2 * n_real)) - 1;
  std::vector<unsigned int> lslot((size_t)lmask + 1, kEmpty);

  long long n_uniq = 0;
  for (long long o = 0; o < n_real; ++o) {
    const unsigned long long k = keys[o];
    unsigned long long h = splitmix64(k) & lmask;
    long long slot = -1;
    while (true) {
      unsigned int s = lslot[h];
      if (s == kEmpty) break;
      if (uniq_key[s] == k) {
        slot = (long long)s;
        break;
      }
      h = (h + 1) & lmask;
    }
    if (slot < 0) {
      slot = n_uniq++;
      lslot[h] = (unsigned int)slot;
      uniq_key[(size_t)slot] = k;
      long long row = -1;
      unsigned long long ch = splitmix64(k) & ix->mask;
      while (true) {
        unsigned int c = ix->slot[ch];
        if (c == kEmpty) break;
        if (ix->keys[c] == k) {
          row = (long long)c;
          break;
        }
        ch = (ch + 1) & ix->mask;
      }
      uniq_pos[slot] = row;
    }
    inverse[o] = (int)slot;
  }
  return n_uniq;
}

}  // extern "C"

extern "C" {

// Row dedup for the sharded serve side: first-seen-order unique of an
// int32 row-id buffer (no census involved).  Replaces per-shard
// np.unique(serve_rows, return_inverse=True) on the plan_group hot path.
//
// Outputs (preallocated, length n):
//   inverse[i] = slot of rows[i]
//   uniq[j]    = the slot's row id (j < n_uniq)
// Returns n_uniq.
long long pbx_dedup_rows(const int* rows, long long n,
                         int* inverse, int* uniq) {
  if (n <= 0) return 0;
  unsigned long long lmask = pow2_at_least((unsigned long long)(2 * n)) - 1;
  std::vector<unsigned int> lslot((size_t)lmask + 1, kEmpty);
  long long n_uniq = 0;
  for (long long i = 0; i < n; ++i) {
    const int r = rows[i];
    unsigned long long h =
        splitmix64((unsigned long long)(unsigned int)r) & lmask;
    long long slot = -1;
    while (true) {
      unsigned int s = lslot[h];
      if (s == kEmpty) break;
      if (uniq[s] == r) {
        slot = (long long)s;
        break;
      }
      h = (h + 1) & lmask;
    }
    if (slot < 0) {
      slot = n_uniq++;
      lslot[h] = (unsigned int)slot;
      uniq[slot] = r;
    }
    inverse[i] = (int)slot;
  }
  return n_uniq;
}

}  // extern "C"
