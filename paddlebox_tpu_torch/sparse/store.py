"""Bucketed host feature store, the CPU tier under the device working set
(reference: paddlebox_tpu/sparse/store.py).

Keys are partitioned into ``n_buckets`` (a power of two) by the top bits of
a splitmix64 mix of the key, so any key distribution balances.  Each bucket
holds a sorted key array and a row matrix.  A pass-boundary merge updates
rows of known keys in place and rebuilds only buckets that received new
keys.  ``decay_evict`` is the shrink's decay and eviction; ``load_bulk``
replaces the content at a restore.  This port runs the store serially and
in RAM; the reference's thread pool, spill files and durable log are later
slices.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

_EMPTY_KEYS = np.empty(0, dtype=np.uint64)

# splitmix64 finalizer constants (public-domain mixing function)
_MIX_1 = np.uint64(0x9E3779B97F4A7C15)
_MIX_2 = np.uint64(0xBF58476D1CE4E5B9)
_MIX_3 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over a uint64 array: bucket assignment and
    the key-deterministic embedding init (sparse/table.py) share it."""
    with np.errstate(over="ignore"):
        z = x + _MIX_1
        z = (z ^ (z >> np.uint64(30))) * _MIX_2
        z = (z ^ (z >> np.uint64(27))) * _MIX_3
        return z ^ (z >> np.uint64(31))


class BucketStore:
    def __init__(self, n_cols: int, n_buckets: int = 256):
        if n_buckets & (n_buckets - 1) or n_buckets <= 0:
            raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
        self.n_cols = n_cols
        self.n_buckets = n_buckets
        self._shift = np.uint64(64 - (n_buckets.bit_length() - 1))
        self._keys = [_EMPTY_KEYS] * n_buckets
        self._vals = [np.empty((0, n_cols), np.float32)] * n_buckets

    @property
    def n(self) -> int:
        return sum(k.shape[0] for k in self._keys)

    def _bucket_of(self, q: np.ndarray) -> np.ndarray:
        if self.n_buckets == 1:
            # a shift by 64 is undefined for uint64
            return np.zeros(q.shape[0], dtype=np.int64)
        return (splitmix64(q) >> self._shift).astype(np.int64)

    def _split(self, q: np.ndarray) -> Iterator[Tuple[int, np.ndarray]]:
        """(bucket, positions into q) groups; positions ascend within a
        group, so ``q[idx]`` stays sorted per bucket."""
        if q.shape[0] == 0:
            return
        bids = self._bucket_of(q)
        order = np.argsort(bids, kind="stable")
        ub, starts = np.unique(bids[order], return_index=True)
        bounds = np.append(starts, q.shape[0])
        for j in range(ub.shape[0]):
            yield int(ub[j]), order[starts[j] : bounds[j + 1]]

    def lookup(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Rows for sorted unique uint64 keys ``q``: (vals [n, n_cols] with
        zero rows where missing, found bool [n])."""
        out = np.zeros((q.shape[0], self.n_cols), dtype=np.float32)
        found = np.zeros(q.shape[0], dtype=bool)
        for b, idx in self._split(q):
            bk, bv = self._keys[b], self._vals[b]
            if bk.shape[0] == 0:
                continue
            sub = q[idx]
            pos_c = np.minimum(np.searchsorted(bk, sub), bk.shape[0] - 1)
            hit = bk[pos_c] == sub
            out[idx[hit]] = bv[pos_c[hit]]
            found[idx] = hit
        return out, found

    def update(self, q: np.ndarray, vals: np.ndarray) -> None:
        """Overwrite or insert rows for sorted unique keys ``q``."""
        if q.shape[0] > 1 and not bool(np.all(q[:-1] < q[1:])):
            raise ValueError("BucketStore.update requires sorted unique keys")
        for b, idx in self._split(q):
            bk, bv = self._keys[b], self._vals[b]
            sub, subv = q[idx], vals[idx]
            if bk.shape[0] == 0:
                self._keys[b] = sub.copy()
                self._vals[b] = subv.astype(np.float32, copy=True)
                continue
            pos = np.searchsorted(bk, sub)
            pos_c = np.minimum(pos, bk.shape[0] - 1)
            hit = bk[pos_c] == sub
            bv[pos_c[hit]] = subv[hit]
            miss = ~hit
            if miss.any():
                self._keys[b] = np.insert(bk, pos[miss], sub[miss])
                self._vals[b] = np.insert(bv, pos[miss], subv[miss], axis=0)

    def decay_evict(self, decay_cols: int, decay: float, threshold: float) -> int:
        """Decay the first ``decay_cols`` columns of every row and evict rows
        whose column 0 falls below ``threshold``.  Returns the evicted
        count (ShrinkTable semantics)."""
        evicted = 0
        for b in range(self.n_buckets):
            bk, bv = self._keys[b], self._vals[b]
            if bk.shape[0] == 0:
                continue
            bv[:, :decay_cols] *= decay
            if threshold <= 0.0:
                continue
            keep = bv[:, 0] >= threshold
            ne = int((~keep).sum())
            if ne:
                self._keys[b] = bk[keep]
                self._vals[b] = bv[keep]
                evicted += ne
        return evicted

    def clear(self) -> None:
        self._keys = [_EMPTY_KEYS] * self.n_buckets
        self._vals = [np.empty((0, self.n_cols), np.float32)] * self.n_buckets

    def load_bulk(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Replace the store content (checkpoint restore).  ``keys`` need not
        be sorted; duplicates keep the LAST occurrence."""
        self.clear()
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.float32)
        if keys.shape[0]:
            order = np.argsort(keys, kind="stable")
            keys, vals = keys[order], vals[order]
            uniq, last_idx = np.unique(keys[::-1], return_index=True)
            if uniq.shape[0] != keys.shape[0]:
                take = keys.shape[0] - 1 - last_idx  # last occurrence wins
                keys, vals = uniq, vals[take]
        for b, idx in self._split(keys):
            self._keys[b] = keys[idx]
            self._vals[b] = vals[idx]

    def materialize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Whole store as (keys, vals), globally key-sorted."""
        ks = [k for k in self._keys if k.shape[0]]
        if not ks:
            return _EMPTY_KEYS, np.empty((0, self.n_cols), dtype=np.float32)
        vs = [v for k, v in zip(self._keys, self._vals) if k.shape[0]]
        keys = np.concatenate(ks)
        vals = np.concatenate(vs)
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]
