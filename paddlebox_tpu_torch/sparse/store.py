"""Bucketed host feature store, the CPU and disk tier under the device
working set (reference: paddlebox_tpu/sparse/store.py).

Keys are partitioned into ``n_buckets`` (a power of two) by the top bits of
a splitmix64 mix of the key, so any key distribution balances.  Each bucket
holds a sorted key array and a row matrix.  A pass-boundary merge updates
rows of known keys in place and rebuilds only buckets that received new
keys.  ``decay_evict`` is the shrink's decay and eviction; ``load_bulk``
replaces the content at a restore.

Disk tier: with ``spill_dir`` set, at most ``max_resident`` buckets stay in
RAM (LRU); the rest live as ``.npz`` files with a CRC32 of their keys and
rows, and reload on access.  A file that fails its check (or does not
parse) is rebuilt through ``recover_fn`` (the table wires its durable log),
or raises ``StoreCorrupt`` when there is none.  Files from before the
checksum load unverified, with a warning.

Parallelism: buckets are independent, so with ``n_threads > 1`` the
per-bucket work of ``lookup`` / ``update`` / ``decay_evict`` fans out over
a pool of daemon threads (utils/workers.py).  A per-bucket lock serializes
access to each bucket's arrays: the table's merge thread, its staging
thread and the caller may all touch the store at once.  The LRU and spill
bookkeeping holds its own lock and only ever *tries* a bucket lock when it
evicts, so the two lock orders cannot deadlock.  ``close()`` retires the
pool; the next parallel call starts a new one.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from collections import OrderedDict
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.workers import DaemonPool

logger = logging.getLogger(__name__)

_EMPTY_KEYS = np.empty(0, dtype=np.uint64)

# splitmix64 finalizer constants (public-domain mixing function)
_MIX_1 = np.uint64(0x9E3779B97F4A7C15)
_MIX_2 = np.uint64(0xBF58476D1CE4E5B9)
_MIX_3 = np.uint64(0x94D049BB133111EB)


class StoreCorrupt(RuntimeError):
    """A spill file failed its integrity check and no recovery source is
    wired: raised instead of loading the damaged rows."""


def _spill_crc(keys: np.ndarray, vals: np.ndarray) -> int:
    return zlib.crc32(
        np.ascontiguousarray(vals).tobytes(),
        zlib.crc32(np.ascontiguousarray(keys).tobytes()),
    )


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over a uint64 array: bucket assignment and
    the key-deterministic embedding init (sparse/table.py) share it."""
    with np.errstate(over="ignore"):
        z = x + _MIX_1
        z = (z ^ (z >> np.uint64(30))) * _MIX_2
        z = (z ^ (z >> np.uint64(27))) * _MIX_3
        return z ^ (z >> np.uint64(31))


class BucketStore:
    def __init__(
        self,
        n_cols: int,
        n_buckets: int = 256,
        spill_dir: str = "",
        max_resident: int = 64,
        n_threads: int = 0,
        recover_fn: Optional[Callable[[int], Tuple[np.ndarray, np.ndarray]]] = None,
    ):
        if n_buckets & (n_buckets - 1) or n_buckets <= 0:
            raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
        self.n_cols = n_cols
        self.n_buckets = n_buckets
        self._shift = np.uint64(64 - (n_buckets.bit_length() - 1))
        # None = spilled or never written; see _get
        self._keys: list = [None] * n_buckets
        self._vals: list = [None] * n_buckets
        self._counts = np.zeros(n_buckets, dtype=np.int64)
        self._spilled = np.zeros(n_buckets, dtype=bool)
        self.spill_dir = spill_dir
        self.max_resident = max(1, max_resident)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # corrupt-spill recovery: bucket id -> (keys, vals) from a durable
        # tier; None = a corrupt spill raises StoreCorrupt
        self._recover_fn = recover_fn
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self.n_threads = max(int(n_threads), 0)
        self._locks = [threading.Lock() for _ in range(n_buckets)]
        self._lru_lock = threading.Lock()
        self._ctr_lock = threading.Lock()
        self._pool: Optional[DaemonPool] = None
        self._pool_lock = threading.Lock()
        # pass-boundary merge counters
        self.updated_in_place = 0  # keys whose rows were overwritten
        self.inserted = 0  # new keys
        self.buckets_rebuilt = 0  # buckets that had to reallocate
        self.spill_writes = 0
        self.spill_reads = 0

    # -- size -------------------------------------------------------------- #
    @property
    def n(self) -> int:
        return int(self._counts.sum())

    @property
    def resident_buckets(self) -> int:
        return sum(k is not None for k in self._keys)

    # -- bucket residency --------------------------------------------------- #
    def _path(self, b: int) -> str:
        return os.path.join(self.spill_dir, f"bucket_{b:05d}.npz")

    def _touch(self, b: int) -> None:
        if not self.spill_dir:
            return
        with self._lru_lock:
            self._lru[b] = None
            self._lru.move_to_end(b)
            while len(self._lru) > self.max_resident:
                old, _ = self._lru.popitem(last=False)
                if old == b:
                    # never evict the bucket being touched: the caller
                    # holds its lock and is working on its arrays
                    self._lru[old] = None
                    self._lru.move_to_end(old)
                    if len(self._lru) <= 1:
                        break
                    continue
                # the evictor holds the LRU lock, so it may only TRY the
                # victim's bucket lock; a busy victim counts as recently
                # used (residency is best-effort under contention)
                lk = self._locks[old]
                if lk.acquire(blocking=False):
                    try:
                        self._spill(old)
                    finally:
                        lk.release()
                else:
                    self._lru[old] = None
                    self._lru.move_to_end(old)
                    break

    def _spill(self, b: int) -> None:
        k = self._keys[b]
        if k is None:
            return
        if k.shape[0]:
            np.savez(
                self._path(b), keys=k, vals=self._vals[b],
                crc=np.uint32(_spill_crc(k, self._vals[b])),
            )
            self._spilled[b] = True
            self.spill_writes += 1
        elif self._spilled[b]:
            # the bucket emptied (decay_evict) after an earlier spill: the
            # stale file would bring evicted rows back at the next _get
            try:
                os.remove(self._path(b))
            except OSError:
                pass
            self._spilled[b] = False
        self._keys[b] = None
        self._vals[b] = None

    def _get(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """Bucket arrays (loaded from disk if spilled); marks it MRU."""
        k = self._keys[b]
        if k is None:
            if self._spilled[b]:
                try:
                    with np.load(self._path(b)) as z:
                        sk = np.ascontiguousarray(z["keys"], dtype=np.uint64)
                        sv = np.ascontiguousarray(z["vals"], dtype=np.float32)
                        crc = int(z["crc"]) if "crc" in z.files else None
                    if crc is None:
                        # a file from before the checksum: loadable but
                        # unverifiable; the next spill rewrites it with one
                        logger.warning(
                            "spill bucket %d: legacy file without "
                            "checksum, loaded unverified", b,
                        )
                    elif _spill_crc(sk, sv) != crc:
                        raise StoreCorrupt(f"spill bucket {b}: checksum mismatch")
                except Exception as e:  # a torn npz raises many kinds
                    stats.add("store.spill_corrupt")
                    logger.error("spill bucket %d failed verification: %s", b, e)
                    if self._recover_fn is None:
                        raise StoreCorrupt(
                            f"spill bucket {b} corrupt and no durable tier "
                            f"to recover from: {e}"
                        ) from e
                    sk, sv = self._recover_fn(b)
                    sk = np.ascontiguousarray(sk, dtype=np.uint64)
                    sv = np.ascontiguousarray(sv, dtype=np.float32)
                    stats.add("store.spill_recovered", int(sk.shape[0]))
                    self._counts[b] = sk.shape[0]
                self._keys[b] = sk
                self._vals[b] = sv
                self.spill_reads += 1
            else:
                self._keys[b] = _EMPTY_KEYS
                self._vals[b] = np.empty((0, self.n_cols), dtype=np.float32)
        self._touch(b)
        return self._keys[b], self._vals[b]

    def _set(self, b: int, keys: np.ndarray, vals: np.ndarray) -> None:
        self._keys[b] = keys
        self._vals[b] = vals
        self._counts[b] = keys.shape[0]
        self._touch(b)

    # -- query splitting ---------------------------------------------------- #
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

    # -- parallel bucket dispatch ------------------------------------------- #
    def _run_buckets(self, tasks: list) -> list:
        """Run ``(bucket, thunk)`` tasks, each under its bucket's lock: on
        the pool when parallelism is on and more than one bucket is
        touched, serially otherwise.  Returns the results in task order
        (numpy releases the GIL in its searchsorted and copy kernels)."""

        def one(b, fn):
            with self._locks[b]:
                return fn()

        if self.n_threads > 1 and len(tasks) > 1:
            with self._pool_lock:
                if self._pool is None:
                    self._pool = DaemonPool("bucket-store", self.n_threads)
                pool = self._pool
            stats.add("store.parallel_buckets", len(tasks))
            futs = [pool.submit(one, b, fn) for b, fn in tasks]
            return [f.result() for f in futs]
        return [one(b, fn) for b, fn in tasks]

    # -- core API ----------------------------------------------------------- #
    def lookup(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Rows for sorted unique uint64 keys ``q``: (vals [n, n_cols] with
        zero rows where missing, found bool [n])."""
        out = np.zeros((q.shape[0], self.n_cols), dtype=np.float32)
        found = np.zeros(q.shape[0], dtype=bool)

        def work(b, idx):
            # buckets' idx rows are disjoint: concurrent writes never overlap
            bk, bv = self._get(b)
            if bk.shape[0] == 0:
                return
            sub = q[idx]
            pos_c = np.minimum(np.searchsorted(bk, sub), bk.shape[0] - 1)
            hit = bk[pos_c] == sub
            out[idx[hit]] = bv[pos_c[hit]]
            found[idx] = hit

        self._run_buckets(
            [(b, lambda b=b, idx=idx: work(b, idx)) for b, idx in self._split(q)]
        )
        return out, found

    def update(self, q: np.ndarray, vals: np.ndarray) -> None:
        """Overwrite or insert rows for sorted unique keys ``q``."""
        # unsorted input would build unsorted buckets (keys lost to every
        # later searchsorted): the contract is checked, not assumed
        if q.shape[0] > 1 and not bool(np.all(q[:-1] < q[1:])):
            raise ValueError("BucketStore.update requires sorted unique keys")

        def work(b, idx):
            bk, bv = self._get(b)
            sub, subv = q[idx], vals[idx]
            if bk.shape[0] == 0:
                self._set(b, sub.copy(), subv.astype(np.float32, copy=True))
                with self._ctr_lock:
                    self.inserted += sub.shape[0]
                    self.buckets_rebuilt += 1
                return
            pos = np.searchsorted(bk, sub)
            pos_c = np.minimum(pos, bk.shape[0] - 1)
            hit = bk[pos_c] == sub
            if hit.any():
                bv[pos_c[hit]] = subv[hit]
                with self._ctr_lock:
                    self.updated_in_place += int(hit.sum())
            miss = ~hit
            if miss.any():
                self._set(b, np.insert(bk, pos[miss], sub[miss]),
                          np.insert(bv, pos[miss], subv[miss], axis=0))
                with self._ctr_lock:
                    self.inserted += int(miss.sum())
                    self.buckets_rebuilt += 1

        self._run_buckets(
            [(b, lambda b=b, idx=idx: work(b, idx)) for b, idx in self._split(q)]
        )

    # -- maintenance -------------------------------------------------------- #
    def decay_evict(self, decay_cols: int, decay: float, threshold: float) -> int:
        """Decay the first ``decay_cols`` columns of every row and evict rows
        whose column 0 falls below ``threshold``.  Returns the evicted
        count (ShrinkTable semantics)."""

        def work(b):
            bk, bv = self._get(b)
            bv[:, :decay_cols] *= decay
            if threshold <= 0.0:
                return 0
            keep = bv[:, 0] >= threshold
            ne = int((~keep).sum())
            if ne:
                self._set(b, bk[keep], bv[keep])
            return ne

        return sum(self._run_buckets(
            [(b, lambda b=b: work(b))
             for b in range(self.n_buckets) if self._counts[b]]
        ))

    # -- bulk and serialization --------------------------------------------- #
    def close(self) -> None:
        """Retire the bucket pool's threads (joined: they are idle at a
        quiet point).  The next parallel call starts a new pool."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()

    def clear(self) -> None:
        for b in range(self.n_buckets):
            if self._spilled[b]:
                try:
                    os.remove(self._path(b))
                except OSError:
                    pass
        self._keys = [None] * self.n_buckets
        self._vals = [None] * self.n_buckets
        self._counts[:] = 0
        self._spilled[:] = False
        self._lru.clear()

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
            self._set(b, keys[idx], vals[idx])

    def stats(self) -> dict:
        """Bucket-by-bucket size and finiteness report, without a global
        copy.  ``spilled_buckets`` and ``resident_rows`` are read before the
        scan loads spilled buckets back."""
        spilled_buckets = int(self._spilled.sum())
        resident_rows = int(sum(
            int(self._counts[b]) for b in range(self.n_buckets)
            if self._keys[b] is not None
        ))
        n_bytes = 0
        finite = True
        for b in range(self.n_buckets):
            if self._counts[b] == 0:
                continue
            with self._locks[b]:
                bk, bv = self._get(b)
                n_bytes += int(bk.nbytes + bv.nbytes)
                if finite:
                    finite = bool(np.isfinite(bv).all())
        return {
            "n": self.n,
            "bytes": n_bytes,
            "finite": finite,
            "spilled_buckets": spilled_buckets,
            "resident_rows": resident_rows,
        }

    def materialize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Whole store as (keys, vals), globally key-sorted (one argsort:
        hash buckets interleave key ranges)."""
        ks, vs = [], []
        for b in range(self.n_buckets):
            if self._counts[b] == 0:
                continue
            with self._locks[b]:
                bk, bv = self._get(b)
                ks.append(bk)
                vs.append(bv)
        if not ks:
            return _EMPTY_KEYS, np.empty((0, self.n_cols), dtype=np.float32)
        keys = np.concatenate(ks)
        vals = np.concatenate(vs)
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]
