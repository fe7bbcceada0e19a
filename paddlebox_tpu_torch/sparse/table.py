"""Single-chip pass-scoped sparse embedding table (reference:
paddlebox_tpu/sparse/table.py).

  * host store: every feature ever seen, rows ``[show, clk, embed..., g2sum]``
    (float32) in a BucketStore (sparse/store.py: a pool of bucket threads,
    optional spill files).  With ``store_log_dir`` every merge writes
    through to a durable log first (sparse/logstore.py), and a table built
    on the directory recovers the last committed merge.
  * HBM cache (sparse/engine/hbm_cache.py, on by default): hot rows that
    persist on the device across passes.  begin_pass fetches only the
    census misses from the host store and fills the hits from the cache;
    end_pass updates resident rows in place, admits new hot keys and writes
    back only cold and evicted rows.  Dirty cache rows drain into the store
    at every barrier (``flush``: n_features, state_dict, delta_state_dict,
    shrink), and membership is dropped whenever the store changes
    underneath (load_state_dict, apply_delta, shrink).
  * begin_pass(keys): promote the pass working set to the device as one
    ``values [P, W]`` tensor plus ``g2sum [P]``.  Layout: ``[0, n)`` live
    rows (sorted pass keys) | ``[n, P-1)`` plan scratch rows | ``P-1`` the
    dead row, held at zero.  New keys get a key-deterministic uniform
    init (``_key_uniform``).
  * plan_keys(keys): host-side key -> row resolution and batch dedup, all
    outputs of static shape: through the native census index
    (``_native/plan_resolve.cpp``) by default, as in the reference, or
    numpy's unique and searchsorted with PADDLEBOX_TORCH_USE_NATIVE_PLANNER=0.
  * pull_rows / push_and_update: device functions on tensors — the gather,
    and the segment-sum merge + sparse adagrad + counter scatter-add.
  * end_pass(): write the working set back (to the cache and the store).

The overlapped pass boundary (``overlap_pass_boundary``, on by default as in
the reference; PADDLEBOX_TORCH_OVERLAP_PASS_BOUNDARY=0 forces the serial
lifecycle) changes when rows move, never which:

  * end_pass copies the rows to the host and hands the filled numpy arrays
    to a merge thread (``_SerialWorker`` "table-merge"); until a merge
    lands, its rows sit in an overlay that every read consults
    (``_lookup_with_overlay``).  ``flush`` is the barrier and re-raises a
    failed merge, which also poisons every later one.
  * ``prepare_pass(keys)`` stages the NEXT pass on a staging thread while
    the current one trains: the census resolve against store and overlay
    (cache misses only), the init of new keys and the host buffer.
    ``begin_pass`` with the same census then only patches the rows the
    finishing pass wrote back, copies the buffer to the device and fills
    the cache hits.

Both threads do host work only: every tensor operation and kernel launch
(the cache fill's ``gather_slots`` and ``scatter_rows``, the write-back
gathers) stays on the calling thread and its stream.  ``close()`` retires
the threads and the store's pool; the table stays usable.

The dead row serves padding and keys missing from the pass census: pulls
read zeros, and it is re-zeroed after every push.

Telemetry (the reference's names, telemetry/): the boundary's histograms
(``cache.miss_fetch_seconds``, ``store.merge_seconds``,
``pass.promote_seconds``, ``pass.boundary_gap_seconds``: the device-idle
gap from an end_pass return to the next begin_pass return), the
``cache.hit_rate`` gauge, the row-volume and fallback counters, and
``health_stats()``, which the run-health rules read each pass.  The
``last_cache_*`` attributes stay beside them.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import SparseTableConfig, flags
from paddlebox_tpu_torch.data.feed import HostBatch
from paddlebox_tpu_torch.ops import sparse_kernels
from paddlebox_tpu_torch.sparse.engine import CachePlan, HbmCache
from paddlebox_tpu_torch.sparse.optimizer import sparse_adagrad_update
from paddlebox_tpu_torch.sparse.store import (
    _MIX_1,
    _MIX_2,
    BucketStore,
    splitmix64,
)
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.device import resolve_device
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.workers import SerialWorker as _SerialWorker

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BatchPlan:
    """Host-resolved device indices for one batch (all static shapes).

    idx:      int32 [K] — table row per key occurrence (dead row for padding
              or keys absent from the pass census).
    uniq_idx: int32 [U] — table row per unique batch key (U == K; the tail
              points at per-slot scratch rows, clamped to the dead row).
    inverse:  int32 [K] — position of each occurrence in uniq_idx (padding
              occurrences point at slot U-1).
    key_mask: float32 [K] — 1.0 for real key occurrences.
    n_missing: keys that were not in the pass census.
    """

    idx: np.ndarray
    uniq_idx: np.ndarray
    inverse: np.ndarray
    key_mask: np.ndarray
    n_missing: int = 0


def _next_pow2(n: int) -> int:
    return 1 << max(10, (n - 1).bit_length())


def _key_uniform(keys: np.ndarray, seed: int, n_cols: int, rng_range: float) -> np.ndarray:
    """Deterministic per-(key, seed, column) uniform(-range, range) init via
    splitmix64: independent of sharding and of the order keys are seen."""
    with np.errstate(over="ignore"):
        x = (
            keys[:, None].astype(np.uint64)
            + np.uint64(seed + 1) * _MIX_1
            + np.arange(1, n_cols + 1, dtype=np.uint64)[None, :] * _MIX_2
        )
        z = splitmix64(x)
    u = (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))  # [0, 1)
    return ((u * 2.0 - 1.0) * rng_range).astype(np.float32)


def _rows_at(table: torch.Tensor, pos: np.ndarray) -> torch.Tensor:
    """Rows ``table[pos]`` of a device tensor through the gather_slots
    kernel (its twin on the CPU); ``pos`` are host indices, all >= 0."""
    idx = torch.from_numpy(np.ascontiguousarray(pos, dtype=np.int32))
    return sparse_kernels.gather_slots(table, idx.to(table.device))


def _sorted_unique(keys) -> np.ndarray:
    """The census as sorted unique uint64 keys: a copy when ``keys`` is
    already that (a dataset's ``unique_keys()``, checked in one pass), the
    sort of ``np.unique`` otherwise."""
    pk = np.asarray(keys, dtype=np.uint64)
    if pk.ndim == 1 and (pk.shape[0] < 2 or bool(np.all(pk[1:] > pk[:-1]))):
        return pk.copy()
    return np.unique(pk)


def _empty_rows(n_cols: int) -> np.ndarray:
    return np.empty((0, n_cols), dtype=np.float32)


def _patch_in(keys: np.ndarray, rows: np.ndarray, entries, found=None) -> None:
    """Overwrite ``rows`` (aligned with sorted ``keys``) with the rows of
    every (seq, keys, rows) entry for the keys they share, oldest entry
    first, so later passes win; mark them in ``found`` when given."""
    n = keys.shape[0]
    for _, ek, ev in entries:
        if not ek.shape[0] or not n:
            continue
        pos_c = np.minimum(np.searchsorted(ek, keys), ek.shape[0] - 1)
        hit = ek[pos_c] == keys
        if hit.any():
            rows[hit] = ev[pos_c[hit]]
            if found is not None:
                found |= hit


class SparseTable:
    def __init__(self, conf: SparseTableConfig, seed: int = 0, device="cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        self._seed = seed
        w = conf.row_width
        self._store = BucketStore(
            n_cols=w + 1,  # + g2sum
            n_buckets=conf.store_buckets,
            spill_dir=conf.store_spill_dir,
            max_resident=conf.store_max_resident,
            n_threads=conf.store_threads,
            recover_fn=self._recover_spill_bucket,
        )
        # the durable log: every merge writes through and commits a
        # manifest generation; a table built on a committed log recovers
        # its state here
        self._log = None
        self._compact_worker: Optional[_SerialWorker] = None
        self._compact_future = None
        if conf.store_log_dir and flags.durable_store:
            from paddlebox_tpu_torch.sparse.logstore import LogStore

            self._log = LogStore(
                conf.store_log_dir, n_cols=w + 1,
                n_buckets=conf.store_log_buckets,
                compact_threshold=conf.store_compact_threshold,
            )
            self._compact_worker = _SerialWorker("table-compact")
            if self._log.gen > 0:
                rk, rv = self._log.materialize()
                if rk.shape[0]:
                    self._store.load_bulk(rk, rv)
                    logger.info("durable log %s: recovered %d rows at gen %d",
                                conf.store_log_dir, rk.shape[0], self._log.gen)
        self.values: Optional[torch.Tensor] = None  # [P, W]
        self.g2sum: Optional[torch.Tensor] = None  # [P]
        self._pass_keys: Optional[np.ndarray] = None  # sorted
        # the native census index over _pass_keys, built at the pass's
        # first plan (see _native_index)
        self._census_index = None
        self._in_pass = False
        # census of every begin_pass since the last pop, for delta_state_dict
        self._delta_keys: list = []
        # largest key buffer planned so far: sizes the next pass's scratch
        # region (pass 1 uses conf.plan_scratch_rows)
        self._last_plan_k = 0
        # -- the overlapped pass boundary ----------------------------------- #
        # write-backs wait in _overlay as (seq, keys, rows) until their merge
        # lands; _patch_log keeps those made while a stage is pending, for
        # begin_pass's patch of the staged buffer
        self._overlap = bool(conf.overlap_pass_boundary
                             and flags.overlap_pass_boundary)
        self._overlay: list = []
        self._overlay_lock = threading.Lock()
        self._wb_seq = 0
        self._merge_worker = _SerialWorker("table-merge")
        self._merge_futures: list = []
        self._merge_poisoned = False
        self._stage_worker = _SerialWorker("table-stage")
        self._stage_future = None
        self._patch_log: list = []
        # the persistent HBM cache, built at the first begin_pass or
        # prepare_pass (None when conf.hbm_cache_rows == 0 or
        # PADDLEBOX_TORCH_HBM_CACHE=0).  _cache_lock makes the directory
        # changes and their write-back atomic against a stage's snapshot.
        self._cache: Optional[HbmCache] = None
        self._cache_tried = False
        self._cache_lock = threading.Lock()
        self._cache_plan: Optional[CachePlan] = None
        self.last_cache_hits = 0
        self.last_cache_misses = 0  # == the begin-pass promotion patch rows
        # rows the last end_pass evicted from the cache and wrote to the
        # host store (the reference counts both in its telemetry)
        self.last_evicted_rows = 0
        self.last_write_back_rows = 0
        self.missing_key_count = 0
        # seconds of the last begin_pass by phase (census, stage_wait,
        # patch, resolve, h2d, cache_fill) and whether it consumed a stage;
        # with boundary_timing set, the card is synchronized between phases
        # so that each holds its device work
        self.boundary_timing = False
        self.last_begin_breakdown: dict = {}
        # the last end_pass's return (monotonic), for the boundary gap
        self._last_end_t: Optional[float] = None

    # -- introspection --------------------------------------------------- #
    @property
    def n_features(self) -> int:
        self.flush()  # pending merges and hot cache rows land first
        return self._store.n

    @property
    def overlap_enabled(self) -> bool:
        """True when this table runs the overlapped pass boundary."""
        return self._overlap

    @property
    def capacity(self) -> int:
        return 0 if self.values is None else int(self.values.shape[0])

    @property
    def dead_row(self) -> int:
        return self.capacity - 1

    def _native_index(self):
        """The native census index of this pass, built on first use; None
        when the native planner is off or did not build.  Shared by the
        single-chip and the sharded planners, and dropped, never freed
        eagerly, at every pass boundary."""
        if not flags.use_native_planner:
            return None
        if self._census_index is None:
            from paddlebox_tpu_torch._native import build_census_index

            self._census_index = build_census_index(self._pass_keys)
        return self._census_index

    def _stage_cap(self, n_keys: int) -> int:
        """Device rows begin_pass allocates for a census of n_keys keys."""
        scratch = self._last_plan_k or self.conf.plan_scratch_rows
        return _next_pow2(n_keys + 1 + scratch)

    def _stamp(self) -> float:
        if self.boundary_timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # -- the HBM cache ----------------------------------------------------- #
    def _get_cache(self) -> Optional[HbmCache]:
        """The persistent HBM hot-row cache, built on first use (None when
        disabled).  Built on the calling thread: prepare_pass builds it
        before it hands anything to the staging thread."""
        if not self._cache_tried:
            with self._cache_lock:
                if not self._cache_tried:
                    if self.conf.hbm_cache_rows > 0 and flags.hbm_cache:
                        self._cache = HbmCache(
                            self.conf.hbm_cache_rows, self.conf.row_width + 1,
                            aging=self.conf.hbm_cache_aging,
                            device=self.device,
                        )
                    self._cache_tried = True
        return self._cache

    def _caches(self) -> list:
        """Every cache this table owns (one on a single chip)."""
        c = self._get_cache()
        return [c] if c is not None else []

    def health_stats(self) -> dict:
        """Cheap per-pass health snapshot for telemetry/health.py: O(1)
        gauges only, never a scan of the store.  ``cache_hit_rate`` is
        present only once the cache has served a pass (an absent signal
        makes the collapse rule skip, not fire)."""
        hits = int(self.last_cache_hits)
        misses = int(self.last_cache_misses)
        out = {
            "cache_hits": hits,
            "cache_misses": misses,
            # the begin-pass promotion patch is exactly the miss rows
            "promotion_patch_rows": misses,
            "merge_backlog": len(self._merge_futures),
            "overlay_entries": len(self._overlay),
            "missing_keys": int(self.missing_key_count),
            "store_rows": int(self._store.n),
            "store_resident_buckets": int(self._store.resident_buckets),
        }
        if hits + misses > 0:
            out["cache_hit_rate"] = hits / (hits + misses)
        caches = self._caches()
        if caches:
            out["cache_capacity"] = int(sum(c.capacity for c in caches))
            out["cache_resident"] = int(sum(c.resident for c in caches))
        return out

    def _cache_fetch_rows(self, miss: np.ndarray, _entries=None) -> np.ndarray:
        """Host-tier fetch of the cache-MISS rows: the begin-pass promotion
        patch, O(cold keys).  Fault site ``cache.fetch``: the callers catch
        the failure and degrade to the full host resolve
        (``_cache_degrade``), never to stale rows."""
        faults.inject("cache.fetch")
        t0 = time.perf_counter()
        rows = self._resolve_or_init(miss, _entries=_entries)
        telemetry.histogram(
            "cache.miss_fetch_seconds",
            "host-tier fetch of the census cache misses (promotion patch)",
        ).observe(time.perf_counter() - t0)
        return rows

    def _cache_degrade(self, pk: np.ndarray) -> None:
        """cache.fetch failed: write every dirty row back and drop the
        census keys from the caches, so the pass runs fully host-resolved
        (the overlay shows the drained rows at once) with no stale row."""
        telemetry.counter(
            "cache.fetch_fallbacks",
            "promotion fetches degraded to the full host resolve",
        ).inc()
        self._drain_cache()
        caches = self._caches()
        with self._cache_lock:
            for c in caches:
                c.evict_keys(pk)

    def _drain_cache(self) -> None:
        """Write every dirty cache row back to the host store in one
        globally sorted write-back over the caches, so the store is truth
        again for every resident key (part of the flush barrier)."""
        caches = self._caches()
        if not caches:
            return
        with self._cache_lock:
            ks, vs = [], []
            for c in caches:
                k, v = c.drain()
                if k.shape[0]:
                    ks.append(k)
                    vs.append(v)
            if ks:
                k = np.concatenate(ks)
                order = np.argsort(k, kind="stable")
                self._write_back(k[order], np.concatenate(vs)[order])

    def _invalidate_caches(self) -> None:
        """Drop cache membership (no row moves): required whenever the host
        store changes underneath."""
        caches = self._caches()  # before the lock: creation takes it too
        with self._cache_lock:
            for c in caches:
                c.invalidate()

    # -- the overlapped pass boundary --------------------------------------- #
    def _lookup_with_overlay(self, q: np.ndarray, entries=None):
        """Store lookup with the pending write-backs laid over it, newest
        last.  ``entries`` pins a snapshot of the overlay (a stage's
        consistency point); None reads the current one.  An entry whose
        merge already landed holds exactly the rows the store got, so
        applying it again is harmless."""
        if entries is None:
            with self._overlay_lock:
                entries = list(self._overlay)
        vals, found = self._store.lookup(q)
        _patch_in(q, vals, entries, found)
        return vals, found

    def _write_back(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Hand rows of sorted unique ``keys`` (a filled host array) to the
        store: merged now on the serial table, through the overlay and the
        merge thread when overlapped."""
        if keys.shape[0] == 0:
            return
        if not self._overlap:
            self._merge_into_store(keys, vals)
            return
        with self._overlay_lock:
            self._wb_seq += 1
            entry = (self._wb_seq, keys, vals)
            self._overlay.append(entry)
            if self._stage_future is not None:
                # a pending stage may have resolved before these rows
                # existed: begin_pass patches its buffer from this log
                self._patch_log.append(entry)
        self._merge_futures.append(
            self._merge_worker.submit(self._merge_job, entry)
        )

    def _merge_job(self, entry) -> None:
        seq, keys, vals = entry
        t0 = time.perf_counter()
        try:
            if self._merge_poisoned:
                # an earlier merge failed: landing this one would skip a
                # pass in the store's layering, so the store stays at the
                # last good pass (the overlay keeps reads right and flush
                # raises)
                raise RuntimeError(
                    "store merge disabled: an earlier pass write-back "
                    "failed (surfaced at flush)"
                )
            faults.inject("store.merge")
            self._merge_into_store(keys, vals)
        except BaseException:
            self._merge_poisoned = True
            raise
        with self._overlay_lock:
            # merges run in order on one thread and a failure poisons the
            # rest, so the oldest overlay entry is always this one
            head = self._overlay.pop(0)
            assert head[0] == seq, "merge completed out of order"
        telemetry.histogram(
            "store.merge_seconds",
            "background pass write-back merge wall time",
        ).observe(time.perf_counter() - t0)

    def flush(self) -> None:
        """The barrier before anything reads the host store as truth: drain
        the dirty cache rows, then wait for every pending merge (the first
        failure re-raises)."""
        self._drain_cache()
        while self._merge_futures:
            self._merge_futures.pop(0).result()
        if self._log is not None:
            self._log.commit()

    def close(self) -> None:
        """Quiesce and retire the background threads: drop a staged pass,
        barrier on the merges and the compaction, close the log, and retire
        the merge, stage and compaction threads and the store's pool.  The
        table stays usable: its threads start again on the next use."""
        if self._in_pass:
            raise RuntimeError("end_pass (or abort_pass) before close")
        try:
            self._discard_stage()
            self.flush()
            if self._compact_future is not None:
                try:
                    self._compact_future.result()
                except Exception:
                    logger.warning("background log compaction failed at close",
                                   exc_info=True)
                self._compact_future = None
            if self._log is not None:
                self._log.close()
        finally:
            self._store.close()
            for wk in (self._merge_worker, self._stage_worker,
                       self._compact_worker):
                if wk is not None and not wk.close():
                    logger.warning("a table thread did not exit on close; "
                                   "it is a daemon and retires after its job")

    def _discard_stage(self) -> None:
        """Drop any staged next pass (after its job ends, so no staging read
        races a store change) and trim the patch log."""
        fut, self._stage_future = self._stage_future, None
        if fut is not None:
            try:
                fut.result()
            except Exception:
                logger.debug("discarded a failed background stage",
                             exc_info=True)
        with self._overlay_lock:
            self._patch_log = []

    def prepare_pass(self, pass_keys) -> None:
        """Stage the NEXT pass's working set on the staging thread while
        the current pass trains: the census resolve against store and
        overlay, the init of new keys, and the host buffer begin_pass
        copies to the device.  ``pass_keys`` is the key array or a
        zero-argument callable returning it (called on the staging thread,
        so it may wait for a dataset load).  No-op on a serial table.
        begin_pass with the same census consumes the stage; any mismatch
        falls back to its synchronous resolve."""
        if not self._overlap:
            return
        self._discard_stage()
        self._caches()  # the cache's tensors are made here, not off-thread
        self._stage_future = self._stage_worker.submit(self._stage_job,
                                                       pass_keys)

    def staged_pass_keys(self) -> Optional[np.ndarray]:
        """Wait for a pending stage and return its census (the sorted unique
        keys to call begin_pass with), or None when nothing is staged."""
        if self._stage_future is None:
            return None
        return self._stage_future.result()[0]

    def _stage_snapshot(self):
        """(cache directories, write-back seq, overlay) for a stage, taken
        under _cache_lock then _overlay_lock, the order end_pass changes
        them in: a stage never pairs a directory from before an eviction
        with an overlay from after it."""
        caches = self._caches()
        with self._cache_lock:
            cache_keys = [c.snapshot_keys() for c in caches]
            with self._overlay_lock:
                return cache_keys, self._wb_seq, list(self._overlay)

    def _stage_resolve(self, pk: np.ndarray, out: np.ndarray, cache_keys,
                       entries) -> bool:
        """Fill ``out`` [n, W+1] for census ``pk`` on the staging thread.
        With a cache, only the keys absent from the snapshot directory
        (hits are filled on the device at begin_pass; keys the finishing
        pass evicts are always written back, so the patch covers them).
        False when the fetch was fault-injected: begin_pass then discards
        the stage and resolves synchronously."""
        if cache_keys is None:
            out[:] = self._resolve_or_init(pk, _entries=entries)
            return True
        miss_pos = np.nonzero(~HbmCache.hit_mask_in(cache_keys, pk))[0]
        try:
            if miss_pos.shape[0]:
                out[miss_pos] = self._cache_fetch_rows(pk[miss_pos],
                                                       _entries=entries)
        except faults.FaultInjected:
            return False
        return True

    def _stage_job(self, pass_keys):
        t0 = time.perf_counter()
        if callable(pass_keys):
            pass_keys = pass_keys()
        pk = _sorted_unique(pass_keys)
        cache_keys, stage_seq, entries = self._stage_snapshot()
        vals = np.zeros((self._stage_cap(pk.shape[0]), self.conf.row_width + 1),
                        dtype=np.float32)
        if not self._stage_resolve(pk, vals[: pk.shape[0]],
                                   cache_keys[0] if cache_keys else None,
                                   entries):
            return pk, None, stage_seq
        telemetry.histogram(
            "pass.promote_seconds",
            "background next-pass census resolve + init + staging wall time",
        ).observe(time.perf_counter() - t0)
        return pk, vals, stage_seq

    def _pop_stage(self):
        """Consume the pending stage: (payload, patches), the _stage_job
        result (payload[-1] is its write-back seq) and the write-backs newer
        than it, or (None, []) when nothing is staged."""
        fut, self._stage_future = self._stage_future, None
        if fut is None:
            return None, []
        try:
            payload = fut.result()
        except Exception:
            stats.add("pass.stage_discards")
            with self._overlay_lock:
                self._patch_log = []
            raise
        with self._overlay_lock:
            patches = [e for e in self._patch_log if e[0] > payload[-1]]
            self._patch_log = []
        return payload, patches

    def _use_stage(self, payload, patches, pk: np.ndarray, cap: int):
        """The patched [cap, W+1] host buffer of a stage that matches the
        census and the capacity, else None (counted as a discard).  The
        patch copies every newer write-back's rows of the keys it shares
        with the census."""
        if payload is None:
            return None
        spk, vals, _ = payload
        if (vals is None or vals.shape[0] != cap
                or not np.array_equal(spk, pk)):
            # the stage's fetch was fault-injected, the census changed
            # between staging and begin_pass, or the scratch sizing moved:
            # resolve synchronously
            stats.add("pass.stage_discards")
            return None
        _patch_in(pk, vals[: pk.shape[0]], patches)
        return vals

    # -- pass lifecycle --------------------------------------------------- #
    def _resolve_or_init(self, pk: np.ndarray, _entries=None) -> np.ndarray:
        """Rows [n, W+1] for sorted unique keys ``pk``: from the host store
        with the pending write-backs laid over it, then from the durable
        log for keys the store lacks, freshly initialized otherwise."""
        w = self.conf.row_width
        if not pk.shape[0]:
            return np.zeros((0, w + 1), dtype=np.float32)
        vals, found = self._lookup_with_overlay(pk, _entries)
        n_new = int((~found).sum())
        if n_new and self._log is not None:
            # the log's bloom and min-max filters prove most unseen keys
            # are on no segment without a read; only the maybes pay one
            miss_idx = np.nonzero(~found)[0]
            maybe = self._log.might_contain(pk[miss_idx])
            stats.add("store.census_disk_rejects", int((~maybe).sum()))
            if maybe.any():
                lv, lf = self._log.lookup(pk[miss_idx[maybe]])
                if lf.any():
                    hit_idx = miss_idx[maybe][lf]
                    vals[hit_idx] = lv[lf]
                    found[hit_idx] = True
                    n_new -= int(lf.sum())
                    stats.add("store.census_log_hits", int(lf.sum()))
        if n_new:
            init = np.zeros((n_new, w + 1), dtype=np.float32)
            init[:, self.conf.cvm_offset : w] = _key_uniform(
                pk[~found], self._seed, w - self.conf.cvm_offset,
                self.conf.initial_range,
            )
            vals[~found] = init
        return vals

    def _cache_plan_and_fill(self, cache: HbmCache, plan: CachePlan,
                             buf: torch.Tensor, n: int) -> None:
        """Fill every hit position of the pass buffer ``buf`` [cap, W+1]
        straight from the cache (hits never touch the host): a gather_slots
        of the hit slots, a scatter_rows into the hit positions.  Then
        credit the census and record the pass's hit counts."""
        if plan.n_hits:
            pos = torch.from_numpy(plan.hit_pos).to(self.device)
            sparse_kernels.scatter_rows(buf, pos,
                                        cache.gather_rows(plan.hit_slots))
        cache.touch(plan)
        self.last_cache_hits = plan.n_hits
        self.last_cache_misses = n - plan.n_hits
        telemetry.gauge(
            "cache.hit_rate",
            "fraction of the pass census served from the HBM cache",
        ).set(plan.n_hits / max(n, 1))

    def _observe_gap(self) -> None:
        """Record one pass-boundary device-idle gap (end_pass return ->
        begin_pass return), the number the whole pipeline exists to
        shrink."""
        if self._last_end_t is None:
            return
        telemetry.histogram(
            "pass.boundary_gap_seconds",
            "device-idle gap from end_pass return to begin_pass return",
        ).observe(time.monotonic() - self._last_end_t)
        self._last_end_t = None

    def begin_pass(self, pass_keys: np.ndarray) -> None:
        """Promote the pass working set to the device.  A matching stage
        leaves only the patch, the copy and the cache fill; with the HBM
        cache, the host supplies only the census misses (the promotion
        patch) and the hits are filled on the device."""
        if self._in_pass:
            raise RuntimeError("end_pass the previous pass first")
        t0 = self._stamp()
        pk = _sorted_unique(pass_keys)
        w = self.conf.row_width
        n = pk.shape[0]
        cap = self._stage_cap(n)
        cache = self._get_cache()
        tc = time.perf_counter()
        payload, patches = self._pop_stage()
        t1 = time.perf_counter()
        vals = self._use_stage(payload, patches, pk, cap)
        staged = vals is not None
        t2 = time.perf_counter()
        plan = None
        if vals is None:
            vals = np.zeros((cap, w + 1), dtype=np.float32)
            if cache is not None:
                # the reference resolves the census twice (once to pick the
                # misses, once to fill the hits); nothing changes the
                # directory in between, so one plan serves both
                try:
                    plan = cache.lookup(pk)
                    miss_pos = np.nonzero(~plan.hit_mask)[0]
                    if miss_pos.shape[0]:
                        vals[miss_pos] = self._cache_fetch_rows(pk[miss_pos])
                except faults.FaultInjected:
                    # a degraded pass: dirty rows drain, the census leaves
                    # the cache, and the host resolves everything
                    self._cache_degrade(pk)
                    cache = plan = None
            if cache is None:
                vals[:n] = self._resolve_or_init(pk)
        t3 = self._stamp()
        buf = torch.from_numpy(vals).to(self.device)
        t4 = self._stamp()
        if cache is not None:
            # a staged buffer holds rows at the current misses (patched:
            # evicted keys are always written back); the current hits are
            # filled here on the device
            if plan is None:
                plan = cache.lookup(pk)
            self._cache_plan_and_fill(cache, plan, buf, n)
        self._cache_plan = plan
        # host-plane promotion volume: every census row the device could
        # not fill from its own cache crossed host -> device here
        n_hits = plan.n_hits if plan is not None else 0
        telemetry.counter(
            "pass.host_row_bytes_in",
            "embedding-row bytes promoted host->device at begin_pass "
            "(cache misses + cold materialization)",
        ).inc(max(n - n_hits, 0) * 4 * (w + 1))
        # two contiguous tensors: the kernels take no strided views
        self.values = buf[:, :w].contiguous()
        self.g2sum = buf[:, w].contiguous()
        t5 = self._stamp()
        self.last_begin_breakdown = {
            "staged": staged, "census_s": tc - t0, "stage_wait_s": t1 - tc,
            "patch_s": t2 - t1, "resolve_s": t3 - t2, "h2d_s": t4 - t3,
            "cache_fill_s": t5 - t4,
        }
        self._pass_keys = pk
        self._census_index = None  # stale: it indexes the previous census
        self._in_pass = True
        self._delta_keys.append(pk)
        self._observe_gap()

    @staticmethod
    def _cache_update_plan(cache: HbmCache, pk: np.ndarray, plan: CachePlan):
        """The admission decision of the finished pass.  Fault site
        ``cache.admit``: a failure returns None, and the caller degrades to
        the full write-back with the census leaving the cache."""
        try:
            faults.inject("cache.admit")
            return cache.plan_update(pk, plan)
        except faults.FaultInjected:
            telemetry.counter(
                "cache.admit_fallbacks",
                "cache admissions degraded to the full host write-back",
            ).inc()
            return None

    def _end_pass_cached(self, cache: HbmCache, plan: CachePlan,
                         pk: np.ndarray, n: int) -> None:
        """Cached end of pass: hits update their cache slots in place, the
        hottest misses are admitted (evicting aged-out residents), and ONLY
        cold and evicted rows travel to the host.  Evicted rows are written
        back even when clean, so a staged next pass that saw them resident
        is patched from the write-back (see hbm_cache.py)."""
        full = torch.cat([self.values, self.g2sum[:, None]], dim=1)
        upd = self._cache_update_plan(cache, pk, plan)
        if upd is None:
            # the census hits leave the cache and every row writes back,
            # as on an uncached table
            vals = full[:n].cpu().numpy()
            count_rows_out(vals)
            with self._cache_lock:
                cache.evict_keys(pk[plan.hit_mask])
                self._write_back(pk, vals)
            self.last_write_back_rows = n
            return
        upd_pos = np.concatenate([plan.hit_pos, upd.admit_pos])
        upd_slots = np.concatenate([plan.hit_slots, upd.admit_slots])
        # victims are read before set_rows overwrites their slots
        victim_rows = (
            cache.gather_rows(upd.victim_slots).cpu().numpy()
            if upd.victim_slots.shape[0] else _empty_rows(cache.n_cols)
        )
        cold_rows = (
            _rows_at(full, upd.cold_pos).cpu().numpy()
            if upd.cold_pos.shape[0] else _empty_rows(cache.n_cols)
        )
        if upd_slots.shape[0]:
            cache.set_rows(upd_slots, _rows_at(full, upd_pos))
        wb_keys = np.concatenate([pk[upd.cold_pos], upd.victim_keys])
        order = np.argsort(wb_keys, kind="stable")
        count_rows_out(cold_rows, victim_rows)
        with self._cache_lock:
            cache.commit_update(plan, upd)
            self._write_back(wb_keys[order],
                             np.concatenate([cold_rows, victim_rows])[order])
        self.last_evicted_rows = int(upd.victim_slots.shape[0])
        self.last_write_back_rows = int(wb_keys.shape[0])
        count_evicted(self.last_evicted_rows)

    def end_pass(self) -> None:
        """Write the working set back: to the cache for its resident and
        admitted rows, to the host store for the rest.  An overlapped table
        pays only the copy to the host here; the merge runs on its thread."""
        if not self._in_pass:
            raise RuntimeError("no pass in flight")
        pk = self._pass_keys
        n = pk.shape[0]
        cache = self._get_cache()
        plan, self._cache_plan = self._cache_plan, None
        self.last_evicted_rows = self.last_write_back_rows = 0
        if cache is not None and plan is not None and n:
            self._end_pass_cached(cache, plan, pk, n)
        elif n:
            vals = torch.cat([self.values[:n], self.g2sum[:n, None]], dim=1)
            vals = vals.cpu().numpy()
            count_rows_out(vals)
            self._write_back(pk, vals)
            self.last_write_back_rows = n
        self.values = None
        self.g2sum = None
        # drop the index rather than close it: a feed-prefetch producer that
        # outlived its close() join may still be inside resolve() with its
        # own reference, and refcounting frees the handle only after that
        # (CensusIndex.__del__), where a close here would free it under it
        self._census_index = None
        self._pass_keys = None
        self._in_pass = False
        self._last_end_t = time.monotonic()

    def abort_pass(self) -> None:
        """Discard the in-flight working set without writing it back.  The
        store and the cache keep the last completed pass's state (cache rows
        change only at end_pass); the aborted census leaves the delta
        tracker.  No-op when no pass is open."""
        if not self._in_pass:
            return
        self.values = None
        self.g2sum = None
        self._census_index = None  # dropped, not closed: see end_pass
        self._pass_keys = None
        self._in_pass = False
        self._cache_plan = None
        if self._delta_keys:
            self._delta_keys.pop()

    def _merge_into_store(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Merge rows for sorted unique ``keys`` into the store.  With a
        durable log the rows land there first and commit a generation: a
        failure aborts before the store sees them, and a kill after the
        commit replays them at the next construction."""
        vals32 = np.asarray(vals, dtype=np.float32)
        if self._log is not None:
            self._log.append(keys, vals32)
            self._log.commit()
            self._maybe_compact_log()
        self._store.update(keys, vals32)

    def _recover_spill_bucket(self, b: int):
        """The store's corrupt-spill recovery: bucket ``b`` rebuilt from the
        durable log's committed state."""
        if self._log is None:
            raise RuntimeError(
                f"spill bucket {b} corrupt and no durable log configured"
            )
        lk, lv = self._log.materialize()
        mask = self._store._bucket_of(lk) == b
        return lk[mask], lv[mask]

    def _maybe_compact_log(self) -> None:
        """Start a background compaction when a log bucket crossed the
        segment threshold, one at a time.  A failure is counted and logged,
        never fatal: the log stays correct, only longer."""
        if self._log is None or not self._log.buckets_over_threshold():
            return
        fut = self._compact_future
        if fut is not None and not fut.done():
            return
        if fut is not None and fut.exception() is not None:
            stats.add("store.compact_failures")
            logger.warning("background log compaction failed: %s",
                           fut.exception())
        self._compact_future = self._compact_worker.submit(self._log.compact)

    # -- maintenance ------------------------------------------------------- #
    def shrink(self) -> int:
        """Decay show/clk and evict cold features (the reference's per-day
        ShrinkTable).  Returns the number of evicted rows."""
        if self._in_pass:
            raise RuntimeError("shrink between passes, not inside one")
        # a stage resolved before the shrink would bring back undecayed rows
        self._discard_stage()
        if self.n_features == 0:  # n_features flushes: merges and cache
            return 0
        evicted = self._store.decay_evict(
            decay_cols=2,  # show + clk
            decay=self.conf.show_decay_rate,
            threshold=self.conf.delete_threshold,
        )
        # cached rows predate the decay: the next pass re-reads the store
        self._invalidate_caches()
        if self._log is not None:
            # the log must not bring decayed or evicted rows back at a
            # recovery: one rewrite generation replaces it
            lk, lv = self._store.materialize()
            self._log.rewrite(lk, lv)
        return evicted

    # -- persistence ------------------------------------------------------- #
    def state_dict(self) -> dict:
        """Key-sorted copy of the host store: {"keys", "values" [n, W+1]}."""
        if self._in_pass:
            raise RuntimeError("end_pass before checkpointing")
        self.flush()
        keys, vals = self._store.materialize()
        return {"keys": keys, "values": vals}

    def load_state_dict(self, state: dict) -> None:
        self.flush()  # pending merges must not land on top of the restore
        self._discard_stage()  # a stage resolved before it is stale
        self._store.load_bulk(
            np.asarray(state["keys"], dtype=np.uint64),
            np.asarray(state["values"], dtype=np.float32),
        )
        # every cached row is now stale relative to the restored store
        self._invalidate_caches()
        if self._log is not None:
            # a recovery must give the restored state, not the one before
            lk, lv = self._store.materialize()
            self._log.rewrite(lk, lv)

    def pass_state_dict(self) -> dict:
        """Snapshot usable mid-pass: the live working set when a pass is
        open, the host store otherwise."""
        if not self._in_pass:
            return self.state_dict()
        n = self._pass_keys.shape[0]
        vals = torch.cat([self.values[:n], self.g2sum[:n, None]], dim=1)
        return {"keys": self._pass_keys, "values": vals.cpu().numpy()}

    def delta_state_dict(self) -> dict:
        """Rows touched since the last pop (the reference's SaveDelta)."""
        if self._in_pass:
            raise RuntimeError("end_pass before checkpointing")
        self.flush()
        if not self._delta_keys:
            return {
                "keys": np.empty(0, np.uint64),
                "values": _empty_rows(self.conf.row_width + 1),
            }
        dk = np.unique(np.concatenate(self._delta_keys))
        vals, found = self._store.lookup(dk)
        # keys evicted since drop out of the delta
        return {"keys": dk[found], "values": vals[found]}

    def pop_delta(self) -> dict:
        state = self.delta_state_dict()
        self._delta_keys = []
        return state

    def clear_delta(self) -> None:
        """Reset the delta tracker (call only after a successful save)."""
        self._delta_keys = []

    def apply_delta(self, state: dict) -> None:
        keys = np.asarray(state["keys"], dtype=np.uint64)
        if keys.shape[0]:
            # ordered after the pending merges; a stage resolved before
            # these rows existed is dropped
            self.flush()
            self._discard_stage()
            self._merge_into_store(keys,
                                   np.asarray(state["values"], np.float32))
            # delta rows may overwrite keys the cache holds
            self._invalidate_caches()

    # -- batch planning (host) ------------------------------------------- #
    def plan_batch(self, batch: HostBatch) -> BatchPlan:
        return self.plan_keys(batch.keys, batch.n_keys)

    def plan_keys(self, keys: np.ndarray, n_real: int) -> BatchPlan:
        """Resolve a padded key buffer to device row indices + dedup maps.

        ``idx`` (the pull side) maps missing and padding occurrences to the
        dead row.  ``uniq_idx`` (the push side) maps every non-live slot to
        its own scratch row (scratch_base + slot), so push targets are
        unique by construction; slots past the scratch region clamp to the
        dead row, whose deltas push_and_update zeroes."""
        if not self._in_pass:
            raise RuntimeError("begin_pass before planning batches")
        K = keys.shape[0]
        dead = self.dead_row
        scratch_base = self._pass_keys.shape[0]
        self._last_plan_k = max(self._last_plan_k, K)

        # the C++ planner: a per-pass census hash index and one sort-free
        # O(K) walk that numbers unique slots in first-seen order.  Training
        # results equal the numpy path's bit for bit (idx is order-free and
        # the push permutes inverse and uniq_idx consistently).
        ix = self._native_index()
        if ix is not None:
            out = ix.resolve(keys, n_real, dead, scratch_base)
            if out is not None:
                idx, uniq_idx, inverse, mask, n_missing = out
                self.missing_key_count += n_missing
                return BatchPlan(idx, uniq_idx, inverse, mask, n_missing)

        idx = np.full(K, dead, dtype=np.int32)
        uniq_idx = np.minimum(
            scratch_base + np.arange(K, dtype=np.int32), dead
        )
        inverse = np.full(K, K - 1, dtype=np.int32)
        mask = np.zeros(K, dtype=np.float32)
        n_missing = 0
        if n_real:
            uk, inv = np.unique(keys[:n_real], return_inverse=True)
            pos = np.searchsorted(self._pass_keys, uk)
            npk = self._pass_keys.shape[0]
            pos_c = np.minimum(pos, max(npk - 1, 0))
            found = (self._pass_keys[pos_c] == uk) if npk else np.zeros(uk.shape[0], bool)
            nu = uk.shape[0]
            # push target: the live row when found, the slot's scratch row else
            rows_push = np.where(found, pos_c, uniq_idx[:nu]).astype(np.int32)
            rows_pull = np.where(found, pos_c, dead).astype(np.int32)
            n_missing = int((~found).sum())
            uniq_idx[:nu] = rows_push
            idx[:n_real] = rows_pull[inv]
            inverse[:n_real] = inv
            mask[:n_real] = 1.0
        self.missing_key_count += n_missing
        return BatchPlan(idx, uniq_idx, inverse, mask, n_missing)


# ------------------------------------------------------------------------- #
# Device functions on tensors
# ------------------------------------------------------------------------- #
def count_rows_out(*rows: np.ndarray) -> None:
    """The end_pass write-back volume: device -> host row bytes."""
    telemetry.counter(
        "pass.host_row_bytes_out",
        "embedding-row bytes written back device->host at "
        "end_pass (cold + evicted rows)",
    ).inc(sum(r.nbytes for r in rows))


def count_evicted(n: int) -> None:
    if n:
        telemetry.counter(
            "cache.evicted_rows",
            "rows evicted from the HBM cache (written back to the host)",
        ).inc(n)


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather through the pull_rows kernel (its twin on the CPU)."""
    return sparse_kernels.pull_rows(values, idx)


def scatter_add_rows(values: torch.Tensor, idx: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """In-place row scatter-add through the scatter_add_rows kernel (its
    twin on the CPU); duplicates accumulate.  Returns ``values``."""
    return sparse_kernels.scatter_add_rows(values, idx, delta)


def pull_rows(
    values: torch.Tensor,
    idx: torch.Tensor,
    create_threshold: float = 0.0,
    cvm_offset: int = 2,
    pull_embedx_scale: float = 1.0,
) -> torch.Tensor:
    """Gather pulled value rows [K, W].  With create_threshold > 0, the
    embedding of a row whose show count is below it reads as zero.
    pull_embedx_scale != 1 descales the embedx columns, but not the first
    embed column (embed_w), which a quantized table stores unscaled."""
    rows = gather_rows(values, idx)
    if create_threshold > 0.0 or pull_embedx_scale != 1.0:
        embed = rows[:, cvm_offset:]
        if pull_embedx_scale != 1.0:
            embed = torch.cat(
                [embed[:, :1], embed[:, 1:] * pull_embedx_scale], dim=1
            )
        if create_threshold > 0.0:
            visible = (rows[:, 0:1] >= create_threshold).to(rows.dtype)
            embed = embed * visible
        rows = torch.cat([rows[:, :cvm_offset], embed], dim=1)
    return rows


def _segment_sum(x: torch.Tensor, segments: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(
        (n, *x.shape[1:]), dtype=x.dtype, device=x.device
    ).index_add_(0, segments, x)


# Padding and routed-away occurrences all fall into one dropped sink
# segment.  Under torch.use_deterministic_algorithms the card's index_add_
# sums each segment's entries one after another in one thread, so a sink of
# ~10^5 entries serialized the multi-chip step (98.6 % of a deterministic
# pass's device time on an H100, chip_smoke.py's profile).  The sink's
# entries spread over this many dropped segments instead.
SINK_SPREAD = 1024


def spread_sink(segments: torch.Tensor, sink: int,
                dropped: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``segments`` with each dropped entry (``dropped``, default the
    entries equal to ``sink``) moved to ``sink + (i % SINK_SPREAD)`` (index
    ``i``): every kept segment keeps the same entries in the same order, so
    its sum is unchanged bit for bit; the caller drops the rows from
    ``sink`` on."""
    if dropped is None:
        dropped = segments == sink
    pos = torch.arange(segments.shape[0], device=segments.device,
                       dtype=segments.dtype) % SINK_SPREAD
    return torch.where(dropped, sink + pos, segments)


def segment_sum_before_sink(x: torch.Tensor, segments: torch.Tensor,
                            sink: int,
                            dropped: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The segment sum of the segments below ``sink`` (``[sink, ...]``),
    the dropped entries spread and dropped (``spread_sink``)."""
    return torch.zeros(
        (sink + SINK_SPREAD, *x.shape[1:]), dtype=x.dtype, device=x.device
    ).index_add_(0, spread_sink(segments, sink, dropped), x)[:sink]


@torch.no_grad()
def push_and_update(
    values: torch.Tensor,
    g2sum: torch.Tensor,
    row_grads: torch.Tensor,
    plan_uniq_idx: torch.Tensor,
    plan_inverse: torch.Tensor,
    key_mask: torch.Tensor,
    key_clicks: torch.Tensor,
    conf: SparseTableConfig,
    key_extras: Optional[torch.Tensor] = None,
    uniq_lr: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
):
    """Merge per-occurrence gradients by unique key, then apply sparse
    adagrad and the show/clk counter update.

    Updates ``values`` [P, W] and ``g2sum`` [P] IN PLACE (the reference
    returns new arrays) and returns them.

    row_grads: [K, W] gradient of the pulled rows (counter columns are zero:
        the CVM transform stops their gradient).
    key_clicks: [K] label of each occurrence's instance (masked).
    key_extras: [K, cvm_offset - 2] extra counter increments per occurrence;
        zeros when absent.
    uniq_lr: [U] per-unique-key learning rates (the BoxPS LR map, resolved
        on the host by ``host_feed``); None = ``conf.learning_rate``.
    gate: a bool device scalar; where False every delta is replaced by zero
        (``torch.where``, so a NaN delta of a skipped batch cannot leak
        through as it would through a multiply), leaving the table as it
        was.  The decision stays on the device.
    """
    U = plan_uniq_idx.shape[0]
    co = conf.cvm_offset
    merged = _segment_sum(row_grads, plan_inverse, U)
    show_inc = _segment_sum(key_mask, plan_inverse, U)
    clk_inc = _segment_sum(key_clicks, plan_inverse, U)
    g2_rows = g2sum.index_select(0, plan_uniq_idx)
    w_delta, g2_delta = sparse_adagrad_update(
        g2_rows, merged[:, co:],
        conf.learning_rate if uniq_lr is None else uniq_lr,
        conf.initial_g2sum, conf.grad_clip,
    )
    counter_delta = torch.stack([show_inc, clk_inc], dim=1)
    if co > 2:
        if key_extras is not None:
            extra_inc = _segment_sum(key_extras, plan_inverse, U)
        else:
            extra_inc = torch.zeros((U, co - 2), dtype=counter_delta.dtype,
                                    device=counter_delta.device)
        counter_delta = torch.cat([counter_delta, extra_inc], dim=1)
    delta = torch.cat([counter_delta, w_delta], dim=1)
    # push targets are unique except repeated dead-row entries (slots the
    # plan clamped): zero every dead-targeted delta, so repeats only ever
    # add zero and the scatter stays exact under any order
    dead = values.shape[0] - 1
    ok = (plan_uniq_idx != dead).to(delta.dtype)
    delta, g2_delta = delta * ok[:, None], g2_delta * ok
    if gate is not None:
        delta = torch.where(gate, delta, 0.0)
        g2_delta = torch.where(gate, g2_delta, 0.0)
    scatter_add_rows(values, plan_uniq_idx, delta.contiguous())
    g2sum.index_add_(0, plan_uniq_idx, g2_delta)
    # the dead row must stay zero (pulls read it as the zero row); zero_()
    # on a slice, since a scalar store copies from the host, which a CUDA
    # graph capture refuses
    values.narrow(0, dead, 1).zero_()
    g2sum.narrow(0, dead, 1).zero_()
    return values, g2sum
