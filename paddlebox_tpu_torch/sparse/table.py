"""Single-chip pass-scoped sparse embedding table (reference:
paddlebox_tpu/sparse/table.py, its serial lifecycle).

  * host store: every feature ever seen, rows ``[show, clk, embed..., g2sum]``
    (float32) in a BucketStore.
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

The dead row serves padding and keys missing from the pass census: pulls
read zeros, and it is re-zeroed after every push.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

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
from paddlebox_tpu_torch.utils.device import resolve_device


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


def _empty_rows(n_cols: int) -> np.ndarray:
    return np.empty((0, n_cols), dtype=np.float32)


class SparseTable:
    def __init__(self, conf: SparseTableConfig, seed: int = 0, device="cuda"):
        self.conf = conf
        self.device = resolve_device(device)
        self._seed = seed
        self._store = BucketStore(n_cols=conf.row_width + 1,
                                  n_buckets=conf.store_buckets)
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
        # the persistent HBM cache, built at the first begin_pass (None when
        # conf.hbm_cache_rows == 0 or PADDLEBOX_TORCH_HBM_CACHE=0)
        self._cache: Optional[HbmCache] = None
        self._cache_tried = False
        self._cache_plan: Optional[CachePlan] = None
        self.last_cache_hits = 0
        self.last_cache_misses = 0  # == the begin-pass promotion patch rows
        # rows the last end_pass evicted from the cache and wrote to the
        # host store (the reference counts both in its telemetry)
        self.last_evicted_rows = 0
        self.last_write_back_rows = 0
        self.missing_key_count = 0

    # -- introspection --------------------------------------------------- #
    @property
    def n_features(self) -> int:
        self.flush()  # hot rows may live only in the cache until a drain
        return self._store.n

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

    # -- the HBM cache ----------------------------------------------------- #
    def _get_cache(self) -> Optional[HbmCache]:
        """The persistent HBM hot-row cache, built on first use (None when
        disabled)."""
        if not self._cache_tried:
            if self.conf.hbm_cache_rows > 0 and flags.hbm_cache:
                self._cache = HbmCache(
                    self.conf.hbm_cache_rows, self.conf.row_width + 1,
                    aging=self.conf.hbm_cache_aging, device=self.device,
                )
            self._cache_tried = True
        return self._cache

    def _caches(self) -> list:
        """Every cache this table owns (one on a single chip)."""
        c = self._get_cache()
        return [c] if c is not None else []

    def _cache_fetch_rows(self, miss: np.ndarray) -> np.ndarray:
        """Host-tier fetch of the cache-MISS rows: the begin-pass promotion
        patch, O(cold keys)."""
        return self._resolve_or_init(miss)

    def _drain_cache(self) -> None:
        """Write every dirty cache row back to the host store, so the store
        is truth again for every resident key."""
        for c in self._caches():
            keys, rows = c.drain()
            self._write_back(keys, rows)

    def _invalidate_caches(self) -> None:
        """Drop cache membership (no row moves): required whenever the host
        store changes underneath."""
        for c in self._caches():
            c.invalidate()

    def _write_back(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Merge rows for sorted unique ``keys`` into the host store."""
        if keys.shape[0]:
            self._store.update(keys, vals)

    def flush(self) -> None:
        """The barrier before anything reads the host store as truth: drain
        the dirty cache rows into it.  (The serial table has no background
        merges to wait for.)"""
        self._drain_cache()

    # -- pass lifecycle --------------------------------------------------- #
    def _resolve_or_init(self, pk: np.ndarray) -> np.ndarray:
        """Rows [n, W+1] for sorted unique keys ``pk``: from the host store
        when present, freshly initialized otherwise."""
        w = self.conf.row_width
        if not pk.shape[0]:
            return np.zeros((0, w + 1), dtype=np.float32)
        vals, found = self._store.lookup(pk)
        n_new = int((~found).sum())
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

    def begin_pass(self, pass_keys: np.ndarray) -> None:
        """Promote the pass working set to the device.  With the HBM cache,
        the host supplies only the census misses (the promotion patch) and
        the hits are filled on the device."""
        if self._in_pass:
            raise RuntimeError("end_pass the previous pass first")
        pk = np.unique(np.asarray(pass_keys, dtype=np.uint64))
        w = self.conf.row_width
        n = pk.shape[0]
        vals = np.zeros((self._stage_cap(n), w + 1), dtype=np.float32)
        cache = self._get_cache()
        plan = None
        if cache is None:
            vals[:n] = self._resolve_or_init(pk)
        else:
            # the reference resolves the census twice (once to pick the
            # misses, once to fill the hits); nothing changes the directory
            # in between, so one plan serves both
            plan = cache.lookup(pk)
            miss_pos = np.nonzero(~plan.hit_mask)[0]
            if miss_pos.shape[0]:
                vals[miss_pos] = self._cache_fetch_rows(pk[miss_pos])
        buf = torch.from_numpy(vals).to(self.device)
        if plan is not None:
            self._cache_plan_and_fill(cache, plan, buf, n)
        self._cache_plan = plan
        # two contiguous tensors: the kernels take no strided views
        self.values = buf[:, :w].contiguous()
        self.g2sum = buf[:, w].contiguous()
        self._pass_keys = pk
        self._census_index = None  # stale: it indexes the previous census
        self._in_pass = True
        self._delta_keys.append(pk)

    def _end_pass_cached(self, cache: HbmCache, plan: CachePlan,
                         pk: np.ndarray, n: int) -> None:
        """Cached end of pass: hits update their cache slots in place, the
        hottest misses are admitted (evicting aged-out residents), and ONLY
        cold and evicted rows travel to the host.  Evicted rows are written
        back even when clean (see hbm_cache.py)."""
        full = torch.cat([self.values, self.g2sum[:, None]], dim=1)
        upd = cache.plan_update(pk, plan)
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
        cache.commit_update(plan, upd)
        self._write_back(wb_keys[order],
                         np.concatenate([cold_rows, victim_rows])[order])
        self.last_evicted_rows = int(upd.victim_slots.shape[0])
        self.last_write_back_rows = int(wb_keys.shape[0])

    def end_pass(self) -> None:
        """Write the working set back: to the cache for its resident and
        admitted rows, to the host store for the rest."""
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
            self._write_back(pk, vals.cpu().numpy())
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

    # -- maintenance ------------------------------------------------------- #
    def shrink(self) -> int:
        """Decay show/clk and evict cold features (the reference's per-day
        ShrinkTable).  Returns the number of evicted rows."""
        if self._in_pass:
            raise RuntimeError("shrink between passes, not inside one")
        if self.n_features == 0:  # n_features drains the cache
            return 0
        evicted = self._store.decay_evict(
            decay_cols=2,  # show + clk
            decay=self.conf.show_decay_rate,
            threshold=self.conf.delete_threshold,
        )
        # cached rows predate the decay: the next pass re-reads the store
        self._invalidate_caches()
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
        self.flush()
        self._store.load_bulk(
            np.asarray(state["keys"], dtype=np.uint64),
            np.asarray(state["values"], dtype=np.float32),
        )
        # every cached row is now stale relative to the restored store
        self._invalidate_caches()

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
            self.flush()
            self._write_back(keys, np.asarray(state["values"], np.float32))
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
    """
    U = plan_uniq_idx.shape[0]
    co = conf.cvm_offset
    merged = _segment_sum(row_grads, plan_inverse, U)
    show_inc = _segment_sum(key_mask, plan_inverse, U)
    clk_inc = _segment_sum(key_clicks, plan_inverse, U)
    g2_rows = g2sum.index_select(0, plan_uniq_idx)
    w_delta, g2_delta = sparse_adagrad_update(
        g2_rows, merged[:, co:], conf.learning_rate, conf.initial_g2sum,
        conf.grad_clip,
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
    scatter_add_rows(values, plan_uniq_idx, (delta * ok[:, None]).contiguous())
    g2sum.index_add_(0, plan_uniq_idx, g2_delta * ok)
    # the dead row must stay zero (pulls read it as the zero row)
    values[dead] = 0.0
    g2sum[dead] = 0.0
    return values, g2sum
