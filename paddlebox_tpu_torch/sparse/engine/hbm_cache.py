"""HBM-resident hot-key row cache: the persistent device tier (reference:
paddlebox_tpu/sparse/engine/hbm_cache.py).

A fixed-capacity slot table whose ROWS (``[capacity, W+1]``: the value
columns and g2sum) live on the device as one tensor, with a host-side
directory (keys, frequency and recency, dirty flags) that decides
membership once per pass from the census.  The directory is host numpy,
exactly as in the reference, so its decisions are bit-identical to the
reference's; the rows move only through the cache-tier kernels
(ops/sparse_kernels.py): ``gather_slots`` reads them, ``scatter_rows``
writes them, and ``sorted_search`` resolves census keys against a device
mirror of the sorted key index.  On the CPU each wrapper runs its twin.

One difference from the reference: ``rows`` is updated IN PLACE by
``set_rows`` (the reference rebinds a new array each time).

Policy: LFU with aging.  Every pass multiplies all resident frequencies by
``aging`` and adds 1 to this census's hits; admission (at end_pass, from the
pass census) fills free slots first, then evicts the lowest-(frequency,
recency) resident slots not touched by the current pass whose aged
frequency has fallen below a fresh candidate's (1.0).  Eviction and
admission move only directory state here; the owning table moves the rows.
An evicted row is ALWAYS written back to the host, dirty or not, so a
pre-staged next pass that believed the key resident can be patched from the
write-back log instead of reading a hole.

Coherence contract (enforced by sparse/table.py): rows newer than the host
store are marked ``dirty`` and must be drained (``drain()``, then the
table's write-back) before anything reads the store as truth: ``state_dict``,
``delta_state_dict``, ``n_features``, ``shrink``.  ``invalidate()`` drops
membership without moving rows and is required whenever the store changes
underneath the cache (``load_state_dict``, ``apply_delta``, ``shrink``).

``materialize_rows=False`` builds a metadata-only twin: the directory and
its policy with no device rows and no device at all (its lookups search the
host directory), which the census plane's ``FleetCacheMirror``
(parallel/census.py) replays per shard.  ``take_rows`` is the read-and-evict
of hot promotion on the sharded table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.ops import sparse_kernels
from paddlebox_tpu_torch.utils.device import resolve_device

_EMPTY_U64 = np.empty(0, dtype=np.uint64)
_EMPTY_I32 = np.empty(0, dtype=np.int32)
_ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclasses.dataclass
class CachePlan:
    """One census resolved against the cache directory.

    hit_mask:  bool [n] aligned with the sorted unique census keys.
    hit_pos:   int32 [H] census positions of the hits (ascending).
    hit_slots: int32 [H] cache slot per hit, aligned with hit_pos.
    """

    hit_mask: np.ndarray
    hit_pos: np.ndarray
    hit_slots: np.ndarray

    @property
    def n_hits(self) -> int:
        return int(self.hit_slots.shape[0])


@dataclasses.dataclass
class UpdatePlan:
    """End-of-pass admission/eviction decision (directory only; the owning
    table moves the rows).  admit_* are parallel; victim_* are parallel;
    every victim slot is reused by exactly one admit."""

    admit_pos: np.ndarray  # int32: census positions being admitted
    admit_keys: np.ndarray  # uint64: keys at those positions
    admit_slots: np.ndarray  # int32: slots they land in
    victim_slots: np.ndarray  # int32: evicted slots (within admit_slots)
    victim_keys: np.ndarray  # uint64: keys leaving the cache
    cold_pos: np.ndarray  # int32: census misses NOT admitted (host-bound)


def _i32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


class HbmCache:
    def __init__(self, capacity: int, n_cols: int, aging: float = 0.8,
                 device="cuda", materialize_rows: bool = True):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if not 0.0 < aging < 1.0:
            raise ValueError(f"aging must be in (0, 1), got {aging}")
        self.capacity = int(capacity)
        self.n_cols = int(n_cols)
        self.aging = float(aging)
        # a twin has no rows, so no device either
        self.device = resolve_device(device) if materialize_rows else None
        self.rows: Optional[torch.Tensor] = (
            torch.zeros((self.capacity, self.n_cols), dtype=torch.float32,
                        device=self.device)
            if materialize_rows else None
        )
        # directory (slot-indexed)
        self.keys = np.zeros(self.capacity, dtype=np.uint64)
        self.used = np.zeros(self.capacity, dtype=bool)
        self.freq = np.zeros(self.capacity, dtype=np.float64)
        self.last_seen = np.full(self.capacity, -1, dtype=np.int64)
        self.dirty = np.zeros(self.capacity, dtype=bool)
        self.tick = 0
        # sorted view for the key->slot resolve (rebuilt on membership change)
        self._sorted_keys = _EMPTY_U64
        self._sorted_slots = _EMPTY_I32
        # lazy device mirror of _sorted_keys: (hay int64 [pow2], n_real)
        self._dev_index: Optional[tuple] = None

    # -- introspection ---------------------------------------------------- #
    @property
    def resident(self) -> int:
        return int(self.used.sum())

    @property
    def dirty_rows(self) -> int:
        return int(self.dirty.sum())

    def snapshot_keys(self) -> np.ndarray:
        """The sorted resident-key array.  Rebuilds replace the array and
        never mutate it in place, so a snapshot stays valid."""
        return self._sorted_keys

    @staticmethod
    def hit_mask_in(sorted_keys: np.ndarray, pk: np.ndarray) -> np.ndarray:
        """bool [n]: which of sorted unique ``pk`` are in ``sorted_keys``."""
        n = pk.shape[0]
        if sorted_keys.shape[0] == 0 or n == 0:
            return np.zeros(n, dtype=bool)
        pos = np.searchsorted(sorted_keys, pk)
        pos_c = np.minimum(pos, sorted_keys.shape[0] - 1)
        return sorted_keys[pos_c] == pk

    # -- resolve ---------------------------------------------------------- #
    def _rebuild_index(self) -> None:
        slots = np.nonzero(self.used)[0].astype(np.int32)
        if slots.shape[0]:
            order = np.argsort(self.keys[slots], kind="stable")
            self._sorted_keys = self.keys[slots][order]
            self._sorted_slots = slots[order]
        else:
            self._sorted_keys = _EMPTY_U64
            self._sorted_slots = _EMPTY_I32
        self._dev_index = None

    def _device_positions(self, pk: np.ndarray) -> np.ndarray:
        """Sorted-view positions of ``pk`` (-1 = miss) through the
        sorted-search kernel over the device key mirror (its twin on the
        CPU).  The mirror is the sorted keys padded to a power of two with
        all-ones sentinels, as int64 tensors holding the uint64 bits."""
        if self._dev_index is None:
            n = self._sorted_keys.shape[0]
            cpad = 1 << max(0, (n - 1).bit_length()) if n else 0
            hay = np.full(cpad, _ALL_ONES, dtype=np.uint64)
            hay[:n] = self._sorted_keys
            self._dev_index = (
                torch.from_numpy(hay.view(np.int64)).to(self.device), n
            )
        hay, n_real = self._dev_index
        q = np.ascontiguousarray(pk, dtype=np.uint64).view(np.int64)
        pos = sparse_kernels.sorted_search(
            hay, n_real, torch.from_numpy(q).to(self.device)
        )
        return pos.cpu().numpy()

    def lookup(self, pk: np.ndarray) -> CachePlan:
        """Resolve a sorted unique census against the directory: through
        the sorted_search kernel, or on the host for a twin."""
        n = pk.shape[0]
        sk = self._sorted_keys
        if n == 0 or sk.shape[0] == 0:
            return CachePlan(np.zeros(n, dtype=bool), _EMPTY_I32, _EMPTY_I32)
        if self.rows is None:
            pos = np.minimum(np.searchsorted(sk, pk), sk.shape[0] - 1)
            hit = sk[pos] == pk
        else:
            pos = self._device_positions(pk)
            hit = pos >= 0
        hit_pos = np.nonzero(hit)[0].astype(np.int32)
        return CachePlan(hit, hit_pos, self._sorted_slots[pos[hit]])

    # -- policy ----------------------------------------------------------- #
    def touch(self, plan: CachePlan) -> None:
        """One pass observed: age every resident frequency, credit this
        census's hits (metadata only; membership is untouched)."""
        if self.used.any():
            self.freq[self.used] *= self.aging
        if plan.n_hits:
            self.freq[plan.hit_slots] += 1.0
            self.last_seen[plan.hit_slots] = self.tick
        self.tick += 1

    def plan_update(self, pk: np.ndarray, plan: CachePlan) -> UpdatePlan:
        """Admission/eviction for the finished pass's census: misses fill
        free slots first, then evict the coldest non-census residents whose
        aged frequency dropped below a fresh candidate's (1.0).  Pure
        decision; ``commit_update`` applies it."""
        miss_pos = np.nonzero(~plan.hit_mask)[0].astype(np.int32)
        n_cand = miss_pos.shape[0]
        free = np.nonzero(~self.used)[0].astype(np.int32)
        n_free = min(n_cand, free.shape[0])
        victim_slots = _EMPTY_I32
        if n_cand > n_free:
            evictable = self.used.copy()
            evictable[plan.hit_slots] = False  # never evict a current hit
            cand_slots = np.nonzero(evictable & (self.freq < 1.0))[0]
            if cand_slots.shape[0]:
                order = np.lexsort(
                    (cand_slots, self.last_seen[cand_slots],
                     self.freq[cand_slots])
                )
                n_evict = min(n_cand - n_free, cand_slots.shape[0])
                victim_slots = cand_slots[order[:n_evict]].astype(np.int32)
        n_admit = n_free + victim_slots.shape[0]
        admit_pos = miss_pos[:n_admit]
        admit_slots = np.concatenate([free[:n_free], victim_slots])
        return UpdatePlan(
            admit_pos=admit_pos,
            admit_keys=pk[admit_pos],
            admit_slots=admit_slots,
            victim_slots=victim_slots,
            victim_keys=self.keys[victim_slots],
            cold_pos=miss_pos[n_admit:],
        )

    def commit_update(self, plan: CachePlan, upd: UpdatePlan) -> None:
        """Apply an UpdatePlan to the directory: victims leave, admits
        enter (fresh frequency 1.0), and every row the pass touched
        (surviving hits and admits) is now newer than the host store."""
        if upd.victim_slots.shape[0]:
            self.used[upd.victim_slots] = False
            self.dirty[upd.victim_slots] = False
        if upd.admit_slots.shape[0]:
            self.keys[upd.admit_slots] = upd.admit_keys
            self.used[upd.admit_slots] = True
            self.freq[upd.admit_slots] = 1.0
            self.last_seen[upd.admit_slots] = self.tick
            self.dirty[upd.admit_slots] = True
        if plan.n_hits:
            self.dirty[plan.hit_slots] = True
        if upd.admit_slots.shape[0] or upd.victim_slots.shape[0]:
            self._rebuild_index()

    def evict_keys(self, keys: np.ndarray) -> int:
        """Drop ``keys`` from the directory WITHOUT moving rows.  Unknown
        keys are ignored; returns the number actually evicted."""
        mask = self.hit_mask_in(self._sorted_keys, np.asarray(keys))
        if not mask.any():
            return 0
        pos = np.searchsorted(self._sorted_keys, np.asarray(keys)[mask])
        slots = self._sorted_slots[pos]
        self.used[slots] = False
        self.dirty[slots] = False
        self._rebuild_index()
        return int(slots.shape[0])

    def take_rows(self, keys: np.ndarray, pad_to: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Read and evict for hot promotion: ``keys`` leaving for the
        replicated hot block must not stay resident here too, or the next
        census would home them twice.  Returns ``(hit_mask bool [n], rows
        [hits, n_cols])``, rows aligned with the hit subset of ``keys`` in
        order; the evicted slots drop clean (the caller now holds the
        newest copy).  Misses are the caller's to resolve from the store.
        ``pad_to`` pads the gather to a fixed length with slot 0, as the
        reference does to reuse one compiled gather."""
        keys = np.asarray(keys, dtype=np.uint64)
        mask = self.hit_mask_in(self._sorted_keys, keys)
        if not mask.any():
            return mask, np.empty((0, self.n_cols), dtype=np.float32)
        pos = np.searchsorted(self._sorted_keys, keys[mask])
        slots = self._sorted_slots[pos]
        k = int(slots.shape[0])
        if pad_to is not None and pad_to >= k:
            padded = np.zeros(pad_to, dtype=np.int32)
            padded[:k] = slots
            rows = self.gather_rows(padded).cpu().numpy()[:k]
        else:
            rows = self.gather_rows(slots).cpu().numpy()
        self.used[slots] = False
        self.dirty[slots] = False
        self._rebuild_index()
        return mask, rows

    # -- row movement ------------------------------------------------------ #
    def _check_rows(self, what: str) -> None:
        if self.rows is None:
            raise RuntimeError(f"metadata-only cache twin has no rows to "
                               f"{what} (materialize_rows=False)")

    def gather_rows(self, slots: np.ndarray) -> torch.Tensor:
        """Rows of ``slots`` as a new device tensor [K, n_cols], through the
        gather_slots kernel."""
        self._check_rows("gather")
        return sparse_kernels.gather_slots(self.rows, _i32(slots, self.device))

    def set_rows(self, slots: np.ndarray, rows: torch.Tensor) -> None:
        """Replace the rows of ``slots`` with ``rows`` in place, through the
        scatter_rows kernel (duplicate slots: the last occurrence wins)."""
        if np.asarray(slots).shape[0] == 0:
            return
        self._check_rows("set")
        sparse_kernels.scatter_rows(self.rows, _i32(slots, self.device), rows)

    # -- coherence --------------------------------------------------------- #
    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys sorted, rows [n, n_cols]) of every DIRTY slot, marking them
        clean: once the table writes them back, the host store is truth
        again for every resident key."""
        d = np.nonzero(self.dirty)[0]
        if d.shape[0] == 0:
            return _EMPTY_U64, np.empty((0, self.n_cols), dtype=np.float32)
        keys = self.keys[d]
        order = np.argsort(keys, kind="stable")
        rows = self.gather_rows(d[order]).cpu().numpy()
        self.dirty[d] = False
        return keys[order], rows

    def invalidate(self) -> None:
        """Forget every resident key without moving rows: required when the
        host store changed underneath.  Callers that need the rows drain()
        first."""
        self.used[:] = False
        self.dirty[:] = False
        self.freq[:] = 0.0
        self.last_seen[:] = -1
        self._rebuild_index()
