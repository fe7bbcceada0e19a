"""Multi-chip sparse table: the pass working set sharded by ``key % n``
(reference: paddlebox_tpu/parallel/sharded_table.py).

Every shard position owns the rows whose key hashes to it.  The host half
mirrors the single-chip ``SparseTable`` (same host store, same pass
lifecycle) but holds the pass working set as one stacked ``values
[n, cap, W]`` / ``g2sum [n, cap]`` pair, each shard laid out like the
single-chip table (``[0, live)`` rows | plan scratch | the dead row
``cap - 1``), and resolves a group of per-position batches into
*per-owner bucketed* row indices, the static-shape plan the step's
all_to_all needs (parallel/trainer.py).

Plan layout over n shards, per-position key capacity K, bucket capacity C,
US = n * C:

    serve_rows [n, n, C] int32  rows shard o must serve: serve_rows[o, d, c]
                                is requester d's c-th row owned by o
                                (dead-row padded).
    occ_flat   [n, K]    int32  o * C + c for each key occurrence of
                                position d's batch (into its [n, C] pull
                                response); padding and hot occurrences ->
                                n * C, which reads an appended zero row.
    serve_map  [n, n, C] int32  dedup: position of (requester, slot) in
                                serve_uniq[o], so a row requested by several
                                positions folds into one segment and the push
                                updates each row once.
    serve_uniq [n, US]   int32  deduped rows served by shard o (the padding
                                tail points at distinct scratch rows,
                                clamped to the dead row).
    key_mask   [n, K]    f32    1.0 for real occurrences.

Realized hybrid placement (``SparseTableConfig.placement_realize``): the
placement planner's hot set (sparse/placement.py) lives as a replicated
``[H, W]`` / ``[H]`` block, one identical copy per position
(``hot_values [n, H, W]``, ``hot_g2sum [n, H]``), resident ACROSS passes
(H = ``placement_hot_capacity``, padded).  A hot occurrence routes to
``hot_occ`` (its slot in the sorted resident hot set; H = sink) instead of
an all_to_all bucket; its ``occ_flat`` entry is the n*C sink, so each
gradient reaches exactly one of the two updates.  Hot and cold rows trade
places only inside begin_pass; ``flush`` writes the resident hot rows back
to the host store, so every barrier sees truth.  The cold census
(``_pass_keys``) excludes the resident hot keys.

Per-shard HBM caches (``hbm_cache_rows`` split evenly over the shards,
on by default as in the reference): each shard position keeps its own
``HbmCache`` of its cold rows across passes.  begin_pass fetches only each
shard's census misses from the host and fills the hits on the device
(``sorted_search`` resolves, ``gather_slots`` reads); end_pass updates the
resident rows and admits new ones in place (``scatter_rows``) and writes
back only the cold and evicted rows, in one globally sorted write-back.
A promotion into the hot block reads the row out of its shard's cache
(``take_rows``), so the block never starts from a stale store row.  The
fault sites ``cache.fetch`` and ``cache.admit`` degrade a pass to the
uncached lifecycle, never to stale rows.

The overlapped pass boundary is the single-chip table's: end_pass hands
its rows to the merge thread, and ``prepare_pass`` stages the next pass's
stacked cold working set on the staging thread (host work only; only
each shard's cache misses), which begin_pass consumes when the census and
the resident hot set match.

``reshard`` grows or shrinks the shard count at a pass boundary, all or
nothing: a migration that changes nothing, then a cutover that commits.
Training after it is bit-equal to a table rebuilt at the new count from
a checkpoint.

Telemetry: the single-chip table's metrics, summed over the shards
(``cache.hit_rate`` over the cold census), the hot block's
``placement.hot_resident_rows`` and ``placement.hot_row_host_bytes``, and
the reshard's ``reshard.migrate`` / ``reshard.cutover`` spans with its
``reshard.*`` metrics, under the reference's names.

Multi-process ownership (a mesh built inside a job, parallel/mesh.py): each
process holds and plans only its local positions ``[p * L, (p + 1) * L)``,
while shard ownership stays ``key % n`` over all n positions.  The host
plane glues the plans together: begin_pass exchanges the local censuses
into the one global census (``KvGatherTransport`` on a ``census-<k>``
KvChannel, so the row numbering agrees everywhere), and plan_group gathers
the capacity need and the want matrices through the gather it is handed
(the trainer's per-pass ``plan-<k>`` channel), so each local shard knows
the rows remote requesters want before the step's all_to_all.  Each process
materializes, serves, persists and checkpoints only its own shards in its
own host store; every process resolves the shared hot set's promotions
from the owners' frames on the census channel and assembles the identical
replicated block, and only a key's owner writes it back.  The stacked
arrays hold the local positions: ``values [L, cap, W]``, ``hot_values
[L, H, W]``; the plan arrays ``[L, ...]``.  The per-shard caches serve the
local shards only: the reference's ``_assemble_cached_multihost`` (each
shard's hit fill as a single-device op, then a global array) is
``_cached_sync_resolve`` + ``_cache_hit_fill`` over the local shards here,
since a process's stacked arrays are its own.  prepare_pass does not stage
there (the census exchange is a lockstep gather on the main thread).  A
live reshard across processes moves the rows that change owner process
over a ``reshard-<k>`` KvChannel, every process together (``reshard``).
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import SparseTableConfig, flags
from paddlebox_tpu_torch.data.feed import HostBatch
from paddlebox_tpu_torch.parallel.census import (
    CensusExchange,
    FleetCacheMirror,
    KvGatherTransport,
    LoopbackTransport,
)
from paddlebox_tpu_torch.parallel.mesh import Mesh
from paddlebox_tpu_torch.sparse.engine import HbmCache
from paddlebox_tpu_torch.sparse.placement import PlacementPlanner, hot_churn
from paddlebox_tpu_torch.sparse.table import (
    SparseTable,
    _empty_rows,
    _next_pow2,
    _patch_in,
    _sorted_unique,
    count_evicted,
    count_rows_out,
)
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.keycodec import (
    decode_u64_with_perm,
    encode_u64_with_perm,
)
from paddlebox_tpu_torch.utils.monitor import stats

# migration payload framing (keycodec-framed, versioned): magic | n_rows |
# row_width+1 | len(key_stream) | delta-compressed sorted keys | int32 rank
# (the keys' order rides as the permutation beside the sorted copy) |
# f32 rows
_RESHARD_MAGIC = b"PBR1"
_RESHARD_HEAD = "<4sIII"

# lockstep census-channel naming: every process builds its sharded tables
# in the same order, so the counter agrees across the job
_CENSUS_CHANNEL_SEQ = [0]
# lockstep reshard-channel naming: every process reshards together
_RESHARD_CHANNEL_SEQ = [0]
# a process's word on the reshard channel when its own side failed: the
# peers raise at once instead of committing (or waiting out the channel)
_RESHARD_ABORT = b"PBRX"


def _encode_migration(keys: np.ndarray, rows: np.ndarray) -> bytes:
    """Frame one batch of migrating rows; ``keys`` keep their order."""
    kb, rank = encode_u64_with_perm(keys)
    head = struct.pack(
        _RESHARD_HEAD, _RESHARD_MAGIC, keys.shape[0], rows.shape[1], len(kb)
    )
    return (head + kb + rank.astype("<i4").tobytes()
            + np.ascontiguousarray(rows, dtype="<f4").tobytes())


def _decode_migration(buf: bytes):
    """Inverse of :func:`_encode_migration` -> (keys, rows), row order
    preserved.  Raises on any framing mismatch: a payload that does not
    round-trip must never half-apply."""
    head = struct.calcsize(_RESHARD_HEAD)
    magic, n, w1, klen = struct.unpack_from(_RESHARD_HEAD, buf, 0)
    if magic != _RESHARD_MAGIC:
        raise ValueError(f"bad reshard payload magic {magic!r}")
    off = head
    kb = bytes(buf[off:off + klen])
    off += klen
    rank = np.frombuffer(buf, dtype="<i4", count=n, offset=off)
    off += 4 * n
    keys = decode_u64_with_perm(kb, rank)
    rows = np.frombuffer(
        buf, dtype="<f4", count=n * w1, offset=off
    ).reshape(n, w1)
    if off + 4 * n * w1 != len(buf):
        raise ValueError("reshard payload length mismatch")
    return keys.copy(), rows.astype(np.float32)


@dataclasses.dataclass
class ShardedBatchPlan:
    """Stacked host plans for one group of per-position batches (leading
    axis = shard position)."""

    serve_rows: np.ndarray  # int32 [n, n, C]
    occ_flat: np.ndarray  # int32 [n, K]
    serve_map: np.ndarray  # int32 [n, n, C]
    serve_uniq: np.ndarray  # int32 [n, n*C]
    key_mask: np.ndarray  # f32 [n, K]
    n_missing: int = 0  # keys absent from the pass census
    # int32 [n, K] hot routing (realized hybrid placement only): each
    # occurrence's slot in the replicated hot block, H for cold/padding
    # occurrences.  Hot occurrences carry the n*C sink in occ_flat and are
    # left out of the want matrices.
    hot_occ: Optional[np.ndarray] = None
    # f32 [n, H] per-hot-slot learning rate, 0.0 where the position has no
    # occurrence of the slot; the step folds it with pmax over positions
    hot_lr: Optional[np.ndarray] = None
    # f32 [n, n*C] learning rate of each served unique row (aligned with
    # serve_uniq), under a per-slot LR map only
    serve_lr: Optional[np.ndarray] = None


class ShardedSparseTable(SparseTable):
    """Same host store, persistence and shrink as SparseTable; the pass
    working set lives stacked over the mesh's shard positions."""

    def __init__(self, conf: SparseTableConfig, mesh: Mesh, seed: int = 0,
                 bucket_slack: float = 2.0):
        super().__init__(conf, seed, device=mesh.device)
        self.mesh = mesh
        self.n_shards = mesh.n
        # all_to_all bucket capacity over the uniform-hash expectation
        # K / n.  It sizes the BASE bucket only: a group whose worst shard
        # needs more grows the bucket in power-of-two steps
        # (capacity_bumps); keys are never dropped.
        self.bucket_slack = float(bucket_slack)
        self._shard_keys: Optional[list] = None
        self.capacity_bumps = 0
        # largest serve buffer (n * C) planned so far: sizes the next
        # pass's per-shard scratch region (pass 1 uses plan_scratch_rows)
        self._last_serve_n = 0
        self._placement_mode = conf.placement or flags.placement
        if self._placement_mode not in ("hybrid", "hash", "loopback"):
            raise ValueError(
                "placement must be hybrid|hash|loopback, got "
                f"{self._placement_mode!r}"
            )
        self._hot_realize = bool(
            conf.placement_realize
            and flags.placement_realize
            and self._placement_mode in ("hybrid", "loopback")
            and conf.placement_hot_capacity > 0
        )
        # the device-resident hot set (sorted unique; its position is the
        # block slot) and the block itself, None until a plan realizes
        self._hot_keys = np.empty(0, np.uint64)
        self.hot_values: Optional[torch.Tensor] = None  # [n, H, W]
        self.hot_g2sum: Optional[torch.Tensor] = None  # [n, H]
        # resident hot rows updated by a pass and not yet written back
        self._hot_dirty = False
        self._census: Optional[CensusExchange] = None
        # the planner's evidence carried across a reshard cutover: it seeds
        # the rebuilt planner, so the hot set survives the new shard map
        self._carry_freq: Optional[tuple] = None
        # one HbmCache per shard position, built by _caches(), and the
        # pass's per-shard cache plans (None when the pass runs uncached)
        self._shard_cache_list: list = []
        self._cache_plans: Optional[list] = None
        self.last_shard_hits: list = []
        self.last_shard_misses: list = []
        # host row traffic of the last begin_pass / end_pass, for reports:
        # cold rows host -> device (the cache misses), and hot rows moved
        # by the migration (promoted rows fetched plus demoted rows
        # written back)
        self.last_promotion_rows = 0
        self.last_hot_moved_rows = 0
        self.last_reshard_s = 0.0
        self._census_channel = None

    @property
    def _local_pos(self) -> np.ndarray:
        """This process's positions (== global shard ids), contiguous; in
        one process every position (a reshard swaps the mesh)."""
        return np.asarray(self.mesh.local_positions, np.int64)

    @property
    def n_local(self) -> int:
        """Shard positions this process holds."""
        return self.mesh.n_local

    @property
    def multiprocess(self) -> bool:
        """True when the mesh was built inside a job: the host plane runs
        over the job's store (even at one process)."""
        return bool(self.mesh.distributed)

    def _proc_of(self, shard: np.ndarray) -> np.ndarray:
        """Owning process of each shard id (contiguous runs of n_local)."""
        return shard // self.n_local

    def _owned(self, keys: np.ndarray) -> np.ndarray:
        """Mask of the keys whose shard this process owns."""
        shard = (keys % np.uint64(self.n_shards)).astype(np.int64)
        return self._proc_of(shard) == self.mesh.proc_index

    def _get_cache(self):
        """Unused here: the sharded lifecycle goes through the per-shard
        list (_caches)."""
        return None

    def _caches(self) -> list:
        """One HbmCache per local shard position, built on first use (empty
        when the cache is off): ``hbm_cache_rows`` split evenly over all
        the shards, every one on the mesh's device."""
        if not self._cache_tried:
            with self._cache_lock:
                if not self._cache_tried:
                    per_shard = self.conf.hbm_cache_rows // self.n_shards
                    if per_shard > 0 and flags.hbm_cache:
                        self._shard_cache_list = [
                            HbmCache(per_shard, self.conf.row_width + 1,
                                     aging=self.conf.hbm_cache_aging,
                                     device=self.device)
                            for _ in range(self.n_local)
                        ]
                    self._cache_tried = True
        return self._shard_cache_list

    # -- census wire (placement + compression) ----------------------------- #
    def _census_exchange_obj(self) -> CensusExchange:
        """The CensusExchange over a loopback transport (a dedicated
        ``census-<k>`` KvChannel in a job), with the placement planner
        unless placement is "hash", seeded from the caches' LFU evidence
        and from a reshard's carried tracker, and with the fleet cache
        mirror when the caches are on.  Deterministic across ranks: the
        channel name rides a lockstep counter and the sizes come from the
        (identical) config."""
        if self._census is None:
            planner = None
            mirror = None
            if self._placement_mode in ("hybrid", "loopback"):
                planner = PlacementPlanner(
                    hot_capacity=self.conf.placement_hot_capacity,
                    aging=self.conf.placement_aging,
                    update_interval=self.conf.placement_update_interval,
                )
                caches = self._caches()
                for c in caches:
                    used = np.nonzero(c.used)[0]
                    if used.shape[0]:
                        planner.seed(c.keys[used], c.freq[used])
                if self._carry_freq is not None:
                    planner.seed(*self._carry_freq)
                    self._carry_freq = None
                if caches:
                    mirror = FleetCacheMirror(self.n_shards,
                                              caches[0].capacity,
                                              self.conf.hbm_cache_aging)
            codec = "raw" if flags.hostplane_codec == "raw" else "varint"
            if self.multiprocess:
                from paddlebox_tpu_torch.parallel.host_plane import KvChannel

                _CENSUS_CHANNEL_SEQ[0] += 1
                self._census_channel = KvChannel(
                    f"census-{_CENSUS_CHANNEL_SEQ[0]}")
                transport = KvGatherTransport(self._census_channel)
            else:
                transport = LoopbackTransport()
            self._census = CensusExchange(
                transport, planner=planner, mirror=mirror,
                codec=codec, realize=self._hot_realize,
            )
        return self._census

    def _exchange_census(self, pk: np.ndarray) -> np.ndarray:
        """Local census -> the global census (in one process, the same
        keys; in a job the exchange on the census channel, in lockstep on
        the main thread, and under the "legacy" codec the plain union of
        the local censuses).  Realization needs the planner even under
        "hybrid"; "loopback" is the mode that exists to run the wire round
        trip."""
        if self.multiprocess:
            if flags.hostplane_codec == "legacy":
                from paddlebox_tpu_torch.parallel.multiprocess import (
                    host_allgather_varlen,
                )

                return np.unique(host_allgather_varlen(pk))
            return self._census_exchange_obj().exchange(pk)
        if self._placement_mode == "loopback" or self._hot_realize:
            return self._census_exchange_obj().exchange(pk)
        return pk

    def placement_plan(self):
        """The current PlacementPlan, or None when the planner is off."""
        if self._census is None or self._census.planner is None:
            return None
        return self._census.planner.plan()

    # -- realized hybrid placement (replicated hot block) ------------------- #
    @property
    def hot_block_capacity(self) -> int:
        """Padded capacity H of the replicated hot block (0 = realization
        off); fixed for the table's lifetime."""
        return self.conf.placement_hot_capacity if self._hot_realize else 0

    def hot_resident_keys(self) -> np.ndarray:
        """The device-resident hot set (sorted; slot i holds key i)."""
        return self._hot_keys

    def _drop_hot_residency(self) -> None:
        """Forget the hot block WITHOUT writing it back: callers that change
        the store underneath flush() first, which writes it back."""
        self._hot_keys = np.empty(0, np.uint64)
        self.hot_values = None
        self.hot_g2sum = None
        self._hot_dirty = False

    def _invalidate_caches(self) -> None:
        """The store changed underneath: the hot block is stale too, so
        residency goes (the next begin_pass realizes it from the store)."""
        super()._invalidate_caches()
        self._drop_hot_residency()

    def flush(self) -> None:
        """Hot rows first: the resident block is truth for its keys, so
        every barrier that makes the store authoritative lands them."""
        self._flush_hot()
        super().flush()

    def _hot_rows(self, slots=None) -> np.ndarray:
        """Rows [m, W+1] of position 0's copy of the hot block (every copy
        is identical), at ``slots`` or the resident prefix."""
        m = self._hot_keys.shape[0]
        lv = self.hot_values[0].cpu().numpy()
        lg = self.hot_g2sum[0].cpu().numpy()
        sel = np.arange(m) if slots is None else slots
        return np.concatenate([lv[sel], lg[sel, None]], axis=1)

    def _flush_hot(self) -> None:
        if (
            self._in_pass
            or not self._hot_dirty
            or self.hot_values is None
            or not self._hot_keys.shape[0]
        ):
            return
        keys, rows = self._hot_keys, self._hot_rows()
        if self.multiprocess:
            # every replica holds the same rows; only the owner persists
            own = self._owned(keys)
            keys, rows = keys[own], rows[own]
        self._write_back(keys, np.ascontiguousarray(rows))
        self._hot_dirty = False

    def _sync_hot_block(self) -> None:
        """Reconcile the resident hot block with the just-updated plan
        (begin_pass, after the census exchange).  With no plan change it
        touches nothing, so the hot tier's boundary traffic is O(churn)."""
        plan = self.placement_plan()
        target = (
            plan.hot_keys if plan is not None else np.empty(0, np.uint64)
        )
        if target.shape[0] > self.conf.placement_hot_capacity:
            raise RuntimeError(
                f"plan hot set ({target.shape[0]}) exceeds the realized "
                f"block capacity ({self.conf.placement_hot_capacity})"
            )
        promote, demote = hot_churn(self._hot_keys, target)
        if (
            promote.shape[0]
            or demote.shape[0]
            or (target.shape[0] and self.hot_values is None)
        ):
            self._migrate_hot(target, promote, demote)
        telemetry.gauge(
            "placement.hot_resident_rows",
            "rows resident in the replicated device hot block",
        ).set(float(self._hot_keys.shape[0]))

    def _migrate_hot(self, target, promote, demote) -> None:
        """Commit one hot-set change: demoted rows go back to the host
        store, promoted rows are fetched from it, and surviving rows move
        to their new slots on the device (no host bytes for survivors)."""
        w = self.conf.row_width
        H = self.conf.placement_hot_capacity
        n = self.n_local
        host_bytes = telemetry.counter(
            "placement.hot_row_host_bytes",
            "hot-tier row bytes crossing the host plane (promotions + "
            "demotions at pass boundaries; structurally zero inside a "
            "pass)",
        )
        old = self._hot_keys
        if demote.shape[0] and self.hot_values is not None:
            rows = self._hot_rows(np.searchsorted(old, demote))
            dk = demote
            if self.multiprocess:  # the owner writes back
                own = self._owned(demote)
                dk, rows = demote[own], rows[own]
            if dk.shape[0]:
                self._write_back(dk, np.ascontiguousarray(rows))
                host_bytes.inc(rows.nbytes)
        promo_rows = self._fetch_hot_rows(promote)
        if promo_rows.shape[0]:
            host_bytes.inc(promo_rows.nbytes)
        self.last_hot_moved_rows += int(demote.shape[0] + promote.shape[0])
        # the new block: promoted rows at their slot in the sorted target,
        # survivors from their old slot, padding slots [live, H) zero
        promo_v = np.zeros((H, w), np.float32)
        promo_g = np.zeros(H, np.float32)
        if promote.shape[0]:
            ts = np.searchsorted(target, promote)
            promo_v[ts] = promo_rows[:, :w]
            promo_g[ts] = promo_rows[:, w]
        pv = torch.from_numpy(promo_v).to(self.device)
        pg = torch.from_numpy(promo_g).to(self.device)
        if self.hot_values is None or not old.shape[0]:
            self.hot_values = pv.expand(n, H, w).contiguous()
            self.hot_g2sum = pg.expand(n, H).contiguous()
        else:
            src = np.zeros(H, np.int64)
            surv = np.zeros(H, bool)
            if target.shape[0]:
                pos = np.searchsorted(old, target)
                pos_c = np.minimum(pos, old.shape[0] - 1)
                src[: target.shape[0]] = pos_c
                surv[: target.shape[0]] = old[pos_c] == target
            src_t = torch.from_numpy(src).to(self.device)
            surv_t = torch.from_numpy(surv).to(self.device)
            self.hot_values = torch.where(
                surv_t[None, :, None],
                self.hot_values.index_select(1, src_t), pv[None],
            )
            self.hot_g2sum = torch.where(
                surv_t[None, :], self.hot_g2sum.index_select(1, src_t),
                pg[None],
            )
        self._hot_keys = np.asarray(target, np.uint64).copy()

    def _fetch_owned_hot_rows(self, keys: np.ndarray) -> np.ndarray:
        """Promotion read-through for keys this process's shards own, shard
        by shard: cache hits come out of the cache and leave its directory
        (``take_rows``: the hot block is their truth now), misses resolve
        from the store and the overlay, unseen keys init
        key-deterministically."""
        caches = self._caches()
        if not caches:
            return self._resolve_or_init(keys)
        out = np.zeros((keys.shape[0], self.conf.row_width + 1), np.float32)
        owner = keys % np.uint64(self.n_shards)
        for cache, o in zip(caches, self._local_pos):
            pos = np.nonzero(owner == np.uint64(o))[0]
            if not pos.shape[0]:
                continue
            sk = keys[pos]
            with self._cache_lock:
                hit, rows = cache.take_rows(sk)
            if hit.any():
                out[pos[hit]] = rows
            if not hit.all():
                out[pos[~hit]] = self._resolve_or_init(sk[~hit])
        return out

    def broadcast_hot_rows(self, payload: bytes) -> list:
        """Host gather (a job's begin_pass, lockstep): every rank
        contributes its owned shards' promoted rows as one migration frame
        on the census channel and receives every rank's frame."""
        self._census_exchange_obj()
        return self._census_channel.gather_bytes(payload)

    def _fetch_hot_rows(self, promote: np.ndarray) -> np.ndarray:
        """[P, W+1] rows for the sorted promoted keys, identical on every
        rank.  One process: every shard is owned, and under "loopback" the
        rows ride the migration frame's encode -> decode round trip and
        must come back bit-exact.  A job: the owners frame their rows, the
        frames cross the census channel and every rank decodes all of
        them."""
        if not promote.shape[0]:
            return _empty_rows(self.conf.row_width + 1)
        if self.multiprocess:
            own = self._owned(promote)
            payload = _encode_migration(
                promote[own], self._fetch_owned_hot_rows(promote[own]))
            out = np.zeros((promote.shape[0], self.conf.row_width + 1),
                           np.float32)
            for buf in self.broadcast_hot_rows(payload):
                k, v = _decode_migration(buf)
                if k.shape[0]:
                    out[np.searchsorted(promote, k)] = v
            return out
        rows = self._fetch_owned_hot_rows(promote)
        if self._placement_mode == "loopback":
            dk, drows = _decode_migration(_encode_migration(promote, rows))
            if not (np.array_equal(dk, promote)
                    and np.array_equal(drows, rows)):
                raise RuntimeError(
                    "hot-promotion payload failed the loopback "
                    "round-trip verify")
            rows = drows
        return rows

    def abort_pass(self) -> None:
        self._cache_plans = None
        super().abort_pass()

    def close(self) -> None:
        """Retire the census channel (its keys) on top of the base table's
        quiesce."""
        ch, self._census_channel = self._census_channel, None
        if ch is not None:
            self._census = None
            ch.close()
        super().close()

    def prepare_pass(self, pass_keys) -> None:
        """Stage the next pass in the background; in a job a no-op (the
        census exchange is a lockstep gather on the main thread, so
        begin_pass resolves synchronously there)."""
        if self.multiprocess:
            return
        super().prepare_pass(pass_keys)

    # -- live reshard ------------------------------------------------------- #
    def reshard(self, new_mesh: Mesh) -> int:
        """Grow or shrink the shard count at a pass boundary.  Returns the
        number of this process's rows whose owner shard changed.

        The cut point is the checkpoint barrier: ``flush`` lands the hot
        block and the dirty cache rows and waits out the merges, so the
        host store is truth for every key before anything moves; a staged
        next pass is dropped (it was laid out for the old split).  Two
        phases, each a fault site: ``_reshard_migrate`` frames the
        owner-changed rows hottest first without changing anything,
        ``_reshard_cutover`` commits.  A failure in either restores the old
        shard map (``_reshard_abort``) and re-raises.

        In a job every process calls it together, with a mesh of the same
        process layout (shards in contiguous runs a process).  The frames
        of the rows that leave a process's shards cross on a dedicated
        ``reshard-<k>`` KvChannel; each process keeps what comes to it,
        and the cutover commits only once every process has passed its
        cutover fault site.  A process whose own side fails posts that on
        the channel, so every process raises and restores its old map
        together; a process that dies outright leaves the others to the
        channel's timeout, as the reference's channel does.

        Rows move verbatim, a new key's init depends on the key alone, and
        every shard orders its rows by the sorted global census, so
        training after a live reshard is bit-equal to a table rebuilt at
        the new shard count from a checkpoint."""
        if self._in_pass:
            raise RuntimeError("reshard between passes, never inside one")
        if new_mesh.n < 1:
            raise ValueError("the new mesh has no shard positions")
        if new_mesh.device != self.device:
            raise ValueError(
                f"the new mesh is on {new_mesh.device}, the table on "
                f"{self.device}: every shard lives on the table's device")
        layout = lambda m: (m.distributed, m.n_proc, m.proc_index)
        if layout(new_mesh) != layout(self.mesh):
            raise ValueError(
                f"the new mesh's process layout {layout(new_mesh)} is not "
                f"the table's {layout(self.mesh)} (distributed, processes, "
                "this process): a reshard keeps the job's processes")
        self.flush()
        self._discard_stage()
        if new_mesh.n == self.n_shards:
            return 0
        old = self._reshard_snapshot()
        ch = None
        if self.multiprocess:
            from paddlebox_tpu_torch.parallel.host_plane import KvChannel

            _RESHARD_CHANNEL_SEQ[0] += 1
            ch = KvChannel(f"reshard-{_RESHARD_CHANNEL_SEQ[0]}")
        t0 = time.perf_counter()
        try:
            with telemetry.span("reshard.migrate", old_shards=self.n_shards,
                                new_shards=new_mesh.n):
                if ch is None:
                    staged, moved = None, self._reshard_migrate(new_mesh)
                else:
                    staged, moved = self._reshard_migrate_job(new_mesh, ch)
            with telemetry.span("reshard.cutover", old_shards=self.n_shards,
                                new_shards=new_mesh.n):
                self._reshard_cutover(new_mesh, staged, ch)
        except Exception:
            self._reshard_abort(old)
            telemetry.counter(
                "reshard.aborts",
                "reshards rolled back to the old shard map",
            ).inc()
            raise
        finally:
            if ch is not None:
                # a fault may end the reshard before a peer read the last
                # sequence: its key stays
                ch.close(keep_last=True)
        telemetry.counter(
            "reshard.migrated_rows",
            "rows whose owner shard changed across reshards",
        ).inc(moved)
        self.last_reshard_s = time.perf_counter() - t0
        telemetry.histogram(
            "reshard.seconds", "live reshard wall time (migrate + cutover)"
        ).observe(self.last_reshard_s)
        return moved

    def _reshard_snapshot(self) -> dict:
        """References to everything the cutover replaces: the migration
        changes nothing and the cutover swaps these fields only after every
        process passed its fault site, so on every abort they are still the
        old state."""
        return {
            "mesh": self.mesh, "n_shards": self.n_shards,
            "caches": self._shard_cache_list,
            "cache_tried": self._cache_tried, "census": self._census,
            "census_channel": self._census_channel,
            "last_serve_n": self._last_serve_n,
            "carry_freq": self._carry_freq, "hot_keys": self._hot_keys,
            "hot_values": self.hot_values, "hot_g2sum": self.hot_g2sum,
            "hot_dirty": self._hot_dirty,
        }

    @staticmethod
    def _vote(ch, step: str, local) -> list:
        """One gather on the reshard channel: this process's payload, or
        its error when ``local`` raised.  Raises this process's own error,
        or a RuntimeError naming every process that posted one; else
        returns the payloads in rank order."""
        try:
            payload = local()
        except Exception as e:
            ch.gather_bytes(_RESHARD_ABORT + f"{step}: {e!r}".encode())
            raise
        got = ch.gather_bytes(payload)
        failed = {r: p[len(_RESHARD_ABORT):].decode(errors="replace")
                  for r, p in enumerate(got) if p.startswith(_RESHARD_ABORT)}
        if failed:
            raise RuntimeError(
                f"reshard aborted: process(es) {sorted(failed)} failed "
                f"their side ({'; '.join(failed.values())})")
        return got

    def _hottest_first(self, keys: np.ndarray, rows: np.ndarray) -> tuple:
        """(keys, rows) ordered hottest first by the planner's evidence
        (ties in key order)."""
        planner = None if self._census is None else self._census.planner
        if planner is not None and keys.shape[0]:
            order = np.argsort(-planner.frequencies(keys), kind="stable")
            keys, rows = keys[order], rows[order]
        return keys, rows

    def _reshard_migrate(self, new_mesh: Mesh) -> int:
        """One process: frame the owner-changed rows and check that the
        frame decodes to them bit for bit, or abort: the reference's
        loopback discipline, which holds the wire format to what a second
        owner would receive.  Changes nothing: in one process ownership
        never leaves the one host store, so no row merges or drops.
        Returns the number of rows moved."""
        faults.inject("reshard.migrate")
        keys, rows = self._store.materialize()
        moved = keys % np.uint64(self.n_shards) != keys % np.uint64(new_mesh.n)
        mk, mrows = self._hottest_first(keys[moved], rows[moved])
        dk, drows = _decode_migration(_encode_migration(mk, mrows))
        if not (np.array_equal(dk, mk) and np.array_equal(drows, mrows)):
            raise RuntimeError(
                "reshard migration payload failed the loopback round-trip "
                "verify")
        return int(mk.shape[0])

    def _reshard_migrate_job(self, new_mesh: Mesh, ch) -> tuple:
        """A job: each process frames only the rows that leave it
        (shards split in contiguous runs a process under either count),
        the frames cross on the channel ``ch``, and each keeps what comes
        to it.  Changes nothing.  Returns (staged, rows moved): what comes
        to this process (to merge) and what leaves it (to drop), committed
        by the cutover.  A row can change process while keeping its shard
        id (key % 4 == 1 is shard 1 at 4 and at 2 shards, on process 0 and
        then 1 of two), so what leaves is decided by process over every
        row, where the reference decides it over the rows whose shard id
        changed and keeps such rows behind; rows moved still counts shard
        changes, the reference's figure."""
        pid = self.mesh.proc_index
        box: dict = {}

        def local() -> bytes:
            faults.inject("reshard.migrate")
            keys, rows = self._store.materialize()
            old_s = keys % np.uint64(self.n_shards)
            new_s = keys % np.uint64(new_mesh.n)
            out = ((old_s.astype(np.int64) // self.n_local == pid)
                   & (new_s.astype(np.int64) // new_mesh.n_local != pid))
            box["moved"] = int((old_s != new_s).sum())
            ok, orows = self._hottest_first(keys[out], rows[out])
            box["drop"] = ok
            return _encode_migration(ok, orows)

        payloads = self._vote(ch, "migrate", local)
        in_keys, in_rows = [], []
        for p, buf in enumerate(payloads):
            if p == pid:
                continue
            k, v = _decode_migration(buf)
            mine = ((k % np.uint64(new_mesh.n)).astype(np.int64)
                    // new_mesh.n_local) == pid
            if mine.any():
                in_keys.append(k[mine])
                in_rows.append(v[mine])
        staged = {
            "drop_keys": box["drop"],
            "in_keys": (np.concatenate(in_keys) if in_keys
                        else np.empty(0, np.uint64)),
            "in_rows": (np.concatenate(in_rows) if in_rows
                        else np.empty((0, self.conf.row_width + 1),
                                      np.float32)),
        }
        return staged, box["moved"]

    def _reshard_cutover(self, new_mesh: Mesh, staged: Optional[dict] = None,
                         ch=None) -> None:
        """Commit the new shard map.  The fault site fires before any
        change, and in a job every process must pass it (a second gather
        on the channel) before any commits, so a failed cutover leaves the
        old map whole everywhere.  A job's ownership commit merges the rows
        that came to this process (sorted: the wire is hottest first, the
        store takes sorted unique keys) and drops the rows that left.  The
        flush at the cut point drained the caches and the hot block, so
        dropping both loses nothing; the planner's evidence seeds the
        rebuilt census exchange."""
        if ch is None:
            faults.inject("reshard.cutover")
        else:
            def local() -> bytes:
                faults.inject("reshard.cutover")
                return b"ok"

            self._vote(ch, "cutover", local)
        if staged is not None:
            if staged["in_keys"].shape[0]:
                order = np.argsort(staged["in_keys"], kind="stable")
                self._store.update(staged["in_keys"][order],
                                   staged["in_rows"][order])
            if staged["drop_keys"].shape[0]:
                keys, rows = self._store.materialize()
                keep = ~np.isin(keys, staged["drop_keys"])
                self._store.clear()
                self._store.load_bulk(keys[keep], rows[keep])
        if self._census is not None and self._census.planner is not None:
            self._carry_freq = self._census.planner.evidence()
        census_ch, self._census_channel = self._census_channel, None
        self._census = None
        self.mesh = new_mesh
        self.n_shards = new_mesh.n
        # the caches, the scratch sizing and the hot block belong to the
        # old split; the next begin_pass rebuilds them
        self._shard_cache_list = []
        self._cache_tried = False
        self._cache_plans = None
        self._shard_keys = None
        self._last_serve_n = 0
        self._drop_hot_residency()
        # the old census channel closes last: everything above is
        # infallible, so an abort never restores a closed channel
        if census_ch is not None:
            census_ch.close()

    def _reshard_abort(self, old: dict) -> None:
        """Restore the old shard map from the snapshot's references."""
        self.mesh = old["mesh"]
        self.n_shards = old["n_shards"]
        self._shard_cache_list = old["caches"]
        self._cache_tried = old["cache_tried"]
        self._census = old["census"]
        self._census_channel = old["census_channel"]
        self._last_serve_n = old["last_serve_n"]
        self._carry_freq = old["carry_freq"]
        self._hot_keys = old["hot_keys"]
        self.hot_values = old["hot_values"]
        self.hot_g2sum = old["hot_g2sum"]
        self._hot_dirty = old["hot_dirty"]
        self._cache_plans = None

    # -- pass lifecycle --------------------------------------------------- #
    def _shard_split(self, pk: np.ndarray):
        """(owner, shard_keys, row_within) for a sorted global census.
        The owner is taken in uint64, so keys at or above 2^63 land on the
        same shard as in the reference."""
        n = self.n_shards
        owner = (pk % np.uint64(n)).astype(np.int64)
        shard_keys = [pk[owner == o] for o in range(n)]  # each stays sorted
        # key -> row-within-shard, aligned with the sorted pass keys, so
        # per-batch planning is one searchsorted
        row_within = np.empty(pk.shape[0], dtype=np.int32)
        for o in range(n):
            m = owner == o
            row_within[m] = np.arange(int(m.sum()), dtype=np.int32)
        return owner, shard_keys, row_within

    def _sharded_cap(self, shard_keys) -> int:
        """Per-shard rows: the largest shard's live rows, the plan scratch
        (the largest serve buffer so far, or plan_scratch_rows at first)
        and the dead row, to a power of two."""
        scratch = self._last_serve_n or self.conf.plan_scratch_rows
        return _next_pow2(
            max((sk.shape[0] for sk in shard_keys), default=0) + 1 + scratch
        )

    def _stage_job(self, pass_keys):
        """The staging thread's half (host work only): the stacked cold
        working set of the next census under the CURRENT resident hot set
        (only begin_pass's exchange changes the plan), each shard resolving
        only the misses of its cache's snapshot directory.  begin_pass
        discards the stage when the hot set churned in between, or when
        the fetch was fault-injected (the buffer is then None)."""
        t0 = time.perf_counter()
        if callable(pass_keys):
            pass_keys = pass_keys()
        # one process: the local census is the global one
        pk = _sorted_unique(pass_keys)
        cache_keys, stage_seq, entries = self._stage_snapshot()
        shot = self._hot_keys if self._hot_realize else None
        cold_pk = (np.setdiff1d(pk, shot, assume_unique=True)
                   if shot is not None and shot.shape[0] else pk)
        owner, shard_keys, row_within = self._shard_split(cold_pk)
        lvals = np.zeros((self.n_shards, self._sharded_cap(shard_keys),
                          self.conf.row_width + 1), dtype=np.float32)
        for o, sk in enumerate(shard_keys):
            if not self._stage_resolve(
                    sk, lvals[o, : sk.shape[0]],
                    cache_keys[o] if cache_keys else None, entries):
                lvals = None
                break
        if lvals is not None:
            telemetry.histogram(
                "pass.promote_seconds",
                "background next-pass census resolve + init + staging "
                "wall time",
            ).observe(time.perf_counter() - t0)
        # stage_seq stays last: _pop_stage reads payload[-1]
        return pk, owner, shard_keys, row_within, lvals, shot, stage_seq

    def _use_sharded_stage(self, payload, patches, pk: np.ndarray):
        """(shard_keys, row_within, patched stacked buffer) of a stage that
        matches the census, the hot set and the capacity, else None
        (counted as a discard)."""
        if payload is None:
            return None
        spk, _, shard_keys, row_within, lvals, shot, _ = payload
        if not (lvals is not None and np.array_equal(spk, pk)
                and (shot is None or np.array_equal(shot, self._hot_keys))
                and lvals.shape[1] == self._sharded_cap(shard_keys)):
            stats.add("pass.stage_discards")
            return None
        for o, sk in enumerate(shard_keys):
            if sk.shape[0]:
                _patch_in(sk, lvals[o, : sk.shape[0]], patches)
        return shard_keys, row_within, lvals

    def _cached_sync_resolve(self, caches, shard_keys, lvals,
                             pk: np.ndarray) -> Optional[list]:
        """The synchronous census resolve against the per-shard caches:
        each shard fetches only its misses from the host.  Returns the
        shards' cache plans, which the device hit-fill reuses.  A
        fault-injected fetch (``cache.fetch``) degrades the whole pass to
        the uncached host resolve (dirty rows drain first, the census
        leaves every cache) and returns None: no hit-fill then."""
        try:
            plans = []
            for i, o in enumerate(self._local_pos):
                sk = shard_keys[o]
                plan = caches[i].lookup(sk)
                miss_pos = np.nonzero(~plan.hit_mask)[0]
                if miss_pos.shape[0]:
                    lvals[i, miss_pos] = self._cache_fetch_rows(sk[miss_pos])
                plans.append(plan)
        except faults.FaultInjected:
            self._cache_degrade(pk)
            lvals[:] = 0.0
            for i, o in enumerate(self._local_pos):
                sk = shard_keys[o]
                lvals[i, : sk.shape[0]] = self._resolve_or_init(sk)
            return None
        return plans

    def _cache_hit_fill(self, caches, plans, shard_keys,
                        buf: torch.Tensor) -> int:
        """Fill every shard's cache hits into the stacked buffer ``buf``
        [n, cap, W+1] straight from the device (hits never touch the
        host): a gather_slots of the hit slots into the hit positions.
        Credits each census (``touch``), keeps the pass's plans for
        end_pass and returns the hits."""
        self._cache_plans = []
        for i, o in enumerate(self._local_pos):
            sk = shard_keys[o]
            plan = plans[i] if plans is not None else caches[i].lookup(sk)
            if plan.n_hits:
                pos = torch.from_numpy(plan.hit_pos.astype(np.int64))
                buf[i].index_copy_(0, pos.to(self.device),
                                   caches[i].gather_rows(plan.hit_slots))
            caches[i].touch(plan)
            self._cache_plans.append(plan)
            self.last_shard_hits.append(plan.n_hits)
            self.last_shard_misses.append(int(sk.shape[0]) - plan.n_hits)
        return sum(self.last_shard_hits)

    def begin_pass(self, pass_keys: np.ndarray) -> None:
        """Exchange the census (advancing the planner), reconcile the hot
        block with the plan, and promote the cold working set to the device
        as the stacked ``values``/``g2sum``: the host supplies each shard's
        cache misses, the hits are filled on the device.  A matching stage
        leaves only its patch, the copy and the fill."""
        if self._in_pass:
            raise RuntimeError("end_pass the previous pass first")
        t0 = self._stamp()
        pk = self._exchange_census(_sorted_unique(pass_keys))
        w = self.conf.row_width
        self.last_hot_moved_rows = 0
        cold_pk = pk
        if self._hot_realize:
            self._sync_hot_block()
            if self._hot_keys.shape[0]:
                cold_pk = np.setdiff1d(pk, self._hot_keys, assume_unique=True)
        t1 = time.perf_counter()
        payload, patches = self._pop_stage()
        t2 = time.perf_counter()
        staged = self._use_sharded_stage(payload, patches, pk)
        t3 = time.perf_counter()
        caches = self._caches()
        plans = None
        if staged is not None:
            shard_keys, row_within, lvals = staged
        else:
            _, shard_keys, row_within = self._shard_split(cold_pk)
            cap = self._sharded_cap(shard_keys)
            # only the local shards materialize: rows come from this
            # process's store and new keys init key-deterministically, so
            # any process layout gives identical rows
            lvals = np.zeros((self.n_local, cap, w + 1), dtype=np.float32)
            if caches:
                plans = self._cached_sync_resolve(caches, shard_keys, lvals,
                                                  cold_pk)
                if plans is None:
                    caches = []
            else:
                for i, o in enumerate(self._local_pos):
                    sk = shard_keys[o]
                    lvals[i, : sk.shape[0]] = self._resolve_or_init(sk)
        t4 = self._stamp()
        buf = torch.from_numpy(lvals).to(self.device)
        t5 = self._stamp()
        self._cache_plans = None
        self.last_shard_hits, self.last_shard_misses = [], []
        hits = 0
        # the cold keys this process's shards own (the whole cold census
        # in one process)
        owned = sum(int(shard_keys[o].shape[0]) for o in self._local_pos)
        if caches:
            hits = self._cache_hit_fill(caches, plans, shard_keys, buf)
            self.last_cache_hits = hits
            self.last_cache_misses = owned - hits
            telemetry.gauge(
                "cache.hit_rate",
                "fraction of the pass census served from the HBM cache",
            ).set(hits / max(owned, 1))
        # boundary host traffic: the rows that crossed host -> device (the
        # cache misses; everything with the caches off).  The hot tier
        # never lands here
        telemetry.counter(
            "pass.host_row_bytes_in",
            "embedding-row bytes promoted host->device at begin_pass "
            "(cache misses + cold materialization)",
        ).inc(max(owned - hits, 0) * 4 * (w + 1))
        # two contiguous tensors: the kernels take no strided views
        self.values = buf[:, :, :w].contiguous()
        self.g2sum = buf[:, :, w].contiguous()
        t6 = self._stamp()
        self.last_begin_breakdown = {
            "staged": staged is not None, "census_s": t1 - t0,
            "stage_wait_s": t2 - t1, "patch_s": t3 - t2,
            "resolve_s": t4 - t3, "h2d_s": t5 - t4, "cache_fill_s": t6 - t5,
        }
        self.last_promotion_rows = owned - hits
        self._shard_keys = shard_keys
        self._shard_live = np.asarray(
            [shard_keys[o].shape[0] for o in self._local_pos], np.int32
        )  # per-local-shard scratch base
        self._pass_row = row_within
        self._pass_keys = cold_pk
        self._census_index = None  # stale: it indexes the previous census
        self._in_pass = True
        if self.multiprocess:
            # this process's delta: its shards' cold keys and the hot keys
            # it owns (every replica trains them, one owner persists them)
            local = [shard_keys[o] for o in self._local_pos]
            if self._hot_keys.shape[0]:
                local.append(self._hot_keys[self._owned(self._hot_keys)])
            self._delta_keys.append(np.concatenate(local))
        else:
            self._delta_keys.append(pk)
        self._observe_gap()

    def _sorted_write_back(self, ks: list, vs: list) -> None:
        """One globally sorted write-back from per-shard key/row pieces
        (shards partition the key space, so the concat is unique)."""
        ks = [k for k in ks if k.shape[0]]
        vs = [v for v in vs if v.shape[0]]
        if ks:
            k = np.concatenate(ks)
            v = np.concatenate(vs)
            order = np.argsort(k, kind="stable")
            count_rows_out(v)
            self._write_back(k[order], v[order])

    def _live_rows(self) -> tuple:
        """(keys, rows) of every local shard's live working-set rows."""
        ks, vs = [], []
        for i, o in enumerate(self._local_pos):
            sk = self._shard_keys[o]
            m = sk.shape[0]
            if m:
                ks.append(sk)
                vs.append(torch.cat(
                    [self.values[i, :m], self.g2sum[i, :m, None]], dim=1
                ).cpu().numpy())
        return ks, vs

    def _end_pass_cached_sharded(self, caches, plans) -> None:
        """Cached end of pass, shard by shard: hits and admits update their
        cache slots in place (``set_rows``) from the stacked working set,
        and only the cold and evicted rows come to the host, in ONE
        globally sorted write-back.  A fault at ``cache.admit`` degrades
        every shard to the full write-back with the census hits leaving
        the caches, as on an uncached table."""
        try:
            faults.inject("cache.admit")
            upds = [c.plan_update(self._shard_keys[o], plans[i])
                    for i, (c, o) in enumerate(zip(caches, self._local_pos))]
        except faults.FaultInjected:
            telemetry.counter(
                "cache.admit_fallbacks",
                "cache admissions degraded to the full host write-back",
            ).inc()
            ks, vs = self._live_rows()
            with self._cache_lock:
                for i, (c, o) in enumerate(zip(caches, self._local_pos)):
                    sk = self._shard_keys[o]
                    c.evict_keys(sk[plans[i].hit_mask])
                self._sorted_write_back(ks, vs)
            self.last_write_back_rows = int(sum(k.shape[0] for k in ks))
            return
        full = torch.cat([self.values, self.g2sum[:, :, None]], dim=2)
        dev_idx = lambda a: torch.from_numpy(a.astype(np.int64)).to(
            self.device)
        ks, vs = [], []
        n_evicted = 0
        for i, (c, o) in enumerate(zip(caches, self._local_pos)):
            sk = self._shard_keys[o]
            plan, upd = plans[i], upds[i]
            if not sk.shape[0]:
                continue
            upd_pos = np.concatenate([plan.hit_pos, upd.admit_pos])
            if upd_pos.shape[0]:
                if upd.victim_slots.shape[0]:
                    # victims are read before set_rows overwrites them
                    ks.append(upd.victim_keys)
                    vs.append(c.gather_rows(upd.victim_slots).cpu().numpy())
                    n_evicted += int(upd.victim_slots.shape[0])
                c.set_rows(np.concatenate([plan.hit_slots, upd.admit_slots]),
                           full[i].index_select(0, dev_idx(upd_pos)))
            if upd.cold_pos.shape[0]:
                ks.append(sk[upd.cold_pos])
                vs.append(full[i].index_select(
                    0, dev_idx(upd.cold_pos)).cpu().numpy())
        with self._cache_lock:
            for i, c in enumerate(caches):
                c.commit_update(plans[i], upds[i])
            self._sorted_write_back(ks, vs)
        self.last_evicted_rows = n_evicted
        self.last_write_back_rows = int(sum(k.shape[0] for k in ks))
        count_evicted(n_evicted)

    def end_pass(self) -> None:
        """Write the cold working set back: to each shard's cache for its
        resident and admitted rows, to the host store for the rest.  The
        hot block stays on the device: its rows are now newer than the
        store until the next flush or demotion."""
        if not self._in_pass:
            raise RuntimeError("no pass in flight")
        caches = self._caches()
        plans, self._cache_plans = self._cache_plans, None
        self.last_evicted_rows = 0
        if caches and plans is not None:
            self._end_pass_cached_sharded(caches, plans)
        else:
            ks, vs = self._live_rows()
            self._sorted_write_back(ks, vs)
            self.last_write_back_rows = int(sum(k.shape[0] for k in ks))
        self.values = None
        self.g2sum = None
        if self._hot_keys.shape[0]:
            self._hot_dirty = True
        self._shard_keys = None
        self._census_index = None  # dropped, not closed: see SparseTable
        self._pass_keys = None
        self._pass_row = None
        self._in_pass = False
        self._last_end_t = time.monotonic()

    def pass_state_dict(self) -> dict:
        """Snapshot usable mid-pass: the live cold rows and the resident hot
        rows when a pass is open, the host store otherwise.  In a job this
        process's shards only (checkpoints are per process)."""
        if not self._in_pass:
            return self.state_dict()
        keys, rows = self._live_rows()
        if self._hot_keys.shape[0] and self.hot_values is not None:
            hk, hr = self._hot_keys, self._hot_rows()
            if self.multiprocess:
                own = self._owned(hk)
                hk, hr = hk[own], hr[own]
            if hk.shape[0]:
                keys.append(hk)
                rows.append(hr)
        if not keys:
            return {
                "keys": np.empty(0, np.uint64),
                "values": np.empty((0, self.conf.row_width + 1), np.float32),
            }
        k = np.concatenate(keys)
        v = np.concatenate(rows)
        order = np.argsort(k)
        return {"keys": k[order], "values": v[order]}

    # -- planning --------------------------------------------------------- #
    @property
    def shard_capacity(self) -> int:
        return 0 if self.values is None else int(self.values.shape[1])

    @property
    def capacity(self) -> int:
        """Working-set rows over all shards."""
        return self.shard_capacity * self.n_shards

    @property
    def dead_row(self) -> int:
        """In-shard dead-row index."""
        return self.shard_capacity - 1

    def plan_batch(self, batch):
        raise TypeError(
            "ShardedSparseTable plans whole position groups: use "
            "plan_group([batch_per_position, ...]) with MultiChipTrainer"
        )

    def plan_keys(self, keys, n_real):
        raise TypeError(
            "ShardedSparseTable plans whole position groups: use plan_group()"
        )

    def bucket_capacity(self, key_capacity: int) -> int:
        n = self.n_shards
        c = int(np.ceil(key_capacity * self.bucket_slack / n / 8.0)) * 8
        return min(key_capacity, max(c, 8))

    def plan_group(self, batches: Sequence[HostBatch],
                   slot_lr_vec: Optional[np.ndarray] = None,
                   n_slots: Optional[int] = None,
                   gather=None) -> ShardedBatchPlan:
        """Resolve one batch group (one batch per LOCAL shard position)
        into the stacked all_to_all plan; every plan array carries this
        process's leading axis [L, ...].  The bucket capacity is exact-fit,
        never lossy: the worst per-shard occupancy is found first (in a job
        agreed over every process), and the bucket grows in power-of-two
        steps above the base when a group needs it.

        ``gather``: the allgather of the two planning exchanges in a job
        (the capacity need, then the want matrices in process order);
        default ``multiprocess.host_allgather``.  The multi-chip trainer's
        producer thread hands its per-pass ``plan-<k>`` KvChannel, so
        planning never issues a process-group collective.  One process
        needs no gather.

        ``slot_lr_vec`` + ``n_slots``: the per-slot LR map ([S] float32 of
        train/slot_policy.py).  Each occurrence's slot lr is resolved on the
        requester, carried beside the row id in the want matrix, and folded
        into a per-served-unique-row lr (``plan.serve_lr``) by the serve
        dedup; hot slots take it in ``hot_lr``.  A key in several slots
        takes the last assignment, as the single-chip feed's does."""
        if not self._in_pass:
            raise RuntimeError("begin_pass before planning batches")
        if slot_lr_vec is not None and not n_slots:
            raise ValueError("slot_lr_vec needs n_slots to resolve "
                             "occurrence slots from key_segments")
        default_lr = float(self.conf.learning_rate)
        n = self.n_shards
        L = self.n_local
        if len(batches) != L:
            raise ValueError(
                f"need {L} batches (one per local shard position), got "
                f"{len(batches)}"
            )
        if self.multiprocess and gather is None:
            from paddlebox_tpu_torch.parallel.multiprocess import (
                host_allgather,
            )

            gather = host_allgather
        K = batches[0].keys.shape[0]
        dead = self.shard_capacity - 1

        # pass 1 (capacity-independent): each position's unique keys and
        # the worst per-shard occupancy
        per_dev: list = []
        needed = 0
        n_missing = 0
        ix = self._native_index()
        hot_res = self._hot_keys if self._hot_realize else None
        H = self.hot_block_capacity
        for b in batches:
            if b.n_keys == 0:
                per_dev.append(None)
                continue
            real = b.keys[: b.n_keys]
            out = ix.lookup_unique(real, b.n_keys) if ix is not None else None
            if out is not None:
                # native dedup and census lookup: unique keys in first-seen
                # order (so the slot layout below follows that order, as in
                # the reference's native plan), census positions -1 where
                # absent
                inv, uk, pos = out
                found = pos >= 0
                if self._pass_row.shape[0]:
                    rows = np.where(
                        found, self._pass_row[np.clip(pos, 0, None)], dead
                    ).astype(np.int32)
                else:  # an empty census finds nothing
                    rows = np.full(uk.shape[0], dead, np.int32)
                owner = (uk % np.uint64(n)).astype(np.int64)
                miss = int((~found).sum())
            else:
                uk, inv = np.unique(real, return_inverse=True)
                rows, owner, miss = self._resolve_shard_rows(uk)
            if hot_res is not None and hot_res.shape[0]:
                hp = np.searchsorted(hot_res, uk)
                hp_c = np.minimum(hp, hot_res.shape[0] - 1)
                ishot = hot_res[hp_c] == uk
                # resident hot keys are not in the cold census, so the
                # resolve counted them missing: they are not
                miss -= int(ishot.sum())
                # hot keys go to a VIRTUAL group n, so they take no cold
                # slot and do not inflate the bucket need
                owner_v = np.where(ishot, np.int64(n), owner)
                slot = _rank_within_group(owner_v, n + 1)
            else:
                ishot = np.zeros(uk.shape[0], dtype=bool)
                hp_c = None
                slot = _rank_within_group(owner, n)
            n_missing += miss
            per_dev.append((b.n_keys, inv, rows, owner, slot, ishot, hp_c))
            cold_slot = slot[~ishot] if hp_c is not None else slot
            if cold_slot.shape[0]:
                needed = max(needed, int(cold_slot.max()) + 1)

        if self.multiprocess:
            # every process builds the same [L, n, C] want shape: agree on
            # the worst need first (8 bytes a process)
            needed = int(gather(np.asarray([needed], np.int64)).max())
        # floor of 8: a K = 0 batch would give base 0, and 0 * 2 == 0
        base = max(self.bucket_capacity(K), 8)
        C = base
        while C < needed:
            C *= 2
        if C > base:
            self.capacity_bumps += 1

        want = np.full((L, n, C), dead, dtype=np.int32)
        want_lr = (None if slot_lr_vec is None
                   else np.full((L, n, C), default_lr, dtype=np.float32))
        occ = np.full((L, K), n * C, dtype=np.int32)
        mask = np.zeros((L, K), dtype=np.float32)
        # every occurrence also carries a hot slot (H = sink for cold and
        # padding) and each referenced hot slot its lr (0.0 where this
        # position has no occurrence: the step's pmax fold recovers it);
        # shapes depend only on the padded capacity H
        hot_occ = hot_lr = None
        if self._hot_realize:
            hot_occ = np.full((L, K), H, dtype=np.int32)
            hot_lr = np.zeros((L, H), dtype=np.float32)
        for d, resolved in enumerate(per_dev):
            if resolved is None:
                continue
            n_keys, inv, rows, owner, slot, ishot, hp_c = resolved
            cold = ~ishot
            want[d, owner[cold], slot[cold]] = rows[cold]
            occ[d, :n_keys] = np.where(
                ishot, n * C, owner * C + slot
            ).astype(np.int32)[inv]
            mask[d, :n_keys] = 1.0
            klr = np.full(rows.shape[0], default_lr, np.float32)
            if want_lr is not None:
                # occurrence slot -> lr, merged per unique key (last wins)
                klr[inv] = np.asarray(slot_lr_vec, np.float32)[
                    np.asarray(batches[d].key_segments[:n_keys]) % n_slots]
                want_lr[d, owner[cold], slot[cold]] = klr[cold]
            if hot_occ is not None and hp_c is not None:
                hot_occ[d, :n_keys] = np.where(
                    ishot, hp_c, H
                ).astype(np.int32)[inv]
                if ishot.any():
                    hot_lr[d, hp_c[ishot]] = klr[ishot]
        # every requester's want matrix in position order (processes hold
        # contiguous runs); one process: want itself.  Under an LR map the
        # float lrs travel bit-packed beside the row ids, so a job still
        # pays one want gather
        if not self.multiprocess:
            want_all, lr_all = want, want_lr
        elif want_lr is None:
            want_all, lr_all = gather(want).reshape(n, n, C), None
        else:
            packed = np.concatenate(
                [want[..., None], want_lr.view(np.int32)[..., None]], axis=-1
            )  # [L, n, C, 2] int32
            packed_all = gather(packed).reshape(n, n, C, 2)
            want_all = np.ascontiguousarray(packed_all[..., 0])
            lr_all = np.ascontiguousarray(packed_all[..., 1]).view(np.float32)
        # the serve side: local shard o serves want_all[:, o, :]; dedup the
        # rows so the push updates each row once (the dead row shares one
        # segment; it is scrubbed after every push)
        serve_rows = np.ascontiguousarray(
            want_all[:, self._local_pos, :].transpose(1, 0, 2))  # [L, n, C]
        serve_map = np.empty((L, n, C), dtype=np.int32)
        serve_lr = lr_serve = None
        if lr_all is not None:
            # aligned with serve_rows
            lr_serve = lr_all[:, self._local_pos, :].transpose(1, 0, 2)
            serve_lr = np.full((L, n * C), default_lr, np.float32)
        # padding tail: every slot its OWN scratch row (live + j), so
        # serve_uniq is unique apart from np.unique's single dead entry and
        # the slots past the scratch region clamped to the dead row, whose
        # deltas sharded_push_and_update zeroes
        self._last_serve_n = max(self._last_serve_n, n * C)
        serve_uniq = np.minimum(
            self._shard_live[:, None]
            + np.arange(n * C, dtype=np.int32)[None, :],
            dead,
        )
        for o in range(L):
            out = None
            if ix is not None:  # the same switch as the request side
                from paddlebox_tpu_torch._native import dedup_rows_native

                out = dedup_rows_native(serve_rows[o])
            if out is not None:
                inv, uq = out  # first-seen order, like the request side
            else:
                uq, inv = np.unique(serve_rows[o].reshape(-1),
                                    return_inverse=True)
            serve_uniq[o, : uq.shape[0]] = uq
            serve_map[o] = inv.reshape(n, C).astype(np.int32)
            if serve_lr is not None:
                # requesters of one row carry one key, hence one slot lr
                # (dead and padding rows may disagree: their deltas are
                # zeroed in the push, so any value is benign)
                serve_lr[o][inv] = lr_serve[o].reshape(-1)
        self.missing_key_count += n_missing
        return ShardedBatchPlan(serve_rows, occ, serve_map, serve_uniq, mask,
                                n_missing, hot_occ, hot_lr, serve_lr)

    def _resolve_shard_rows(self, uk: np.ndarray):
        """Owner shard and row-within-shard for sorted unique keys (the dead
        row when absent from the pass census); owners and the search stay
        in uint64."""
        dead = self.shard_capacity - 1
        owner = (uk % np.uint64(self.n_shards)).astype(np.int64)
        npk = self._pass_keys.shape[0]
        if npk == 0:
            return np.full(uk.shape[0], dead, np.int32), owner, uk.shape[0]
        pos = np.searchsorted(self._pass_keys, uk)
        pos_c = np.minimum(pos, npk - 1)
        found = self._pass_keys[pos_c] == uk
        rows = np.where(found, self._pass_row[pos_c], dead).astype(np.int32)
        return rows, owner, int((~found).sum())


def _rank_within_group(group: np.ndarray, n_groups: int) -> np.ndarray:
    """rank_within_group([2,0,2,1]) -> [0,0,1,0]: occurrence index of each
    element within its group, preserving order."""
    order = np.argsort(group, kind="stable")
    sorted_g = group[order]
    starts = np.searchsorted(sorted_g, np.arange(n_groups))
    ranks = np.empty_like(group)
    ranks[order] = np.arange(group.shape[0]) - starts[sorted_g]
    return ranks
