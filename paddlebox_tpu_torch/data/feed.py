"""Batch assembly: columnar records -> fixed-shape padded host batches
(reference: paddlebox_tpu/data/feed.py).

    keys          uint64 [K]   all feasigns of the batch (padded with 0)
    key_segments  int32  [K]   segment id = ins_in_batch * S + slot;
                               padding gets segment B*S (overflow bin)
    dense         f32    [B, D]
    labels        f32    [B]
    ins_mask      f32    [B]   0 for padding instances of a partial batch

and, only where the config or the data asks for them: ``rank_offset`` (PV
merge), ``seq_pos`` (``sequence_slot``), ``task_labels``
(``task_label_slots``), ``cmatches`` / ``ranks`` (``parse_logkey``) and
``ins_ids`` (``parse_ins_id``).  A batch without them costs nothing more.

Fixed shapes keep every device tensor of a pass the same size.  Pooling on
the device is one segment sum over ``key_segments`` (ops/seqpool_cvm.py).
Every batch built reports the ``feed`` stage to the active liveness
watchdog (parallel/watchdog.py), so a slow but live feed is not a stall.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data.record import RecordBlock

_beat = None  # resolved on first use: the liveness stage beat


def _liveness_beat(stage: str) -> None:
    """Report feed-assembly progress to the active liveness watchdog
    (parallel/watchdog.py; a no-op outside a guarded pass).  Imported on
    first use: the data plane loads without the parallel package."""
    global _beat
    if _beat is None:
        from paddlebox_tpu_torch.parallel.watchdog import beat

        _beat = beat
    _beat(stage)


@dataclasses.dataclass
class HostBatch:
    keys: np.ndarray  # uint64 [K]
    key_segments: np.ndarray  # int32 [K]; padding -> batch_size * n_slots
    n_keys: int  # real key count
    dense: np.ndarray  # float32 [B, D]
    labels: np.ndarray  # float32 [B]
    ins_mask: np.ndarray  # float32 [B]
    batch_size: int
    n_sparse_slots: int
    rank_offset: Optional[np.ndarray] = None  # int32 [B, C] (PV merge)
    # the sequence slot's key positions per instance, in order; padding =
    # the key capacity K
    seq_pos: Optional[np.ndarray] = None  # int32 [B, max_seq_len]
    # [B, T]: column 0 the primary label, 1.. the task_label_slots
    task_labels: Optional[np.ndarray] = None
    cmatches: Optional[np.ndarray] = None  # int32 [B], padding -1
    ranks: Optional[np.ndarray] = None  # int32 [B], padding -1
    ins_ids: Optional[list] = None  # the real rows' ids (field dumps)

    @property
    def n_real_ins(self) -> int:
        return int(self.ins_mask.sum())


def empty_like(batch: HostBatch) -> HostBatch:
    """An all-padding batch with the same static shapes (ins_mask zero, every
    key slot pointing at the overflow segment), used to pad a ragged group
    of per-position batches in multi-chip training."""
    B, S = batch.batch_size, batch.n_sparse_slots
    zeros = lambda a: None if a is None else np.zeros_like(a)
    return HostBatch(
        keys=np.zeros_like(batch.keys),
        key_segments=np.full_like(batch.key_segments, B * S),
        n_keys=0,
        dense=np.zeros_like(batch.dense),
        labels=np.zeros_like(batch.labels),
        ins_mask=np.zeros_like(batch.ins_mask),
        batch_size=B,
        n_sparse_slots=S,
        rank_offset=zeros(batch.rank_offset),
        seq_pos=None if batch.seq_pos is None
        else np.full_like(batch.seq_pos, batch.keys.shape[0]),
        task_labels=zeros(batch.task_labels),
        cmatches=zeros(batch.cmatches),
        ranks=zeros(batch.ranks),
        ins_ids=None if batch.ins_ids is None else [],
    )


def build_rank_offset(block: RecordBlock, ids: np.ndarray,
                      pv_bounds: np.ndarray, batch_size: int, max_rank: int,
                      cmatch_filter=None) -> np.ndarray:
    """The PV rank matrix [B, 2*max_rank+1] with batch-local peer rows
    (reference: CopyRankOffsetKernel, data_feed.cu:208-258; -1 fill).

    ``pv_bounds`` [n_pvs+1]: the page-view boundaries within ``ids``.  Row
    layout per ad: column 0 its own rank (1-based, -1 unranked); for peer
    rank m, column 2m+1 the peer's rank and 2m+2 the peer's row in this
    batch.  The ads of a PV see each other, themselves included.  An ad is
    unranked when its cmatch is filtered out or its rank is 0 or above
    max_rank."""
    cols = 2 * max_rank + 1
    mat = np.full((batch_size, cols), -1, dtype=np.int32)
    if block.ranks is None:
        return mat
    ranks = block.ranks[ids]
    cmatches = (block.cmatches[ids] if block.cmatches is not None
                else np.zeros_like(ranks))
    ok = (ranks > 0) & (ranks <= max_rank)
    if cmatch_filter is not None:
        ok &= np.isin(cmatches, np.asarray(list(cmatch_filter)))
    eff_rank = np.where(ok, ranks, -1).astype(np.int32)
    mat[:ids.shape[0], 0] = eff_rank
    # the (ranked j, ranked k) pairs of each PV, expanded without a Python
    # loop over PVs (millions of them at pass scale)
    n_pvs = pv_bounds.shape[0] - 1
    pv_of = np.repeat(np.arange(n_pvs), np.diff(pv_bounds))
    ranked_pos = np.nonzero(eff_rank > 0)[0]
    if ranked_pos.shape[0] == 0:
        return mat
    counts = np.bincount(pv_of[ranked_pos], minlength=n_pvs)
    group_start = np.zeros(n_pvs, dtype=np.int64)
    np.cumsum(counts[:-1], out=group_start[1:])
    sq = counts.astype(np.int64) ** 2
    total = int(sq.sum())
    pair_start = np.zeros(n_pvs, dtype=np.int64)
    np.cumsum(sq[:-1], out=pair_start[1:])
    # j: each ranked member of a c-member PV appears c times in a row
    j = ranked_pos[np.repeat(np.arange(ranked_pos.shape[0]),
                             np.repeat(counts, counts))]
    # k: the PV's members tiled c times, from the position in the pair run
    pair_pos = np.arange(total, dtype=np.int64) - np.repeat(pair_start, sq)
    k_within = pair_pos % np.repeat(counts, sq).astype(np.int64)
    k = ranked_pos[np.repeat(group_start, sq) + k_within]
    m = eff_rank[k] - 1
    mat[j, 2 * m + 1] = eff_rank[k]
    mat[j, 2 * m + 2] = k
    return mat


class BatchBuilder:
    """Packs instance index ranges of a RecordBlock into HostBatches."""

    def __init__(self, conf: DataFeedConfig):
        self.conf = conf
        self.key_capacity = conf.batch_key_capacity or (
            conf.batch_size * conf.max_feasigns_per_ins
        )
        self.dropped_keys = 0  # overflow counter
        self.seq_slot_idx: Optional[int] = None
        if conf.sequence_slot:
            names = [s.name for s in conf.sparse_slots()]
            if conf.sequence_slot not in names:
                raise ValueError(
                    f"sequence_slot {conf.sequence_slot!r} is not a sparse "
                    f"slot (have {names})"
                )
            self.seq_slot_idx = names.index(conf.sequence_slot)

    def build_pv(self, block: RecordBlock, ids: np.ndarray,
                 pv_bounds: np.ndarray) -> HostBatch:
        """A PV-merged batch: the same packing plus the rank_offset
        matrix."""
        batch = self.build(block, ids)
        batch.rank_offset = build_rank_offset(
            block, np.asarray(ids, dtype=np.int64), pv_bounds,
            self.conf.batch_size, self.conf.max_rank,
            self.conf.rank_cmatch_filter,
        )
        return batch

    def build(self, block: RecordBlock, ids: np.ndarray) -> HostBatch:
        _liveness_beat("feed")
        B = self.conf.batch_size
        S = block.n_sparse_slots
        K = self.key_capacity
        ids = np.asarray(ids, dtype=np.int64)
        b = int(ids.shape[0])
        if b > B:
            raise ValueError(f"{b} instances for a batch of {B}")

        sel_rows = (ids[:, None] * S + np.arange(S)[None, :]).reshape(-1)
        lens = np.diff(block.key_offsets)[sel_rows]
        total = int(lens.sum())
        if total > K:
            # clip overflowing tail rows (counted in dropped_keys)
            cum = np.cumsum(lens)
            lens = np.minimum(lens, np.maximum(K - (cum - lens), 0))
            self.dropped_keys += total - int(lens.sum())
            total = int(lens.sum())
        new_off = np.zeros(sel_rows.shape[0] + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        starts = block.key_offsets[sel_rows]
        pos = np.arange(total, dtype=np.int64) - np.repeat(new_off[:-1], lens)
        src_idx = np.repeat(starts, lens) + pos

        keys = np.zeros(K, dtype=np.uint64)
        keys[:total] = block.keys[src_idx]
        segs = np.full(K, B * S, dtype=np.int32)
        segs[:total] = np.repeat(np.arange(b * S, dtype=np.int32), lens)

        dense = np.zeros((B, block.dense.shape[1]), dtype=np.float32)
        dense[:b] = block.dense[ids]
        labels = np.zeros(B, dtype=np.float32)
        labels[:b] = block.labels[ids]
        mask = np.zeros(B, dtype=np.float32)
        mask[:b] = 1.0
        batch = HostBatch(
            keys=keys,
            key_segments=segs,
            n_keys=total,
            dense=dense,
            labels=labels,
            ins_mask=mask,
            batch_size=B,
            n_sparse_slots=S,
        )
        if self.seq_slot_idx is not None:
            # instance i's run of the sequence slot is [new_off[r],
            # new_off[r] + lens[r]) with r = i*S + slot, in file (behavior)
            # order; the rest pads with K
            T = self.conf.max_seq_len
            seq_pos = np.full((B, T), K, dtype=np.int32)
            rr = np.arange(b, dtype=np.int64) * S + self.seq_slot_idx
            col = np.arange(T, dtype=np.int64)[None, :]
            seq_pos[:b] = np.where(col < np.minimum(lens[rr], T)[:, None],
                                   new_off[:-1][rr][:, None] + col, K)
            batch.seq_pos = seq_pos
        if block.task_labels is not None and block.task_labels.shape[1]:
            tl = np.zeros((B, 1 + block.task_labels.shape[1]), dtype=np.float32)
            tl[:b, 0] = labels[:b]
            tl[:b, 1:] = block.task_labels[ids]
            batch.task_labels = tl
        if block.cmatches is not None:
            batch.cmatches = np.full(B, -1, dtype=np.int32)
            batch.cmatches[:b] = block.cmatches[ids]
        if block.ranks is not None:
            batch.ranks = np.full(B, -1, dtype=np.int32)
            batch.ranks[:b] = block.ranks[ids]
        if block.ins_ids is not None:
            batch.ins_ids = [block.ins_ids[i] for i in ids]
        return batch
