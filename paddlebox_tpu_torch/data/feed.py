"""Batch assembly: columnar records -> fixed-shape padded host batches
(reference: paddlebox_tpu/data/feed.py).

    keys          uint64 [K]   all feasigns of the batch (padded with 0)
    key_segments  int32  [K]   segment id = ins_in_batch * S + slot;
                               padding gets segment B*S (overflow bin)
    dense         f32    [B, D]
    labels        f32    [B]
    ins_mask      f32    [B]   0 for padding instances of a partial batch

Fixed shapes keep every device tensor of a pass the same size.  Pooling on
the device is one segment sum over ``key_segments`` (ops/seqpool_cvm.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data.record import RecordBlock


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


def empty_like(batch: HostBatch) -> HostBatch:
    """An all-padding batch with the same static shapes (ins_mask zero, every
    key slot pointing at the overflow segment), used to pad a ragged group
    of per-position batches in multi-chip training."""
    B, S = batch.batch_size, batch.n_sparse_slots
    return HostBatch(
        keys=np.zeros_like(batch.keys),
        key_segments=np.full_like(batch.key_segments, B * S),
        n_keys=0,
        dense=np.zeros_like(batch.dense),
        labels=np.zeros_like(batch.labels),
        ins_mask=np.zeros_like(batch.ins_mask),
        batch_size=B,
        n_sparse_slots=S,
    )


class BatchBuilder:
    """Packs instance index ranges of a RecordBlock into HostBatches."""

    def __init__(self, conf: DataFeedConfig):
        self.conf = conf
        self.key_capacity = conf.batch_key_capacity or (
            conf.batch_size * conf.max_feasigns_per_ins
        )
        self.dropped_keys = 0  # overflow counter

    def build(self, block: RecordBlock, ids: np.ndarray) -> HostBatch:
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
        return HostBatch(
            keys=keys,
            key_segments=segs,
            n_keys=total,
            dense=dense,
            labels=labels,
            ins_mask=mask,
            batch_size=B,
            n_sparse_slots=S,
        )
