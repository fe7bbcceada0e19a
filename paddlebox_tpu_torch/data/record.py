"""Columnar instance storage (reference: paddlebox_tpu/data/record.py).

A whole file of instances parses into one CSR block, so batch assembly is
array slicing.  The optional per-instance metadata (ins_id, search_id,
rank, cmatch, task labels) feeds PV merge, shuffle routing, metric groups
and field dumps; a column is None unless the parser was told to read it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


# the optional per-instance columns, in the reference's field order
_META = ("ins_ids", "search_ids", "ranks", "cmatches", "task_labels")


@dataclasses.dataclass
class RecordBlock:
    """A block of N instances over S sparse slots and D dense floats.

    CSR layout: ``keys[key_offsets[i*S+s] : key_offsets[i*S+s+1]]`` are the
    uint64 feasigns of instance ``i``, sparse slot ``s``.
    """

    n_ins: int
    n_sparse_slots: int
    keys: np.ndarray  # uint64 [total_keys]
    key_offsets: np.ndarray  # int64 [n_ins * n_sparse_slots + 1]
    dense: np.ndarray  # float32 [n_ins, dense_width]
    labels: np.ndarray  # float32 [n_ins]
    # optional per-instance metadata (PV merge, shuffle routing, dumps)
    ins_ids: Optional[list] = None  # str [n_ins]
    search_ids: Optional[np.ndarray] = None  # uint64 [n_ins]
    ranks: Optional[np.ndarray] = None  # int32 [n_ins]
    cmatches: Optional[np.ndarray] = None  # int32 [n_ins]
    task_labels: Optional[np.ndarray] = None  # float32 [n_ins, n_tasks]

    def __post_init__(self):
        if (self.key_offsets.shape[0] != self.n_ins * self.n_sparse_slots + 1
                or self.dense.shape[0] != self.n_ins
                or self.labels.shape[0] != self.n_ins):
            raise ValueError(
                f"inconsistent RecordBlock: {self.n_ins} instances x "
                f"{self.n_sparse_slots} slots, {self.key_offsets.shape[0]} "
                f"offsets, {self.dense.shape[0]} dense rows, "
                f"{self.labels.shape[0]} labels"
            )

    @property
    def n_keys(self) -> int:
        return int(self.keys.shape[0])

    def slot_slice(self, ins: int, slot: int) -> np.ndarray:
        """The keys of sparse slot ``slot`` of instance ``ins``."""
        s = self.n_sparse_slots
        lo = self.key_offsets[ins * s + slot]
        hi = self.key_offsets[ins * s + slot + 1]
        return self.keys[lo:hi]

    @staticmethod
    def concat(blocks: Sequence["RecordBlock"]) -> "RecordBlock":
        """Merge blocks into one, rebasing the CSR offsets."""
        if not blocks:
            raise ValueError("nothing to concat")
        nonempty = [b for b in blocks if b.n_ins > 0]
        if not nonempty:
            return blocks[0]  # an empty dataset is legal
        if len(nonempty) == 1:
            return nonempty[0]
        offs = [nonempty[0].key_offsets]
        base = nonempty[0].key_offsets[-1]
        for b in nonempty[1:]:
            offs.append(b.key_offsets[1:] + base)
            base = base + b.key_offsets[-1]

        def cat_opt(field):
            # a column survives only when every block carries it
            vals = [getattr(b, field) for b in nonempty]
            if any(v is None for v in vals):
                return None
            if field == "ins_ids":
                return [i for v in vals for i in v]
            return np.concatenate(vals)

        return RecordBlock(
            n_ins=sum(b.n_ins for b in nonempty),
            n_sparse_slots=nonempty[0].n_sparse_slots,
            keys=np.concatenate([b.keys for b in nonempty]),
            key_offsets=np.concatenate(offs),
            dense=np.concatenate([b.dense for b in nonempty]),
            labels=np.concatenate([b.labels for b in nonempty]),
            **{f: cat_opt(f) for f in _META},
        )

    def select(self, order: np.ndarray) -> "RecordBlock":
        """Gather instances by index (shuffle, shuffle routing, PV
        regrouping, the spill's chunking)."""
        s = self.n_sparse_slots
        order = np.asarray(order, dtype=np.int64)
        lens = np.diff(self.key_offsets)
        sel_rows = (order[:, None] * s + np.arange(s)[None, :]).reshape(-1)
        new_lens = lens[sel_rows]
        new_offsets = np.zeros(order.shape[0] * s + 1, dtype=np.int64)
        np.cumsum(new_lens, out=new_offsets[1:])
        total = int(new_offsets[-1])
        # vectorized ragged ranges: row r reads starts[r] + arange(len[r])
        pos = np.arange(total, dtype=np.int64) - np.repeat(new_offsets[:-1],
                                                           new_lens)
        src_idx = np.repeat(self.key_offsets[sel_rows], new_lens) + pos
        meta = {}
        for f in _META:
            v = getattr(self, f)
            if v is None:
                meta[f] = None
            elif f == "ins_ids":
                meta[f] = [v[i] for i in order]
            else:
                meta[f] = v[order]
        return RecordBlock(
            n_ins=int(order.shape[0]),
            n_sparse_slots=s,
            keys=self.keys[src_idx],
            key_offsets=new_offsets,
            dense=self.dense[order],
            labels=self.labels[order],
            **meta,
        )

    def unique_keys(self) -> np.ndarray:
        """Key census for the pass."""
        return np.unique(self.keys)
