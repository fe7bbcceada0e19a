"""Per-slot training policy helpers shared by the single-chip Trainer and
MultiChipTrainer (reference: paddlebox_tpu/train/slot_policy.py): the
BoxPS LR map (box_wrapper.h:631 GetLRMap/SetLRMap) and the join/update
phase slot participation (box_wrapper.h:627-630).  A leaf module, numpy
and torch only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def normalize_slot_mask(slot_mask, n_sparse_slots: int):
    """Sorted unique participation tuple, validated against the model's
    slot count (None = all slots participate)."""
    if slot_mask is None:
        return None
    mask = tuple(sorted(set(slot_mask)))
    bad = [s for s in mask if not 0 <= s < n_sparse_slots]
    if bad:
        raise ValueError(
            f"slot_mask indices {bad} out of range for "
            f"{n_sparse_slots} sparse slots"
        )
    return mask


def slot_participation_vec(slot_mask, n_sparse_slots: int,
                           device="cpu") -> Optional[torch.Tensor]:
    """[S] 1.0/0.0 float32 vector of a normalized slot mask on ``device``
    (None = no gating).  The step indexes it per occurrence as
    ``vec[key_segments % S]``: gating the pulled rows inside the loss
    zeroes excluded slots' pooled features and, through the chain rule,
    their row gradients; the same factor gates the show/clk counter
    increments."""
    if slot_mask is None:
        return None
    v = np.zeros(n_sparse_slots, np.float32)
    v[list(slot_mask)] = 1.0
    return torch.from_numpy(v).to(device)


def resolve_slot_lr_vec(table_conf, n_sparse_slots: int) -> Optional[np.ndarray]:
    """``SparseTableConfig.slot_learning_rates`` as a dense [S] float32
    vector (the default lr for unmapped slots), or None when no map is
    configured: the host half of the BoxPS LR map.  Both trainers validate
    through this."""
    if not table_conf.slot_learning_rates:
        return None
    v = np.full(n_sparse_slots, table_conf.learning_rate, np.float32)
    for slot, lr in table_conf.slot_learning_rates:
        if not 0 <= slot < n_sparse_slots:
            raise ValueError(
                f"slot_learning_rates slot {slot} out of range "
                f"for {n_sparse_slots} sparse slots"
            )
        v[slot] = lr
    return v
