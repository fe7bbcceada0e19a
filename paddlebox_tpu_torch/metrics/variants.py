"""Masked AUC metric variants (reference: paddlebox_tpu/metrics/variants.py,
the MetricMsg family of box_wrapper.cc:1222-1270).

A ``MetricSpec`` declares which instances count: by cmatch codes, by rank
values, or all real instances.  The host builds one {0, 1} mask row per
spec per batch, and the device updates the group's stacked AucState (a
leading metric axis) with one batched in-place update, however many specs
the group has.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.metrics.auc import (
    AucState,
    compute_metrics_stacked,
    init_auc_state,
    stack_auc_states,
    update_auc_states_,
)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named, filtered AUC stream.  cmatch_values / rank_values of None
    filter nothing on that field; an instance failing any filter, or a
    padding row, contributes nothing."""

    name: str
    cmatch_values: Optional[Sequence[int]] = None
    rank_values: Optional[Sequence[int]] = None

    def mask(self, batch) -> np.ndarray:
        m = batch.ins_mask.copy()
        for field, values in (("cmatch", self.cmatch_values),
                              ("rank", self.rank_values)):
            if values is None:
                continue
            col = batch.cmatches if field == "cmatch" else batch.ranks
            if col is None:
                raise ValueError(
                    f"metric {self.name!r} filters by {field} but the batch "
                    "carries none (parse_logkey off?)"
                )
            m *= np.isin(col, np.asarray(values)).astype(np.float32)
        return m


class MetricGroup:
    """Stacked AUC streams, one per spec (leading axis = the spec)."""

    def __init__(self, specs: Sequence[MetricSpec], n_buckets: int = 1 << 20):
        self.specs = list(specs)
        self.n_buckets = n_buckets

    def init_state(self, device="cuda") -> AucState:
        return stack_auc_states(init_auc_state(self.n_buckets, device),
                                len(self.specs))

    def masks(self, batch) -> np.ndarray:
        """[n_specs, B] float32 mask matrix of one host batch."""
        return np.stack([s.mask(batch) for s in self.specs])

    @staticmethod
    def update(state: AucState, preds: torch.Tensor, labels: torch.Tensor,
               masks: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> AucState:
        """The device update, in place: every spec's stream in one batched
        update (``gate``: a bool device scalar, False adds nothing)."""
        return update_auc_states_(state, preds, labels, masks, gate)

    def compute(self, state: AucState) -> dict:
        return compute_metrics_stacked(state, [s.name for s in self.specs])
