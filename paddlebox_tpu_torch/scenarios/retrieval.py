"""In-batch sampled-softmax trainer for two-tower retrieval models
(reference: paddlebox_tpu/scenarios/retrieval.py).

A ``Trainer`` whose step loss (``_loss``) is the in-batch negative
objective: ``sim = user @ item.T / temperature``; each clicked real
instance's own item is its positive (the diagonal) and every other real
instance's item in the batch a negative (padding columns read -1e9): a
cross-entropy over the batch's item columns, weighted to the clicked real
rows.  Everything else is the ranking step's (train/trainer.py:_tick): the
pull and push kernels, the slot mask, the counters, ``check_nan_inf`` with
``skip_batch`` and ``rollback``, ``scan_steps`` as a CUDA graph and the
grad-norm stream.

The AUC reads the diagonal through a sigmoid, so the pass AUC still says
whether clicked pairs outscore unclicked ones; ``evaluate`` scores
``sigmoid(user . item / temperature)``, which is the model's forward.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.train.trainer import Trainer


class RetrievalTrainer(Trainer):
    """Trainer over a model exposing ``apply_towers`` (models/two_tower)."""

    def __init__(self, model, table_conf: SparseTableConfig,
                 trainer_conf: Optional[TrainerConfig] = None, device="cuda",
                 slot_mask: Optional[Iterable[int]] = None,
                 metric_group=None):
        if not hasattr(model, "apply_towers"):
            raise ValueError(
                "RetrievalTrainer needs a two-tower model exposing "
                "apply_towers(rows, key_segments, dense, batch_size)"
            )
        if metric_group is not None:
            raise ValueError(
                "metric groups are per-instance ranking metrics; the "
                "retrieval objective has no per-variant logloss split"
            )
        super().__init__(model, table_conf, trainer_conf, device=device,
                         slot_mask=slot_mask)
        if self.n_tasks > 1:
            raise ValueError("retrieval models are single-task")
        self.temperature = float(getattr(model, "temperature", 1.0))

    def _loss(self, pulled: torch.Tensor, feed: dict) -> tuple:
        """(the in-batch softmax loss, the diagonal logits [B])."""
        labels, mask = feed["labels"], feed["ins_mask"]
        user, item = self.model.apply_towers(
            pulled, feed["key_segments"], feed["dense"], labels.shape[0])
        sim = (user @ item.t()) / self.temperature  # [B, B]
        # negatives are the batch's real items only: padding instances'
        # (zero) item vectors must not dilute the softmax denominator
        sim = torch.where(mask[None, :] > 0, sim, -1e9)
        logp = sim - torch.logsumexp(sim, dim=1, keepdim=True)
        w = labels * mask  # the positive pairs: clicked real instances
        loss = -(torch.diagonal(logp) * w).sum() / torch.clamp(w.sum(),
                                                              min=1.0)
        return loss, torch.diagonal(sim)
