"""Production fleet utilities: model monitoring and publish gates
(reference: paddlebox_tpu/utils/fleet_util.py).

The decision layer of a day loop: is this pass's model healthy, and may it
be published?  :class:`ModelMonitor` tracks the per-pass metric stream
and gates publishing; :func:`check_model` reports the model's size and
finiteness.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class HealthPolicy:
    """Thresholds for pass-level model health (fleet_util's production
    alarm conditions, as one explicit policy object)."""

    min_auc: float = 0.5  # below = model worse than chance
    max_auc_drop: float = 0.05  # vs previous pass
    max_loss: float = 10.0
    # predictions collapsing to one value (dead model): |pred_mean - label
    # mean| above this while AUC ~ 0.5 usually means the tower died
    max_calibration_gap: float = 0.3


@dataclasses.dataclass
class HealthReport:
    ok: bool
    reasons: list

    def __bool__(self) -> bool:
        return self.ok


class ModelMonitor:
    """Tracks the per-pass metric stream and gates publishing.

    Usage (the production day loop):
        monitor = ModelMonitor()
        ...
        metrics = trainer.train_from_dataset(ds, table)
        report = monitor.observe(metrics)
        if monitor.should_publish(metrics):
            cm.save_base(tag, table, *trainer.dense_state())
            publish_checkpoint(...)  # utils/fs.py donefile-last
    """

    def __init__(self, policy: Optional[HealthPolicy] = None):
        self.policy = policy or HealthPolicy()
        self.history: list = []  # observed metric dicts (shallow copies)
        self._best_auc = -math.inf

    # -- health ----------------------------------------------------------- #
    def check(self, metrics: dict) -> HealthReport:
        """Health verdict for one pass's metrics (does not record)."""
        p = self.policy
        reasons = []
        loss = float(metrics.get("loss", 0.0))
        auc = float(metrics.get("auc", 0.0))
        if not math.isfinite(loss):
            reasons.append(f"loss is not finite: {loss}")
        elif loss > p.max_loss:
            reasons.append(f"loss {loss:.4f} > max_loss {p.max_loss}")
        if auc < p.min_auc:
            reasons.append(f"auc {auc:.4f} < min_auc {p.min_auc}")
        if self.history:
            prev = float(self.history[-1].get("auc", 0.0))
            if prev - auc > p.max_auc_drop:
                reasons.append(
                    f"auc dropped {prev:.4f} -> {auc:.4f} "
                    f"(> max_auc_drop {p.max_auc_drop})"
                )
        # calibration: predicted CTR should track actual CTR
        if "predicted_ctr" in metrics and "actual_ctr" in metrics:
            gap = abs(
                float(metrics["predicted_ctr"])
                - float(metrics["actual_ctr"])
            )
            if gap > p.max_calibration_gap:
                reasons.append(
                    f"calibration gap {gap:.4f} > "
                    f"{p.max_calibration_gap} (pred "
                    f"{metrics['predicted_ctr']:.4f} vs actual "
                    f"{metrics['actual_ctr']:.4f})"
                )
        ok = not reasons
        if not ok:
            logger.warning("model health check failed: %s", "; ".join(reasons))
        return HealthReport(ok, reasons)

    def observe(self, metrics: dict) -> HealthReport:
        """Check AND record one pass's metrics.  Unhealthy passes are NOT
        recorded: a diverged pass reporting a bogus high AUC must not
        become the drop-check baseline or the publish-gate best (it would
        block every later healthy pass)."""
        report = self.check(metrics)
        if report.ok:
            self.history.append(dict(metrics))
            self._best_auc = max(
                self._best_auc, float(metrics.get("auc", 0.0))
            )
        return report

    def should_publish(self, metrics: dict,
                       min_auc_vs_best: float = 0.02) -> bool:
        """Publish gate: healthy AND not materially behind the best pass
        seen (fleet_util's check-before-push-to-serving discipline)."""
        if not self.check(metrics):
            return False
        auc = float(metrics.get("auc", 0.0))
        if self._best_auc > -math.inf and \
                self._best_auc - auc > min_auc_vs_best:
            logger.warning(
                "publish gate: auc %.4f is %.4f behind best %.4f",
                auc, self._best_auc - auc, self._best_auc,
            )
            return False
        return True

    # -- global AUC readout (fleet_util.get_global_auc analog) ------------- #
    @staticmethod
    def global_auc(trainer) -> float:
        """AUC over everything the trainer has streamed so far (multi-pass,
        when auc_state was carried)."""
        from paddlebox_tpu_torch.metrics.auc import compute_metrics

        state = getattr(trainer, "last_auc_state", None)
        if state is None:
            raise RuntimeError("trainer has not trained yet")
        return float(compute_metrics(state)["auc"])


def check_model(table, trainer=None) -> dict:
    """Model size/sanity report (fleet_util's check-model helpers): feature
    count, host-store bytes, dense parameter count/bytes, finiteness.
    Walks the bucketed store bucket-by-bucket — no global copy, so the
    check itself cannot OOM at production store sizes."""
    report = {"n_features": int(table.n_features)}
    store = getattr(table, "_store", None)
    if store is not None and hasattr(store, "stats"):
        st = store.stats()
        report["sparse_bytes"] = int(st["bytes"])
        report["sparse_finite"] = bool(st["finite"])
    else:  # foreign table types: fall back to the materialized snapshot
        sd = table.state_dict()
        report["sparse_bytes"] = int(sd["values"].nbytes + sd["keys"].nbytes)
        report["sparse_finite"] = bool(np.isfinite(sd["values"]).all())
    if trainer is not None:
        import torch

        leaves = [p.detach() for p in trainer.model.parameters()]
        report["dense_params"] = int(sum(p.numel() for p in leaves))
        report["dense_bytes"] = int(
            sum(p.numel() * p.element_size() for p in leaves))
        report["dense_finite"] = bool(
            all(bool(torch.isfinite(p).all()) for p in leaves)
        )
    return report
