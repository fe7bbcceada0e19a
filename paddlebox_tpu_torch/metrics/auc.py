"""Streaming AUC family, accumulated on the device during training
(reference: paddlebox_tpu/metrics/auc.py).

Predictions are histogrammed into pos/neg bucket tables with one
scatter-add per batch; the final AUC/MAE/RMSE reduction runs on the host.
Bucket and instance counts are int64, exact to 2^63 increments.  The
reference holds them as uint32 (TPU arrays run without x64) and wraps at
2^32; that is its ceiling, not this port's.  The real-valued moment sums are
Kahan pairs ``[sum, compensation]`` in float32, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class AucState(NamedTuple):
    pos: torch.Tensor  # int64 [n_buckets]
    neg: torch.Tensor  # int64 [n_buckets]
    abserr: torch.Tensor  # f32 [2] Kahan: sum |pred - label|
    sqrerr: torch.Tensor  # f32 [2] Kahan: sum (pred - label)^2
    pred_sum: torch.Tensor  # f32 [2] Kahan
    label_sum: torch.Tensor  # int64 scalar (labels are {0,1})
    count: torch.Tensor  # int64 scalar


def init_auc_state(n_buckets: int = 1 << 20, device="cuda") -> AucState:
    i64, f32 = torch.int64, torch.float32
    return AucState(
        pos=torch.zeros(n_buckets, dtype=i64, device=device),
        neg=torch.zeros(n_buckets, dtype=i64, device=device),
        abserr=torch.zeros(2, dtype=f32, device=device),
        sqrerr=torch.zeros(2, dtype=f32, device=device),
        pred_sum=torch.zeros(2, dtype=f32, device=device),
        label_sum=torch.zeros((), dtype=i64, device=device),
        count=torch.zeros((), dtype=i64, device=device),
    )


def _kahan_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """acc = [sum, comp]; add scalar x with compensated summation."""
    s, c = acc[0], acc[1]
    y = x - c
    t = s + y
    c = (t - s) - y
    return torch.stack([t, c])


def kahan_value(acc) -> float:
    """Host-side read of a Kahan pair (sum minus residual compensation)."""
    a = np.asarray(torch.as_tensor(acc).cpu(), dtype=np.float64)
    return float(a[0] - a[1])


def update_auc_state(state: AucState, preds: torch.Tensor,
                     labels: torch.Tensor, mask: torch.Tensor) -> AucState:
    """Accumulate one batch into a copy of ``state``.  preds: [B]
    probabilities in [0, 1]; labels: [B] in {0, 1}; mask: [B] 1.0 for real
    instances."""
    return update_auc_state_(AucState(*(t.clone() for t in state)), preds,
                             labels, mask)


@torch.no_grad()
def update_auc_state_(state: AucState, preds: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor,
                      gate: Optional[torch.Tensor] = None) -> AucState:
    """Accumulate one batch IN PLACE into ``state``'s tensors, which keep
    their addresses (a captured CUDA graph replays into them).  ``gate``:
    a bool device scalar; where False the batch adds nothing
    (``torch.where`` on every increment, so the NaN of a poisoned batch
    cannot leak in)."""
    nb = state.pos.shape[0]
    idx = torch.clamp((preds * nb).to(torch.int32), 0, nb - 1)
    pos_w = (mask * labels).to(torch.int64)
    neg_w = (mask * (1.0 - labels)).to(torch.int64)
    err = (preds - labels) * mask
    label_inc = (mask * labels).sum().to(torch.int64)
    count_inc = mask.sum().to(torch.int64)
    sums = [(state.abserr, err.abs().sum()), (state.sqrerr, (err * err).sum()),
            (state.pred_sum, (preds * mask).sum())]
    if gate is not None:
        pos_w, neg_w = torch.where(gate, pos_w, 0), torch.where(gate, neg_w, 0)
        label_inc = torch.where(gate, label_inc, 0)
        count_inc = torch.where(gate, count_inc, 0)
    state.pos.index_add_(0, idx, pos_w)
    state.neg.index_add_(0, idx, neg_w)
    for acc, x in sums:
        new = _kahan_add(acc, x)
        acc.copy_(new if gate is None else torch.where(gate, new, acc))
    state.label_sum.add_(label_inc)
    state.count.add_(count_inc)
    return state


@torch.no_grad()
def update_auc_states_(state: AucState, preds: torch.Tensor,
                       labels: torch.Tensor, masks: torch.Tensor,
                       gate: Optional[torch.Tensor] = None) -> AucState:
    """``update_auc_state_`` of M stacked streams at once, IN PLACE: each
    stream has its mask row of ``masks`` [M, B]; ``preds`` and ``labels``
    are [B], shared by the streams (a metric group's specs), or [M, B], one
    row per stream (a multi-task model's tasks).  One scatter-add per
    bucket table over the [M, B] weights, as the reference vmaps the update
    over the metric axis; the integer counts equal M separate updates bit
    for bit."""
    m, nb = state.pos.shape
    idx = torch.clamp((preds * nb).to(torch.int32), 0, nb - 1)
    flat = (torch.arange(m, device=idx.device)[:, None] * nb
            + idx.to(torch.int64)).reshape(-1)
    pos_w = (masks * labels).to(torch.int64)
    neg_w = (masks * (1.0 - labels)).to(torch.int64)
    err = (preds - labels) * masks
    label_inc = (masks * labels).sum(1).to(torch.int64)
    count_inc = masks.sum(1).to(torch.int64)
    sums = [(state.abserr, err.abs().sum(1)), (state.sqrerr, (err * err).sum(1)),
            (state.pred_sum, (preds * masks).sum(1))]
    if gate is not None:
        pos_w, neg_w = torch.where(gate, pos_w, 0), torch.where(gate, neg_w, 0)
        label_inc = torch.where(gate, label_inc, 0)
        count_inc = torch.where(gate, count_inc, 0)
    state.pos.view(-1).index_add_(0, flat, pos_w.reshape(-1))
    state.neg.view(-1).index_add_(0, flat, neg_w.reshape(-1))
    for acc, x in sums:
        # the Kahan step of _kahan_add, one pair per stream
        s, c = acc[:, 0], acc[:, 1]
        y = x - c
        t = s + y
        new = torch.stack([t, (t - s) - y], dim=1)
        acc.copy_(new if gate is None else torch.where(gate, new, acc))
    state.label_sum.add_(label_inc)
    state.count.add_(count_inc)
    return state


def stack_auc_states(base: AucState, n: int) -> AucState:
    """n copies stacked along a new leading axis: one stream per shard
    position of the multi-chip trainer, or per spec of a metric group."""
    return AucState(*(torch.stack([t] * n) for t in base))


def unstack_auc_state(state: AucState, i: int) -> AucState:
    """Stream i of a stacked state (views, no copy)."""
    return AucState(*(t[i] for t in state))


def merge_auc_states(*states: AucState) -> AucState:
    """Merge independently accumulated states by summing every field, in
    argument order (the reference sums the device axis the same way; the
    Kahan pairs add as pairs, so ``kahan_value`` of the merge is the sum of
    the values)."""
    return AucState(*(sum(xs[1:], start=xs[0]) for xs in zip(*states)))


def compute_metrics_stacked(state: AucState, names) -> dict:
    """compute_metrics of each stream of a stacked state, keys
    ``<name>/<metric>``."""
    out = {}
    for i, name in enumerate(names):
        for k, v in compute_metrics(unstack_auc_state(state, i)).items():
            out[f"{name}/{k}"] = v
    return out


def compute_metrics(state: AucState) -> dict:
    """Final reduction on the host.  Ties within a bucket count half.  A
    stacked state (one stream per shard position) is merged over its
    leading axis first."""
    if state.pos.dim() == 2:
        state = merge_auc_states(
            *(unstack_auc_state(state, i) for i in range(state.pos.shape[0]))
        )
    pos = state.pos.cpu().numpy().astype(np.float64)
    neg = state.neg.cpu().numpy().astype(np.float64)
    tot_pos, tot_neg = pos.sum(), neg.sum()
    neg_below = np.cumsum(neg) - neg
    area = float((pos * (neg_below + 0.5 * neg)).sum())
    auc = float(area / (tot_pos * tot_neg)) if tot_pos > 0 and tot_neg > 0 else 0.5
    count = int(state.count)
    n = max(float(count), 1.0)
    return {
        "auc": auc,
        "mae": kahan_value(state.abserr) / n,
        "rmse": float(np.sqrt(max(kahan_value(state.sqrerr), 0.0) / n)),
        "actual_ctr": float(int(state.label_sum)) / n,
        "predicted_ctr": kahan_value(state.pred_sum) / n,
        "count": float(count),
    }
