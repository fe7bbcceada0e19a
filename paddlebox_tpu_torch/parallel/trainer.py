"""Multi-chip training: data parallel over the mesh's shard positions, the
sparse pull and push through all_to_alls against the key-sharded table
(reference: paddlebox_tpu/parallel/trainer.py).

The reference runs one ``shard_map`` body per device.  Here every shard
position lives in one process (parallel/mesh.py), and the step runs that
body once per position, in ascending order, on the position's slices; only
the collectives (parallel/collectives.py) span all positions:

  * sparse pull: each shard gathers the rows the host plan told it to serve
    (the pull_rows kernel) -> all_to_all -> occurrence gather; under the
    realized hybrid placement the hot occurrences then take their rows from
    the position's copy of the replicated hot block (the hot_cold_select
    kernel).
  * sparse push: the transpose: segment-sum the occurrence gradients into
    per-owner buckets -> all_to_all -> fold requesters of the same row
    (serve_map) -> sparse adagrad -> the scatter_add_rows kernel.  Hot
    gradients fold over positions in a fixed ascending order and every
    copy of the hot block applies the identical update.
  * dense sync, ``TrainerConfig.sync_dense_mode``:
    - "step": the positions' gradients of ``per_ins.sum() / psum(count)``
      are summed (psum) and one ``torch.optim.Adam`` step applies them to
      the one model.
    - "kstep": every position holds its own dense copy and Adam state and
      steps on its own gradient of ``per_ins.sum() / count``; every
      ``sync_weight_step`` steps the floating leaves of the copies and of
      their Adam states are averaged (the step counts are left alone).
      The pass loss is the positions' losses weighted by their counts.
    - "async": the "step" gradient, handed one step late to a host
      ``AsyncDenseTable`` (parallel/async_dense.py) whose thread applies
      Adam; the device parameters are pulled back every
      ``sync_weight_step`` steps and, after a drain, at the pass end.
  * metrics: one AUC stream per position, merged at read time.

With ``TrainerConfig.prefetch_batches`` > 0 (the default) grouping,
``plan_group`` and the feed's copy run on the single-chip trainer's
producer thread (train/trainer.py), as in the reference.

The step policies, as in the reference's multi-chip trainer: ``slot_mask``
(the single-chip gating, per position), the per-slot LR map through
``plan_group`` (``serve_lr`` and ``hot_lr``), ``dense_optimizer`` "sgd",
the tower's compute dtype, ``evaluate`` (forward only, per-position AUC
streams merged) and the grad-norm stream (one ``[sum of squares, steps]``
accumulator per position, summed at the pass end).  As in the reference,
the multi-chip trainer has no skip or rollback policy and no step
grouping: ``check_nan_inf`` raises, ``nan_policy`` and ``scan_steps`` are
not read.

The data half, as in the reference: a ``metric_group`` keeps one stacked
group state per position ([n, n_specs, ...]), updated in the step from the
feed's per-position mask matrices and merged over the positions at the
pass end; ``rank_offset``, ``seq_pos`` and ``task_labels`` ride the feed
when the batches have them; with ``need_dump_field`` the step also
returns the positions' predictions and each position's real instances are
dumped (a padding batch dumps nothing); ``need_dump_param`` dumps the
dense tower and the table's rows at the pass end.

Telemetry, as in the reference's multi-chip trainer: the exporter and the
event log from ``TrainerConfig.telemetry`` or the flags, the ``plan`` and
``feed`` stage histograms (``StatsProfiler``; no span tracing and no
profiled mode), the norm gauges, the health rules and the ``pass_end``
record at each pass end (window: the global step).

The model contract, as in the reference: a model's extra inputs by
marker (``rank_offset``, ``seq_pos``, each position's slice), the
multi-task loss (the mean BCE over a model's ``n_tasks`` logit columns
against the batch's task labels) and per-task AUC streams, one stacked
state per position merged at the pass end (``task<t>/<metric>``); the
primary AUC reads task 0.  As the reference's, this trainer reads no
``counter_label_tasks``.

A composed mesh (``make_composed_mesh(n_data, n_inner, axis)``): the
table, the feeds, the plans and the counters see the ``n_data`` data
positions; a model built with ``"inherit"`` (MMoE's ``expert_mesh``,
LongSeqCtrDnn's ``seq_mesh``) takes the inner axis when the trainer is
built (its ``bind_composed_mesh``) and splits its dense compute over the
inner positions inside each data position (reference: the
``axis_names={"data"}`` binding of the step's shard_map).

Not ported: the host plane; the watchdog; the cross-process fleet
snapshot.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import (
    SparseTableConfig,
    TelemetryConfig,
    TrainerConfig,
)
from paddlebox_tpu_torch.data.feed import HostBatch, empty_like
from paddlebox_tpu_torch.metrics.auc import (
    AucState,
    compute_metrics,
    compute_metrics_stacked,
    init_auc_state,
    merge_auc_states,
    stack_auc_states,
    unstack_auc_state,
    update_auc_state_,
    update_auc_states_,
)
from paddlebox_tpu_torch.metrics.variants import MetricGroup
from paddlebox_tpu_torch.models.layers import (
    apply_compute_dtype_override,
    bce_with_logits,
)
from paddlebox_tpu_torch.ops import sparse_kernels
from paddlebox_tpu_torch.parallel import collectives
from paddlebox_tpu_torch.parallel.async_dense import AsyncDenseTable
from paddlebox_tpu_torch.parallel.mesh import Mesh, data_axis_size
from paddlebox_tpu_torch.parallel.sharded_table import (
    ShardedBatchPlan,
    ShardedSparseTable,
)
from paddlebox_tpu_torch.sparse.optimizer import sparse_adagrad_update
from paddlebox_tpu_torch.sparse.table import _segment_sum, gather_rows, scatter_add_rows
from paddlebox_tpu_torch.train.slot_policy import (
    normalize_slot_mask,
    resolve_slot_lr_vec,
    slot_participation_vec,
)
from paddlebox_tpu_torch.train.trainer import (
    NonFiniteBatchError,
    _dense_opt,
    await_feed,
    check_model_inputs,
    check_task_labels,
    model_extras,
    finish_pass_telemetry,
    pass_norms,
    prefetched,
    stage_feed,
    sum_squares,
    to_device,
)
from paddlebox_tpu_torch.utils.profiler import StatsProfiler


def _stack_group(batches: Sequence[HostBatch], plan: ShardedBatchPlan,
                 metric_group: Optional[MetricGroup] = None) -> dict:
    """Stack per-position batches and the plan into [n, ...] numpy arrays."""
    key_clicks = []
    for b, m in zip(batches, plan.key_mask):
        ins = np.minimum(b.key_segments // b.n_sparse_slots, b.batch_size - 1)
        key_clicks.append(b.labels[ins] * m)
    extra = {}
    for name in ("rank_offset", "seq_pos", "task_labels"):
        if getattr(batches[0], name) is not None:
            extra[name] = np.stack([getattr(b, name) for b in batches])
    if metric_group is not None:
        extra["metric_masks"] = np.stack(
            [metric_group.masks(b) for b in batches])
    if plan.hot_occ is not None:
        extra["hot_occ"] = plan.hot_occ
        extra["hot_lr"] = plan.hot_lr
    if plan.serve_lr is not None:
        extra["uniq_lr"] = plan.serve_lr
    return {
        **extra,
        "serve_rows": plan.serve_rows,
        "occ_flat": plan.occ_flat,
        "serve_map": plan.serve_map,
        "serve_uniq": plan.serve_uniq,
        "key_mask": plan.key_mask,
        "key_clicks": np.stack(key_clicks),
        "key_segments": np.stack([b.key_segments for b in batches]),
        "dense": np.stack([b.dense for b in batches]),
        "labels": np.stack([b.labels for b in batches]),
        "ins_mask": np.stack([b.ins_mask for b in batches]),
    }


def _apply_threshold(rows: torch.Tensor, create_threshold: float,
                     cvm_offset: int) -> torch.Tensor:
    """Embedding columns of rows whose show count is below the threshold
    read as zero."""
    if create_threshold <= 0.0:
        return rows
    visible = (rows[:, 0:1] >= create_threshold).to(rows.dtype)
    return torch.cat([rows[:, :cvm_offset], rows[:, cvm_offset:] * visible],
                     dim=1)


def sharded_pull(values: torch.Tensor, serve_rows: torch.Tensor,
                 occ_flat: torch.Tensor, create_threshold: float,
                 cvm_offset: int) -> list:
    """The cross-shard pull.  The host plan already told each shard which
    rows to serve, so there is no key exchange: local gather -> one
    all_to_all -> occurrence gather.

    values: [n, cap, W]; serve_rows: [n, n, C], the rows shard o serves to
    each requester; occ_flat: [n, K] into the received [n, C] response.
    Returns one [K, W] tensor of pulled rows per position."""
    n, _, C = serve_rows.shape
    W = values.shape[2]
    served = torch.stack([
        gather_rows(values[o], serve_rows[o].reshape(-1)) for o in range(n)
    ]).view(n, n, C, W)
    got = collectives.all_to_all(served)  # got[d, s] = served[s, d]
    sink = values.new_zeros((1, W))
    return [
        _apply_threshold(
            torch.cat([got[d].view(n * C, W), sink]).index_select(
                0, occ_flat[d]),
            create_threshold, cvm_offset)
        for d in range(n)
    ]


def hybrid_pull(values: torch.Tensor, hot_values: torch.Tensor,
                serve_rows: torch.Tensor, occ_flat: torch.Tensor,
                hot_occ: torch.Tensor, create_threshold: float,
                cvm_offset: int) -> list:
    """The hybrid-placement pull: cold occurrences take the all_to_all
    path, hot occurrences read the position's copy of the replicated hot
    block (hot_values [n, H, W]; hot_occ [n, K] in [0, H], H = cold or
    padding, whose occ_flat entries carry real cold routes; hot
    occurrences carry the n*C sink, so the two selects partition).
    create_threshold applies after the select, so hot and cold rows see
    the same visibility rule."""
    rows = sharded_pull(values, serve_rows, occ_flat, 0.0, cvm_offset)
    return [
        _apply_threshold(
            sparse_kernels.hot_cold_select(hot_values[d], hot_occ[d], r),
            create_threshold, cvm_offset)
        for d, r in enumerate(rows)
    ]


def _counter_contrib(row_grads: torch.Tensor, segments: torch.Tensor,
                     key_mask: torch.Tensor, key_clicks: torch.Tensor,
                     n_seg: int, co: int) -> torch.Tensor:
    """[n_seg, W]: show, click (and zero extra counters) beside the merged
    embedding gradient, segment-summed in occurrence order."""
    merged = _segment_sum(row_grads, segments, n_seg)
    counters = [_segment_sum(key_mask, segments, n_seg),
                _segment_sum(key_clicks, segments, n_seg)]
    counters = torch.stack(counters, dim=1)
    if co > 2:
        counters = torch.cat(
            [counters, counters.new_zeros((n_seg, co - 2))], dim=1)
    return torch.cat([counters, merged[:, co:]], dim=1)


@torch.no_grad()
def hybrid_hot_update(hot_values: torch.Tensor, hot_g2sum: torch.Tensor,
                      row_grads: Sequence[torch.Tensor],
                      hot_occ: torch.Tensor, hot_lr: torch.Tensor,
                      key_mask: torch.Tensor, key_clicks: torch.Tensor,
                      conf: SparseTableConfig) -> None:
    """Replica-identical hot-block update, IN PLACE on hot_values [n, H, W]
    and hot_g2sum [n, H].

    Level 1 merges each position's occurrences in occurrence order, as the
    cold path does; level 2 is an all_gather followed by an unrolled
    ascending fold over positions, the requester order the cold path's
    serve_map segment sum folds in, so a key served hot reduces in the
    order it would have reduced cold.  The adagrad apply runs over all H
    slots: an untouched slot's merged gradient is exactly zero, and so is
    its delta, so padding and unreferenced residents stay bitwise
    unchanged.  hot_lr is 0.0 on positions without an occurrence of the
    slot; the pmax fold recovers the one real lr."""
    n, H, _ = hot_values.shape
    co = conf.cvm_offset
    contrib = torch.stack([
        _counter_contrib(row_grads[d], hot_occ[d], key_mask[d],
                         key_clicks[d], H + 1, co)[:H]
        for d in range(n)
    ])  # [n, H, W]
    gathered = collectives.all_gather(contrib)  # [n, n, H, W]
    lr = collectives.pmax(hot_lr)
    for d in range(n):
        acc = gathered[d, 0]
        for i in range(1, n):  # unrolled: fixed fold order
            acc = acc + gathered[d, i]
        w_delta, g2_delta = sparse_adagrad_update(
            hot_g2sum[d], acc[:, co:], lr[d], conf.initial_g2sum,
            conf.grad_clip,
        )
        hot_values[d] += torch.cat([acc[:, :co], w_delta], dim=1)
        hot_g2sum[d] += g2_delta


@torch.no_grad()
def sharded_push_and_update(values: torch.Tensor, g2sum: torch.Tensor,
                            row_grads: Sequence[torch.Tensor],
                            occ_flat: torch.Tensor, serve_map: torch.Tensor,
                            serve_uniq: torch.Tensor, key_mask: torch.Tensor,
                            key_clicks: torch.Tensor,
                            conf: SparseTableConfig,
                            uniq_lr: Optional[torch.Tensor] = None) -> None:
    """The cross-shard push, IN PLACE on values [n, cap, W] and g2sum
    [n, cap]: merge occurrence gradients into per-owner buckets, exchange
    them (the push all_to_all), fold requesters of the same row into one
    segment (serve_map / serve_uniq), and apply the counters and sparse
    adagrad to exactly the touched rows.  ``uniq_lr`` [n, n*C]: the lr of
    each served unique row (the LR map), else ``conf.learning_rate``."""
    n, _, C = serve_map.shape
    co = conf.cvm_offset
    cap, W = values.shape[1:]
    US = serve_uniq.shape[1]
    # last segment = the padding and hot-occurrence sink, dropped
    send = torch.stack([
        _counter_contrib(row_grads[d], occ_flat[d], key_mask[d],
                         key_clicks[d], n * C + 1, co)[: n * C]
        for d in range(n)
    ]).view(n, n, C, W)
    recv = collectives.all_to_all(send)  # [n, n, C, W]
    for o in range(n):
        acc = _segment_sum(recv[o].view(n * C, W), serve_map[o].view(-1), US)
        uniq = serve_uniq[o]
        w_delta, g2_delta = sparse_adagrad_update(
            g2sum[o].index_select(0, uniq), acc[:, co:],
            conf.learning_rate if uniq_lr is None else uniq_lr[o],
            conf.initial_g2sum, conf.grad_clip,
        )
        delta = torch.cat([acc[:, :co], w_delta], dim=1)
        # serve_uniq targets are unique except repeated dead-row entries:
        # zero every dead-targeted delta, so repeats only add zero and the
        # scatter stays exact under any order
        ok = (uniq != cap - 1).to(delta.dtype)
        scatter_add_rows(values[o], uniq, (delta * ok[:, None]).contiguous())
        g2sum[o].index_add_(0, uniq, g2_delta * ok)
        values[o, cap - 1] = 0.0
        g2sum[o, cap - 1] = 0.0


class MultiChipTrainer:
    """Drives a model and a ShardedSparseTable over the mesh's shard
    positions (the reference's BoxPSTrainer analog: one worker per
    position)."""

    def __init__(self, model, table_conf: SparseTableConfig, mesh: Mesh,
                 trainer_conf: Optional[TrainerConfig] = None,
                 metric_group=None, slot_mask: Optional[Iterable[int]] = None):
        """slot_mask: participating sparse-slot indices (None = all), with
        the single-chip Trainer's semantics on every position."""
        self.model = model
        # a multi-task model's logits are [B, n_tasks] (task 0 primary)
        self.n_tasks = getattr(model, "n_tasks", 1)
        self.table_conf = table_conf
        self.mesh = mesh
        self.device = mesh.device
        # data positions; a composed mesh's inner axis splits the dense
        # compute inside the step, unseen by the feeds and the table
        self.n_dev = data_axis_size(mesh)
        self.conf = trainer_conf or TrainerConfig()
        self.metric_group = metric_group
        n_slots = model.n_sparse_slots
        self.slot_mask = normalize_slot_mask(slot_mask, n_slots)
        self._part_vec = slot_participation_vec(self.slot_mask, n_slots,
                                                self.device)
        # the per-slot LR map, consumed by plan_group -> serve_lr / hot_lr
        self._slot_lr_vec = resolve_slot_lr_vec(table_conf, n_slots)
        apply_compute_dtype_override(model, self.conf.compute_dtype)
        # a model built with "inherit" takes the composed mesh's inner axis
        if hasattr(model, "bind_composed_mesh"):
            model.bind_composed_mesh(mesh)
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"model parameters on {p.device}, mesh on {self.device}"
                )
        # one dense copy per position in "kstep" mode (position 0 is the
        # caller's model; the copies start equal), one shared copy else.
        # the optimizers match optax's (train/trainer.py:_dense_opt)
        n_copies = self.n_dev if self.conf.sync_dense_mode == "kstep" else 1
        self.models = [model] + [copy.deepcopy(model)
                                 for _ in range(n_copies - 1)]
        self.optimizers = [_dense_opt(self.conf.dense_optimizer,
                                      m.parameters(), self.conf.dense_lr,
                                      capturable=False)
                           for m in self.models]
        self.optimizer = self.optimizers[0]
        # the host table of "async" mode, built at the first pass
        self.async_dense: Optional[AsyncDenseTable] = None
        self.global_step = 0
        self.last_auc_state: Optional[AucState] = None
        self.last_metric_state: Optional[dict] = None

    # -- dense persistence -------------------------------------------------- #
    def dense_state(self) -> tuple:
        """(model state_dict, optimizer state_dict) of position 0: in
        "step" and "async" mode every position holds the same dense state;
        in "kstep" mode the copies drift between syncs."""
        return self.model.state_dict(), self.optimizer.state_dict()

    def load_dense_state(self, params, opt_state=None) -> None:
        """Load one dense state into every position's copy; ``params`` may
        also be a list of one state_dict per position (the reference's
        stacked per-position state, ``weights.params_from_jax_stacked``),
        which must be equal where the mode keeps one shared copy."""
        if isinstance(params, (list, tuple)):
            if len(params) != self.n_dev:
                raise ValueError(f"{len(params)} dense states for "
                                 f"{self.n_dev} positions")
            if len(self.models) == 1:
                if not all(torch.equal(params[0][k], p[k])
                           for p in params[1:] for k in params[0]):
                    raise ValueError(
                        f"sync_dense_mode={self.conf.sync_dense_mode!r} "
                        "keeps one dense copy: the positions' states differ")
                params = params[:1]
            for m, p in zip(self.models, params):
                m.load_state_dict(p)
        elif params is not None:
            for m in self.models:
                m.load_state_dict(params)
        if opt_state is not None:
            for o in self.optimizers:
                o.load_state_dict(opt_state)
        if self.async_dense is not None:
            # the host master copy restarts from the loaded state
            self.close()

    def close(self) -> None:
        """Retire the host table of "async" mode (raises when its update
        thread had died)."""
        table, self.async_dense = self.async_dense, None
        if table is not None:
            table.stop()

    @torch.no_grad()
    def _average_copies(self) -> None:
        """The "kstep" sync: every floating leaf of the position copies and
        of their Adam states becomes the copies' mean (an ascending psum
        over n); Adam's step counts are equal on every copy and stay."""
        n = len(self.models)
        for group in zip(*(m.parameters() for m in self.models)):
            mean = collectives.psum(torch.stack(group))[0] / n
            for p in group:
                p.copy_(mean)
        states = [[o.state[p] for p in m.parameters()]
                  for m, o in zip(self.models, self.optimizers)]
        for per_param in zip(*states):
            for key in ("exp_avg", "exp_avg_sq"):
                group = [st[key] for st in per_param if key in st]
                if len(group) == n:
                    mean = collectives.psum(torch.stack(group))[0] / n
                    for t in group:
                        t.copy_(mean)

    def _stage_async(self, grads: Sequence[torch.Tensor]) -> tuple:
        """Start one step's summed gradient on its way to the host: on the
        card a non-blocking copy into pinned buffers, then an event behind
        it, so that waiting for it later waits for this step alone."""
        if self.device.type != "cuda":
            return [g.cpu() for g in grads], None
        host = [torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                for g in grads]
        for h, g in zip(host, grads):
            h.copy_(g, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _push_async(self, staged: tuple) -> None:
        host, done = staged
        if done is not None:
            done.synchronize()
        names = [name for name, _ in self.model.named_parameters()]
        self.async_dense.push({k: h.numpy() for k, h in zip(names, host)})

    @torch.no_grad()
    def _pull_async(self) -> None:
        master = self.async_dense.pull()
        for name, p in self.model.named_parameters():
            p.copy_(torch.from_numpy(master[name]))

    # -- state -------------------------------------------------------------- #
    def init_auc(self) -> AucState:
        """Fresh AUC streams, one per position, stacked [n, ...]."""
        return stack_auc_states(
            init_auc_state(self.conf.auc_buckets, self.device), self.n_dev)

    def _ensure_hot_block(self, table: ShardedSparseTable, hot_cap: int) -> None:
        """Give the table an all-zero hot block before the first plan
        realizes: nothing routes hot then, the pull still runs the select
        (all-sink), and a zero block receives exactly-zero updates."""
        if table.hot_values is None:
            w = self.table_conf.row_width
            table.hot_values = torch.zeros((self.n_dev, hot_cap, w),
                                           device=self.device)
            table.hot_g2sum = torch.zeros((self.n_dev, hot_cap),
                                          device=self.device)

    def _to_device(self, host: dict) -> dict:
        return to_device(host, self.device)

    # -- the step ----------------------------------------------------------- #
    def _step(self, table: ShardedSparseTable, feed: dict,
              aucs: list, gn: Optional[torch.Tensor] = None,
              groups: Optional[list] = None,
              tasks: Optional[list] = None) -> tuple:
        """One step over every position; updates the model copies (or, in
        "async" mode, returns their gradient), the table and the hot block
        in place, ``aucs`` (one AucState per position), ``groups`` (one
        stacked metric-group state per position), ``tasks`` (a multi-task
        model's stacked per-task streams, one per position) and ``gn``
        [n, 2] (each position's grad-norm stream).  Returns (loss, per-position
        instance counts [n], summed dense gradients or None, the
        positions' predictions [n, B]) on the device: the psummed loss, or
        in "kstep" mode each position's own loss [n]."""
        tconf = self.table_conf
        n = self.n_dev
        mode = self.conf.sync_dense_mode
        hot = "hot_occ" in feed
        if hot:
            rows = hybrid_pull(table.values, table.hot_values,
                               feed["serve_rows"], feed["occ_flat"],
                               feed["hot_occ"], tconf.create_threshold,
                               tconf.cvm_offset)
        else:
            rows = sharded_pull(table.values, feed["serve_rows"],
                                feed["occ_flat"], tconf.create_threshold,
                                tconf.cvm_offset)
        mask = feed["ins_mask"]
        cnt = mask.sum(1)
        if mode == "kstep":
            # each copy trains on its own batch's mean
            denoms = torch.clamp(cnt, min=1.0)
        else:
            denoms = torch.clamp(collectives.psum(cnt), min=1.0)
        key_mask, key_clicks = feed["key_mask"], feed["key_clicks"]
        key_part = None
        if self._part_vec is not None:
            # the single-chip gating (train/trainer.py), per position
            key_part = self._part_vec[
                feed["key_segments"] % self._part_vec.shape[0]]
            key_mask = key_mask * key_part
            key_clicks = key_clicks * key_part
        multi = self.n_tasks > 1
        losses, pgrads, row_grads, preds, task_preds = [], [], [], [], []
        for d in range(n):
            model = self.models[d % len(self.models)]
            params = list(model.parameters())
            r = rows[d].detach().requires_grad_(True)
            pulled = r if key_part is None else r * key_part[d][:, None]
            logits = model(pulled, feed["key_segments"][d],
                           feed["dense"][d], mask.shape[1],
                           **_position_extras(model, feed, d))
            if multi:
                per_ins = bce_with_logits(
                    logits, feed["task_labels"][d]).mean(1) * mask[d]
            else:
                per_ins = bce_with_logits(logits, feed["labels"][d]) * mask[d]
            loss = per_ins.sum() / denoms[d]
            grads = torch.autograd.grad(loss, params + [r])
            losses.append(loss.detach())
            pgrads.append(grads[:-1])
            row_grads.append(grads[-1])
            p = torch.sigmoid(logits.detach())
            task_preds.append(p)
            preds.append(p[:, 0] if multi else p)
        summed = None
        if mode == "kstep":
            loss = torch.stack(losses)
            dense_grads = [g for gs in pgrads for g in gs]
        else:
            summed = [collectives.psum(torch.stack(g))[0]
                      for g in zip(*pgrads)]
            loss = collectives.psum(torch.stack(losses))[0]
            dense_grads = summed
        if gn is not None:
            # per position: the gradient its dense update sees (summed in
            # "step" and "async", its own in "kstep") and its row gradients
            for d in range(n):
                dg = summed if summed is not None else pgrads[d]
                gsq = sum_squares(list(dg) + [row_grads[d]])
                gn[d] += torch.stack([gsq, torch.ones_like(gsq)])
        if self.conf.check_nan_inf:
            finite = torch.isfinite(loss).all()
            for g in dense_grads + row_grads:
                finite &= torch.isfinite(g).all()
            if not bool(finite):
                raise NonFiniteBatchError(
                    f"non-finite loss/grad at step {self.global_step}"
                )
        if mode != "async":
            # "step": the one copy takes the summed gradient; "kstep":
            # each copy its own
            for d, (model, opt) in enumerate(zip(self.models,
                                                 self.optimizers)):
                for p, g in zip(model.parameters(),
                                summed if summed is not None else pgrads[d]):
                    p.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
        sharded_push_and_update(
            table.values, table.g2sum, row_grads, feed["occ_flat"],
            feed["serve_map"], feed["serve_uniq"], key_mask, key_clicks,
            tconf, uniq_lr=feed.get("uniq_lr"),
        )
        if hot:
            # hot occurrences carried the cold sink above, so each gradient
            # reaches exactly one of the two updates
            hybrid_hot_update(
                table.hot_values, table.hot_g2sum, row_grads,
                feed["hot_occ"], feed["hot_lr"], key_mask, key_clicks, tconf,
            )
        for d in range(n):
            update_auc_state_(aucs[d], preds[d], feed["labels"][d], mask[d])
            if tasks is not None:
                update_auc_states_(tasks[d], task_preds[d].t(),
                                   feed["task_labels"][d].t(),
                                   mask[d].expand(self.n_tasks, -1))
            if groups is not None:
                MetricGroup.update(groups[d], preds[d], feed["labels"][d],
                                   feed["metric_masks"][d])
        return loss, cnt, summed if mode == "async" else None, preds

    # -- public API --------------------------------------------------------- #
    def train_from_dataset(self, dataset, table: ShardedSparseTable,
                           auc_state=None, drop_last: bool = False,
                           next_pass_keys=None) -> dict:
        """One pass over the dataset, one batch per position at a time (the
        caller owns begin_pass/end_pass, as with the single-chip Trainer).
        ``auc_state`` (a stacked AucState or ``last_metric_state``)
        continues an earlier pass's metric streams.  ``next_pass_keys``
        (an array or a zero-argument callable) goes to
        ``table.prepare_pass`` once the groups are exhausted."""
        return self.train_groups(
            table, _group_batches(dataset.batches(drop_last=drop_last),
                                  self.n_dev),
            auc_state=auc_state, next_pass_keys=next_pass_keys,
        )

    def train_groups(self, table: ShardedSparseTable,
                     groups: Iterator[Sequence[HostBatch]],
                     auc_state=None, next_pass_keys=None) -> dict:
        """Train over explicit groups of n batches: plan, copy, step, with
        the plan and the copy on the prefetch producer when
        ``prefetch_batches`` > 0."""
        if not table._in_pass:
            raise RuntimeError("begin_pass before training")
        if table.mesh.n != self.n_dev or table.device != self.device:
            raise ValueError("the table and the trainer use different meshes")
        t0 = time.monotonic()
        hot_cap = table.hot_block_capacity
        if hot_cap:
            self._ensure_hot_block(table, hot_cap)
        gn = torch.zeros((self.n_dev, 2), device=self.device)
        group_state = task_state = None
        if self.metric_group is not None:
            group_state = stack_auc_states(
                self.metric_group.init_state(self.device), self.n_dev)
        if self.n_tasks > 1:
            # [n, n_tasks, ...]: per position, one stream per task
            task_state = stack_auc_states(stack_auc_states(
                init_auc_state(self.conf.auc_buckets, self.device),
                self.n_tasks), self.n_dev)
        if isinstance(auc_state, dict):
            if "gn" in auc_state:
                gn.copy_(auc_state["gn"])
            if group_state is not None and "group" in auc_state:
                group_state = AucState(*(t.clone()
                                         for t in auc_state["group"]))
            if task_state is not None and "task" in auc_state:
                task_state = AucState(*(t.clone() for t in auc_state["task"]))
            auc_state = auc_state["auc"]
        elif auc_state is not None and (group_state is not None
                                        or task_state is not None):
            raise ValueError(
                "pass trainer.last_metric_state (dict) to continue metrics "
                "across passes: a bare AucState would reset the task/group "
                "streams while continuing the primary one"
            )
        # per-position views of the stacked group and task states, updated
        # in place
        group_views = (None if group_state is None else
                       [unstack_auc_state(group_state, d)
                        for d in range(self.n_dev)])
        task_views = (None if task_state is None else
                      [unstack_auc_state(task_state, d)
                       for d in range(self.n_dev)])
        # the grad-norm stream carries across continued passes: the pass
        # reads a float64 delta of the positions' sum
        gn_base = gn.sum(0).double().cpu()
        stacked = auc_state if auc_state is not None else self.init_auc()
        aucs = [AucState(*(t.clone() for t in unstack_auc_state(stacked, d)))
                for d in range(self.n_dev)]
        losses, counts = [], []
        hot_occurrences = [0]
        depth = self.conf.prefetch_batches
        mode = self.conf.sync_dense_mode
        if mode == "async" and self.async_dense is None:
            self.async_dense = AsyncDenseTable(
                dict(self.model.named_parameters()),
                optimizer=self.conf.dense_optimizer, lr=self.conf.dense_lr)
        pull_every = max(self.conf.sync_weight_step, 1)
        pending: list = []  # "async": gradients pushed one step late
        # telemetry: the exporter and the event log are process singletons
        # (the first pass starts them); the host stages always feed the
        # stage histograms (plan and feed run on the producer thread; the
        # step is asynchronous and not timed per group), as the
        # reference's multi-chip trainer does
        tele = self.conf.telemetry or TelemetryConfig.from_flags()
        telemetry.ensure_exporter(tele.metrics_port or None)
        event_log = telemetry.ensure_event_log(tele.events_path or None)
        sprof = StatsProfiler()
        dumper = None
        if self.conf.need_dump_field and self.conf.dump_fields_path:
            from paddlebox_tpu_torch.train.dump import FieldDumper

            dumper = FieldDumper(
                os.path.join(self.conf.dump_fields_path,
                             f"dump-{self.global_step}.txt"),
                self.conf.dump_fields,
            )

        def feeds():
            """(device feed, ready event, the batches when dumping) per
            group; on the producer thread when prefetching."""
            for batches in groups:
                check_model_inputs(self.model, batches[0])
                check_task_labels(self.n_tasks, batches[0])
                with sprof.stage("plan"):
                    plan = table.plan_group(batches, self._slot_lr_vec,
                                            batches[0].n_sparse_slots)
                if plan.hot_occ is not None:
                    hot_occurrences[0] += int((plan.hot_occ < hot_cap).sum())
                with sprof.stage("feed"):
                    host = _stack_group(batches, plan, self.metric_group)
                keep = batches if dumper is not None else None
                if depth > 0:
                    yield (*stage_feed(host, self.device), keep)
                else:
                    yield self._to_device(host), None, keep

        feed_iter, prefetcher = prefetched(feeds(), depth)
        try:
            for feed, ready, batches in feed_iter:
                loss, cnt, grads, preds = self._step(
                    table, await_feed(feed, ready), aucs, gn, group_views,
                    task_views)
                if dumper is not None:
                    # a padding batch has no real instance: it dumps nothing
                    for b, p in zip(batches, preds):
                        dumper.dump_batch(b, p.cpu().numpy())
                if grads is not None:
                    pending.append(self._stage_async(grads))
                    if len(pending) > 1:
                        self._push_async(pending.pop(0))
                    if (self.global_step + 1) % pull_every == 0:
                        self._pull_async()
                losses.append(loss)
                counts.append(cnt)
                self.global_step += 1
                if mode == "kstep" and self.global_step % pull_every == 0:
                    self._average_copies()
            if mode == "async":
                # the pass end: the late gradient goes in, the master copy
                # absorbs everything, the device parameters refresh
                for g in pending:
                    self._push_async(g)
                pending.clear()
                self.async_dense.drain()
                self._pull_async()
        finally:
            if prefetcher is not None:
                prefetcher.close()
            if dumper is not None:
                dumper.close()
        # the staging window, as in the single-chip Trainer
        if next_pass_keys is not None:
            table.prepare_pass(next_pass_keys)
        if self.conf.need_dump_param and self.conf.dump_fields_path:
            from paddlebox_tpu_torch.train.dump import dump_params

            dump_params(
                os.path.join(self.conf.dump_fields_path,
                             f"param-{self.global_step}"),
                self.model.state_dict(), table=table,
                select=self.conf.dump_param,
            )
        merged = AucState(*(torch.stack(ts) for ts in zip(*aucs)))
        metrics = compute_metrics(merged)
        if task_state is not None:
            # the positions' streams summed in ascending order, per task
            metrics.update(compute_metrics_stacked(
                merge_auc_states(*task_views),
                [f"task{t}" for t in range(self.n_tasks)]))
        if group_state is not None:
            # the positions' streams summed in ascending order, per spec
            metrics.update(self.metric_group.compute(
                merge_auc_states(*group_views)))
        metrics["loss"] = 0.0
        if losses and mode == "kstep":
            # local means, recombined weighted by the real instance counts
            # so that padded empty batches do not bias the pass
            per_step = torch.stack(losses).double().cpu().numpy()
            cnts = torch.stack(counts).double().cpu().numpy()
            num = (per_step * cnts).sum(axis=1)
            metrics["loss"] = float(
                (num / np.maximum(cnts.sum(axis=1), 1.0)).mean())
        elif losses:
            metrics["loss"] = float(torch.stack(losses).mean())
        metrics["samples"] = float(torch.stack(counts).sum()) if counts else 0.0
        metrics["steps"] = len(losses)
        metrics["duration_s"] = time.monotonic() - t0
        metrics["missing_keys"] = table.missing_key_count
        metrics["capacity_bumps"] = table.capacity_bumps
        metrics["hot_occurrences"] = hot_occurrences[0]
        metrics.update(pass_norms(gn.sum(0).double().cpu() - gn_base,
                                  self.model.parameters()))
        self.last_auc_state = merged
        self.last_metric_state = {"auc": merged, "gn": gn}
        if task_state is not None:
            self.last_metric_state["task"] = task_state
        if group_state is not None:
            self.last_metric_state["group"] = group_state
        # the cross-process fleet snapshot gather comes with the
        # multi-process slice; one process has nothing to gather
        finish_pass_telemetry(metrics, sprof, False, "", event_log, table,
                              self.global_step, global_step=self.global_step)
        return metrics

    # -- evaluation --------------------------------------------------------- #
    @torch.no_grad()
    def evaluate(self, dataset, table: ShardedSparseTable,
                 drop_last: bool = False) -> dict:
        """Forward-only pass over every position (reference:
        parallel/trainer.py evaluate): no table, parameter or counter
        change, one AUC stream per position, merged.  Needs an open
        pass."""
        if not table._in_pass:
            raise RuntimeError("begin_pass before evaluating")
        tconf = self.table_conf
        hot_cap = table.hot_block_capacity
        if hot_cap:
            self._ensure_hot_block(table, hot_cap)
        aucs = [init_auc_state(self.conf.auc_buckets, self.device)
                for _ in range(self.n_dev)]
        for group in _group_batches(dataset.batches(drop_last=drop_last),
                                    self.n_dev):
            check_model_inputs(self.model, group[0])
            feed = self._to_device(_stack_group(group,
                                                table.plan_group(group)))
            if "hot_occ" in feed:
                rows = hybrid_pull(table.values, table.hot_values,
                                   feed["serve_rows"], feed["occ_flat"],
                                   feed["hot_occ"], tconf.create_threshold,
                                   tconf.cvm_offset)
            else:
                rows = sharded_pull(table.values, feed["serve_rows"],
                                    feed["occ_flat"], tconf.create_threshold,
                                    tconf.cvm_offset)
            mask = feed["ins_mask"]
            for d in range(self.n_dev):
                model = self.models[d % len(self.models)]
                logits = model(rows[d], feed["key_segments"][d],
                               feed["dense"][d], mask.shape[1],
                               **_position_extras(model, feed, d))
                if self.n_tasks > 1:
                    logits = logits[:, 0]  # the primary task
                update_auc_state_(aucs[d], torch.sigmoid(logits),
                                  feed["labels"][d], mask[d])
        return compute_metrics(AucState(*(torch.stack(ts)
                                          for ts in zip(*aucs))))


def _position_extras(model, feed: dict, d: int) -> dict:
    """Position d's slice of the extra inputs the model reads
    (train/trainer.py:model_extras): the feed stacks rank_offset and
    seq_pos [n, ...] over the positions."""
    return {k: v[d] for k, v in model_extras(model, feed).items()}


def _group_batches(batches: Iterator[HostBatch],
                   n: int) -> Iterator[list]:
    """Yield n batches at a time; a ragged tail is padded with empty
    batches (ins_mask all zero) so every position always gets a feed."""
    group: list = []
    for b in batches:
        group.append(b)
        if len(group) == n:
            yield group
            group = []
    if group:
        group += [empty_like(group[0])] * (n - len(group))
        yield group
