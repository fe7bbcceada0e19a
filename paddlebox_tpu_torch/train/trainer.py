"""Single-chip training loop (reference: paddlebox_tpu/train/trainer.py).

One step: pull (the gather kernel) -> fused_seqpool_cvm -> dense tower ->
logloss -> one backward that yields both the dense gradients and the
gradient of the pulled rows (JAX's ``value_and_grad(argnums=(0, 1))``) ->
Adam on the dense parameters -> push (segment-sum merge + sparse adagrad +
the scatter-add kernel) -> AUC histogram.  The host plans each batch's keys
(SparseTable.plan_batch) and copies the feed to the device.

With ``TrainerConfig.prefetch_batches`` > 0 (the default, 2, as in the
reference) batch assembly, key planning and the feed's copy to the device
run on a producer thread (``_FeedPrefetcher``), up to that many batches
ahead of the step.  On the card the producer copies from pinned host memory
on a side stream of its own and records an event; the step's stream waits
on it.  The producer launches no kernel of ``ops/sparse_kernels.py``: every
launch stays on the step's thread and stream.  0 runs the feed serially.

``next_pass_keys`` hands the next pass's census to ``table.prepare_pass``
once the feed is exhausted (the overlapped pass boundary, sparse/table.py).

The step policies of the reference:
  * ``TrainerConfig.scan_steps`` = k > 1 groups k steps into one body
    (``Trainer._group_body``), the reference's ``lax.scan`` of k steps.  On
    the card the body is captured once a pass as a CUDA graph (its first
    group runs eagerly on a side stream as the warm-up) and replayed, the
    group's k prefetched feeds copied into the graph's static feed slots
    first; a capture that fails raises, nothing falls back to eager steps.
    On the CPU the same body runs eagerly.  A ragged tail runs single
    steps.
  * ``check_nan_inf`` and ``nan_policy``: the finite flag of every step is
    decided on the device, and ``torch.where`` on it picks the pre- or
    post-step dense parameters and optimizer state, and whether the
    push's deltas, the AUC and the grad-norm updates apply ("skip_batch":
    a non-finite step drops only itself; "raise" and "rollback": it and
    every later step of its group leave all state untouched, and the host,
    reading the group's flags once, raises ``NonFiniteBatchError`` or
    rolls back to the attached checkpointer's last pass,
    ``PassRolledBack``).  The reference applies the poisoned step itself
    before it raises; the port applies nothing of it.
  * ``slot_mask`` (excluded slots read zero and neither train nor count),
    the per-slot LR map (``SparseTableConfig.slot_learning_rates``, the
    feed's ``uniq_lr``), ``dense_optimizer`` "sgd", the compute dtype of
    the tower (models/layers.py), and the grad-norm stream ``"gn"`` (summed
    squared global gradient norm and a step count, read as a delta per
    pass: ``grad_norm`` and ``weight_norm`` in the pass metrics).
  * ``evaluate``: forward only, streaming AUC, no table, parameter or
    counter change.

The data half (reference: train/trainer.py):
  * ``metric_group`` (metrics/variants.py): the feed carries the group's
    [n_specs, B] mask matrix, and every step updates the group's stacked
    AUC streams in the same body as the primary stream, so a captured
    graph holds the masks as one more static feed slot.
  * The feed also carries ``rank_offset``, ``seq_pos`` and ``task_labels``
    when the batch has them; a model that reads rank_offset or seq_pos
    (``uses_rank_offset`` / ``uses_seq_pos``) gets them by keyword, and a
    RuntimeError for a batch without them.
  * Field dumps (``TrainerConfig.need_dump_field``, train/dump.py): each
    step's predictions go to a FieldDumper, and the pass runs one step at
    a time whatever ``scan_steps`` says.  ``need_dump_param`` dumps the
    dense tower and the table's rows at the pass end.

The model contract (reference: train/trainer.py): a model with ``n_tasks``
> 1 returns logits [B, n_tasks] and trains on the mean BCE over the
batch's task-label columns (task 0 is the primary label, the stream the
pass AUC reads); its per-task AUC streams ("task" in the metric state)
update in the same step body and give ``task<t>/<metric>`` in the pass
metrics.  ``TrainerConfig.counter_label_tasks`` (cvm_offset - 2 entries)
adds each key's instance's task-label columns to its extra counters: the
feed's ``key_extras``, masked like the show/clk counters.

Telemetry (reference: train/trainer.py; telemetry/, utils/profiler.py):
  * the policy: ``TrainerConfig.telemetry``, else the
    PADDLEBOX_TORCH_METRICS_PORT / _TRACE_DIR / _EVENTS_PATH flags, starts
    the process's ``/metrics`` exporter and event log; ``trace_dir`` (the
    trainer's or the telemetry's) enables host span tracing, and the
    trainer's also records a torch.profiler device trace of the pass;
  * every pass times its host stages into ``trainer.stage_seconds``
    (``StatsProfiler``); under ``profile`` or tracing the ``StepProfiler``
    synchronizes each step, the feed runs serially and the steps one at a
    time, so that the split stays honest, and a ``pass`` span encloses the
    ``plan``, ``feed``, ``step`` and ``dump`` spans;
  * at the pass end: the ``train.grad_norm`` and ``train.weight_norm``
    gauges, ``metrics["profile"]`` under the StepProfiler, the host trace
    ``host-trace-r<rank>-pass<k>.json``, the health rules on the pass's
    delta snapshot, and the ``pass_end`` event record.  A rollback dumps
    the flight recorder before it raises.

Liveness (``TrainerConfig.liveness``, parallel/watchdog.py): a watchdog
runs around each pass, the producer reports ``feed`` before each batch and
the step thread ``step`` after each step group (the fault site
``train.step`` precedes it), so a frozen stage is detected locally past the
deadline; the prefetch queue's get is bounded and checks the watchdog
between polls, so an abort interrupts a consumer waiting on a stalled
producer.  A stall raises ``DistributedStallError`` after the teardown;
with ``LivenessConfig.rollback_on_abort`` and an attached checkpointer the
pass rolls back to the last completed pass first (``PassRolledBack``).
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import (
    SparseTableConfig,
    TelemetryConfig,
    TrainerConfig,
)
from paddlebox_tpu_torch.data.feed import HostBatch
from paddlebox_tpu_torch.metrics.auc import (
    AucState,
    compute_metrics,
    compute_metrics_stacked,
    init_auc_state,
    stack_auc_states,
    update_auc_state_,
    update_auc_states_,
)
from paddlebox_tpu_torch.metrics.variants import MetricGroup
from paddlebox_tpu_torch.models.layers import (
    apply_compute_dtype_override,
    bce_with_logits,
)
from paddlebox_tpu_torch.sparse.table import BatchPlan, SparseTable, pull_rows, push_and_update
from paddlebox_tpu_torch.train.slot_policy import (
    normalize_slot_mask,
    resolve_slot_lr_vec,
    slot_participation_vec,
)
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.device import resolve_device
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.profiler import (
    StatsProfiler,
    StepProfiler,
    device_trace,
)
from paddlebox_tpu_torch.utils.queues import bounded_put

logger = logging.getLogger(__name__)


def _watchdog_mod():
    """The liveness watchdog module (parallel/watchdog.py), imported on
    first use: the parallel package imports this module."""
    from paddlebox_tpu_torch.parallel import watchdog

    return watchdog


class NonFiniteBatchError(FloatingPointError):
    """A batch produced a non-finite loss or gradient and the nan_policy
    did not absorb it ("raise", or "rollback" without a checkpoint)."""


class PassRolledBack(RuntimeError):
    """nan_policy="rollback" fired: the in-flight pass was aborted and the
    table and dense state restored to the last completed pass through the
    attached AutoCheckpointer.  ``status`` is the restored status dict: the
    caller re-runs from ``status["next_pass"]`` and does NOT call
    ``table.end_pass()`` for the aborted pass."""

    def __init__(self, status: dict):
        super().__init__(
            f"pass rolled back to checkpoint tag {status['tag']!r}; "
            f"re-run from pass {status['next_pass']}"
        )
        self.status = status


def host_feed(batch: HostBatch, plan: BatchPlan,
              slot_lr_vec: Optional[np.ndarray] = None,
              metric_group: Optional[MetricGroup] = None,
              counter_label_tasks=()) -> dict:
    """The static-shape feed of one step, as numpy arrays.

    ``slot_lr_vec``: [S] per-slot learning rates; the feed then carries
    ``uniq_lr`` [K], each unique key's lr from the slot of its occurrences
    (the last assignment wins; the padding tail gets the mean), as the
    reference's ``_host_batch_dict`` builds it.  ``metric_group``: the
    feed carries its ``metric_masks`` [n_specs, B].  The batch's
    ``rank_offset``, ``seq_pos`` and ``task_labels`` ride along when it has
    them.  ``counter_label_tasks``: the feed carries ``key_extras`` [K, n],
    each occurrence's task-label columns (masked), the extra counter
    increments of a cvm_offset > 2 table."""
    n_slots = batch.n_sparse_slots
    ins = np.minimum(batch.key_segments // n_slots, batch.batch_size - 1)
    feed = {
        "idx": plan.idx,
        "uniq_idx": plan.uniq_idx,
        "inverse": plan.inverse,
        "key_mask": plan.key_mask,
        "key_clicks": batch.labels[ins] * plan.key_mask,
        "key_segments": batch.key_segments,
        "dense": batch.dense,
        "labels": batch.labels,
        "ins_mask": batch.ins_mask,
    }
    for name in ("rank_offset", "seq_pos", "task_labels"):
        v = getattr(batch, name)
        if v is not None:
            feed[name] = v
    if counter_label_tasks:
        if batch.task_labels is None:
            raise RuntimeError(
                "counter_label_tasks configured but the batch carries no "
                "task labels: set DataFeedConfig.task_label_slots"
            )
        n_cols = batch.task_labels.shape[1]
        bad = [t for t in counter_label_tasks if not 0 <= t < n_cols]
        if bad:
            raise ValueError(
                f"counter_label_tasks {bad} out of range: the batch has "
                f"{n_cols} task-label columns (col 0 = primary label)"
            )
        feed["key_extras"] = np.stack(
            [batch.task_labels[ins, t] * plan.key_mask
             for t in counter_label_tasks], axis=1).astype(np.float32)
    if metric_group is not None:
        feed["metric_masks"] = metric_group.masks(batch)
    if slot_lr_vec is not None:
        uniq_lr = np.full(batch.key_segments.shape[0], slot_lr_vec.mean(),
                          np.float32)
        n_real = batch.n_keys
        if n_real:
            uniq_lr[plan.inverse[:n_real]] = slot_lr_vec[
                batch.key_segments[:n_real] % n_slots
            ]
        feed["uniq_lr"] = uniq_lr
    return feed


def check_model_inputs(model, batch: HostBatch) -> None:
    """The reference's errors for a model whose extra inputs the batch
    lacks: rank_offset (``uses_rank_offset``) or seq_pos
    (``uses_seq_pos``)."""
    if getattr(model, "uses_rank_offset", False) and batch.rank_offset is None:
        raise RuntimeError(
            "model requires PV-merged batches with rank_offset: "
            "set enable_pv_merge and call dataset.preprocess_instance()"
        )
    if getattr(model, "uses_seq_pos", False) and batch.seq_pos is None:
        raise RuntimeError(
            "model consumes an ordered behavior sequence: set "
            "DataFeedConfig.sequence_slot (and max_seq_len) so "
            "batches carry seq_pos"
        )


def check_task_labels(n_tasks: int, batch: HostBatch) -> None:
    """The reference's error for a multi-task model whose batch lacks its
    task-label columns (task 0 is the primary label)."""
    if n_tasks > 1 and (batch.task_labels is None
                        or batch.task_labels.shape[1] != n_tasks):
        got = 0 if batch.task_labels is None else batch.task_labels.shape[1]
        raise RuntimeError(
            f"model has {n_tasks} tasks but the batch carries {got} task "
            "label columns: configure DataFeedConfig.task_label_slots with "
            f"{n_tasks - 1} slots (task 0 is the primary label)"
        )


def model_extras(model, feed: dict) -> dict:
    """The extra inputs a model reads from the feed by its markers:
    ``rank_offset`` (``uses_rank_offset``) and ``seq_pos``
    (``uses_seq_pos``)."""
    extra = {}
    if getattr(model, "uses_rank_offset", False):
        extra["rank_offset"] = feed["rank_offset"]
    if getattr(model, "uses_seq_pos", False):
        extra["seq_pos"] = feed["seq_pos"]
    return extra


def to_device(host: dict, device: torch.device) -> dict:
    """The serial feed's copy: every array to ``device`` on the caller's
    current stream."""
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


# device -> the side stream the prefetch producers copy on
_copy_streams: dict = {}


def stage_feed(host: dict, device: torch.device) -> tuple:
    """The producer's copy of one feed: (tensors, ready event).  On the card
    each array is copied into pinned host memory and from there, without
    blocking, on the device's copy stream, after which an event is
    recorded; on the CPU it is the serial copy and the event is None."""
    if device.type != "cuda":
        return to_device(host, device), None
    stream = _copy_streams.get(device)
    if stream is None:
        stream = _copy_streams.setdefault(device, torch.cuda.Stream(device))
    with torch.cuda.stream(stream):
        dev = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
               for k, v in host.items()}
        ready = torch.cuda.Event()
        ready.record(stream)
    return dev, ready


def await_feed(dev: dict, ready) -> dict:
    """Make the current stream wait for a staged feed's copies, and tell the
    caching allocator that the current stream uses its tensors (they were
    allocated on the producer's stream, which must not get their memory
    back while the step still reads it)."""
    if ready is not None:
        cur = torch.cuda.current_stream(next(iter(dev.values())).device)
        cur.wait_event(ready)
        for t in dev.values():
            t.record_stream(cur)
    return dev


# how long close() waits for the producer thread before counting it stuck
# (module level, so tests can shrink it)
_PREFETCH_JOIN_S = 5.0


class _FeedPrefetcher:
    """Bounded background feed assembly (reference: train/trainer.py
    ``_FeedPrefetcher``): a producer thread drains ``gen`` up to ``depth``
    items ahead of the consumer.  An exception raised by the producer
    re-raises at the consumer's next() call."""

    _SENTINEL = object()

    def __init__(self, gen: Iterator, depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = False
        self._done = False
        self._thread = threading.Thread(
            target=self._run, args=(gen,), name="feed-prefetch", daemon=True
        )
        self._thread.start()

    def _run(self, gen) -> None:
        def put(item) -> bool:
            # re-checks _stop: close() drains the queue, so a blocking put
            # would race it, and the producer could go on planning batches
            # (and touching the table) after the caller ended the pass
            return bounded_put(self._q, item, lambda: self._stop)

        try:
            for item in gen:
                if self._stop or not put(item):
                    return
                stats.add("trainer.prefetched_feeds")
            put(self._SENTINEL)
        except BaseException as e:  # surfaced to the consumer
            put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:  # the producer will never put again
            raise StopIteration
        wd_mod = _watchdog_mod()
        while True:
            # a bounded get: a coordinated liveness abort interrupts a
            # consumer waiting on a stalled producer within one poll slice
            wd_mod.check()
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                # the producer always ends with a sentinel or an error; a
                # dead one with an empty queue would leave this loop
                # waiting forever
                if not self._thread.is_alive() and self._q.empty():
                    self._done = True
                    raise RuntimeError(
                        "the feed-prefetch producer exited without a result")
        if item is self._SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item

    def close(self) -> None:
        """Unblock and retire the producer (call on every exit)."""
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=_PREFETCH_JOIN_S)
        if self._thread.is_alive():
            # stuck in planning or a copy: it exits at its next _stop check;
            # make the leak visible and countable
            stats.add("trainer.prefetch_close_timeout")
            logger.warning(
                "feed-prefetch producer did not exit within %ss of close(); "
                "the daemon thread retires at its next stop check",
                _PREFETCH_JOIN_S,
            )


def prefetched(feeds: Iterator, depth: int):
    """(iterator, prefetcher): ``feeds`` itself when ``depth`` <= 0 (the
    serial feed), else a _FeedPrefetcher over it, which the caller closes."""
    if depth <= 0:
        return feeds, None
    p = _FeedPrefetcher(feeds, depth)
    return p, p


def _dense_opt(kind: str, params, lr: float, capturable: bool):
    """The dense optimizer.  torch.optim.Adam's defaults (betas 0.9/0.999,
    eps 1e-8 added to sqrt(v_hat)) match optax.adam's (eps outside the
    root, eps_root 0); torch.optim.SGD without momentum is optax.sgd.
    ``capturable`` keeps Adam's step count on the device, which a CUDA
    graph needs and a where-gated step reads without a host sync."""
    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr)
    return torch.optim.Adam(params, lr=lr, capturable=capturable)


def init_opt_state(optimizer) -> None:
    """Create Adam's per-parameter state now, as its first step would (step
    0, zero moments), so a graph capture or a where-gated first step finds
    it in place.  SGD without momentum keeps no state."""
    if not isinstance(optimizer, torch.optim.Adam):
        return
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state[p]
            if st:
                continue
            st["step"] = torch.zeros(
                (), dtype=torch.float32,
                device=p.device if group["capturable"] else "cpu")
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)


def opt_state_tensors(optimizer) -> list:
    """Every tensor of the optimizer's state, in parameter order."""
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            out += [t for t in optimizer.state[p].values() if torch.is_tensor(t)]
    return out


def sum_squares(tensors) -> torch.Tensor:
    """float32 sum of the squares of every element of ``tensors``."""
    total = None
    for t in tensors:
        sq = t.float().square().sum()
        total = sq if total is None else total + sq
    return total


class _StepGraph:
    """One captured group of k steps: the static feed slots the body reads,
    the static loss and flag outputs, and the tensors whose addresses the
    capture baked in (the table's, which begin_pass reallocates, and the
    metric streams')."""

    def __init__(self, trainer: "Trainer", table, feeds: list, auc, gn,
                 group=None, task=None):
        self.values, self.g2sum = table.values, table.g2sum
        self.auc, self.gn, self.group, self.task = auc, gn, group, task
        self.shapes = _feed_shapes(feeds)
        self.slots = [{k: torch.empty_like(v) for k, v in f.items()}
                      for f in feeds]
        self.losses = torch.zeros(len(feeds), device=table.values.device)
        self.flags = torch.ones(len(feeds), dtype=torch.bool,
                                device=table.values.device)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the prefetch producer keeps pinning and copying
        # feeds on its own thread and stream while this thread captures;
        # the default ("global") mode would count its calls against the
        # capture and invalidate it
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            trainer._group_body(self.values, self.g2sum, self.slots, auc, gn,
                                self.losses, self.flags, group, task=task)

    def matches(self, table, feeds: list, auc, gn, group=None,
                task=None) -> bool:
        return (self.values is table.values and self.g2sum is table.g2sum
                and self.gn is gn
                and all(a is b for a, b in zip(self.auc, auc))
                and _same_tensors(self.group, group)
                and _same_tensors(self.task, task)
                and self.shapes == _feed_shapes(feeds))

    def replay(self, feeds: list) -> tuple:
        """Copy the group's feeds into the slots and replay; returns the
        losses and flags as fresh tensors (the next replay overwrites the
        static ones)."""
        for slot, feed in zip(self.slots, feeds):
            for k, v in feed.items():
                slot[k].copy_(v)
        self.graph.replay()
        return self.losses.clone(), self.flags.clone()


def _same_tensors(a, b) -> bool:
    """The same metric-group or task state (or both absent)."""
    if a is None or b is None:
        return a is b
    return all(x is y for x, y in zip(a, b))


def _feed_shapes(feeds: list) -> tuple:
    return tuple(tuple(sorted((k, tuple(v.shape), v.dtype)
                              for k, v in f.items())) for f in feeds)


class Trainer:
    """Drives a model + SparseTable over a dataset's batches."""

    def __init__(
        self,
        model,
        table_conf: SparseTableConfig,
        trainer_conf: Optional[TrainerConfig] = None,
        device="cuda",
        slot_mask: Optional[Iterable[int]] = None,
        metric_group: Optional[MetricGroup] = None,
    ):
        """slot_mask: participating sparse-slot indices (None = all).
        Excluded slots read zero pooled features, receive no gradient and
        increment no show/clk counter (the reference's per-phase slot
        participation, box_wrapper.h:627-630).  metric_group: filtered AUC
        streams beside the primary one, in the pass metrics as
        ``<spec>/<metric>``."""
        self.device = resolve_device(device)
        self.model = model
        self.table_conf = table_conf
        self.conf = trainer_conf or TrainerConfig()
        self.metric_group = metric_group
        n_slots = model.n_sparse_slots
        self.slot_mask = normalize_slot_mask(slot_mask, n_slots)
        apply_compute_dtype_override(model, self.conf.compute_dtype)
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"model parameters on {p.device}, trainer on {self.device}"
                )
        n_extra = len(self.conf.counter_label_tasks)
        if n_extra and n_extra != table_conf.cvm_offset - 2:
            raise ValueError(
                f"counter_label_tasks has {n_extra} entries but the table's "
                f"cvm_offset={table_conf.cvm_offset} leaves "
                f"{table_conf.cvm_offset - 2} extra counter column(s)"
            )
        # a multi-task model's logits are [B, n_tasks]; task 0 is the
        # primary label, the stream the pass AUC reads
        self.n_tasks = getattr(model, "n_tasks", 1)
        self._part_vec = slot_participation_vec(self.slot_mask, n_slots,
                                                self.device)
        # the host half of the per-slot LR map; the feed carries uniq_lr
        self._slot_lr_vec = resolve_slot_lr_vec(table_conf, n_slots)
        self.optimizer = _dense_opt(self.conf.dense_optimizer,
                                    model.parameters(), self.conf.dense_lr,
                                    capturable=self.device.type == "cuda")
        # AutoCheckpointer for nan_policy="rollback" (assign after
        # construction); without one, rollback raises as "raise" does
        self.checkpointer = None
        self.global_step = 0
        self._graph: Optional[_StepGraph] = None
        # the table values whose warm-up group ran: the next full group on
        # them captures
        self._warmed = None
        # captures and replays of the k-step CUDA graph, over the trainer's
        # life (a kernel wrapper's launch count counts captures only)
        self.graph_captures = 0
        self.graph_replays = 0
        self.last_auc_state: Optional[AucState] = None
        self.last_metric_state: Optional[dict] = None
        # completed passes: the pass span's, the trace file's and the
        # event record's index
        self._pass_idx = 0

    def close(self) -> None:
        """API parity with MultiChipTrainer.close(): the single-chip
        trainer holds no background thread (train_from_dataset closes its
        pass's prefetcher itself), so this is a no-op; TwoPhaseTrainer.close
        calls it on either path."""

    @property
    def _check_nan(self) -> bool:
        """Per-step finiteness check: the flag, or any policy that acts on
        it."""
        return self.conf.check_nan_inf or self.conf.nan_policy != "raise"

    @property
    def _skip_batches(self) -> bool:
        return self._check_nan and self.conf.nan_policy == "skip_batch"

    def _to_device(self, host: dict) -> dict:
        return to_device(host, self.device)

    # -- the step ----------------------------------------------------------- #
    def _tick(self, values, g2sum, feed: dict, auc: AucState,
              gn: torch.Tensor, ok: Optional[torch.Tensor],
              group: Optional[AucState] = None,
              task: Optional[AucState] = None):
        """One training step, every update in place.  ``ok``: with the
        check on, a bool device scalar, False when an earlier step of the
        group failed under a raising policy.  ``group``: the metric group's
        stacked streams, updated from the feed's metric_masks.  ``task``: a
        multi-task model's stacked per-task streams [n_tasks, ...].
        Returns (loss, gate, preds): gate is None without the check, else
        the device flag that decided whether this step's updates applied;
        preds are the primary task's."""
        tconf = self.table_conf
        rows = pull_rows(
            values, feed["idx"],
            create_threshold=tconf.create_threshold,
            cvm_offset=tconf.cvm_offset,
            pull_embedx_scale=tconf.pull_embedx_scale,
        ).requires_grad_(True)
        key_part = None
        pulled = rows
        if self._part_vec is not None:
            # occurrence-level participation (segment = ins * S + slot):
            # gating inside the loss zeroes the excluded slots' pooled
            # features and, through the chain rule, their row gradients
            key_part = self._part_vec[
                feed["key_segments"] % self._part_vec.shape[0]]
            pulled = rows * key_part[:, None]
        labels, mask = feed["labels"], feed["ins_mask"]
        loss, logits = self._loss(pulled, feed)
        multi = self.n_tasks > 1
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        row_grads = rows.grad
        params = list(self.model.parameters())
        grads = [p.grad for p in params]
        gate = None
        if self._check_nan:
            init_opt_state(self.optimizer)  # a no-op once the state exists
            finite = torch.isfinite(loss) & torch.isfinite(row_grads).all()
            for g in grads:
                finite = finite & torch.isfinite(g).all()
            gate = finite if ok is None else ok & finite
        gsq = sum_squares(grads + [row_grads])
        if gate is None:
            self.optimizer.step()
        else:
            # the decision stays on the device: where, never a multiply
            # (NaN * 0 is NaN)
            dense = params + opt_state_tensors(self.optimizer)
            before = [t.detach().clone() for t in dense]
            self.optimizer.step()
            with torch.no_grad():
                for t, b in zip(dense, before):
                    t.copy_(torch.where(gate, t, b))
        key_mask, key_clicks = feed["key_mask"], feed["key_clicks"]
        key_extras = feed.get("key_extras")
        if key_part is not None:
            # excluded slots increment no show/clk/extra counter either
            key_mask = key_mask * key_part
            key_clicks = key_clicks * key_part
            if key_extras is not None:
                key_extras = key_extras * key_part[:, None]
        push_and_update(
            values, g2sum, row_grads, feed["uniq_idx"], feed["inverse"],
            key_mask, key_clicks, tconf, key_extras=key_extras,
            uniq_lr=feed.get("uniq_lr"), gate=gate,
        )
        all_preds = torch.sigmoid(logits.detach())
        preds = all_preds[:, 0] if multi else all_preds
        update_auc_state_(auc, preds, labels, mask, gate)
        if task is not None:
            update_auc_states_(task, all_preds.t(), feed["task_labels"].t(),
                               mask.expand(self.n_tasks, -1), gate)
        if group is not None:
            MetricGroup.update(group, preds, labels, feed["metric_masks"],
                               gate)
        inc = torch.stack([gsq, torch.ones_like(gsq)])
        gn.add_(inc if gate is None else torch.where(gate, inc, 0.0))
        return loss.detach(), gate, preds

    def _loss(self, pulled: torch.Tensor, feed: dict) -> tuple:
        """(loss, logits) of one step's forward on the pulled rows: the mean
        BCE over the batch's real instances (a multi-task model's over its
        task-label columns); the sigmoid of the logits ([B], or [B,
        n_tasks]) are the step's predictions.  RetrievalTrainer overrides
        it with the in-batch sampled softmax; every policy of ``_tick``
        applies to either."""
        labels, mask = feed["labels"], feed["ins_mask"]
        logits = self.model(pulled, feed["key_segments"], feed["dense"],
                            labels.shape[0], **model_extras(self.model, feed))
        if self.n_tasks > 1:
            # [B, T] logits against [B, T] task labels, mean over the tasks
            per_ins = bce_with_logits(logits, feed["task_labels"]).mean(1)
        else:
            per_ins = bce_with_logits(logits, labels)
        return (per_ins * mask).sum() / torch.clamp(mask.sum(), min=1.0), logits

    def _group_body(self, values, g2sum, feeds: list, auc: AucState,
                    gn: torch.Tensor, losses: torch.Tensor,
                    flags: torch.Tensor, group: Optional[AucState] = None,
                    preds: Optional[list] = None,
                    task: Optional[AucState] = None) -> None:
        """k steps in one body (the reference's scan tick): the CPU runs
        it eagerly, the card captures it.  No host sync: each step's loss
        and flag land in ``losses`` / ``flags`` [k].  Under "skip_batch" a
        non-finite step drops only itself; under a raising policy every
        later step of the group leaves all state untouched.  ``preds``: a
        list that receives each step's predictions (the field dump)."""
        skip = self._skip_batches
        ok = None
        if self._check_nan and not skip:
            ok = torch.ones((), dtype=torch.bool, device=values.device)
        for j, feed in enumerate(feeds):
            loss, gate, p = self._tick(values, g2sum, feed, auc, gn, ok,
                                       group, task)
            if preds is not None:
                preds.append(p)
            losses[j] = loss
            if gate is not None:
                flags[j] = gate
                if not skip:
                    ok = gate

    def _check_table(self, table) -> None:
        if table.values.device.type != self.device.type:
            raise RuntimeError(
                f"table on {table.values.device}, trainer on {self.device}"
            )

    def _run_group(self, table, feeds: list, auc: AucState,
                   gn: torch.Tensor, group: Optional[AucState] = None,
                   preds: Optional[list] = None,
                   task: Optional[AucState] = None) -> tuple:
        """Run one group: replayed as the captured graph when it is a full
        group of scan_steps > 1 on the card, else eagerly.  Returns (losses
        [k], flags [k]) on the device.  ``preds`` (a list, eager groups
        only) receives each step's predictions."""
        self._check_table(table)
        k = len(feeds)
        if self.device.type == "cuda" and k > 1:
            graph = self._graph
            if graph is None or not graph.matches(table, feeds, auc, gn,
                                                  group, task):
                self._graph = None
                if self._warmed is not table.values:
                    # the warm-up of a new table: this group runs eagerly
                    # on a side stream (autograd, cuBLAS and the allocator
                    # settle), the next one captures
                    self._warmed = table.values
                    return self._warm_up(table, feeds, auc, gn, group, task)
                # a failed capture raises; nothing runs these steps
                # eagerly.  The capture is the port's compile event of the
                # step group (the reference's scan program)
                t0 = time.perf_counter()
                graph = _StepGraph(self, table, feeds, auc, gn, group, task)
                telemetry.record_compile(time.perf_counter() - t0,
                                         stage="train.scan")
                self._graph = graph
                self.graph_captures += 1
                stats.add("trainer.graph_captures")
            self.graph_replays += 1
            stats.add("trainer.graph_replays")
            return graph.replay(feeds)
        losses = torch.zeros(k, device=table.values.device)
        flags = torch.ones(k, dtype=torch.bool, device=table.values.device)
        self._group_body(table.values, table.g2sum, feeds, auc, gn, losses,
                         flags, group, preds, task)
        return losses, flags

    def _warm_up(self, table, feeds, auc, gn, group=None, task=None) -> tuple:
        """The group eagerly on a side stream, ordered after and before the
        current stream's work, as torch.cuda.graphs' whole-network example
        warms up before a capture; the optimizer's state is created here,
        so the capture finds it."""
        init_opt_state(self.optimizer)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        k = len(feeds)
        with torch.cuda.stream(side):
            losses = torch.zeros(k, device=self.device)
            flags = torch.ones(k, dtype=torch.bool, device=self.device)
            self._group_body(table.values, table.g2sum, feeds, auc, gn,
                             losses, flags, group, task=task)
        cur.wait_stream(side)
        # for the caching allocator: the feeds were read on the side
        # stream, the outputs will be on the current one
        for t in (v for f in feeds for v in f.values()):
            t.record_stream(side)
        for t in (losses, flags):
            t.record_stream(cur)
        return losses, flags

    def _step(self, table: SparseTable, dev: dict, auc: AucState):
        """One eager training step on a device feed, ``auc`` updated in
        place; returns (loss, auc) with loss a device scalar."""
        gn = torch.zeros(2, device=self.device)
        losses, flags = self._run_group(table, [dev], auc, gn)
        if self._check_nan and not bool(flags[0]):
            raise NonFiniteBatchError(
                f"non-finite loss/grad at step {self.global_step}")
        return losses[0], auc

    # -- dense persistence -------------------------------------------------- #
    def dense_state(self) -> tuple:
        """(model state_dict, optimizer state_dict) for the checkpoint
        managers (checkpoint.py)."""
        return self.model.state_dict(), self.optimizer.state_dict()

    def load_dense_state(self, params, opt_state=None) -> None:
        if params is not None:
            self.model.load_state_dict(params)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        # a loaded optimizer state holds new tensors: the captured graph's
        # addresses are stale
        self._graph = None

    def init_auc(self) -> AucState:
        """A fresh AUC stream on the trainer's device (the template of a
        saved metric state)."""
        return init_auc_state(self.conf.auc_buckets, self.device)

    def _rollback_to_checkpoint(self, table) -> None:
        """nan_policy="rollback": abort the poisoned pass, restore the last
        completed pass from the attached AutoCheckpointer and raise
        PassRolledBack.  Returns (the caller re-raises the
        NonFiniteBatchError) when no checkpointer is attached or no pass
        completed."""
        acp = self.checkpointer
        if acp is None:
            logger.warning("nan_policy='rollback' but no checkpointer "
                           "attached (set trainer.checkpointer); raising")
            return
        if acp.status() is None:
            logger.warning("nan_policy='rollback' but no completed pass "
                           "recorded; raising")
            return
        table.abort_pass()
        status, _ = acp.resume(table, self)
        stats.add("train.nan_rollback")
        # the flight ring still holds the spans and events leading into the
        # poisoned pass
        telemetry.dump_flight("pass_rollback", {
            "restored_pass": (status or {}).get("pass_idx")
            if isinstance(status, dict) else None,
            "pass_idx": self._pass_idx,
        })
        raise PassRolledBack(status)

    # -- public API --------------------------------------------------------- #
    def train_from_dataset(
        self,
        dataset,
        table: SparseTable,
        auc_state=None,
        drop_last: bool = False,
        next_pass_keys=None,
    ) -> dict:
        """Run one pass over the dataset's batches.  The caller owns the
        pass lifecycle: table.begin_pass() before, table.end_pass() after
        (except after PassRolledBack, which aborted the pass).
        ``auc_state`` continues an earlier pass's metric streams: an
        AucState, or ``last_metric_state`` (which carries the grad-norm
        stream too).

        ``next_pass_keys``: the NEXT pass's census (an array, or a
        zero-argument callable returning one, called on the table's staging
        thread).  Handed to ``table.prepare_pass`` once this pass's feed is
        exhausted, while the device still runs the last steps (a no-op on a
        serial table)."""
        return self.train_steps(table, dataset.batches(drop_last=drop_last),
                                auc_state, next_pass_keys=next_pass_keys)

    def _metric_state(self, auc_state) -> tuple:
        """(auc, gn, group, task) of a pass: fresh, or continued from an
        AucState (the primary stream only) or from ``last_metric_state``
        (every stream).  A bare AucState with a metric group or a
        multi-task model is refused: it would reset the group's or the
        tasks' streams while continuing the primary one."""
        gn = torch.zeros(2, device=self.device)
        group = task = None
        if self.metric_group is not None:
            group = self.metric_group.init_state(self.device)
        if self.n_tasks > 1:
            task = stack_auc_states(self.init_auc(), self.n_tasks)
        if isinstance(auc_state, dict):
            if "gn" in auc_state:
                gn.copy_(auc_state["gn"])
            if group is not None and "group" in auc_state:
                group = AucState(*(t.clone() for t in auc_state["group"]))
            if task is not None and "task" in auc_state:
                task = AucState(*(t.clone() for t in auc_state["task"]))
            auc_state = auc_state["auc"]
        elif auc_state is not None and (group is not None or task is not None):
            raise ValueError(
                "pass trainer.last_metric_state (dict) to continue metrics "
                "across passes: a bare AucState would reset the task/group "
                "streams while continuing the primary one"
            )
        auc = (AucState(*(t.clone() for t in auc_state))
               if auc_state is not None else self.init_auc())
        return auc, gn, group, task

    def train_steps(self, table: SparseTable, batches: Iterable[HostBatch],
                    auc_state=None, next_pass_keys=None) -> dict:
        """Lower-level entry: train over an explicit batch iterable."""
        if not table._in_pass:
            raise RuntimeError("begin_pass before training")
        t0 = time.monotonic()
        auc, gn, group, task = self._metric_state(auc_state)
        # the stream carries across continued passes: the pass reads a
        # delta, in float64 on the host as the reference reads it
        gn_base = gn.double().cpu()
        losses = []
        n_samples = [0.0]
        depth = self.conf.prefetch_batches
        dumper = None
        if self.conf.need_dump_field and self.conf.dump_fields_path:
            from paddlebox_tpu_torch.train.dump import FieldDumper

            dumper = FieldDumper(
                os.path.join(self.conf.dump_fields_path,
                             f"dump-{self.global_step}.txt"),
                self.conf.dump_fields,
            )
        event_log, host_trace_dir, prof = telemetry_policy(self.conf)
        # a dumped pass reads every step's predictions, and a profiled or
        # traced one times each step: one step at a time, fed serially
        k = (1 if dumper is not None or prof.enabled
             else max(1, self.conf.scan_steps))
        if prof.enabled:
            depth = 0
        # the liveness watchdog of the pass: local stall detection in one
        # process, heartbeats and the coordinated abort in a job
        wd_mod = _watchdog_mod()
        wd = wd_mod.for_trainer(self.conf.liveness,
                                namespace=f"train-{self.global_step}")
        if wd is not None:
            wd.start()

        def feeds():
            """Groups of k (device feed, ready event, instances, batch), the
            ragged tail as single steps: batch assembly, key planning, the
            chaos site and the copy; on the producer thread when
            prefetching.  The batch rides along only for the dump."""
            group_items = []
            for batch in batches:
                if wd is not None:
                    wd.report("feed")
                check_model_inputs(self.model, batch)
                check_task_labels(self.n_tasks, batch)
                with prof.stage("plan"):
                    plan = table.plan_batch(batch)
                with prof.stage("feed"):
                    host = host_feed(batch, plan, self._slot_lr_vec,
                                     self.metric_group,
                                     self.conf.counter_label_tasks)
                if faults.fire("train.nan"):
                    # chaos: poison the labels, so the loss and gradients
                    # really go non-finite on the device
                    host["labels"] = np.full_like(host["labels"], np.nan)
                ins = float(batch.ins_mask.sum())
                n_samples[0] += ins
                with prof.stage("feed"):
                    if depth > 0:
                        dev, ready = stage_feed(host, self.device)
                    else:
                        dev, ready = self._to_device(host), None
                group_items.append(
                    (dev, ready, ins, batch if dumper is not None else None))
                if len(group_items) == k:
                    yield group_items
                    group_items = []
            for item in group_items:
                yield [item]

        # queue slots hold groups: the depth shrinks so the staged device
        # memory stays about prefetch_batches batches either way
        feed_iter, prefetcher = prefetched(
            feeds(), max(1, depth // k) if depth > 0 else 0)
        sync = prof.enabled and self.device.type == "cuda"
        try:
            try:
                with telemetry.span("pass", pass_idx=self._pass_idx,
                                    global_step=self.global_step), \
                        device_trace(self.conf.trace_dir or None):
                    n_steps = self._train_loop(table, feed_iter, auc, gn,
                                               group, dumper, prof, sync,
                                               losses, task, wd)
            finally:
                # the watchdog retires first, so its latch cannot fire into
                # the teardown
                if wd is not None:
                    wd.close()
                if prefetcher is not None:
                    prefetcher.close()
                if dumper is not None:
                    dumper.close()
        except NonFiniteBatchError:
            if self.conf.nan_policy == "rollback":
                self._rollback_to_checkpoint(table)  # raises PassRolledBack
            raise
        except wd_mod.DistributedStallError:
            # the pass is torn down (producer closed); with
            # rollback_on_abort and a checkpointer the last completed pass
            # comes back first, so nothing partial survives the replay
            stats.add("train.stall_aborts")
            if (self.conf.liveness is not None
                    and self.conf.liveness.rollback_on_abort):
                self._rollback_to_checkpoint(table)  # raises PassRolledBack
            raise
        # the feed is done (the producer closed) while the card still runs
        # the last steps: the window the next pass's staging hides in,
        # before the metric readback below waits for the card
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
        metrics = compute_metrics(auc)
        if task is not None:
            metrics.update(compute_metrics_stacked(
                task, [f"task{t}" for t in range(self.n_tasks)]))
        if group is not None:
            metrics.update(self.metric_group.compute(group))
        metrics["loss"] = (
            float(torch.cat(losses).mean()) if n_steps else 0.0
        )
        metrics["steps"] = n_steps
        metrics["samples"] = n_samples[0]
        metrics["duration_s"] = time.monotonic() - t0
        metrics.update(pass_norms(gn.double().cpu() - gn_base,
                                  self.model.parameters()))
        self.last_auc_state = auc
        self.last_metric_state = {"auc": auc, "gn": gn}
        if task is not None:
            self.last_metric_state["task"] = task
        if group is not None:
            self.last_metric_state["group"] = group
        trace_path = ""
        if host_trace_dir:
            trace_path = os.path.join(
                host_trace_dir,
                f"host-trace-r{telemetry.events._default_rank()}"
                f"-pass{self._pass_idx}.json")
        finish_pass_telemetry(metrics, prof, self.conf.profile, trace_path,
                              event_log, table, self._pass_idx,
                              pass_idx=self._pass_idx)
        self._pass_idx += 1
        return metrics

    def _train_loop(self, table, feed_iter, auc, gn, group, dumper, prof,
                    sync: bool, losses: list, task=None, wd=None) -> int:
        """The pass's steps over its feed, each group's losses appended to
        ``losses``; returns the steps counted."""
        check_nan, skip = self._check_nan, self._skip_batches
        n_steps = 0
        for items in feed_iter:
            # entering the step stage; a hang at the chaos site here is a
            # stalled step, which the watchdog bounds and names
            if wd is not None:
                wd.report("step")
            faults.inject("train.step")
            devs = [await_feed(d, r) for d, r, _, _ in items]
            preds = [] if dumper is not None else None
            with prof.stage("step"):
                loss_k, flags = self._run_group(table, devs, auc, gn, group,
                                                preds, task)
                if sync:
                    torch.cuda.synchronize(self.device)  # honest timing
            if wd is not None:
                wd.report("step")
            prof.step_done()
            n = len(items)
            good = None
            if check_nan:
                fin = flags.cpu().numpy()  # one readback a group
                if not fin.all():
                    if not skip:
                        raise NonFiniteBatchError(
                            f"non-finite loss/grad within steps "
                            f"{self.global_step}.."
                            f"{self.global_step + n - 1}")
                    bad = np.nonzero(~fin)[0]
                    stats.add("train.nan_skipped_steps", bad.shape[0])
                    stats.add("train.nan_skipped_ins",
                              sum(items[j][2] for j in bad))
                    good = np.nonzero(fin)[0]
                    loss_k = loss_k[torch.from_numpy(good).to(loss_k.device)]
                    n = good.shape[0]
            if dumper is not None:
                with prof.stage("dump"):
                    # a skipped batch dumps nothing, as it trains nothing
                    for j, (_, _, _, batch) in enumerate(items):
                        if good is None or j in good:
                            dumper.dump_batch(batch, preds[j].cpu().numpy())
            losses.append(loss_k)
            n_steps += n
            self.global_step += n
        return n_steps

    # -- evaluation --------------------------------------------------------- #
    @torch.no_grad()
    def evaluate(self, dataset, table: SparseTable,
                 drop_last: bool = False) -> dict:
        """Forward-only pass: no table, parameter or counter change, a
        streaming AUC only (reference: infer_from_dataset).  Needs an open
        pass.  Takes any dataset mode: in memory, PV-merged or spilled."""
        if not table._in_pass:
            raise RuntimeError("begin_pass before evaluating")
        self._check_table(table)
        tconf = self.table_conf
        auc = self.init_auc()
        for batch in dataset.batches(drop_last=drop_last):
            check_model_inputs(self.model, batch)
            dev = self._to_device(host_feed(batch, table.plan_batch(batch)))
            rows = pull_rows(
                table.values, dev["idx"],
                create_threshold=tconf.create_threshold,
                cvm_offset=tconf.cvm_offset,
                pull_embedx_scale=tconf.pull_embedx_scale,
            )
            logits = self.model(rows, dev["key_segments"], dev["dense"],
                                dev["labels"].shape[0],
                                **model_extras(self.model, dev))
            if self.n_tasks > 1:
                logits = logits[:, 0]  # the primary task
            update_auc_state_(auc, torch.sigmoid(logits), dev["labels"],
                              dev["ins_mask"])
        return compute_metrics(auc)


def telemetry_policy(conf: TrainerConfig) -> tuple:
    """(event log or None, host trace dir or "", stage profiler) of a pass
    (reference: train/trainer.py's telemetry policy).  Explicit config wins
    over the flags; the exporter and the event log are process singletons
    the first pass starts.  Host span tracing runs under the trainer's
    ``trace_dir`` or the telemetry's; the full ``StepProfiler`` under
    ``profile`` or tracing, the histogram-only ``StatsProfiler``
    otherwise."""
    tele = conf.telemetry or TelemetryConfig.from_flags()
    telemetry.ensure_exporter(tele.metrics_port or None)
    event_log = telemetry.ensure_event_log(tele.events_path or None)
    host_trace_dir = conf.trace_dir or tele.trace_dir
    if host_trace_dir:
        telemetry.enable_tracing(pid=telemetry.events._default_rank())
    prof = (StepProfiler() if conf.profile or host_trace_dir
            else StatsProfiler())
    return event_log, host_trace_dir, prof


def finish_pass_telemetry(metrics: dict, prof, print_profile: bool,
                          trace_path: str, event_log, table, window,
                          **record_fields) -> None:
    """The pass end's telemetry (reference: train/trainer.py): the norm
    gauges, ``metrics["profile"]`` under the StepProfiler, the host trace
    file at ``trace_path`` ("" = none), then the health rules on the pass's
    delta snapshot, before the ``pass_end`` record that carries the same
    snapshot."""
    if "grad_norm" in metrics:
        telemetry.gauge(
            "train.grad_norm",
            "per-pass RMS global gradient norm (dense + sparse)",
        ).set(metrics["grad_norm"])
    telemetry.gauge(
        "train.weight_norm", "dense parameter L2 norm at pass end"
    ).set(metrics["weight_norm"])
    if prof.enabled:
        metrics["profile"] = prof.report()
        stage_q = prof.quantiles()
        if stage_q:
            metrics["profile"]["stage_quantiles"] = stage_q
        if print_profile:
            print("[profile]", prof.log_line())
    if trace_path:
        telemetry.flush_trace(trace_path)
    snap = telemetry.registry.delta_snapshot()
    telemetry.observe_pass(window, metrics=metrics, telemetry=snap,
                           table=table)
    if event_log is not None:
        event_log.log_pass(metrics, telemetry=snap, **record_fields)


def pass_norms(gn_delta: torch.Tensor, params) -> dict:
    """The pass metrics of the grad-norm stream: ``grad_norm``, the RMS
    over the pass's steps of the global gradient norm (dense and sparse),
    from a float64 "gn" delta [sum of squares, steps] (absent when the pass
    counted no step), and ``weight_norm``, the L2 norm of ``params`` at the
    pass end."""
    out = {}
    d_sq, d_n = (float(x) for x in gn_delta)
    if d_n > 0:
        out["grad_norm"] = math.sqrt(d_sq / d_n) if d_sq >= 0 else float("nan")
    wsq = sum(float(p.detach().float().square().sum()) for p in params)
    out["weight_norm"] = math.sqrt(wsq) if wsq >= 0 else float("nan")
    return out
