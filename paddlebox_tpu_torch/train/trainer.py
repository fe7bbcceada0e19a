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

Scan grouping, the skip/rollback NaN policies, evaluation, dumping, the
watchdog and telemetry are later slices.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.feed import HostBatch
from paddlebox_tpu_torch.metrics.auc import (
    AucState,
    compute_metrics,
    init_auc_state,
    update_auc_state,
)
from paddlebox_tpu_torch.models.layers import bce_with_logits, resolve_compute_dtype
from paddlebox_tpu_torch.sparse.table import BatchPlan, SparseTable, pull_rows, push_and_update
from paddlebox_tpu_torch.utils.device import resolve_device
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.queues import bounded_put

logger = logging.getLogger(__name__)


class NonFiniteBatchError(FloatingPointError):
    """A batch produced a non-finite loss or gradient (check_nan_inf)."""


def host_feed(batch: HostBatch, plan: BatchPlan) -> dict:
    """The static-shape feed of one step, as numpy arrays."""
    ins = np.minimum(
        batch.key_segments // batch.n_sparse_slots, batch.batch_size - 1
    )
    return {
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
        while True:
            # a bounded get, as in the reference, where it lets a liveness
            # abort interrupt a consumer waiting on a stalled producer
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                continue
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


class Trainer:
    """Drives a model + SparseTable over a dataset's batches."""

    def __init__(
        self,
        model,
        table_conf: SparseTableConfig,
        trainer_conf: Optional[TrainerConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.table_conf = table_conf
        self.conf = trainer_conf or TrainerConfig()
        resolve_compute_dtype(self.conf.compute_dtype)
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"model parameters on {p.device}, trainer on {self.device}"
                )
        # torch.optim.Adam's defaults (betas 0.9/0.999, eps 1e-8 added to
        # sqrt(v_hat)) match optax.adam's (eps outside the root, eps_root 0)
        self.optimizer = torch.optim.Adam(model.parameters(),
                                          lr=self.conf.dense_lr)
        self.global_step = 0
        self.last_auc_state: Optional[AucState] = None

    def _to_device(self, host: dict) -> dict:
        return to_device(host, self.device)

    def _step(self, table: SparseTable, dev: dict, auc: AucState):
        """One training step; updates the model, the table and returns
        (loss, auc) with loss a device scalar."""
        tconf = self.table_conf
        if table.values.device.type != self.device.type:
            raise RuntimeError(
                f"table on {table.values.device}, trainer on {self.device}"
            )
        rows = pull_rows(
            table.values, dev["idx"],
            create_threshold=tconf.create_threshold,
            cvm_offset=tconf.cvm_offset,
            pull_embedx_scale=tconf.pull_embedx_scale,
        ).requires_grad_(True)
        labels, mask = dev["labels"], dev["ins_mask"]
        logits = self.model(rows, dev["key_segments"], dev["dense"],
                            labels.shape[0])
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (bce_with_logits(logits, labels) * mask).sum() / denom
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        row_grads = rows.grad
        if self.conf.check_nan_inf:
            finite = torch.isfinite(loss) & torch.isfinite(row_grads).all()
            for p in self.model.parameters():
                finite &= torch.isfinite(p.grad).all()
            if not bool(finite):
                raise NonFiniteBatchError(
                    f"non-finite loss/grad at step {self.global_step}"
                )
        self.optimizer.step()
        push_and_update(
            table.values, table.g2sum, row_grads, dev["uniq_idx"],
            dev["inverse"], dev["key_mask"], dev["key_clicks"], tconf,
        )
        auc = update_auc_state(auc, torch.sigmoid(logits.detach()), labels, mask)
        return loss.detach(), auc

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

    def init_auc(self) -> AucState:
        """A fresh AUC stream on the trainer's device (the template of a
        saved metric state)."""
        return init_auc_state(self.conf.auc_buckets, self.device)

    # -- public API --------------------------------------------------------- #
    def train_from_dataset(
        self,
        dataset,
        table: SparseTable,
        auc_state: Optional[AucState] = None,
        drop_last: bool = False,
        next_pass_keys=None,
    ) -> dict:
        """Run one pass over the dataset's batches.  The caller owns the
        pass lifecycle: table.begin_pass() before, table.end_pass() after.
        ``auc_state`` continues an earlier pass's metric stream.

        ``next_pass_keys``: the NEXT pass's census (an array, or a
        zero-argument callable returning one, called on the table's staging
        thread).  Handed to ``table.prepare_pass`` once this pass's feed is
        exhausted, while the device still runs the last steps (a no-op on a
        serial table)."""
        return self.train_steps(table, dataset.batches(drop_last=drop_last),
                                auc_state, next_pass_keys=next_pass_keys)

    def train_steps(self, table: SparseTable, batches: Iterable[HostBatch],
                    auc_state: Optional[AucState] = None,
                    next_pass_keys=None) -> dict:
        """Lower-level entry: train over an explicit batch iterable."""
        if not table._in_pass:
            raise RuntimeError("begin_pass before training")
        t0 = time.monotonic()
        auc = (
            AucState(*(t.clone() for t in auc_state))
            if auc_state is not None
            else self.init_auc()
        )
        losses = []
        n_samples = [0.0]
        depth = self.conf.prefetch_batches

        def feeds():
            """(device feed, ready event) per batch: batch assembly, key
            planning and the copy; on the producer thread when prefetching."""
            for batch in batches:
                plan = table.plan_batch(batch)
                host = host_feed(batch, plan)
                n_samples[0] += float(batch.ins_mask.sum())
                if depth > 0:
                    yield stage_feed(host, self.device)
                else:
                    yield self._to_device(host), None

        feed_iter, prefetcher = prefetched(feeds(), depth)
        try:
            for dev, ready in feed_iter:
                loss, auc = self._step(table, await_feed(dev, ready), auc)
                losses.append(loss)
                self.global_step += 1
        finally:
            if prefetcher is not None:
                prefetcher.close()
        # the feed is done (the producer closed) while the card still runs
        # the last steps: the window the next pass's staging hides in,
        # before the metric readback below waits for the card
        if next_pass_keys is not None:
            table.prepare_pass(next_pass_keys)
        metrics = compute_metrics(auc)
        metrics["loss"] = (
            float(torch.stack(losses).mean()) if losses else 0.0
        )
        metrics["steps"] = len(losses)
        metrics["samples"] = n_samples[0]
        metrics["duration_s"] = time.monotonic() - t0
        self.last_auc_state = auc
        return metrics
