"""StreamingTrainer: the loop of feed -> train -> publish -> served
(reference: paddlebox_tpu/streaming/runner.py).

Each mini-pass window runs the lifecycle a batch driver runs a pass —
``begin_pass(census) -> train_from_dataset -> end_pass`` — with the NEXT
window's census handed to ``prepare_pass`` through the trainer's
``next_pass_keys`` hook (it blocks on the scheduler from the table's
staging thread, overlapping the current window's device tail).  The
metric state carries across windows, so the AUC streams on.

Both trainers fit: anything with ``train_from_dataset(dataset, table,
auc_state=, drop_last=, next_pass_keys=)``, ``last_metric_state`` and
``dense_state()`` (the single-chip ``Trainer`` and the ``MultiChipTrainer``).
A publish with programs exports ``model`` with ``dense_state()[0]``.

Guards:

  * **liveness** — with a ``LivenessConfig`` on the trainer the runner
    holds its own watchdog (parallel/watchdog.py) across the run,
    reporting ``feed`` as it waits for a window and ``step`` as it trains
    one.  A wedged source (``stream.tail`` hang) stops the feed beats and
    the watchdog raises ``DistributedStallError(stage="feed")``.  One
    window is one unit of progress: the deadline must exceed the longest
    window's training time.
  * **NaN rollback** — after ``PassRolledBack`` (nan_policy="rollback")
    the runner retrains the window in hand once
    (``stream.window_retrains``) and re-raises on a second failure.

Shutdown drains, then checkpoints: ``stop()`` (or ``max_seconds``) stops
the source; the scheduler cuts one final ``drain`` window from what is
buffered; the runner trains it, forces a final publish so no trained row
stays unpublished, flushes the table and writes an ``AutoCheckpointer``
pass record when one is attached.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.parallel import watchdog
from paddlebox_tpu_torch.streaming.freshness import DeadlinePublishPolicy
from paddlebox_tpu_torch.streaming.minipass import MiniPassScheduler
from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)

_WINDOWS = telemetry.counter(
    "stream.windows", help="mini-pass windows trained"
)
_RETRAINS = telemetry.counter(
    "stream.window_retrains", help="windows retrained after a NaN rollback"
)


class StreamingTrainer:
    """Wires trainer + table + scheduler + publish policy into one loop.

    policy: a :class:`DeadlinePublishPolicy` (None = train-only, no
    publishing).  served_seq_fn: zero-arg callable returning the newest
    donefile seq the serving side has applied (e.g. ``lambda:
    (server.model_version("live") or {}).get("seq")``) — when given, a
    confirmation poller closes the freshness loop and
    ``stream.freshness_seconds`` records true event→served latency.
    """

    def __init__(
        self,
        trainer,
        table,
        scheduler: MiniPassScheduler,
        *,
        policy: Optional[DeadlinePublishPolicy] = None,
        model=None,
        checkpointer=None,
        checkpoint_every_windows: int = 0,
        served_seq_fn=None,
        census_wait_s: float = 1.0,
    ):
        self.trainer = trainer
        self.table = table
        self.scheduler = scheduler
        self.policy = policy
        self.model = model
        self.checkpointer = checkpointer
        self.checkpoint_every_windows = int(checkpoint_every_windows)
        self.served_seq_fn = served_seq_fn
        self.census_wait_s = float(census_wait_s)
        self._stop_evt = threading.Event()
        self._confirm_thread: Optional[threading.Thread] = None
        self._confirm_stop = threading.Event()
        self._mstate = None
        self._auto_start = False
        self.windows_trained = 0
        self.records_trained = 0
        self.last_metrics: Optional[dict] = None

    @classmethod
    def from_config(
        cls,
        trainer,
        table,
        feed_conf,
        stream_conf=None,
        *,
        publisher=None,
        model=None,
        served_seq_fn=None,
        checkpointer=None,
        source=None,
    ):
        """Build the whole plane from a :class:`~paddlebox_tpu_torch.config.
        StreamingConfig` (None = ``StreamingConfig.from_flags()``, the
        ``PADDLEBOX_TORCH_STREAM_ROOT`` / ``_MAX_STALENESS_S`` /
        ``_STREAM_WINDOW_RECORDS`` surface ``launch.py
        --stream-root/--max-staleness-s`` sets fleet-wide): a
        TailingFileSource over ``stream_root`` (or the given ``source``),
        the mini-pass scheduler, and — with a ``publisher`` — the
        deadline publish policy.  ``run()`` starts the source and
        scheduler itself."""
        from paddlebox_tpu_torch.config import StreamingConfig
        from paddlebox_tpu_torch.streaming.source import TailingFileSource

        sc = stream_conf or StreamingConfig.from_flags()
        if source is None:
            if not sc.stream_root:
                raise ValueError(
                    "StreamingConfig.stream_root is empty and no source "
                    "was given (set PADDLEBOX_TORCH_STREAM_ROOT / launch.py "
                    "--stream-root, or pass source=)"
                )
            source = TailingFileSource(
                sc.stream_root,
                poll_interval_s=sc.tail_poll_interval_s,
                buffer_records=sc.buffer_records,
            )
        scheduler = MiniPassScheduler(
            source, feed_conf,
            window_records=sc.window_records,
            window_seconds=sc.window_seconds,
            max_pending=sc.max_pending_windows,
        )
        policy = None
        if publisher is not None:
            policy = DeadlinePublishPolicy(
                publisher, sc.max_staleness_s, scheduler=scheduler,
                trigger_fraction=sc.trigger_fraction,
                widen_factor=sc.widen_factor,
                max_window_records=sc.max_window_records,
            )
        runner = cls(
            trainer, table, scheduler, policy=policy, model=model,
            checkpointer=checkpointer,
            checkpoint_every_windows=sc.checkpoint_every_windows,
            served_seq_fn=served_seq_fn,
        )
        runner._auto_start = True
        return runner

    def _dense_params(self):
        """The trained dense state to export ``model`` with: None when the
        model is the trainer's own (it holds its parameters), else the
        trainer's ``dense_state()[0]`` (a MultiChipTrainer's serial
        model)."""
        if self.model is None or self.model is getattr(self.trainer,
                                                        "model", None):
            return None
        return self.trainer.dense_state()[0]

    # -- control ------------------------------------------------------------ #
    def stop(self) -> None:
        """Request the graceful drain-and-checkpoint shutdown: the source
        stops, buffered records become the final drain window, and run()
        returns after training + publishing it."""
        self._stop_evt.set()
        self.scheduler.source.stop()

    # -- serve confirmation poller ------------------------------------------ #
    def _confirm_loop(self) -> None:
        while not self._confirm_stop.is_set():
            try:
                self.policy.confirm_served(self.served_seq_fn())
            except Exception:
                # the serving side may not be up yet — expected early on,
                # but a *persistently* failing poll must stay visible
                stats.add("stream.confirm_errors")
            self._confirm_stop.wait(0.05)
        # final sweep so a publish confirmed just before shutdown lands
        try:
            self.policy.confirm_served(self.served_seq_fn())
        except Exception:
            stats.add("stream.confirm_errors")
            logger.debug("final serve-confirmation sweep failed",
                         exc_info=True)

    # -- the loop ------------------------------------------------------------ #
    def run(
        self,
        max_windows: Optional[int] = None,
        max_seconds: Optional[float] = None,
    ) -> dict:
        """Consume windows until the source drains (after ``stop()`` /
        ``max_seconds``) or ``max_windows`` were trained.  Returns a
        summary dict (windows, records, publishes, freshness...)."""
        if self._auto_start:
            self._auto_start = False
            self.scheduler.source.start()
            self.scheduler.start()
        wd = None
        liveness = getattr(self.trainer.conf, "liveness", None)
        if liveness is not None:
            wd = watchdog.for_trainer(liveness, namespace="stream")
            if wd is not None:
                wd.start()
        if self.policy is not None and self.served_seq_fn is not None:
            self.policy.track_served()
            self._confirm_stop.clear()
            self._confirm_thread = threading.Thread(
                target=self._confirm_loop, name="stream-confirm", daemon=True
            )
            self._confirm_thread.start()
        t_start = time.monotonic()
        try:
            while True:
                if max_windows is not None \
                        and self.windows_trained >= max_windows:
                    self.stop()
                if (
                    max_seconds is not None
                    and time.monotonic() - t_start >= max_seconds
                ):
                    self.stop()
                window = self._next_window(wd)
                if window is None:
                    break  # drained
                self._train_window(window, wd)
            # drain complete: nothing trained may stay unpublished
            if self.policy is not None and self.windows_trained:
                self.policy.maybe_publish(
                    self.table, self.model,
                    self._dense_params(),
                    metrics=self.last_metrics, force=True,
                )
            self.table.flush()
            if self.checkpointer is not None and self.windows_trained:
                self.checkpointer.after_pass(
                    self.windows_trained - 1, self.table, self.trainer,
                    metric_state=self._mstate,
                )
        finally:
            if self._confirm_thread is not None:
                self._confirm_stop.set()
                self._confirm_thread.join(timeout=5.0)
                self._confirm_thread = None
            # two-phase source shutdown made explicit: request the
            # graceful drain first (idempotent — the normal path already
            # stopped), then escalate through close().  An exception
            # path that skipped stop() must not jump straight to the
            # hard-kill half of the contract.
            self.scheduler.source.stop()
            self.scheduler.close()
            self.scheduler.source.close()
            if wd is not None:
                wd.close()
            # retire the table's background machinery (write-back pool);
            # the table stays checkpointable — a later use respawns it
            self.table.close()
        return self.summary()

    def _next_window(self, wd):
        """Block for the next window; None once the stream is drained.
        The wait is the runner's ``feed`` stage: a wedged source stops
        the beats and the watchdog (when armed) names this stage."""
        if wd is not None:
            wd.report("feed")
        while True:
            if wd is not None:
                wd.check()
            window = self.scheduler.next_window(timeout=0.2)
            if window is not None:
                return window
            if self.scheduler.done:
                if wd is not None:
                    # a watchdog abort KILLS the hung source, which drains
                    # the scheduler — "done" may therefore be the abort's
                    # own shadow; surface the structured error, never a
                    # clean-looking empty run
                    wd.check()
                return None

    def _train_window(self, window, wd) -> None:
        if wd is not None:
            wd.report("step")
        sched = self.scheduler
        ds = sched.dataset(window)
        census_wait = self.census_wait_s
        for attempt in (0, 1):
            # pbox-lint: ignore[protocol-sparse-pass] the retrain lap only
            # re-enters after PassRolledBack, whose rollback machinery
            # already abort_pass()ed and restored the table
            self.table.begin_pass(window.census)
            try:
                # the window's lineage ID ("w<idx>") names this span AND
                # the publish entry the window lands in — the doctor
                # joins trained-window, published-entry and applied-model
                # records on it
                with telemetry.span("stream.window", window=window.index,
                                    lineage=f"w{window.index}",
                                    n_records=window.n_records):
                    metrics = self.trainer.train_from_dataset(
                        ds, self.table, auc_state=self._mstate,
                        next_pass_keys=lambda: sched.wait_census(
                            census_wait),
                    )
            except BaseException as e:
                from paddlebox_tpu_torch.train.trainer import PassRolledBack

                if isinstance(e, PassRolledBack) and attempt == 0:
                    # the poisoned window was aborted and the table
                    # restored; its records are still in hand — retrain
                    # once before surfacing
                    stats.add("stream.window_retrains")
                    _RETRAINS.inc()
                    logger.warning(
                        "window %d rolled back (%s); retraining once",
                        window.index, e,
                    )
                    self._mstate = None  # restored state owns the metrics
                    continue
                if not isinstance(e, PassRolledBack):
                    # rollback already aborted the pass; every other
                    # escape leaves it open — discard the in-flight
                    # working set so the caller sees a consistent table
                    self.table.abort_pass()
                raise
            break
        self._mstate = self.trainer.last_metric_state
        self.table.end_pass()
        self.windows_trained += 1
        self.records_trained += window.n_records
        self.last_metrics = metrics
        _WINDOWS.inc()
        if self.policy is not None:
            self.policy.observe_window(window)
            self.policy.maybe_publish(
                self.table, self.model,
                self._dense_params(), metrics=metrics,
            )
        if (
            self.checkpointer is not None
            and self.checkpoint_every_windows > 0
            and self.windows_trained % self.checkpoint_every_windows == 0
        ):
            self.checkpointer.after_pass(
                self.windows_trained - 1, self.table, self.trainer,
                metric_state=self._mstate,
            )

    # -- reporting ----------------------------------------------------------- #
    def summary(self) -> dict:
        out = {
            "windows": self.windows_trained,
            "records": self.records_trained,
            "auc": (self.last_metrics or {}).get("auc"),
        }
        if self.policy is not None:
            out.update(
                publishes=self.policy.publishes,
                publish_failures=self.policy.publish_failures,
                deadline_misses=self.policy.deadline_misses,
                backpressure_widenings=self.policy.widenings,
                last_freshness_s=self.policy.last_freshness_s,
            )
        return out
