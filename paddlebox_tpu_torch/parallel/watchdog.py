"""Distributed liveness: heartbeats, stall detection, coordinated abort
(reference: paddlebox_tpu/parallel/watchdog.py).

A multi-process job has a failure mode that single-process fault tolerance
cannot touch: a HANG.  One process stuck in a feed read, a step, a
host-plane gather or a process-group collective stalls the whole job, every
peer blocked in its next collective, with no culprit in any log.  This
module is the liveness layer of the job's planning plane:

  * every process ``report()``s its current *stage* (``feed``, ``step``,
    ``hostplane:<channel>``) with a monotonic progress counter;
  * a per-process :class:`Watchdog` thread publishes heartbeats carrying
    (stage, progress) through the job's KV store (the TCPStore the
    ``KvChannel`` gathers ride, parallel/host_plane.py) and detects both
    LOCAL stalls (our own progress frozen past the deadline) and PEER
    stalls (a peer's heartbeat progress frozen, measured by when *we* last
    saw it change, so host clock skew never matters);
  * detection converges through a POISON KEY: the first detector writes one
    key naming the culprit (rank, stage, stall age) and every watchdog
    polls it, so the whole job aborts with the SAME structured
    :class:`DistributedStallError`;
  * every bounded wait (``KvChannel`` gathers, the prefetch queue's get,
    injected-fault hangs) calls :meth:`Watchdog.check` from its poll loop,
    so an abort interrupts a blocked thread within one poll interval.

A single process runs local stall detection only (``kv=None``); tests drive
the detector through :meth:`Watchdog.tick` with an injected clock and an
:class:`InMemoryKv`.  The KV surface is ``set/get/delete`` of strings, with
the reference's semantics (``host_plane.StoreKv`` over a TCPStore,
``InMemoryKv`` in tests).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import LivenessConfig
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)

# liveness gauges: the watchdog's view of every rank, refreshed each tick.
# A slow-but-not-stalled straggler shows up HERE (staleness climbing,
# progress rate flat) passes before the deadline would ever fire — scrape
# /metrics or read the fleet snapshot instead of waiting for the abort.
_STALENESS = telemetry.gauge(
    "watchdog.staleness_s",
    help="seconds since each rank's progress counter last changed",
)
_PROGRESS = telemetry.gauge(
    "watchdog.progress", help="each rank's monotonic stage-progress counter"
)
_STAGE = telemetry.gauge(
    "watchdog.stage",
    help="1 for each rank's current stage (label churn pruned per tick)",
)


class DistributedStallError(RuntimeError):
    """A process stalled past the liveness deadline and the run aborted.

    Structured so callers and operators get a named culprit instead of a bare
    timeout: ``culprit`` (process index), ``stage`` (what it was last
    doing), ``age_s`` (how long its progress counter was frozen),
    ``progress`` (its last progress count), ``detected_by`` (which rank
    noticed) and ``kind`` ("local" | "peer" | "poison").
    """

    def __init__(
        self,
        culprit: int,
        stage: str,
        kind: str,
        age_s: float,
        progress: int,
        detected_by: int,
        message: Optional[str] = None,
    ):
        self.culprit = int(culprit)
        self.stage = stage
        self.kind = kind
        self.age_s = float(age_s)
        self.progress = int(progress)
        self.detected_by = int(detected_by)
        super().__init__(
            message
            or (
                f"distributed stall: process {self.culprit} stalled in stage "
                f"{self.stage!r} (no progress for {self.age_s:.1f}s, "
                f"progress={self.progress}; detected by process "
                f"{self.detected_by}, {self.kind} check)"
            )
        )

    def to_payload(self) -> str:
        """The poison-key payload: everything a peer needs to rebuild the
        SAME error locally (no free-text parsing on the read side)."""
        return json.dumps(
            {
                "culprit": self.culprit,
                "stage": self.stage,
                "kind": self.kind,
                "age_s": self.age_s,
                "progress": self.progress,
                "detected_by": self.detected_by,
            }
        )

    @staticmethod
    def from_payload(raw: str, reader_rank: int) -> "DistributedStallError":
        try:
            d = json.loads(raw)
            return DistributedStallError(
                culprit=d["culprit"],
                stage=d["stage"],
                kind="poison",
                age_s=d.get("age_s", 0.0),
                progress=d.get("progress", -1),
                detected_by=d.get("detected_by", reader_rank),
            )
        except (ValueError, KeyError, TypeError):
            # a corrupt poison key still means SOMEONE aborted: converge
            return DistributedStallError(
                culprit=-1, stage="unknown", kind="poison", age_s=0.0,
                progress=-1, detected_by=reader_rank,
                message=f"distributed abort via poison key (payload {raw!r})",
            )


# --------------------------------------------------------------------------- #
# staleness math (pure, unit-testable)
# --------------------------------------------------------------------------- #
class PeerTracker:
    """Progress-staleness accounting over observed (stage, progress) pairs.

    The tracked age of a peer is measured from when the OBSERVER last saw
    its progress counter change (or from first tracking, for a peer that
    never reported) — never from timestamps inside the heartbeat, so host
    clock skew cannot fake or mask a stall.  Used for peers (fed from KV
    heartbeats) and for the local process itself (fed from the in-process
    stage state): one math, two sources.
    """

    def __init__(self):
        # rank -> (progress, stage, local time progress last changed)
        self._seen: Dict[int, Tuple[int, str, float]] = {}

    def observe(self, rank: int, progress: int, stage: str, now: float) -> None:
        prev = self._seen.get(rank)
        if prev is None or progress != prev[0]:
            self._seen[rank] = (progress, stage, now)
        else:
            # progress frozen: keep the original change time, refresh stage
            # (a live heartbeat may still rotate its stage label)
            self._seen[rank] = (prev[0], stage, prev[2])

    def age(self, rank: int, now: float) -> Optional[float]:
        """Seconds since ``rank``'s progress last changed (None = never
        observed)."""
        prev = self._seen.get(rank)
        return None if prev is None else now - prev[2]

    def last(self, rank: int) -> Tuple[int, str]:
        """(progress, stage) last observed for ``rank``."""
        prev = self._seen.get(rank)
        return (-1, "unknown") if prev is None else (prev[0], prev[1])

    def stale(self, now: float, deadline_s: float) -> list:
        """[(rank, age_s, progress, stage)] of every tracked rank whose
        progress has been frozen longer than ``deadline_s``."""
        out = []
        for rank, (progress, stage, t) in sorted(self._seen.items()):
            age = now - t
            if age > deadline_s:
                out.append((rank, age, progress, stage))
        return out

    def deregister(self, rank: int) -> None:
        """Deliberate membership shrink (a drained or retired rank leaves
        the fleet on purpose).  Forget the rank entirely — its
        frozen progress counter is expected, not a stall, and it must
        never be named a culprit by :meth:`stale` again.  Idempotent."""
        self._seen.pop(rank, None)


# --------------------------------------------------------------------------- #
# KV transports
# --------------------------------------------------------------------------- #
class InMemoryKv:
    """Process-local KV store with the job store's surface: simulated
    multi-worker tests share ONE of these across their fake ranks'
    watchdogs; single-process runs need none (``Watchdog(kv=None)`` does
    local stall detection only)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, str] = {}

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._data.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


# --------------------------------------------------------------------------- #
# the watchdog
# --------------------------------------------------------------------------- #
class Watchdog:
    """Per-process liveness monitor + coordinated-abort participant.

    Lifecycle: construct with the process's (rank, world) and a KV store
    (None = single-process, local checks only), ``start()`` the monitor
    thread, ``report(stage)`` from the pipeline's hot points, and wrap
    every bounded wait's poll loop with ``check()``.  ``close()`` always —
    it retires the thread, unhooks the fault-injection hang interrupt and
    deletes this process's heartbeat key.  Context-manager form does
    start/close.
    """

    def __init__(
        self,
        conf: Optional[LivenessConfig] = None,
        *,
        rank: int = 0,
        world: int = 1,
        kv=None,
        namespace: str = "default",
        clock: Callable[[], float] = time.monotonic,
        install_current: bool = True,
        hard_exit_grace_s: Optional[float] = None,
    ):
        self.conf = conf or LivenessConfig.from_flags()
        self.rank = int(rank)
        self.world = int(world)
        self.kv = kv
        self.namespace = namespace
        self._clock = clock
        self._install_current = install_current
        # multi-process escape hatch: a rank wedged inside a device
        # collective can't unwind via Python, so after the grace the
        # process hard-exits and the launcher/pod controller reaps the
        # fleet.  close() cancels it — a cleanly-unwound run never exits.
        self._hard_exit_grace_s = (
            hard_exit_grace_s
            if hard_exit_grace_s is not None and hard_exit_grace_s > 0
            else None
        )
        self._hard_exit_cancel = threading.Event()
        self._lock = threading.Lock()
        self._stage = "start"
        self._progress = 0
        self._tracker = PeerTracker()
        self._last_hb = -float("inf")
        self._aborted = threading.Event()
        self._error: Optional[DistributedStallError] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._unhook: Optional[Callable[[], None]] = None
        # deliberately-retired peers (elastic shrink): skipped by the
        # peer sweep, ignored as poison culprits
        self._retired: set = set()
        # the local process starts tracked from construction time: a run
        # that never reports ANY stage is itself a stall (stage "start")
        self._tracker.observe(self.rank, 0, "start", self._clock())
        # rank -> last exported stage label (so the stage gauge's old
        # series is removed when a rank's stage rotates)
        self._exported_stage: Dict[int, str] = {}

    # -- keys --------------------------------------------------------------- #
    def _hb_key(self, rank: int) -> str:
        return f"pbox_wd/{self.namespace}/hb/{rank}"

    @property
    def poison_key(self) -> str:
        return f"pbox_wd/{self.namespace}/poison"

    # -- stage reporting ---------------------------------------------------- #
    def report(self, stage: str) -> None:
        """Record progress: the caller is alive and entering ``stage``.
        Callable from any thread (feed producer, consumer, shuffler)."""
        with self._lock:
            self._stage = stage
            self._progress += 1

    def state(self) -> Tuple[str, int]:
        with self._lock:
            return self._stage, self._progress

    # -- abort plumbing ----------------------------------------------------- #
    @property
    def aborted(self) -> bool:
        return self._aborted.is_set()

    @property
    def error(self) -> Optional[DistributedStallError]:
        return self._error

    def check(self) -> None:
        """Raise the abort error if the run has been poisoned/stalled.
        Bounded waits call this from their poll loops; injected-fault hang
        loops call it too (registered via faults.register_hang_interrupt),
        so even a simulated freeze terminates with the structured error."""
        if self._aborted.is_set():
            assert self._error is not None
            raise self._error

    def check_poison(self) -> None:
        """Read the poison key now, then ``check()``: for a waiter whose
        peer vanished mid-collective (an aborting peer leaves at once), so
        the job's structured error surfaces without waiting for the
        monitor thread's next tick."""
        if not self._aborted.is_set():
            self._check_poison(self._clock())
        self.check()

    def abort(self, err: DistributedStallError, poison: bool = True) -> None:
        """Converge the fleet on ``err``: publish the poison key (unless
        we're reacting to one) and trip the local abort latch."""
        if self._aborted.is_set():
            return
        if poison and self.kv is not None:
            try:
                self.kv.set(self.poison_key, err.to_payload())
                stats.add("watchdog.poison_set")
            except Exception:
                logger.exception("watchdog: failed to publish poison key")
        # pbox-lint: ignore[thread-shared-state] written before the
        # _aborted Event trips; readers check the Event first — it is the
        # fence
        self._error = err
        self._aborted.set()
        stats.add("watchdog.aborts")
        logger.error("watchdog abort: %s", err)
        # crash-time capture: every rank dumps its OWN flight ring as the
        # abort latch trips — the culprit's dump shows what it was doing
        # when it froze, the peers' dumps show what the stall blocked
        # (pbox_doctor merges them and names who stalled first)
        telemetry.dump_flight("stall", {
            "culprit": err.culprit, "stage": err.stage, "kind": err.kind,
            "age_s": err.age_s, "progress": err.progress,
            "detected_by": err.detected_by, "rank": self.rank,
        })
        if self._hard_exit_grace_s is not None:
            threading.Thread(
                target=self._hard_exit_reaper,
                name=f"pbox-watchdog-reaper-r{self.rank}",
                daemon=True,
            ).start()

    def _hard_exit_reaper(self) -> None:
        if self._hard_exit_cancel.wait(self._hard_exit_grace_s):
            return  # clean unwind won the race
        import os

        logger.error(
            "watchdog: process %d did not unwind within %.1fs of abort "
            "(wedged in a device collective?); hard-exiting 124 — %s",
            self.rank, self._hard_exit_grace_s, self._error,
        )
        # best effort: make the culprit visible on stderr even when
        # logging isn't configured in this process
        print(
            f"[pbox-watchdog] hard exit (rank {self.rank}): {self._error}",
            flush=True,
        )
        os._exit(124)

    # -- detector ----------------------------------------------------------- #
    def _publish_heartbeat(self, now: float) -> None:
        if self.kv is None:
            return
        if now - self._last_hb < self.conf.heartbeat_interval_s:
            return
        try:
            # chaos site: a hang here freezes THIS watchdog's publisher —
            # exactly a dead-process signature — and peers must catch it
            faults.inject("watchdog.heartbeat")
        except faults.FaultInjected:
            stats.add("watchdog.heartbeat_faults")
            return
        stage, progress = self.state()
        try:
            self.kv.set(
                self._hb_key(self.rank),
                json.dumps(
                    {"rank": self.rank, "stage": stage, "progress": progress}
                ),
            )
            self._last_hb = now
            stats.add("watchdog.heartbeats")
        except Exception:
            logger.exception("watchdog: heartbeat publish failed")

    def retire_peer(self, rank: int) -> None:
        """Deliberate membership shrink: ``rank`` drained and left the
        fleet on purpose.  Deregister it from staleness tracking (its
        frozen heartbeat is EXPECTED — it must never be named a stall
        culprit), prune its liveness gauges, and best-effort delete its
        heartbeat key (a retired rank killed mid-drain can't clean up
        after itself).  A poison payload naming a retired culprit is
        ignored by :meth:`_check_poison`.  Idempotent."""
        rank = int(rank)
        if rank == self.rank:
            raise ValueError("a watchdog cannot retire its own rank")
        with self._lock:
            self._retired.add(rank)
        self._tracker.deregister(rank)
        _STALENESS.remove(rank=str(rank))
        _PROGRESS.remove(rank=str(rank))
        prev = self._exported_stage.pop(rank, None)
        if prev is not None:
            _STAGE.remove(rank=str(rank), stage=prev)
        if self.kv is not None:
            try:
                self.kv.delete(self._hb_key(rank))
            except Exception:
                logger.debug("retired peer %d heartbeat cleanup failed",
                             rank, exc_info=True)
        stats.add("watchdog.peers_retired")
        logger.info("watchdog: rank %d retired from liveness tracking "
                    "(deliberate membership shrink)", rank)

    def _is_retired(self, rank: int) -> bool:
        with self._lock:
            return rank in self._retired

    def _check_poison(self, now: float) -> bool:
        if self.kv is None:
            return False
        raw = self.kv.get(self.poison_key)
        if raw is None:
            return False
        err = DistributedStallError.from_payload(raw, self.rank)
        if self._is_retired(err.culprit):
            # a racing detector named a peer that was deliberately
            # retired (it saw the drain, not a stall): this poison is
            # stale — drop it so the fleet doesn't converge on a
            # non-error, and best-effort clear the key
            stats.add("watchdog.poison_retired_ignored")
            logger.warning(
                "watchdog: ignoring poison naming retired rank %d",
                err.culprit)
            try:
                self.kv.delete(self.poison_key)
            except Exception:
                logger.debug("stale poison cleanup failed", exc_info=True)
            return False
        self.abort(err, poison=False)
        return True

    def _check_local(self, now: float) -> bool:
        stage, progress = self.state()
        self._tracker.observe(self.rank, progress, stage, now)
        age = self._tracker.age(self.rank, now)
        if age is not None and age > self.conf.deadline_s:
            self.abort(
                DistributedStallError(
                    culprit=self.rank, stage=stage, kind="local", age_s=age,
                    progress=progress, detected_by=self.rank,
                )
            )
            return True
        return False

    def _check_peers(self, now: float) -> bool:
        if self.kv is None:
            return False
        for r in range(self.world):
            if r == self.rank or self._is_retired(r):
                continue
            raw = self.kv.get(self._hb_key(r))
            if raw is None:
                # never-published peers start their staleness clock at our
                # first attempt to observe them (observe with progress -1)
                self._tracker.observe(r, -1, "unstarted", now)
                continue
            try:
                hb = json.loads(raw)
                self._tracker.observe(
                    r, int(hb["progress"]), str(hb["stage"]), now
                )
            except (ValueError, KeyError, TypeError):
                logger.warning("watchdog: bad heartbeat from rank %d: %r", r, raw)
        for rank, age, progress, stage in self._tracker.stale(
            now, self.conf.deadline_s
        ):
            if rank == self.rank or self._is_retired(rank):
                continue  # local check covers us; retired is deliberate
            self.abort(
                DistributedStallError(
                    culprit=rank, stage=stage, kind="peer", age_s=age,
                    progress=progress, detected_by=self.rank,
                )
            )
            return True
        return False

    def _export_gauges(self, now: float) -> None:
        """Refresh the liveness gauges from the tracker: per-rank
        staleness + progress, and a 1-valued stage gauge whose stale
        series are pruned as stages rotate."""
        for rank in sorted(self._tracker._seen):
            age = self._tracker.age(rank, now)
            progress, stage = self._tracker.last(rank)
            if age is not None:
                _STALENESS.set(age, rank=str(rank))
            _PROGRESS.set(progress, rank=str(rank))
            prev = self._exported_stage.get(rank)
            if prev is not None and prev != stage:
                _STAGE.remove(rank=str(rank), stage=prev)
            self._exported_stage[rank] = stage
            _STAGE.set(1, rank=str(rank), stage=stage)

    def tick(self, now: Optional[float] = None) -> bool:
        """One detector round (heartbeat + poison + local + peers).
        Returns True when this tick aborted the run.  The monitor thread
        calls it on the poll cadence; tests call it directly with a fake
        clock for deterministic staleness/convergence coverage."""
        if self._aborted.is_set():
            return True
        now = self._clock() if now is None else now
        self._publish_heartbeat(now)
        out = (
            self._check_poison(now)
            or self._check_local(now)
            or self._check_peers(now)
        )
        self._export_gauges(now)
        return out

    # -- lifecycle ---------------------------------------------------------- #
    def _run(self) -> None:
        while not self._stop.wait(self.conf.poll_interval_s):
            try:
                if self.tick():
                    return
            except Exception:
                # the monitor must never die silently: a crashed watchdog
                # is a liveness hole
                logger.exception("watchdog tick failed")

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        if self._install_current:
            _install_current(self)
        # injected hangs (utils/faults "hang:" specs) poll this check, so a
        # frozen stage raises the structured stall error at the hang site
        self._unhook = faults.register_hang_interrupt(self.check)
        self._thread = threading.Thread(
            target=self._run, name=f"pbox-watchdog-r{self.rank}", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._hard_exit_cancel.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._unhook is not None:
            self._unhook()
            self._unhook = None
        if self._install_current:
            _uninstall_current(self)
        if self.kv is not None:
            try:
                self.kv.delete(self._hb_key(self.rank))
            except Exception:
                logger.debug("heartbeat key cleanup failed on close "
                             "(stale key ages out)", exc_info=True)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------- #
# process-wide current watchdog (stage beats from any layer)
# --------------------------------------------------------------------------- #
_current_lock = threading.Lock()
_current: Optional[Watchdog] = None


def _install_current(wd: Watchdog) -> None:
    global _current
    with _current_lock:
        _current = wd


def _uninstall_current(wd: Watchdog) -> None:
    global _current
    with _current_lock:
        if _current is wd:
            _current = None


def current() -> Optional[Watchdog]:
    """The process's active watchdog (None outside a guarded run)."""
    with _current_lock:
        return _current


def beat(stage: str) -> None:
    """Report progress to the active watchdog, if any — the no-op-when-idle
    hook lower layers (feed assembly, host collectives, shuffle) call
    without holding a watchdog reference."""
    wd = current()
    if wd is not None:
        wd.report(stage)


def check() -> None:
    """Raise the active watchdog's abort error, if an abort is pending —
    for poll loops in layers that only know the module, not the instance."""
    wd = current()
    if wd is not None:
        wd.check()


def for_trainer(conf: Optional[LivenessConfig], namespace: str) -> Optional[Watchdog]:
    """Build (not start) the watchdog a trainer pass runs under: None when
    liveness is off; KV-backed (the job's TCPStore) inside a
    multi-process job (parallel/mesh.py:initialize_distributed), local
    checks only otherwise."""
    if conf is None or not conf.enabled:
        return None
    from paddlebox_tpu_torch.parallel import mesh

    rank, world, kv = 0, 1, None
    job = mesh.job()
    if job is not None and job.world > 1:
        from paddlebox_tpu_torch.parallel.host_plane import StoreKv

        rank, world, kv = job.rank, job.world, StoreKv(job.store)
    return Watchdog(
        conf, rank=rank, world=world, kv=kv, namespace=namespace,
        # hard exit is a multi-process convergence tool only: a wedged
        # single-process run can always be interrupted, and tests must
        # never be os._exit()ed from a background thread
        hard_exit_grace_s=conf.hard_exit_grace_s if kv is not None else None,
    )
