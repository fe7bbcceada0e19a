"""Replica supervisor: spawn, babysit, restart-with-backoff.

The process-management half of the serving fleet: a
:class:`ReplicaSupervisor` launches N replica server processes (each its
own ``python -m paddlebox_tpu_torch.serve`` by default: one ScoringServer,
and one Syncer per process when a sync root is configured), watches
them from a babysitter thread, and restarts any that crash with
jittered exponential backoff (the same
:class:`~paddlebox_tpu_torch.utils.retry.RetryPolicy` curve every transient-
failure site in the package uses — a replica crash IS a transient
failure to the fleet).

A replica that crash-loops backs off deeper each consecutive crash
(``RetryPolicy.delay``); a replica that stays up for
``stable_after_s`` resets its crash streak.  Respawns run through fault
site ``fleet.restart`` so chaos plans can make restarts themselves fail
(the attempt is counted and retried on the next babysit tick with a
deeper delay).  Counter: ``fleet.restarts``.

The supervisor owns the port plan: each replica's port is bind-probed
(``find_free_port``) when the replica first joins — at construction for
the initial fleet, at :meth:`spawn_replica` time for autoscaled ones —
and then pinned for that replica's lifetime (so the router's membership
is stable across CRASH restarts: a respawned replica comes back at the
SAME address and the router's half-open probes readmit it).  A retired
replica's port goes back to the OS pool; a later spawn may legitimately
probe it again.

Elastic-fleet surface: :meth:`spawn_replica` grows the fleet by
one (fresh id, fresh bind-probed port), :meth:`retire_replica` shrinks
it deliberately — SIGTERM (the replica's graceful stop/drain path),
wait, escalate to SIGKILL past the deadline — and marks the replica
``retired`` so the babysitter NEVER resurrects it: a deliberate
retirement must not look like a crash to the restart loop.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import subprocess
import threading
import time
from typing import Callable, List, Optional

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

_RESTARTS = telemetry.counter(
    "fleet.restarts", help="crashed serving replicas respawned"
)
_RESTART_FAILURES = telemetry.counter(
    "fleet.restart_failures",
    help="replica respawn attempts that themselves failed",
)
_SPAWNS = telemetry.counter(
    "fleet.spawns", help="replicas added to the fleet after start"
)
_RETIRES = telemetry.counter(
    "fleet.retires", help="replicas deliberately retired from the fleet"
)


def find_free_port() -> int:
    from paddlebox_tpu_torch.launch import find_free_port as _f

    return _f()


@dataclasses.dataclass
class ReplicaProc:
    """One supervised replica: identity, address, live process, and the
    crash-streak bookkeeping its backoff is computed from."""

    replica_id: int
    port: int
    proc: Optional[subprocess.Popen] = None
    restarts: int = 0  # lifetime respawns
    crash_streak: int = 0  # consecutive crashes (resets when stable)
    started_at: float = 0.0
    next_restart_at: float = 0.0  # monotonic; 0 = not pending
    retired: bool = False  # deliberately removed; babysitter must not respawn

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ReplicaSupervisor:
    def __init__(
        self,
        n_replicas: int,
        argv_for: Callable[[int, int], List[str]],
        *,
        host: str = "127.0.0.1",
        ports: Optional[List[int]] = None,
        env: Optional[dict] = None,
        log_dir: Optional[str] = None,
        poll_interval_s: float = 0.2,
        restart_policy: Optional[RetryPolicy] = None,
        stable_after_s: float = 10.0,
    ):
        """argv_for(replica_id, port) -> the replica's command line.  The
        supervisor execs it verbatim (tests pass a stub server script;
        serve.py passes its own single-server invocation)."""
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.host = host
        ports = list(ports) if ports else [
            find_free_port() for _ in range(n_replicas)
        ]
        if len(ports) != n_replicas:
            raise ValueError("ports must have one entry per replica")
        self.argv_for = argv_for
        self.env = env
        self.log_dir = log_dir
        self.poll_interval_s = poll_interval_s
        # respawn backoff: many attempts, sub-second first delay — a
        # fleet wants its replica back fast, but a crash LOOP must not
        # spin (jitter from the shared per-(site, attempt) stream keeps
        # replicas from thundering back in lockstep)
        self.restart_policy = restart_policy or RetryPolicy(
            max_attempts=1_000_000, base_delay_s=0.5, max_delay_s=15.0)
        self.stable_after_s = stable_after_s
        self.replicas = [
            ReplicaProc(replica_id=i, port=p) for i, p in enumerate(ports)
        ]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # one persistent append handle per replica, reused across
        # respawns — a crash-looping replica must not leak an FD per
        # restart (the policy allows a million of them)
        self._logs: dict = {}

    # -- lifecycle ----------------------------------------------------------- #
    def endpoints(self) -> List[str]:
        """Addresses of the current (non-retired) fleet membership."""
        with self._lock:
            return [f"{self.host}:{r.port}"
                    for r in self.replicas if not r.retired]

    def _spawn(self, r: ReplicaProc) -> None:
        argv = self.argv_for(r.replica_id, r.port)
        # replica children import the package by name, but the package
        # is not installed — it resolves only from its parent dir.  The
        # supervisor's own import already found it, so pin that dir onto
        # the child's PYTHONPATH: spawning must not silently depend on
        # the supervisor's cwd being the repo root.
        env = dict(self.env if self.env is not None else os.environ)
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        pp = env.get("PYTHONPATH", "")
        if pkg_parent not in pp.split(os.pathsep):
            env["PYTHONPATH"] = \
                pkg_parent + os.pathsep + pp if pp else pkg_parent
        stdout = stderr = None
        if self.log_dir:
            out = self._logs.get(r.replica_id)
            if out is None:
                os.makedirs(self.log_dir, exist_ok=True)
                out = open(os.path.join(
                    self.log_dir, f"replica{r.replica_id}.log"), "ab")
                self._logs[r.replica_id] = out
            stdout, stderr = out, subprocess.STDOUT
        r.proc = subprocess.Popen(
            argv, env=env, stdout=stdout, stderr=stderr)
        r.started_at = time.monotonic()
        r.next_restart_at = 0.0
        logger.info("fleet: replica %d up (pid %d, port %d)",
                    r.replica_id, r.proc.pid, r.port)

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        for r in self.replicas:
            self._spawn(r)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._babysit, name="replica-supervisor", daemon=True)
        self._thread.start()

    def poll_once(self) -> None:
        """One babysit tick: detect crashed replicas, (re)spawn the ones
        whose backoff has elapsed."""
        now = time.monotonic()
        with self._lock:
            for r in self.replicas:
                if r.retired:
                    # deliberate retirement is not a crash: the babysitter
                    # must never resurrect a drained replica
                    continue
                if r.alive():
                    if r.crash_streak and \
                            now - r.started_at >= self.stable_after_s:
                        r.crash_streak = 0  # survived: streak forgiven
                    continue
                if r.proc is not None and r.next_restart_at == 0.0:
                    # fresh crash: schedule the respawn with a jittered
                    # backoff that deepens each consecutive crash
                    r.crash_streak += 1
                    delay = self.restart_policy.delay(
                        min(r.crash_streak, 30), "fleet.restart")
                    r.next_restart_at = now + delay
                    logger.warning(
                        "fleet: replica %d (pid %s) exited rc=%s; "
                        "restart %d in %.2fs", r.replica_id, r.pid,
                        r.proc.returncode, r.restarts + 1, delay)
                    self._dump_crash(r)
                if r.next_restart_at and now >= r.next_restart_at:
                    try:
                        # pbox-lint: ignore[lock-held-blocking] a hang:
                        # spec wedging the respawn under the lock is the
                        # chaos the watchdog must catch — deliberate
                        faults.inject("fleet.restart")
                        # pbox-lint: ignore[lock-held-blocking] respawn is
                        # serialized against stop()/kill_replica by design;
                        # spawn cost is bounded (log open + fork)
                        self._spawn(r)
                        r.restarts += 1
                        _RESTARTS.inc()
                    except Exception as e:
                        # the respawn itself failed (injected chaos, fork
                        # limits): deepen the backoff and try again on a
                        # later tick — the supervisor never gives up
                        _RESTART_FAILURES.inc()
                        r.crash_streak += 1
                        r.next_restart_at = now + self.restart_policy.delay(
                            min(r.crash_streak, 30), "fleet.restart")
                        logger.warning(
                            "fleet: respawn of replica %d failed (%r); "
                            "next attempt in %.2fs", r.replica_id, e,
                            r.next_restart_at - now)

    def _dump_crash(self, r: ReplicaProc) -> None:
        """Postmortem capture for a dead replica: dump the supervisor's
        own flight ring naming the child (replica id, pid, rc, port) and
        collect — by path — any dump files the child itself left in the
        shared flight dir (a SIGTERM'd replica dumps on the way out; a
        SIGKILLed one can't, which is exactly why the supervisor's dump
        must name it)."""
        from paddlebox_tpu_torch.telemetry import flight

        child_dumps: List[str] = []
        try:
            d = flight.resolve_flight_dir()
            if d and os.path.isdir(d) and r.pid is not None:
                needle = f"-pid{r.pid}-"
                child_dumps = sorted(
                    os.path.join(d, f) for f in os.listdir(d)
                    if f.startswith("flight-") and needle in f
                )
        except OSError:
            pass
        telemetry.dump_flight("replica_crash", {
            "replica_id": r.replica_id,
            "pid": r.pid,
            "returncode": r.proc.returncode if r.proc else None,
            "port": r.port,
            "crash_streak": r.crash_streak,
            "child_dumps": child_dumps,
        })

    def _babysit(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                logger.exception("supervisor tick failed; continuing")
            self._stop.wait(self.poll_interval_s)

    def restart_count(self) -> int:
        with self._lock:
            return sum(r.restarts for r in self.replicas)

    # -- elastic membership ------------------------------------------------- #
    def live_replica_ids(self) -> List[int]:
        """replica_ids still part of the fleet (spawn order preserved)."""
        with self._lock:
            return [r.replica_id for r in self.replicas if not r.retired]

    def spawn_replica(self) -> str:
        """Grow the fleet by one replica: next replica_id, fresh
        bind-probed port (NOT a static offset — under churn the next
        offset may be taken by anything, including a previously retired
        replica's reused port).  Returns the new replica's address.

        Fault site ``fleet.scale`` fires before the spawn so chaos plans
        can make scale-up itself fail; on failure nothing joins the
        fleet (the ReplicaProc is only appended after a clean spawn).
        """
        faults.inject("fleet.scale")
        port = find_free_port()
        with self._lock:
            r = ReplicaProc(replica_id=len(self.replicas), port=port)
            # pbox-lint: ignore[lock-held-blocking] spawn cost is bounded
            # (log open + fork); membership changes are serialized against
            # the babysitter by design
            self._spawn(r)
            self.replicas.append(r)
        _SPAWNS.inc()
        logger.info("fleet: scaled up — replica %d at %s:%d",
                    r.replica_id, self.host, r.port)
        return f"{self.host}:{r.port}"

    def retire_replica(self, replica_id: int,
                       timeout_s: float = 10.0) -> None:
        """Deliberately remove one replica: mark it retired FIRST (so a
        concurrent babysit tick cannot mistake the exit for a crash),
        then SIGTERM — the replica's own graceful stop: drain in-flight,
        then exit — and escalate to SIGKILL past the deadline.  The
        port returns to the OS pool; a later :meth:`spawn_replica` may
        legitimately bind-probe it again.  Idempotent."""
        with self._lock:
            r = self.replicas[replica_id]
            if r.retired:
                return
            r.retired = True
            r.next_restart_at = 0.0
            proc = r.proc if r.alive() else None
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                logger.warning(
                    "fleet: replica %d ignored SIGTERM for %.1fs; killing",
                    replica_id, timeout_s)
                proc.kill()
                proc.wait(timeout=timeout_s)
        f = self._logs.pop(replica_id, None)
        if f is not None:
            f.close()
        _RETIRES.inc()
        logger.info("fleet: retired replica %d (port %d freed)",
                    replica_id, r.port)

    def kill_replica(self, replica_id: int,
                     sig: int = signal.SIGKILL) -> int:
        """Chaos hook: signal one replica (default SIGKILL).  Returns the
        pid signalled.  The babysitter restarts it like any crash."""
        r = self.replicas[replica_id]
        if r.retired:
            raise RuntimeError(f"replica {replica_id} is retired")
        pid = r.pid
        if pid is None:
            raise RuntimeError(f"replica {replica_id} has no process")
        os.kill(pid, sig)
        return pid

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop babysitting, then terminate every replica (TERM, then
        KILL past the deadline)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        with self._lock:
            procs = [r.proc for r in self.replicas if r.alive()]
        for p in procs:
            p.terminate()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
        for f in self._logs.values():
            f.close()
        self._logs = {}
