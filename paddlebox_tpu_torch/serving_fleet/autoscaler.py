"""Fleet autoscaler: telemetry-driven elastic membership + rolling
restarts (reference: paddlebox_tpu/serving_fleet/autoscaler.py).

Every signal the :class:`FleetAutoscaler` acts on already existed as
exported telemetry — per-replica queue depth and admission-wait EWMA
(the ``/healthz`` payload the router's probe loop collects), and the
router's own shed outcomes (``fleet.requests{outcome=shed}``).  What was
missing was the actor: a loop that turns sustained pressure into
``ReplicaSupervisor.spawn_replica`` / drain-retire, with enough
hysteresis that flapping is structurally impossible:

  * **thresholds are asymmetric** — the scale-down low-water marks sit
    far below the scale-up high-water marks, so there is a wide dead
    band where the fleet simply holds;
  * **decisions need a streak** — one tick over threshold does nothing;
    scale-up fires only after ``up_after`` CONSECUTIVE pressured ticks
    (scale-down after ``down_after``, deliberately slower: adding
    capacity late sheds traffic, removing it late only costs a replica);
  * **cooldown** — after ANY scale action, no further action for
    ``cooldown_s`` regardless of streaks (the backstop on top of the
    dead band: a freshly spawned replica needs time to take load before
    its absence from the signals can justify another spawn).

**Retirement is a drain, never a kill**: the victim leaves the router's
routing set first (no new request can reach it), then the autoscaler
polls its ``/healthz`` until the queue empties and in-flight work
completes (fault site ``fleet.drain`` — a ``hang:`` chaos spec wedges
exactly this wait, and the watchdog's hang interrupt bounds it), and
only then does the supervisor SIGTERM it (the replica's own graceful
stop) with the ``retired`` flag set so the babysitter never resurrects
it.  A wedged drain is counted, logged, and abandoned past its deadline
— the fleet moves on; it does not hang behind one stuck replica.

**Rolling restart** (:meth:`rolling_restart`) recycles the fleet one
replica at a time for upgrades/config rolls, coordinated with the
delivery plane: before each replica goes down, the REMAINING fleet's
freshness (``serving_sync.fleet_min_freshness`` over the router's view)
must be within the staleness deadline — so the fleet-level freshness
floor (min applied seq across serving replicas) never drops below the
deadline mid-roll — and the recycled replica must probe back healthy
before the next one is touched.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import signal
import threading
import time
from typing import List, Optional

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.parallel import watchdog as watchdog_mod
from paddlebox_tpu_torch.serving_fleet.router import EJECTED, FleetRouter, _REQUESTS
from paddlebox_tpu_torch.serving_fleet.supervisor import ReplicaSupervisor
from paddlebox_tpu_torch.serving_sync.syncer import fleet_min_freshness
from paddlebox_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

_AUTOSCALE = telemetry.counter(
    "fleet.autoscale", help="autoscale actions by direction (up|down)"
)
_REPLICAS = telemetry.gauge(
    "fleet.replicas", help="current fleet size (non-retired replicas)"
)
_DRAIN_SECONDS = telemetry.histogram(
    "fleet.drain_seconds",
    help="drain-retire wait (s) from unroute to empty queue, by outcome",
)
_ROLLS = telemetry.counter(
    "fleet.rolls", help="replicas recycled by rolling restart, by outcome"
)


@dataclasses.dataclass
class AutoscalerConfig:
    """Thresholds + hysteresis for the scaling decision.  The up/down
    water marks are deliberately far apart (dead band) and the down
    streak deliberately long — see the module docstring's flap-proofing
    argument."""

    min_replicas: int = 1
    max_replicas: int = 8
    interval_s: float = 2.0  # decision cadence (threaded loop)
    cooldown_s: float = 30.0  # no action within this of the last action
    # scale-up high-water marks (ANY sustained breach scales up)
    up_queue_depth: float = 4.0  # mean queued requests per serving replica
    up_wait_s: float = 0.25  # worst per-replica admission-wait estimate
    up_shed_rate: float = 0.5  # router sheds/second since the last tick
    # scale-down low-water marks (ALL must hold to scale down)
    down_queue_depth: float = 0.5
    down_wait_s: float = 0.02
    up_after: int = 3  # consecutive pressured ticks before scaling up
    down_after: int = 10  # consecutive idle ticks before scaling down
    drain_timeout_s: float = 10.0  # bounded drain wait per retirement

    @classmethod
    def from_flags(cls) -> "AutoscalerConfig":
        from paddlebox_tpu_torch.config import flags

        return cls(
            min_replicas=int(flags.autoscale_min_replicas),
            max_replicas=int(flags.autoscale_max_replicas),
            interval_s=float(flags.autoscale_interval_s),
            cooldown_s=float(flags.autoscale_cooldown_s),
        )


class FleetAutoscaler:
    """Drives supervisor spawn/retire and router membership from the
    fleet's own telemetry.  ``tick()`` is synchronous and deterministic
    (tests drive it with a fake clock); ``start()`` runs it on a daemon
    thread at ``config.interval_s``."""

    def __init__(
        self,
        supervisor: ReplicaSupervisor,
        router: FleetRouter,
        config: Optional[AutoscalerConfig] = None,
        *,
        clock=time.monotonic,
    ):
        self.supervisor = supervisor
        self.router = router
        self.config = config or AutoscalerConfig.from_flags()
        if self.config.min_replicas < 1:
            raise ValueError("autoscale_min_replicas must be >= 1")
        if self.config.max_replicas < self.config.min_replicas:
            raise ValueError("autoscale_max_replicas < min_replicas")
        self._clock = clock
        self._lock = threading.Lock()
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_action_at = -float("inf")
        self._last_shed = _REQUESTS.value(outcome="shed")
        self._last_tick_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _REPLICAS.set(len(self.supervisor.endpoints()))

    # -- signals ------------------------------------------------------------- #
    def signals(self, now: Optional[float] = None) -> dict:
        """One snapshot of the three pressure signals: mean queue depth
        per serving replica, worst admission-wait estimate, and the
        router's shed rate since the previous snapshot."""
        now = self._clock() if now is None else now
        view = self.router.fleet_view()
        serving = [r for r in view["replicas"] if r["state"] != EJECTED]
        depths = [r["queue_depth"] for r in serving
                  if r.get("queue_depth") is not None]
        waits = [r["estimated_wait_s"] for r in serving
                 if r.get("estimated_wait_s") is not None]
        shed = _REQUESTS.value(outcome="shed")
        dt = (now - self._last_tick_at) if self._last_tick_at else None
        shed_rate = (shed - self._last_shed) / dt if dt and dt > 0 else 0.0
        self._last_shed = shed
        self._last_tick_at = now
        return {
            "n_serving": len(serving),
            "queue_depth": (sum(depths) / len(depths)) if depths else 0.0,
            "wait_s": max(waits) if waits else 0.0,
            "shed_rate": shed_rate,
        }

    def _fleet_size(self) -> int:
        return len(self.supervisor.endpoints())

    # -- decision ------------------------------------------------------------ #
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One decision round.  Returns "up"/"down" when a scale action
        fired, else None."""
        now = self._clock() if now is None else now
        sig = self.signals(now)
        c = self.config
        pressured = (
            sig["queue_depth"] > c.up_queue_depth
            or sig["wait_s"] > c.up_wait_s
            or sig["shed_rate"] > c.up_shed_rate
        )
        idle = (
            sig["queue_depth"] < c.down_queue_depth
            and sig["wait_s"] < c.down_wait_s
            and sig["shed_rate"] <= 0.0
        )
        with self._lock:
            # a pressured tick resets the idle streak and vice versa: the
            # streaks count CONSECUTIVE evidence, and the dead band
            # between the water marks resets both
            self._up_ticks = self._up_ticks + 1 if pressured else 0
            self._down_ticks = self._down_ticks + 1 if idle else 0
            in_cooldown = now - self._last_action_at < c.cooldown_s
            n = self._fleet_size()
            want_up = (self._up_ticks >= c.up_after and not in_cooldown
                       and n < c.max_replicas)
            want_down = (self._down_ticks >= c.down_after and not in_cooldown
                         and n > c.min_replicas)
        if want_up:
            try:
                self.scale_up()
            except Exception:
                logger.exception("fleet: scale-up failed; will retry after "
                                 "cooldown")
                return None
            finally:
                with self._lock:
                    self._up_ticks = self._down_ticks = 0
                    self._last_action_at = now
            return "up"
        if want_down:
            try:
                self.scale_down()
            except Exception:
                logger.exception("fleet: scale-down failed; will retry "
                                 "after cooldown")
                return None
            finally:
                with self._lock:
                    self._up_ticks = self._down_ticks = 0
                    self._last_action_at = now
            return "down"
        return None

    # -- actions ------------------------------------------------------------- #
    def scale_up(self) -> str:
        """Spawn one replica (site ``fleet.scale`` inside the
        supervisor) and admit it to the routing set; the router's next
        clean probe starts sending it traffic."""
        addr = self.supervisor.spawn_replica()
        self.router.add_replica(addr)
        _AUTOSCALE.inc(direction="up")
        _REPLICAS.set(self._fleet_size())
        logger.info("fleet: autoscaled up to %d replicas (%s joined)",
                    self._fleet_size(), addr)
        return addr

    def scale_down(self) -> int:
        """Drain-retire the newest live replica (highest replica_id:
        last in, first out keeps the long-lived base fleet stable)."""
        live = self.supervisor.live_replica_ids()
        if not live:
            raise RuntimeError("no live replica to retire")
        victim = live[-1]
        self.drain_replica(victim)
        _AUTOSCALE.inc(direction="down")
        _REPLICAS.set(self._fleet_size())
        return victim

    def _addr_of(self, replica_id: int) -> str:
        r = self.supervisor.replicas[replica_id]
        return f"{self.supervisor.host}:{r.port}"

    def drain_replica(self, replica_id: int) -> None:
        """The zero-downtime retirement sequence: unroute FIRST (no new
        request can reach the victim), wait for its queue + in-flight
        work to finish, then retire the process.  The wait is the fault
        site ``fleet.drain``: a ``hang:`` spec wedges it, the watchdog's
        hang interrupt raises out, and the fleet proceeds to retire the
        wedged replica anyway — one stuck drain must not stall a roll."""
        addr = self._addr_of(replica_id)
        self.router.remove_replica(addr)
        t0 = self._clock()
        outcome = "drained"
        with telemetry.span("fleet.drain", replica=addr):
            try:
                self._await_drain(addr)
            except Exception as e:
                # wedged or chaos-failed drain: bounded, counted, and the
                # retirement proceeds — the replica is already unrouted,
                # so abandoning its drain can only lose requests it was
                # already failing to finish
                outcome = "abandoned"
                logger.warning("fleet: drain of %s abandoned (%r); "
                               "retiring anyway", addr, e)
        _DRAIN_SECONDS.observe(self._clock() - t0, outcome=outcome)
        self.supervisor.retire_replica(replica_id)
        _REPLICAS.set(self._fleet_size())

    def _await_drain(self, addr: str) -> None:
        """Poll the victim's /healthz until its admission queue is empty
        and nothing is estimated in flight, bounded by
        ``drain_timeout_s``.  Each poll round passes through the
        ``fleet.drain`` fault site and the watchdog beat/check pair."""
        host, _, port = addr.rpartition(":")
        deadline = self._clock() + self.config.drain_timeout_s
        while True:
            faults.inject("fleet.drain")
            watchdog_mod.beat("fleet:drain")
            watchdog_mod.check()
            try:
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=2.0)
                try:
                    conn.request("GET", "/healthz")
                    payload = json.loads(conn.getresponse().read() or b"{}")
                finally:
                    conn.close()
                depth = payload.get("queue_depth") or 0
                wait = payload.get("estimated_wait_s") or 0.0
                if depth == 0 and wait <= 0.0:
                    return
            except OSError:
                return  # already gone: nothing left to drain
            if self._clock() >= deadline:
                raise TimeoutError(
                    f"replica {addr} still has queue_depth={depth} after "
                    f"{self.config.drain_timeout_s:.1f}s drain")
            time.sleep(0.05)

    # -- rolling restart ---------------------------------------------------- #
    def rolling_restart(
        self,
        *,
        freshness_max_age_s: Optional[float] = None,
        replica_timeout_s: float = 30.0,
    ) -> List[int]:
        """Recycle every live replica, one at a time, without the fleet
        freshness floor ever crossing the staleness deadline.

        Per replica: (1) gate — wait until the REST of the fleet is
        serving and fresh (``fleet_min_freshness`` max age within
        ``freshness_max_age_s``; with no bound, any serving remainder
        passes); (2) unroute + drain (site ``fleet.drain``; a wedged
        drain is abandoned and the roll CONTINUES past it); (3) SIGTERM —
        the babysitter respawns it at the same port; (4) re-admit to the
        router and wait for it to probe back non-ejected before touching
        the next replica.  Returns the replica_ids recycled."""
        live = self.supervisor.live_replica_ids()
        rolled: List[int] = []
        for rid in live:
            addr = self._addr_of(rid)
            with telemetry.span("fleet.roll", replica=addr):
                if rid not in self.supervisor.live_replica_ids():
                    # retired since the snapshot (a concurrent scale-down
                    # picked it): gone for good, nothing to recycle
                    _ROLLS.inc(outcome="skipped")
                    continue
                if not self._await_rest_fresh(addr, freshness_max_age_s,
                                              replica_timeout_s):
                    _ROLLS.inc(outcome="skipped")
                    logger.warning(
                        "fleet: roll skipped replica %d — the rest of the "
                        "fleet never reached the freshness gate", rid)
                    continue
                self.router.remove_replica(addr)
                try:
                    self._await_drain(addr)
                except Exception as e:
                    logger.warning("fleet: roll drain of %s abandoned "
                                   "(%r); restarting anyway", addr, e)
                try:
                    self.supervisor.kill_replica(rid, signal.SIGTERM)
                except RuntimeError:
                    # lost the race with a concurrent retirement mid-roll:
                    # the replica is retired (babysitter will not respawn
                    # it), so there is nothing to bring back — leave it
                    # unrouted and move on
                    _ROLLS.inc(outcome="skipped")
                    continue
                self.router.add_replica(addr)
                if self._await_serving(addr, replica_timeout_s):
                    _ROLLS.inc(outcome="ok")
                    rolled.append(rid)
                else:
                    # the recycled replica never probed back: stop the
                    # roll — continuing would eat fleet capacity one
                    # replica at a time
                    _ROLLS.inc(outcome="stuck")
                    logger.error(
                        "fleet: replica %d did not return to service "
                        "within %.1fs; halting the roll", rid,
                        replica_timeout_s)
                    break
        return rolled

    def _await_rest_fresh(self, victim_addr: str,
                          max_age_s: Optional[float],
                          timeout_s: float) -> bool:
        """Freshness gate: True once every OTHER replica needed to hold
        the fleet's freshness floor is serving and within the staleness
        deadline."""
        deadline = self._clock() + timeout_s
        while True:
            view = self.router.fleet_view()
            rest = {
                "replicas": [r for r in view["replicas"]
                             if r["addr"] != victim_addr],
            }
            f = fleet_min_freshness(rest)
            ok = f["n_serving"] >= 1
            if ok and max_age_s is not None:
                age = f["max_age_seconds"]
                ok = age is not None and age <= max_age_s
            if ok:
                return True
            if self._clock() >= deadline:
                return False
            # no watchdog check here: this wait is deadline-bounded on
            # its own, and a latched abort elsewhere must not stop the
            # roll from restoring capacity
            time.sleep(0.1)

    def _await_serving(self, addr: str, timeout_s: float) -> bool:
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            view = self.router.fleet_view()
            for r in view["replicas"]:
                if r["addr"] == addr and r["state"] != EJECTED:
                    return True
            time.sleep(0.1)
        return False

    # -- lifecycle ------------------------------------------------------------ #
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                logger.exception("autoscaler tick failed; continuing")
            self._stop.wait(self.config.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
