"""The port's elastic fleet (serving_fleet/ supervisor spawn and retire,
router add and remove, the FleetAutoscaler) against the JAX package's
(port of tests/test_elastic_fleet.py).

  * the autoscaler's ``tick`` decisions equal the reference
    FleetAutoscaler's over one scripted run of signals (queue depth,
    admission wait, shed rate) with the same stub supervisor and router;
  * the reference's cases: spawn with a fresh port, a retired replica
    never resurrected and its port freed, the ``fleet.scale`` site, router
    membership, the hysteresis (streak, dead band, cooldown, bounds),
    drain-then-retire LIFO, the ``fleet.drain`` site, and the rolling
    restart's freshness gate and races, with a ``hang:``-wedged drain
    bounded by the watchdog;
  * a real drain: a replica with work in flight leaves the routing set
    first and retires only once its queue empties.
"""

import http.client
import signal
import socket
import sys
import threading
import time

import pytest
import torch

import paddlebox_tpu.serving_fleet as ref_fleet
from paddlebox_tpu.serving_fleet.router import _REQUESTS as REF_REQUESTS

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import LivenessConfig
from paddlebox_tpu_torch.parallel.watchdog import Watchdog
from paddlebox_tpu_torch.serving_fleet import (
    EJECTED,
    AutoscalerConfig,
    FleetAutoscaler,
    FleetRouter,
    ReplicaProc,
    ReplicaSupervisor,
)
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.faults import FaultInjected, fault_plan
from paddlebox_tpu_torch.utils.retry import RetryPolicy
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

_SLEEPER = [sys.executable, "-c", "import time; time.sleep(300)"]


class _PORT:
    AutoscalerConfig = AutoscalerConfig
    FleetAutoscaler = FleetAutoscaler


def _fast_policy():
    return RetryPolicy(max_attempts=1_000_000, base_delay_s=0.05,
                       max_delay_s=0.2)


def _supervisor(n=1):
    return ReplicaSupervisor(
        n, lambda rid, port: _SLEEPER, poll_interval_s=0.05,
        restart_policy=_fast_policy(), stable_after_s=0.5,
    )


def _wait_until(cond, timeout_s=15.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return cond()


# --------------------------------------------------------------------------- #
# supervisor elastic membership
# --------------------------------------------------------------------------- #
def test_spawn_replica_grows_fleet_with_fresh_port():
    sup = _supervisor(1)
    sup.start()
    try:
        spawns = telemetry.counter("fleet.spawns")
        base = spawns.value()
        addr = sup.spawn_replica()
        assert len(sup.replicas) == 2
        assert sup.replicas[1].alive()
        assert addr == f"{sup.host}:{sup.replicas[1].port}"
        assert sup.endpoints() == [f"{sup.host}:{r.port}"
                                   for r in sup.replicas]
        # the port is bind-probed fresh, never a static offset collision
        assert sup.replicas[1].port != sup.replicas[0].port
        assert spawns.value() == base + 1
        assert sup.live_replica_ids() == [0, 1]
    finally:
        sup.stop()


def test_retired_replica_never_resurrected():
    """The babysitter must treat a deliberate retirement as membership,
    not as a crash: across many poll ticks the retired replica stays
    down, keeps restarts == 0, and leaves the endpoint list."""
    sup = _supervisor(2)
    sup.start()
    try:
        sup.retire_replica(1)
        assert not sup.replicas[1].alive()
        assert sup.endpoints() == [f"{sup.host}:{sup.replicas[0].port}"]
        assert sup.live_replica_ids() == [0]
        # give the babysitter many chances to wrongly respawn it
        for _ in range(6):
            sup.poll_once()
            time.sleep(0.05)
        assert not sup.replicas[1].alive()
        assert sup.replicas[1].restarts == 0
        # a retired replica is no longer a chaos target either
        with pytest.raises(RuntimeError):
            sup.kill_replica(1)
        sup.retire_replica(1)  # idempotent
    finally:
        sup.stop()


def test_retired_port_returns_to_the_os_pool():
    sup = _supervisor(2)
    sup.start()
    try:
        port = sup.replicas[1].port
        sup.retire_replica(1)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))  # freed: a later spawn may take it
        finally:
            s.close()
    finally:
        sup.stop()


def test_scale_fault_site_aborts_spawn_cleanly():
    """Chaos at fleet.scale: the scale-up fails BEFORE anything joins the
    fleet — membership unchanged, and the next attempt succeeds."""
    sup = _supervisor(1)
    sup.start()
    try:
        with fault_plan({"fleet.scale": "first:1"}):
            with pytest.raises(FaultInjected):
                sup.spawn_replica()
            assert len(sup.replicas) == 1
            assert len(sup.endpoints()) == 1
            sup.spawn_replica()  # first:1 spent: recovery is clean
            assert len(sup.replicas) == 2 and sup.replicas[1].alive()
    finally:
        sup.stop()


# --------------------------------------------------------------------------- #
# router dynamic membership
# --------------------------------------------------------------------------- #
def test_router_add_remove_replica():
    router = FleetRouter(["127.0.0.1:1"], recover_after=2)
    h = router.add_replica("127.0.0.1:2")
    assert [r["addr"] for r in router.fleet_view()["replicas"]] == \
        ["127.0.0.1:1", "127.0.0.1:2"]
    # unproven: it starts ejected, one clean probe from admission
    assert h.state == EJECTED
    assert h.consecutive_ok == 1
    assert router.add_replica("127.0.0.1:2") is h  # idempotent on addr
    assert len(router.replicas) == 2
    router.remove_replica("127.0.0.1:2")
    assert [r["addr"] for r in router.fleet_view()["replicas"]] == \
        ["127.0.0.1:1"]
    router.remove_replica("127.0.0.1:2")  # idempotent too
    # bare port normalizes like the constructor's endpoints do
    router.add_replica("7777")
    assert router.replicas[-1].addr == "127.0.0.1:7777"


# --------------------------------------------------------------------------- #
# autoscaler decisions (fake clock + stub supervisor/router)
# --------------------------------------------------------------------------- #
class _StubSupervisor:
    """Membership bookkeeping without processes: ports are fake (nothing
    listens, so _await_drain's probe sees OSError == already drained)."""

    def __init__(self, n=1, proc_cls=ReplicaProc):
        self.host = "127.0.0.1"
        self.proc_cls = proc_cls
        self.replicas = [proc_cls(replica_id=i, port=40000 + i)
                         for i in range(n)]
        self.killed = []

    def endpoints(self):
        return [f"{self.host}:{r.port}"
                for r in self.replicas if not r.retired]

    def live_replica_ids(self):
        return [r.replica_id for r in self.replicas if not r.retired]

    def spawn_replica(self):
        faults.inject("fleet.scale")
        r = self.proc_cls(replica_id=len(self.replicas),
                          port=40000 + len(self.replicas))
        self.replicas.append(r)
        return f"{self.host}:{r.port}"

    def retire_replica(self, replica_id, timeout_s=10.0):
        self.replicas[replica_id].retired = True

    def kill_replica(self, replica_id, sig=signal.SIGKILL):
        if self.replicas[replica_id].retired:
            raise RuntimeError(f"replica {replica_id} is retired")
        self.killed.append((replica_id, sig))
        return 1000 + replica_id


class _StubRouter:
    """Canned fleet_view + membership recording."""

    def __init__(self):
        self.rows = []
        self.added = []
        self.removed = []

    def set_pressure(self, addrs, queue_depth=0.0, wait_s=0.0,
                     age_seconds=1.0):
        self.rows = [
            {"addr": a, "state": "healthy", "queue_depth": queue_depth,
             "estimated_wait_s": wait_s,
             "models": {"live": {"seq": 7, "age_seconds": age_seconds}}}
            for a in addrs
        ]

    def fleet_view(self):
        return {"replicas": list(self.rows)}

    def add_replica(self, addr):
        self.added.append(addr)

    def remove_replica(self, addr):
        self.removed.append(addr)
        self.rows = [r for r in self.rows if r["addr"] != addr]


def _scaler(sup, router, pkg=None, **over):
    opts = dict(min_replicas=1, max_replicas=4, cooldown_s=30.0,
                up_after=3, down_after=5, drain_timeout_s=0.2)
    opts.update(over)
    conf = (pkg or _PORT).AutoscalerConfig(**opts)
    clock = [1000.0]

    def _clock():
        # every read advances a little, so the autoscaler's internal
        # deadline-bounded waits always terminate under the fake clock
        # (tick() itself is driven by the explicit now= below)
        clock[0] += 0.05
        return clock[0]

    a = (pkg or _PORT).FleetAutoscaler(sup, router, conf, clock=_clock)
    return a, clock


def test_autoscaler_needs_a_streak_not_one_spike():
    sup, router = _StubSupervisor(1), _StubRouter()
    a, clock = _scaler(sup, router)
    router.set_pressure(sup.endpoints(), queue_depth=10.0)
    assert a.tick(now=clock[0]) is None  # tick 1: pressured, no action
    clock[0] += 1
    assert a.tick(now=clock[0]) is None  # tick 2
    clock[0] += 1
    # one calm tick in between resets the streak entirely
    router.set_pressure(sup.endpoints(), queue_depth=2.0)  # dead band
    assert a.tick(now=clock[0]) is None
    router.set_pressure(sup.endpoints(), queue_depth=10.0)
    for _ in range(2):
        clock[0] += 1
        assert a.tick(now=clock[0]) is None
    clock[0] += 1
    assert a.tick(now=clock[0]) == "up"  # 3rd consecutive pressured tick
    assert len(sup.replicas) == 2
    assert router.added == [sup.endpoints()[-1]]


def test_autoscaler_cooldown_blocks_back_to_back_actions():
    sup, router = _StubSupervisor(1), _StubRouter()
    a, clock = _scaler(sup, router)
    router.set_pressure(sup.endpoints(), queue_depth=10.0)
    for _ in range(3):
        clock[0] += 1
        last = a.tick(now=clock[0])
    assert last == "up"
    t_up = clock[0]
    # keep the pressure on: nothing may fire inside the cooldown window
    for _ in range(20):
        clock[0] += 1
        router.set_pressure(sup.endpoints(), queue_depth=10.0)
        assert a.tick(now=clock[0]) is None
    assert len(sup.replicas) == 2
    # past cooldown the still-standing pressure streak acts again
    clock[0] = t_up + 31.0
    results = []
    for _ in range(3):
        clock[0] += 1
        router.set_pressure(sup.endpoints(), queue_depth=10.0)
        results.append(a.tick(now=clock[0]))
    assert "up" in results and len(sup.replicas) == 3


def test_autoscaler_scale_down_is_drain_then_retire_lifo():
    sup, router = _StubSupervisor(3), _StubRouter()
    a, clock = _scaler(sup, router)
    victim_addr = sup.endpoints()[-1]
    for _ in range(5):
        clock[0] += 1
        router.set_pressure(sup.endpoints(), queue_depth=0.0)
        last = a.tick(now=clock[0])
    assert last == "down"
    # newest replica drained out: unrouted FIRST, then retired
    assert router.removed == [victim_addr]
    assert sup.live_replica_ids() == [0, 1]
    assert sup.replicas[2].retired


def test_autoscaler_respects_min_and_max():
    sup, router = _StubSupervisor(1), _StubRouter()
    a, clock = _scaler(sup, router, max_replicas=1)
    for _ in range(10):  # pressured at the ceiling: hold
        clock[0] += 1
        router.set_pressure(sup.endpoints(), queue_depth=10.0)
        assert a.tick(now=clock[0]) is None
    assert len(sup.replicas) == 1
    for _ in range(10):  # idle at the floor: hold
        clock[0] += 1
        router.set_pressure(sup.endpoints(), queue_depth=0.0)
        assert a.tick(now=clock[0]) is None
    assert sup.live_replica_ids() == [0]
    with pytest.raises(ValueError):
        FleetAutoscaler(sup, router, AutoscalerConfig(min_replicas=0))
    with pytest.raises(ValueError):
        FleetAutoscaler(sup, router,
                        AutoscalerConfig(min_replicas=3, max_replicas=2))


def test_autoscaler_shed_rate_pressures_and_spike_scales_up():
    from paddlebox_tpu_torch.serving_fleet.router import _REQUESTS

    sup, router = _StubSupervisor(1), _StubRouter()
    a, clock = _scaler(sup, router)
    router.set_pressure(sup.endpoints(), queue_depth=0.0)
    a.tick(now=clock[0])  # prime the shed-rate baseline
    for _ in range(3):
        clock[0] += 1
        _REQUESTS.inc(2, outcome="shed")  # 2 sheds/s > up_shed_rate
        last = a.tick(now=clock[0])
    assert last == "up"


def test_injected_scale_failure_leaves_fleet_unchanged():
    """Chaos at fleet.scale THROUGH the autoscaler: the action fails, the
    decision loop logs + holds (cooldown applies), membership intact."""
    sup, router = _StubSupervisor(1), _StubRouter()
    a, clock = _scaler(sup, router)
    with fault_plan({"fleet.scale": "first:1"}):
        router.set_pressure(sup.endpoints(), queue_depth=10.0)
        for _ in range(3):
            clock[0] += 1
            last = a.tick(now=clock[0])
    assert last is None  # the failed action reports no scale event
    assert len(sup.replicas) == 1
    assert router.added == []


def test_drain_fault_abandons_but_still_retires():
    sup, router = _StubSupervisor(2), _StubRouter()
    a, clock = _scaler(sup, router)
    with fault_plan({"fleet.drain": "first:1"}):
        a.drain_replica(1)
    # the drain chaos-failed, but the replica was already unrouted — the
    # retirement must proceed (abandoning can only drop already-lost work)
    assert router.removed == [f"{sup.host}:{sup.replicas[1].port}"]
    assert sup.replicas[1].retired


# --------------------------------------------------------------------------- #
# rolling restart
# --------------------------------------------------------------------------- #
def test_rolling_restart_recycles_one_at_a_time():
    sup, router = _StubSupervisor(3), _StubRouter()
    a, clock = _scaler(sup, router)
    addrs = sup.endpoints()

    orig_remove = router.remove_replica

    def remove_and_restore(addr):
        orig_remove(addr)
        # the babysitter "respawns at the same port": the stub router's
        # next view shows every addr serving again (same membership)
        router.set_pressure(addrs)

    router.remove_replica = remove_and_restore
    router.set_pressure(addrs)
    rolled = a.rolling_restart(freshness_max_age_s=60.0,
                               replica_timeout_s=1.0)
    assert rolled == [0, 1, 2]
    # each victim left the routing set exactly once, SIGTERM'd (graceful
    # stop), and re-admitted before the next was touched
    assert router.removed == addrs
    assert router.added == addrs
    assert sup.killed == [(0, signal.SIGTERM), (1, signal.SIGTERM),
                          (2, signal.SIGTERM)]
    rolls = telemetry.counter("fleet.rolls")
    assert rolls.value(outcome="ok") >= 3


def test_rolling_restart_skips_when_rest_of_fleet_is_stale():
    """Freshness gate: if taking the victim down would leave the fleet's
    min-freshness past the deadline, the roll must NOT touch it."""
    sup, router = _StubSupervisor(2), _StubRouter()
    a, clock = _scaler(sup, router)
    # every replica's model is 500s old: no remainder can hold the floor
    router.set_pressure(sup.endpoints(), age_seconds=500.0)
    rolled = a.rolling_restart(freshness_max_age_s=60.0,
                               replica_timeout_s=0.3)
    assert rolled == []
    assert sup.killed == []
    assert router.removed == []


def test_rolling_restart_skips_replica_retired_out_from_under_it():
    """A concurrent scale-down may retire a replica between the roll's
    snapshot and its turn: the roll must skip it (it is gone for good —
    the babysitter will not respawn it) and keep recycling the rest."""
    sup, router = _StubSupervisor(3), _StubRouter()
    a, clock = _scaler(sup, router)
    addrs = sup.endpoints()

    orig_remove = router.remove_replica

    def remove_and_restore(addr):
        orig_remove(addr)
        if addr == addrs[0]:
            # the race: a scale-down retires replica 1 while the roll is
            # still busy recycling replica 0
            sup.retire_replica(1)
        router.set_pressure(sup.endpoints())

    router.remove_replica = remove_and_restore
    router.set_pressure(addrs)
    rolled = a.rolling_restart(freshness_max_age_s=60.0,
                               replica_timeout_s=1.0)
    assert rolled == [0, 2]
    assert [rid for rid, _ in sup.killed] == [0, 2]
    assert addrs[1] not in router.added  # never touched, never re-admitted


def test_rolling_restart_survives_victim_retired_mid_drain():
    """Tighter race: the victim itself retires AFTER the roll unroutes it
    but before the SIGTERM.  kill_replica refuses (retired replicas are
    not chaos/restart targets); the roll counts it skipped, leaves it
    unrouted, and moves on instead of crashing."""
    sup, router = _StubSupervisor(3), _StubRouter()
    a, clock = _scaler(sup, router)
    addrs = sup.endpoints()

    orig_remove = router.remove_replica

    def remove_and_restore(addr):
        orig_remove(addr)
        if addr == addrs[0]:
            sup.retire_replica(0)  # retired right after its unroute
        router.set_pressure(sup.endpoints())

    router.remove_replica = remove_and_restore
    router.set_pressure(addrs)
    rolled = a.rolling_restart(replica_timeout_s=1.0)
    assert rolled == [1, 2]
    assert [rid for rid, _ in sup.killed] == [1, 2]
    assert addrs[0] not in router.added  # gone for good: stays unrouted


def test_drain_hang_bounded_by_watchdog_and_roll_continues():
    """Chaos: a ``hang:`` spec wedges the drain wait.  The watchdog's
    hang interrupt bounds it (no unbounded stall), the drain is
    abandoned, and the rolling restart still recycles EVERY replica —
    one wedged drain must not stop the roll."""
    sup, router = _StubSupervisor(2), _StubRouter()
    a, clock = _scaler(sup, router)
    addrs = sup.endpoints()

    orig_remove = router.remove_replica

    def remove_and_restore(addr):
        orig_remove(addr)
        router.set_pressure(addrs)

    router.remove_replica = remove_and_restore
    router.set_pressure(addrs)
    conf = LivenessConfig(
        deadline_s=0.3, heartbeat_interval_s=0.05, poll_interval_s=0.03)
    wd = Watchdog(conf, rank=0, world=1).start()
    try:
        with fault_plan({"fleet.drain": "hang:first:1"}):
            t0 = time.monotonic()
            rolled = a.rolling_restart(replica_timeout_s=1.0)
            assert time.monotonic() - t0 < 10.0  # bounded, not wedged
        assert rolled == [0, 1]
        assert sup.killed == [(0, signal.SIGTERM), (1, signal.SIGTERM)]
        from paddlebox_tpu_torch.utils.monitor import stats

        assert stats.get("faults.hung.fleet.drain") >= 1
    finally:
        wd.close()
        faults.clear()


# --------------------------------------------------------------------------- #
# the decisions against the reference's
# --------------------------------------------------------------------------- #
# one scripted run: per tick (queue depth, admission wait s, sheds since
# the previous tick); ticks 1 s apart
_SIGNALS = ([(10.0, 0.0, 0)] * 2 + [(2.0, 0.0, 0)] + [(10.0, 0.0, 0)] * 4
            + [(0.0, 0.5, 0)] * 3 + [(0.0, 0.0, 3)] * 3
            + [(0.0, 0.0, 0)] * 40 + [(6.0, 0.0, 0)] * 5
            + [(0.1, 0.001, 0)] * 40)


def _decisions(pkg, proc_cls, requests):
    sup, router = _StubSupervisor(1, proc_cls), _StubRouter()
    a, clock = _scaler(sup, router, pkg=pkg, cooldown_s=10.0)
    out = []
    for depth, wait, sheds in _SIGNALS:
        clock[0] += 1.0
        if sheds:
            requests.inc(sheds, outcome="shed")
        router.set_pressure(sup.endpoints(), queue_depth=depth, wait_s=wait)
        out.append((a.tick(now=clock[0]), len(sup.live_replica_ids())))
    return out, [r.retired for r in sup.replicas], router.added, \
        router.removed


def test_tick_decisions_equal_the_reference():
    from paddlebox_tpu_torch.serving_fleet.router import _REQUESTS

    got = _decisions(_PORT, ReplicaProc, _REQUESTS)
    want = _decisions(ref_fleet, ref_fleet.ReplicaProc, REF_REQUESTS)
    assert got == want
    ups = sum(d == "up" for d, _ in got[0])
    downs = sum(d == "down" for d, _ in got[0])
    assert ups >= 2 and downs >= 1, got[0]


def test_from_flags(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_AUTOSCALE_MIN_REPLICAS", "2")
    monkeypatch.setenv("PADDLEBOX_TORCH_AUTOSCALE_MAX_REPLICAS", "5")
    monkeypatch.setenv("PADDLEBOX_TORCH_AUTOSCALE_INTERVAL_S", "0.5")
    monkeypatch.setenv("PADDLEBOX_TORCH_AUTOSCALE_COOLDOWN_S", "3")
    c = AutoscalerConfig.from_flags()
    assert (c.min_replicas, c.max_replicas, c.interval_s, c.cooldown_s) == (
        2, 5, 0.5, 3.0)


def test_real_drain_waits_for_in_flight_work():
    """drain_replica on a live replica: it leaves the routing set at once,
    and the retirement waits until its queue has emptied."""
    from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
    from paddlebox_tpu_torch.inference import ScoringServer

    class _Pred:
        meta = {"n_tasks": 1, "row_width": 4}
        bucket_shapes = [(8, 64)]
        n_features = 1

    srv = ScoringServer(max_batch=1, device="cpu")
    srv.register_predictor("stub", _Pred(), DataFeedConfig(
        slots=(SlotConfig("click", type="float", is_dense=True),
               SlotConfig("s0")), batch_size=8))
    release = threading.Event()

    def slow(text, name=None):
        with srv._lock:
            release.wait(10)
        return [0.5]

    srv.score_lines = slow
    port = srv.start(port=0)
    sup = _StubSupervisor(1)
    sup.replicas[0].port = port
    router = FleetRouter([f"127.0.0.1:{port}"], probe_interval_s=60)
    a, _ = _scaler(sup, router, drain_timeout_s=10.0)
    a._clock = time.monotonic
    results = []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/score", body=b"x\n")
        results.append(conn.getresponse().status)
        conn.close()

    # one request in flight, one queued behind it
    ts = [threading.Thread(target=client) for _ in range(2)]
    for t in ts:
        t.start()
    try:
        assert _wait_until(lambda: srv.gate.queue_depth() >= 1, timeout_s=5)
        threading.Timer(0.5, release.set).start()
        t0 = time.monotonic()
        a.drain_replica(0)
        waited = time.monotonic() - t0
        assert router.replicas == []
        assert sup.replicas[0].retired
        assert waited >= 0.3, waited
    finally:
        release.set()
        for t in ts:
            t.join(10)
        srv.stop()
    assert results == [200, 200]
