"""The port's serving fleet (serving_fleet/ router and supervisor, and
``serve --replicas``) against the JAX package's (port of
tests/test_serving_fleet.py's fleet cases).

  * the router's replica state machine (healthy, degraded, ejected,
    half-open recovery) steps exactly as the reference's over one scripted
    run of probe outcomes;
  * failover, ejection and recovery; degraded replicas kept but used
    last; the ``fleet.probe`` fault site; the HTTP front door with
    ``/healthz``, ``/fleet`` and ``/metrics``; the ``fleet.request`` and
    ``fleet.attempt`` spans under the client's trace and the
    ``X-PBox-Replica`` / ``X-PBox-Trace-Id`` headers; deadline-aware
    retries; the body cap at the front door; zero client failures while a
    replica dies mid-stream;
  * the supervisor's restart of a SIGKILLed replica, the deepening
    backoff, one log handle across respawns and the ``fleet.restart``
    fault site;
  * ``_replica_argv`` round trip: a replica never re-enters fleet mode;
  * the SIGKILL chaos run over replica PROCESSES (the stub of
    tests/_torch_replica_child.py): zero client failures, the restart
    observed, the fleet view converging back (the reference's
    test_fleet_sigkill_chaos_zero_client_failures);
  * a real fleet, ``python -m paddlebox_tpu_torch.serve --replicas 2
    --cpu`` on a small artifact: its ``/score`` equals one port
    ScoringServer's reply exactly, and a SIGTERM to the fleet process
    takes its replicas down with it; the same with ``--autoscale``, whose
    live autoscaler keeps ``--replicas`` as its floor on an idle fleet;
  * ``launch --serve-replicas 2``: the co-run fleet serves the model the
    job publishes, and stops with the job.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu.serving_fleet import FleetRouter as RefRouter
from paddlebox_tpu.utils import faults as ref_faults
from paddlebox_tpu_torch import serve, telemetry
from paddlebox_tpu_torch.config import (
    DataFeedConfig,
    SlotConfig,
    SparseTableConfig,
)
from paddlebox_tpu_torch.data.synth import make_synth_config
from paddlebox_tpu_torch.inference import ScoringServer, export_model
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.serving_fleet import (
    DEGRADED,
    EJECTED,
    HEALTHY,
    FleetRouter,
    ReplicaSupervisor,
)
from paddlebox_tpu_torch.serving_fleet.supervisor import find_free_port
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.telemetry import context, flight
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.faults import fault_plan
from paddlebox_tpu_torch.utils.retry import RetryPolicy
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_replica_child.py")
BODY = b"line one\nline two\n"  # 2 "instances" for the stub scorer


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def _wait_until(cond, timeout_s=15.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return cond()


class _StubPredictor:
    meta = {"n_tasks": 1, "row_width": 4}
    bucket_shapes = [(8, 64)]
    n_features = 1


def _stub_server(service_ms=1.0, tag=0.5, max_body_bytes=None):
    """The port's real ScoringServer whose scoring is a stub: ``tag`` a
    line after ``service_ms`` under the real scoring lock."""
    conf = DataFeedConfig(
        slots=(SlotConfig("click", type="float", is_dense=True),
               SlotConfig("s0")),
        batch_size=8,
    )
    srv = ScoringServer(max_batch=1, device="cpu",
                        max_body_bytes=max_body_bytes)
    srv.register_predictor("stub", _StubPredictor(), conf)

    def score_lines(text, name=None):
        lines = [ln for ln in text.decode().splitlines() if ln.strip()]
        with srv._lock:
            if service_ms:
                time.sleep(service_ms / 1e3)
        return [float(tag)] * len(lines)

    srv.score_lines = score_lines
    return srv


def _post(port, body=BODY, path="/score", headers=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        return r.status, (json.loads(data) if data else {}), dict(
            (k.lower(), v) for k, v in r.getheaders())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


# --------------------------------------------------------------------------- #
# the router's state machine against the reference's
# --------------------------------------------------------------------------- #
# a scripted run: per step, the probe outcome of each of two replicas
# ("ok", "degraded", "stale" (a fresh-looking payload whose freshest
# model is older than degraded_max_age_s), or "fail")
_SCRIPT = [("ok", "ok"), ("fail", "ok"), ("fail", "degraded"),
           ("fail", "degraded"), ("ok", "fail"), ("ok", "ok"),
           ("stale", "fail"), ("fail", "fail"), ("fail", "fail"),
           ("ok", "fail"), ("ok", "stale"), ("degraded", "ok"),
           ("ok", "ok")]


def _payload(outcome):
    if outcome == "degraded":
        return {"degraded": True, "models": {"m": {"age_seconds": 1.0}}}
    age = 500.0 if outcome == "stale" else 1.0
    return {"degraded": False, "models": {"m": {"age_seconds": age}}}


def _replay(router):
    seen = []
    for outcomes in _SCRIPT:
        for r, o in zip(router.replicas, outcomes):
            if o == "fail":
                router._note_failure(r, "scripted")
            else:
                router._note_success(r, _payload(o))
        rot = [[c.addr for c in router._candidates()] for _ in range(3)]
        seen.append(([(r.state, r.consecutive_failures, r.consecutive_ok)
                      for r in router.replicas], rot))
    return seen


def test_state_machine_steps_as_the_reference():
    kw = dict(probe_interval_s=60, eject_after=2, recover_after=2,
              degraded_max_age_s=100.0)
    addrs = ["127.0.0.1:1", "127.0.0.1:2"]
    got = _replay(FleetRouter(addrs, **kw))
    want = _replay(RefRouter(addrs, **kw))
    assert got == want
    states = {s for step in got for s, _, _ in step[0]}
    assert states == {HEALTHY, DEGRADED, EJECTED}


def test_failover_eject_and_half_open_recovery():
    srv_a, srv_b = _stub_server(tag=1.0), _stub_server(tag=2.0)
    pa, pb = srv_a.start(port=0), srv_b.start(port=0)
    router = FleetRouter([f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"],
                         probe_interval_s=60, eject_after=2,
                         recover_after=2)
    try:
        router.probe_once()
        assert [r.state for r in router.replicas] == [HEALTHY, HEALTHY]
        srv_a.stop()
        for _ in range(6):
            st, data, hdrs = router.route_request("POST", "/score", BODY, {})
            assert st == 200
            assert json.loads(data)["scores"] == [2.0, 2.0]
            assert hdrs[context.REPLICA_RESPONSE_HEADER] == \
                f"127.0.0.1:{pb}"
        router.probe_once()
        router.probe_once()
        ra = router.replicas[0]
        assert ra.state == EJECTED
        srv_a2 = _stub_server(tag=1.0)
        srv_a2.start(port=pa)
        try:
            router.probe_once()
            assert ra.state == EJECTED
            router.probe_once()
            assert ra.state == HEALTHY
            scores = {json.loads(router.route_request(
                "POST", "/score", BODY, {})[1])["scores"][0]
                for _ in range(8)}
            assert scores == {1.0, 2.0}
        finally:
            srv_a2.stop()
    finally:
        router.stop()
        srv_b.stop()


def test_degraded_deprioritized_but_kept():
    srv_a, srv_b = _stub_server(tag=1.0), _stub_server(tag=2.0)
    pa, pb = srv_a.start(port=0), srv_b.start(port=0)
    router = FleetRouter([f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"],
                         probe_interval_s=60, eject_after=2)
    try:
        srv_b.set_degraded("sync:live", "3 entries behind")
        router.probe_once()
        assert [r.state for r in router.replicas] == [HEALTHY, DEGRADED]
        view = router.fleet_view()
        assert view["n_serving"] == 2
        assert view["replicas"][1]["degraded_reasons"] == {
            "sync:live": "3 entries behind"}
        for _ in range(5):
            st, data, _ = router.route_request("POST", "/score", BODY, {})
            assert json.loads(data)["scores"][0] == 1.0
        srv_a.stop()
        for _ in range(4):
            st, data, _ = router.route_request("POST", "/score", BODY, {})
            assert st == 200 and json.loads(data)["scores"][0] == 2.0
        srv_b.clear_degraded("sync:live")
        router.probe_once()
        assert router.replicas[1].state == HEALTHY
    finally:
        router.stop()
        srv_b.stop()


def test_probe_fault_site_ejects_and_recovers():
    srv = _stub_server()
    p = srv.start(port=0)
    router = FleetRouter([f"127.0.0.1:{p}"], probe_interval_s=60,
                         eject_after=2, recover_after=1)
    try:
        router.probe_once()
        assert router.replicas[0].state == HEALTHY
        with fault_plan({"fleet.probe": "first:2"}):
            router.probe_once()
            router.probe_once()
            assert router.replicas[0].state == EJECTED
            router.probe_once()
        assert router.replicas[0].state == HEALTHY
    finally:
        router.stop()
        srv.stop()
    assert {"fleet.probe", "fleet.route", "fleet.restart", "fleet.scale",
            "fleet.drain"} <= faults.known_sites()


def test_route_fault_site_fails_over():
    srv_a, srv_b = _stub_server(tag=1.0), _stub_server(tag=2.0)
    pa, pb = srv_a.start(port=0), srv_b.start(port=0)
    router = FleetRouter([f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"],
                         probe_interval_s=60, eject_after=5)
    failovers = telemetry.counter("fleet.failovers")
    base = failovers.value()
    try:
        router.probe_once()
        with fault_plan({"fleet.route": "first:1"}):
            st, data, _ = router.route_request("POST", "/score", BODY, {})
        assert st == 200 and failovers.value() == base + 1
    finally:
        router.stop()
        srv_a.stop()
        srv_b.stop()


def test_front_door_views_spans_and_headers():
    srv_a, srv_b = _stub_server(tag=1.0), _stub_server(tag=2.0)
    pa, pb = srv_a.start(port=0), srv_b.start(port=0)
    router = FleetRouter([f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"],
                         probe_interval_s=0.1)
    rec = flight.reset_for_tests()
    try:
        port = router.start(port=0)
        caller = context.new_root()
        st, out, hdrs = _post(port, headers={
            context.TRACEPARENT_HEADER: caller.to_traceparent()})
        assert st == 200 and len(out["scores"]) == 2
        # the caller's trace continues through the router
        assert hdrs[context.TRACE_ID_RESPONSE_HEADER.lower()] == \
            caller.trace_id
        assert hdrs[context.REPLICA_RESPONSE_HEADER.lower()] in (
            f"127.0.0.1:{pa}", f"127.0.0.1:{pb}")
        spans = [r for r in rec.snapshot()
                 if r.get("name") in ("fleet.request", "fleet.attempt")]
        assert {s["name"] for s in spans} == {"fleet.request",
                                             "fleet.attempt"}
        assert all(s.get("trace_id") == caller.trace_id for s in spans)
        st, health = _get(port, "/healthz")
        assert st == 200 and health["ok"] and health["n_serving"] == 2
        st, view = _get(port, "/fleet")
        assert {r["state"] for r in view["replicas"]} == {HEALTHY}
        assert all("stub" in r["models"] for r in view["replicas"])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        text = r.read().decode()
        conn.close()
        assert r.status == 200 and "fleet_requests_total" in text
        assert _post(port, path="/nope")[0] == 404
    finally:
        router.stop()
        srv_a.stop()
        srv_b.stop()
        flight.reset_for_tests()


def test_deadline_aware_retry_math():
    seen = {}
    srv = _stub_server(tag=1.0)
    p = srv.start(port=0)
    router = FleetRouter([f"127.0.0.1:{p}"], probe_interval_s=60)
    try:
        router.probe_once()
        orig = router._forward

        def capture(r, method, path, body, headers):
            seen["deadline"] = headers.get("X-Request-Deadline-Ms")
            seen["n"] = seen.get("n", 0) + 1
            return orig(r, method, path, body, headers)

        router._forward = capture
        st, _, _ = router.route_request(
            "POST", "/score", BODY, {"X-Request-Deadline-Ms": "30000"})
        assert st == 200 and 0 < float(seen["deadline"]) <= 30000
        st, data, _ = router.route_request(
            "POST", "/score", BODY, {"X-Request-Deadline-Ms": "0.000001"})
        assert st == 504 and b"deadline" in data
        assert seen["n"] == 1  # a spent budget reaches no replica
    finally:
        router.stop()
        srv.stop()


def test_body_cap_at_the_front_door():
    srv = _stub_server()
    p = srv.start(port=0)
    router = FleetRouter([f"127.0.0.1:{p}"], probe_interval_s=0.1,
                         max_body_bytes=64)
    oversized = telemetry.counter("fleet.oversized_body")
    base = oversized.value()
    try:
        port = router.start(port=0)
        st, out, _ = _post(port, body=b"x" * 65)
        assert st == 413 and "max_body_bytes" in out["error"]
        assert oversized.value() == base + 1
        st, out, _ = _post(port)
        assert st == 200 and len(out["scores"]) == 2
    finally:
        router.stop()
        srv.stop()


def test_replica_argv_never_reenters_fleet_mode(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_SERVE_REPLICAS", "3")
    ap = serve._build_parser()
    args = ap.parse_args(["--artifact", "m=/tmp/art", "--cpu",
                          "--sync-root", "/pub", "--sync-cache", "/c",
                          "--max-queue", "7"])
    assert args.replicas == 3  # the parent is in fleet mode by the flag
    child = serve._replica_argv(args, replica_id=1, port=18080)
    assert child[1:3] == ["-m", "paddlebox_tpu_torch.serve"]
    back = ap.parse_args(child[3:])
    assert back.replicas == 0 and back.port == 18080 and back.cpu
    assert back.artifact == ["m=/tmp/art"] and back.sync_root == ["/pub"]
    assert back.sync_cache == "/c-r1" and back.max_queue == 7


def test_zero_failures_while_a_replica_dies_midstream():
    servers = [_stub_server(service_ms=2, tag=float(i + 1))
               for i in range(3)]
    ports = [s.start(port=0) for s in servers]
    router = FleetRouter([f"127.0.0.1:{p}" for p in ports],
                         probe_interval_s=0.05, eject_after=2)
    port = router.start(port=0)
    bad, tags = [], set()
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                st, out, _ = _post(port)
                if st != 200:
                    bad.append(st)
                else:
                    tags.add(out["scores"][0])
            except Exception as e:
                bad.append(repr(e))

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.4)
        servers[1].stop()
        time.sleep(0.8)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        router.stop()
        for i, s in enumerate(servers):
            if i != 1:
                s.stop()
    assert not bad, f"client-visible failures: {bad[:5]}"
    assert tags >= {1.0, 3.0}
    assert router.replicas[1].consecutive_failures > 0


# --------------------------------------------------------------------------- #
# supervisor
# --------------------------------------------------------------------------- #
_SLEEPER = [sys.executable, "-c", "import time; time.sleep(300)"]


def _fast_policy():
    return RetryPolicy(max_attempts=1_000_000, base_delay_s=0.05,
                       max_delay_s=0.2)


def test_supervisor_restarts_a_sigkilled_replica():
    sup = ReplicaSupervisor(2, lambda rid, port: _SLEEPER,
                            poll_interval_s=0.05,
                            restart_policy=_fast_policy(), stable_after_s=0.5)
    sup.start()
    try:
        assert all(r.alive() for r in sup.replicas)
        assert len(set(sup.endpoints())) == 2
        pid0 = sup.replicas[0].pid
        sup.kill_replica(0, signal.SIGKILL)
        assert _wait_until(
            lambda: sup.restart_count() >= 1 and sup.replicas[0].alive())
        assert sup.replicas[0].pid != pid0
        assert sup.replicas[1].restarts == 0
    finally:
        sup.stop()
    assert not any(r.alive() for r in sup.replicas)


def test_supervisor_backoff_deepens_on_a_crash_loop():
    crashy = [sys.executable, "-c", "raise SystemExit(1)"]
    sup = ReplicaSupervisor(
        1, lambda rid, port: crashy, poll_interval_s=0.02,
        restart_policy=RetryPolicy(max_attempts=1_000_000,
                                   base_delay_s=0.05, max_delay_s=10.0),
        stable_after_s=60.0)
    sup.start()
    try:
        assert _wait_until(lambda: sup.replicas[0].crash_streak >= 3,
                           timeout_s=20)
        r = sup.replicas[0]
        # the pending respawn sits further out than the first delay
        assert r.next_restart_at == 0.0 or \
            r.next_restart_at - time.monotonic() <= \
            sup.restart_policy.delay(min(r.crash_streak, 30), "fleet.restart")
        assert sup.restart_count() >= 1
    finally:
        sup.stop()
    assert sup.restart_policy.delay(3, "fleet.restart") > \
        sup.restart_policy.delay(1, "fleet.restart")


def test_supervisor_reuses_one_log_handle(tmp_path):
    crashy = [sys.executable, "-c", "print('boom'); raise SystemExit(1)"]
    sup = ReplicaSupervisor(
        1, lambda rid, port: crashy, poll_interval_s=0.02,
        restart_policy=RetryPolicy(max_attempts=1_000_000,
                                   base_delay_s=0.01, max_delay_s=0.05),
        stable_after_s=60.0, log_dir=str(tmp_path))
    sup.start()
    try:
        assert _wait_until(lambda: sup.restart_count() >= 3, timeout_s=20)
        assert len(sup._logs) == 1
    finally:
        sup.stop()
    assert not sup._logs
    assert "boom" in (tmp_path / "replica0.log").read_text()


def test_supervisor_restart_fault_then_recovers(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_FLIGHT_DIR", str(tmp_path))
    sup = ReplicaSupervisor(1, lambda rid, port: _SLEEPER,
                            poll_interval_s=0.05,
                            restart_policy=_fast_policy(), stable_after_s=0.5)
    failures = telemetry.counter("fleet.restart_failures")
    base = failures.value()
    sup.start()
    try:
        with fault_plan({"fleet.restart": "first:1"}):
            sup.kill_replica(0, signal.SIGKILL)
            assert _wait_until(lambda: failures.value() >= base + 1)
            assert _wait_until(lambda: sup.restart_count() >= 1
                               and sup.replicas[0].alive())
    finally:
        sup.stop()
    # the crash dump names the dead replica
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flight-")]
    assert dumps and any("replica_crash" in open(tmp_path / f).read()
                         for f in dumps)


# --------------------------------------------------------------------------- #
# the chaos run: replica processes, a real SIGKILL, zero client failures
# --------------------------------------------------------------------------- #
def test_fleet_sigkill_chaos_zero_client_failures(tmp_path):
    sup = ReplicaSupervisor(
        2, lambda rid, port: [sys.executable, CHILD, "--port", str(port),
                              "--service-ms", "2"],
        log_dir=str(tmp_path / "logs"), poll_interval_s=0.1,
        restart_policy=_fast_policy(), stable_after_s=1.0)
    sup.start()
    router = FleetRouter(sup.endpoints(), probe_interval_s=0.2,
                         eject_after=2, recover_after=2)
    bad, pids = [], set()
    stop = threading.Event()
    try:
        assert _wait_until(
            lambda: (router.probe_once() or True)
            and all(r.state == HEALTHY for r in router.replicas),
            timeout_s=120, interval_s=0.5,
        ), f"fleet never healthy: {[r.last_error for r in router.replicas]}"
        port = router.start(port=0)

        def hammer():
            while not stop.is_set():
                try:
                    st, out, _ = _post(port)
                    if st != 200:
                        bad.append(st)
                    else:
                        pids.add(int(out["scores"][0]))
                except Exception as e:
                    bad.append(repr(e))

        threads = [threading.Thread(target=hammer) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        victim = sup.kill_replica(0, signal.SIGKILL)
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not bad, f"client-visible failures: {bad[:5]}"
        assert victim in pids and len(pids) >= 2
        assert _wait_until(lambda: sup.restart_count() >= 1, timeout_s=30)
        assert _wait_until(
            lambda: (router.probe_once() or True)
            and router.fleet_view()["n_serving"] == 2,
            timeout_s=120, interval_s=0.5,
        ), f"fleet never reconverged: {router.fleet_view()}"
        assert sup.replicas[0].pid not in (None, victim)
    finally:
        stop.set()
        router.stop()
        sup.stop()


# --------------------------------------------------------------------------- #
# a real fleet of two --cpu replicas on an artifact
# --------------------------------------------------------------------------- #
S, DENSE, B = 3, 2, 16


def _lines(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = ["1 0"]
        for _s in range(S):
            ks = rng.integers(0, 50, int(rng.integers(1, 3)))
            parts.append(f"{len(ks)} " + " ".join(map(str, ks)))
        parts.append(f"{DENSE} " + " ".join(f"{v:.3f}"
                                           for v in rng.random(DENSE)))
        out.append(" ".join(parts))
    return ("\n".join(out) + "\n").encode()


def _small_artifact(out):
    """A small CtrDnn artifact: (its dir, the requests, one port
    ScoringServer's scores for them)."""
    conf = make_synth_config(S, DENSE, B, 8)
    tc = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(S, tc.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu", seed=2)
    table = SparseTable(tc, device="cpu")
    table.begin_pass(np.arange(0, 50, dtype=np.uint64))
    table.end_pass()
    art = str(out)
    export_model(model, table, art, batch_size=B, key_capacity=B * 8,
                 dense_dim=DENSE, feed_conf=conf)
    table.close()
    one = ScoringServer(device="cpu")
    one.register("m", art)
    bodies = [_lines(5, seed=s) for s in range(4)]
    return art, bodies, [one.score_lines(b) for b in bodies]


def _start_fleet(argv, env=None):
    """``python -m paddlebox_tpu_torch.serve`` in fleet mode: (the
    process, its router port, its printed lines so far)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.serve", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))
    port, seen = None, []
    t0 = time.time()
    while time.time() - t0 < 120 and port is None:
        line = proc.stdout.readline()
        if not line:
            assert proc.poll() is None, "".join(seen)
            continue
        seen.append(line)
        if "fleet router on http://" in line:
            port = int(line.split(":")[2].split("/")[0])
    assert port, "".join(seen)
    return proc, port, seen


def _down(addr):
    host, _, p = addr.rpartition(":")
    try:
        conn = http.client.HTTPConnection(host, int(p), timeout=2)
        conn.request("GET", "/healthz")
        conn.getresponse()
        return False
    except OSError:
        return True


def test_real_fleet_equals_one_server(tmp_path):
    art, bodies, want = _small_artifact(tmp_path / "art")
    proc, port, _ = _start_fleet(
        ["--artifact", f"m={art}", "--replicas", "2", "--router-port", "0",
         "--cpu", "--log-dir", str(tmp_path / "logs")])
    try:
        assert _wait_until(lambda: _get(port, "/healthz")[1]["n_serving"]
                           == 2, timeout_s=120, interval_s=0.5)
        served = set()
        for b, w in zip(bodies, want):
            st, out, hdrs = _post(port, body=b)
            assert st == 200 and out["scores"] == w
            served.add(hdrs["x-pbox-replica"])
        assert len(served) == 2  # round-robin reached both replicas
        addrs = [r["addr"] for r in _get(port, "/fleet")[1]["replicas"]]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    # SIGTERM to the fleet process stops its replicas too
    assert _wait_until(lambda: all(_down(a) for a in addrs), timeout_s=20)


def test_real_fleet_autoscale_keeps_the_replicas_as_its_floor(tmp_path):
    """``serve --replicas 2 --autoscale --cpu``: the autoscaler ticks every
    50 ms with no cooldown and a flag floor of 1, and an idle fleet scales
    down after 10 idle ticks; --replicas 2 is the floor, so over 40 idle
    ticks the fleet stays at 2 and serves one server's scores."""
    art, bodies, want = _small_artifact(tmp_path / "art")
    proc, port, seen = _start_fleet(
        ["--artifact", f"m={art}", "--replicas", "2", "--router-port", "0",
         "--autoscale", "--cpu"],
        env={"PADDLEBOX_TORCH_AUTOSCALE_INTERVAL_S": "0.05",
             "PADDLEBOX_TORCH_AUTOSCALE_COOLDOWN_S": "0",
             "PADDLEBOX_TORCH_AUTOSCALE_MIN_REPLICAS": "1",
             "PADDLEBOX_TORCH_AUTOSCALE_MAX_REPLICAS": "3"})
    try:
        assert "autoscaling" in seen[-1]
        assert _wait_until(lambda: _get(port, "/healthz")[1]["n_serving"]
                           == 2, timeout_s=120, interval_s=0.5)
        time.sleep(2.0)
        view = _get(port, "/fleet")[1]
        assert view["n_replicas"] == view["n_serving"] == 2, view
        for b, w in zip(bodies, want):
            st, out, _ = _post(port, body=b)
            assert st == 200 and out["scores"] == w
        addrs = [r["addr"] for r in view["replicas"]]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    assert proc.returncode == 0
    assert _wait_until(lambda: all(_down(a) for a in addrs), timeout_s=20)


_LAUNCH_RANK = """
import http.client, json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from paddlebox_tpu_torch.config import SparseTableConfig
from paddlebox_tpu_torch.data.synth import make_synth_config
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.serving_sync import Publisher
from paddlebox_tpu_torch.sparse.table import SparseTable

root, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
bodies = [b.encode() for b in json.load(open(sys.argv[4]))]
conf = make_synth_config({S}, {DENSE}, {B}, 8)
tc = SparseTableConfig(embedding_dim=4)
model = CtrDnn({S}, tc.row_width, dense_dim={DENSE}, hidden=(8,),
               device="cpu", seed=2)
table = SparseTable(tc, device="cpu")
table.begin_pass(np.arange(0, 50, dtype=np.uint64))
table.end_pass()
Publisher(root, staging_dir=out + ".stage").publish_base(
    "p0", model, None, table, batch_size={B}, key_capacity={B} * 8,
    dense_dim={DENSE}, feed_conf=conf)


def call(method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{{}}")
    finally:
        conn.close()


end = time.monotonic() + 120
while True:
    try:
        if call("GET", "/healthz")[1].get("n_serving") == 2:
            break
    except OSError:
        pass
    assert time.monotonic() < end, "the co-run fleet never served"
    time.sleep(0.2)
replies = [call("POST", "/score", b) for b in bodies]
addrs = [r["addr"] for r in call("GET", "/fleet")[1]["replicas"]]
json.dump({{"replies": replies, "addrs": addrs}}, open(out, "w"))
"""


def test_launch_co_runs_a_fleet_that_serves_the_published_model(tmp_path):
    """``launch --publish-root R --serve-replicas 2``: a 1-rank job
    publishes a base into R, and the fleet the launcher co-runs (2
    ``--cpu`` replicas syncing from R behind its router) answers ``/score``
    with one server's scores for that model; the fleet stops with the
    job."""
    from paddlebox_tpu_torch.launch import launch

    _, bodies, want = _small_artifact(tmp_path / "art")
    prog, out = tmp_path / "rank.py", tmp_path / "out.json"
    prog.write_text(_LAUNCH_RANK.format(repo=REPO, S=S, DENSE=DENSE, B=B))
    (tmp_path / "bodies.json").write_text(
        json.dumps([b.decode() for b in bodies]))
    root, port = str(tmp_path / "pub"), find_free_port()
    rc = launch([str(prog), root, str(port), str(out),
                 str(tmp_path / "bodies.json")], nproc=1, device="cpu",
                publish_root=root, serve_replicas=2, serve_router_port=port,
                log_dir=str(tmp_path / "logs"), job_timeout_s=180,
                env=dict(os.environ, PYTHONPATH=REPO))
    logs = "".join(open(tmp_path / "logs" / f).read()
                   for f in sorted(os.listdir(tmp_path / "logs")))
    assert rc == 0, logs
    got = json.load(open(out))
    assert [st for st, _ in got["replies"]] == [200] * len(bodies)
    assert [o["scores"] for _, o in got["replies"]] == want
    assert len(got["addrs"]) == 2
    # the launcher stopped the fleet, and the fleet its replicas
    assert _wait_until(lambda: all(_down(a) for a in got["addrs"]),
                       timeout_s=20)
