"""Fleet front door: health-checked replica routing with failover.

One :class:`FleetRouter` spreads ``/score`` traffic over N replica
:class:`~paddlebox_tpu_torch.inference.server.ScoringServer` processes so a
single replica hiccup is never client-visible.

**Membership is a per-replica state machine**, fed by a background probe
loop (``GET /healthz`` every ``probe_interval_s``, fault site
``fleet.probe``) and by per-request forwarding outcomes:

    HEALTHY   — probing clean; first-choice routing (round-robin)
    DEGRADED  — serving but impaired: the replica itself advertises
                ``degraded`` in /healthz (syncer behind, delta chain
                broken — it serves its pinned last-good model), or its
                freshest model is older than ``degraded_max_age_s``.
                Deprioritized-but-kept: used only when no HEALTHY
                replica can take the request (degrade, don't fail).
    EJECTED   — ``eject_after`` consecutive failures (connection
                refused, timeout, 5xx probe, 503 not-ready).  Receives
                no traffic; the probe loop keeps half-open probing it
                and ``recover_after`` consecutive clean probes readmit
                it (to HEALTHY or DEGRADED per its own health payload).

**Requests fail over**: the request body is buffered in the router, so a
forward that dies mid-flight (replica SIGKILLed, connection reset, 5xx)
is retried verbatim on the next candidate (scoring is idempotent) —
and because the router is what buffers, it enforces ``max_body_bytes``
itself (413 before reading, counter ``fleet.oversized_body``) rather
than trusting the replicas' identical bound to fire after the fact —
site ``fleet.route``, counter ``fleet.failovers``.  Client-errors (4xx
except 429) pass through: a malformed line is malformed on every
replica.  A 429 shed is retried on the next replica (another may have
queue room); only when EVERY candidate sheds does the client see 429,
with the smallest Retry-After observed.  With no serving-capable replica
at all the router answers 503.

**Every request is traced end to end**: the router adopts the client's
W3C ``traceparent`` (or mints a fresh trace ID), wraps the whole routed
request in a ``fleet.request`` span, gives each forward attempt its own
``fleet.attempt`` child span (failed attempts leave a ``fleet.failover``
marker naming the replica and error), and carries the context to the
replica in the forwarded ``traceparent`` header — so the replica's
server-side spans land under the SAME trace ID.  Responses carry the
debug headers ``X-PBox-Trace-Id`` (correlate client-side tail latency
with server logs without log-diving) and ``X-PBox-Replica`` (which
replica actually served, after failover).  All of it lands in the
always-on flight ring, which the doctor's ``--trace <id>`` reconstructs
into one cross-process request path.

Endpoints: ``POST /score[/name]`` (proxied), ``GET /healthz`` (fleet
summary: 200 while any replica can serve), ``GET /fleet`` (the full
freshness/state view), ``GET /metrics`` (router-process Prometheus).
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.telemetry import context as trace_context
from paddlebox_tpu_torch.utils import faults

logger = logging.getLogger(__name__)


class _Httpd(ThreadingHTTPServer):
    # same rationale as the scoring server: the replicas' admission
    # gates bound overload with fast 429s — the router's listen backlog
    # must never be the thing that queues (SYN drops + 1s client
    # retransmits would smear the fleet's tail)
    request_queue_size = 128


HEALTHY = "healthy"
DEGRADED = "degraded"
EJECTED = "ejected"

_STATE_CODE = {HEALTHY: 0, DEGRADED: 1, EJECTED: 2}

_REQUESTS = telemetry.counter(
    "fleet.requests", help="routed client requests by outcome"
)
_FAILOVERS = telemetry.counter(
    "fleet.failovers",
    help="per-request forwards that failed and retried on another replica",
)
_PROBE_FAILURES = telemetry.counter(
    "fleet.probe_failures", help="replica health probes that failed"
)
_REPLICA_STATE = telemetry.gauge(
    "fleet.replica_state",
    help="per-replica state (0 healthy, 1 degraded, 2 ejected)",
)
_ROUTE_SECONDS = telemetry.histogram(
    "fleet.route_seconds",
    help="router request latency (s) by outcome, failovers included",
)
# the router buffers the full body for failover retries, so the
# max_body_bytes bound must hold HERE at the front door — not only on
# the replicas, after the router has already read an oversized payload
_OVERSIZED = telemetry.counter(
    "fleet.oversized_body",
    help="routed requests rejected 413 at the front door for exceeding "
         "max_body_bytes",
)


class ReplicaHandle:
    """One replica's routing view: address + state machine + the last
    health payload (the fleet freshness view is aggregated from these)."""

    def __init__(self, addr: str):
        self.addr = addr  # "host:port"
        self.host, _, port = addr.rpartition(":")
        self.port = int(port)
        self.state = EJECTED  # unproven until the first clean probe
        self.consecutive_failures = 0
        self.consecutive_ok = 0
        self.last_error: Optional[str] = None
        self.last_probe_at = 0.0
        self.health: dict = {}  # last /healthz payload (freshness view)

    def view(self) -> dict:
        models = self.health.get("models") or {}
        return {
            "addr": self.addr,
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
            "degraded_reasons": self.health.get("degraded_reasons") or {},
            "queue_depth": self.health.get("queue_depth"),
            "estimated_wait_s": self.health.get("estimated_wait_s"),
            # run-health summary straight off the probe payload
            # (telemetry/health.py health_view on the replica)
            "health": self.health.get("health") or {},
            "models": {
                n: {"seq": m.get("seq"), "age_seconds": m.get("age_seconds"),
                    "lineage": m.get("lineage"),
                    # the quantization byte win per replica, straight off
                    # the probe payload (_entry_health)
                    "artifact_bytes": m.get("artifact_bytes"),
                    "embedding_dtype": m.get("embedding_dtype")}
                for n, m in models.items()
            },
        }


class FleetRouter:
    def __init__(
        self,
        replicas: List[str],
        *,
        probe_interval_s: Optional[float] = None,
        probe_timeout_s: float = 2.0,
        eject_after: int = 3,
        recover_after: int = 2,
        degraded_max_age_s: Optional[float] = None,
        request_timeout_s: float = 60.0,
        max_body_bytes: Optional[int] = None,
    ):
        """replicas: "host:port" (or bare-port) strings.  degraded_max_age_s:
        additionally treat a replica whose FRESHEST model is older than
        this as degraded even if it doesn't say so itself (None = trust
        the replica's own flag only)."""
        if not replicas:
            raise ValueError("a fleet router needs at least one replica")
        from paddlebox_tpu_torch.config import flags

        self.replicas = [
            ReplicaHandle(a if ":" in a else f"127.0.0.1:{a}")
            for a in replicas
        ]
        # a NEVER-failed replica admits on its first clean probe: the
        # recover_after streak is half-open caution for replicas that
        # actually failed, not a cold-start tax (the seed is wiped by
        # any failure, restoring the full recovery requirement)
        for r in self.replicas:
            r.consecutive_ok = max(0, int(recover_after) - 1)
        self.probe_interval_s = (
            probe_interval_s if probe_interval_s is not None
            else flags.fleet_probe_interval_s
        )
        self.probe_timeout_s = probe_timeout_s
        self.eject_after = int(eject_after)
        self.recover_after = int(recover_after)
        self.degraded_max_age_s = degraded_max_age_s
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = int(
            flags.serve_max_body_bytes if max_body_bytes is None
            else max_body_bytes
        )
        self._lock = threading.Lock()
        self._rr = 0  # round-robin cursor
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- state machine ------------------------------------------------------- #
    def _note_failure(self, r: ReplicaHandle, err: str) -> None:
        with self._lock:
            if r not in self.replicas:
                return  # removed mid-probe: don't resurrect its gauge
            r.consecutive_ok = 0
            r.consecutive_failures += 1
            r.last_error = err[:200]
            if r.state != EJECTED \
                    and r.consecutive_failures >= self.eject_after:
                logger.warning("fleet: ejecting replica %s after %d "
                               "consecutive failures (%s)", r.addr,
                               r.consecutive_failures, r.last_error)
                r.state = EJECTED
            self._export_state(r)

    def _note_success(self, r: ReplicaHandle, health: dict) -> None:
        degraded = bool(health.get("degraded"))
        if not degraded and self.degraded_max_age_s is not None:
            ages = [m.get("age_seconds") for m in
                    (health.get("models") or {}).values()
                    if m.get("age_seconds") is not None]
            # the FRESHEST model decides: one stale side model must not
            # degrade a replica whose live model is current
            if ages and min(ages) > self.degraded_max_age_s:
                degraded = True
        with self._lock:
            if r not in self.replicas:
                return  # removed mid-probe: don't resurrect its gauge
            r.consecutive_failures = 0
            r.consecutive_ok += 1
            r.last_error = None
            r.health = health
            want = DEGRADED if degraded else HEALTHY
            if r.state == EJECTED:
                # half-open: an ejected replica must string together
                # recover_after clean probes before traffic returns
                if r.consecutive_ok >= self.recover_after:
                    logger.info("fleet: replica %s recovered (%s)",
                                r.addr, want)
                    r.state = want
            else:
                r.state = want
            self._export_state(r)

    def _export_state(self, r: ReplicaHandle) -> None:
        _REPLICA_STATE.set(_STATE_CODE[r.state], replica=r.addr)

    # -- dynamic membership (the elastic fleet) ------------------------------ #
    def add_replica(self, addr: str) -> ReplicaHandle:
        """Admit a freshly spawned replica into the routing set.  It
        starts EJECTED (unproven) with the same never-failed recovery
        seed as construction-time replicas: one clean probe admits it.
        Idempotent on address."""
        addr = addr if ":" in addr else f"127.0.0.1:{addr}"
        with self._lock:
            for r in self.replicas:
                if r.addr == addr:
                    return r
            r = ReplicaHandle(addr)
            r.consecutive_ok = max(0, self.recover_after - 1)
            self.replicas.append(r)
            self._export_state(r)
        logger.info("fleet: replica %s joined the routing set", addr)
        return r

    def remove_replica(self, addr: str) -> None:
        """Eject a replica from the routing set for good (drain-retire:
        the caller stops the process AFTER removal, so no new request is
        ever routed to a dying replica).  Clears its per-replica gauge
        label so a retired address doesn't linger in /metrics."""
        addr = addr if ":" in addr else f"127.0.0.1:{addr}"
        with self._lock:
            self.replicas = [r for r in self.replicas if r.addr != addr]
        _REPLICA_STATE.remove(replica=addr)
        logger.info("fleet: replica %s left the routing set", addr)

    def _snapshot(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self.replicas)

    # -- probing ------------------------------------------------------------- #
    def probe_once(self) -> None:
        """One health sweep over every replica (ejected ones included —
        that IS the half-open recovery probe)."""
        for r in self._snapshot():
            r.last_probe_at = time.monotonic()
            try:
                faults.inject("fleet.probe")
                conn = http.client.HTTPConnection(
                    r.host, r.port, timeout=self.probe_timeout_s)
                try:
                    conn.request("GET", "/healthz")
                    resp = conn.getresponse()
                    payload = json.loads(resp.read() or b"{}")
                finally:
                    conn.close()
                if resp.status == 200:
                    self._note_success(r, payload)
                else:
                    _PROBE_FAILURES.inc()
                    self._note_failure(r, f"healthz {resp.status}")
            except Exception as e:
                _PROBE_FAILURES.inc()
                self._note_failure(r, repr(e))

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:
                # the sweep itself must never die — a router without a
                # probe loop would freeze the membership view
                logger.exception("fleet probe sweep failed; continuing")
            self._stop.wait(self.probe_interval_s)

    # -- routing ------------------------------------------------------------- #
    def _candidates(self) -> List[ReplicaHandle]:
        """Serving-capable replicas in preference order: HEALTHY ones
        first (rotated round-robin so load spreads), then DEGRADED ones
        (also rotated) — a degraded replica takes traffic only when every
        healthy one already failed this request."""
        with self._lock:
            healthy = [r for r in self.replicas if r.state == HEALTHY]
            degraded = [r for r in self.replicas if r.state == DEGRADED]
            k = self._rr
            self._rr += 1
        out = healthy[k % len(healthy):] + healthy[:k % len(healthy)] \
            if healthy else []
        if degraded:
            out += degraded[k % len(degraded):] + degraded[:k % len(degraded)]
        return out

    def _forward(self, r: ReplicaHandle, method: str, path: str,
                 body: bytes, headers: dict) -> Tuple[int, bytes, dict]:
        faults.inject("fleet.route")
        conn = http.client.HTTPConnection(
            r.host, r.port, timeout=self.request_timeout_s)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            keep = {}
            for k in ("Content-Type", "Retry-After"):
                v = resp.getheader(k)
                if v:
                    keep[k] = v
            return resp.status, data, keep
        finally:
            conn.close()

    def route_request(self, method: str, path: str, body: bytes,
                      headers: dict) -> Tuple[int, bytes, dict]:
        """Forward one client request with failover.  Returns (status,
        body, headers) for the handler to relay.

        Deadline-aware retry math: with an ``X-Request-Deadline-Ms``
        header, every retry decision charges the time already burned in
        earlier attempts against the client's budget — the forwarded
        header carries only the REMAINING milliseconds (so a replica's
        admission gate, which under micro-batching estimates queue +
        linger waits against that number, sheds on what is actually
        left), and once the budget is spent the router stops failing
        over (a replica would shed it anyway; retrying is pure waste)
        and answers the best shed seen, else 504.

        Tracing: each forward attempt runs under its own ``fleet.attempt``
        child span of the active trace context, and the forwarded
        ``traceparent`` header carries that attempt's span — the replica's
        server-side spans parent under the attempt that reached it, so a
        failover shows up as sibling attempts (one dead, one served)
        under ONE trace ID.  The response names the replica that actually
        served in ``X-PBox-Replica``."""
        t0 = time.perf_counter()
        deadline_ms = _deadline_ms_header(headers)
        candidates = self.route_candidates()
        shed: Optional[Tuple[int, bytes, dict]] = None
        tried = 0
        expired = False
        for r in candidates:
            remaining_ms = None
            if deadline_ms is not None:
                remaining_ms = deadline_ms - (time.perf_counter() - t0) * 1e3
                if remaining_ms <= 0:
                    expired = True
                    break
            tried += 1
            try:
                with telemetry.span("fleet.attempt", replica=r.addr,
                                    attempt=tried):
                    # inside the span: current() IS the attempt's span,
                    # so the replica's server-side spans parent under
                    # the exact attempt that reached it
                    attempt_ctx = trace_context.current()
                    fwd = dict(headers)
                    if attempt_ctx is not None:
                        fwd[trace_context.TRACEPARENT_HEADER] = \
                            attempt_ctx.to_traceparent()
                    if remaining_ms is not None:
                        fwd["X-Request-Deadline-Ms"] = \
                            f"{max(remaining_ms, 1.0):.0f}"
                    status, data, hdrs = self._forward(
                        r, method, path, body, fwd)
            except Exception as e:
                # replica died under us (SIGKILL, reset, timeout): feeds
                # the same state machine as a failed probe, and the
                # request retries on the next candidate — the client
                # never sees this
                self._note_failure(r, repr(e))
                _FAILOVERS.inc()
                telemetry.instant("fleet.failover", replica=r.addr,
                                  attempt=tried, error=repr(e)[:120])
                continue
            if status == 429:
                # this replica is shedding; another may have queue room.
                # Keep the SMALLEST Retry-After seen — the soonest any
                # replica claims it will have capacity.
                if shed is None or _retry_after(hdrs) < _retry_after(shed[2]):
                    shed = (status, data, hdrs)
                continue
            if status >= 500:
                self._note_failure(r, f"status {status}")
                _FAILOVERS.inc()
                continue
            outcome = "ok" if tried == 1 else "failover_ok"
            _REQUESTS.inc(outcome=outcome)
            _ROUTE_SECONDS.observe(time.perf_counter() - t0,
                                   outcome=outcome)
            # which replica actually served, after any failover: clients
            # attribute tail latency without log-diving
            hdrs[trace_context.REPLICA_RESPONSE_HEADER] = r.addr
            return status, data, hdrs
        if shed is not None:
            _REQUESTS.inc(outcome="shed")
            _ROUTE_SECONDS.observe(time.perf_counter() - t0, outcome="shed")
            return shed
        if expired:
            # the client's deadline died during routing/failover with no
            # replica having shed it: 504, not 429 — "your budget ran
            # out here", distinguishable from "we are overloaded"
            _REQUESTS.inc(outcome="deadline")
            _ROUTE_SECONDS.observe(time.perf_counter() - t0,
                                   outcome="deadline")
            return 504, json.dumps({
                "error": "request deadline exhausted during fleet "
                         "routing/failover",
                "deadline_ms": deadline_ms,
            }).encode(), {"Content-Type": "application/json"}
        _REQUESTS.inc(outcome="no_replica")
        _ROUTE_SECONDS.observe(time.perf_counter() - t0,
                               outcome="no_replica")
        return 503, json.dumps({
            "error": "no serving-capable replica",
            "replicas": {r.addr: r.state for r in self._snapshot()},
        }).encode(), {"Content-Type": "application/json"}

    def route_candidates(self) -> List[ReplicaHandle]:
        return self._candidates()

    # -- fleet view ---------------------------------------------------------- #
    def fleet_view(self) -> dict:
        """The operator/freshness view: every replica's state, error,
        queue depth and per-model (seq, age) — convergence of ``seq``
        across replicas is the fleet-level freshness statement."""
        replicas = [r.view() for r in self._snapshot()]
        serving = [r for r in replicas if r["state"] != EJECTED]
        return {
            "ok": bool(serving),
            "n_replicas": len(replicas),
            "n_serving": len(serving),
            # fleet-level run-health rollup: total/critical alert counts
            # summed over every replica's health summary
            "health_alerts": sum(
                int((r.get("health") or {}).get("alerts_total") or 0)
                for r in replicas
            ),
            "health_critical": sum(
                int((r.get("health") or {}).get("critical_total") or 0)
                for r in replicas
            ),
            "replicas": replicas,
        }

    # -- http front door ------------------------------------------------------ #
    def _handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            def _send_raw(self, code: int, data: bytes,
                          headers: dict) -> None:
                self.send_response(code)
                hdrs = {"Content-Type": "application/json", **headers}
                hdrs["Content-Length"] = str(len(data))
                for k, v in hdrs.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, code: int, payload: dict) -> None:
                self._send_raw(code, json.dumps(payload).encode(), {})

            def do_GET(self):
                if self.path == "/healthz":
                    view = router.fleet_view()
                    self._send_json(200 if view["ok"] else 503, view)
                elif self.path == "/fleet":
                    self._send_json(200, router.fleet_view())
                elif self.path == "/metrics":
                    body = telemetry.render_prometheus().encode()
                    self._send_raw(
                        200, body,
                        {"Content-Type": telemetry.PROMETHEUS_CONTENT_TYPE},
                    )
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                # the router fronts both serving surfaces: /score[/name]
                # (ranking) and /retrieve[/name] (ANN retrieval) share
                # the same failover/deadline/outcome machinery — the
                # forwarded path is opaque to route_request.  Anything
                # else is a clean 404 here, never forwarded.
                if self.path not in ("/score", "/retrieve") \
                        and not self.path.startswith("/score/") \
                        and not self.path.startswith("/retrieve/"):
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "-1"))
                except ValueError:
                    n = -1
                if n < 0:
                    self._send_json(
                        400, {"error": "missing or invalid Content-Length"})
                    return
                if n > router.max_body_bytes:
                    _OVERSIZED.inc()
                    self._send_json(413, {
                        "error": f"body of {n} bytes exceeds this router's "
                                 f"max_body_bytes={router.max_body_bytes}",
                    })
                    return
                body = self.rfile.read(n)
                fwd = {"Content-Length": str(len(body))}
                for k in ("Content-Type", "X-Request-Deadline-Ms"):
                    v = self.headers.get(k)
                    if v:
                        fwd[k] = v
                # adopt the client's traceparent or mint a fresh trace:
                # every attempt span, failover marker and replica-side
                # span of this request now shares one trace ID, and the
                # client gets it back for its own latency attribution
                ctx = trace_context.from_headers(self.headers) \
                    or trace_context.new_root()
                with trace_context.activate(ctx), \
                        telemetry.span("fleet.request", path=self.path):
                    status, data, hdrs = router.route_request(
                        "POST", self.path, body, fwd)
                hdrs[trace_context.TRACE_ID_RESPONSE_HEADER] = ctx.trace_id
                self._send_raw(status, data, hdrs)

            def log_message(self, *a):  # quiet by default
                pass

        return Handler

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Bind the front door + start the probe loop; returns the port."""
        if self._httpd is not None:
            raise RuntimeError("router already started")
        self.probe_once()  # seed membership before taking traffic
        self._stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="fleet-router-probe", daemon=True)
        self._probe_thread.start()
        self._httpd = _Httpd((host, port), self._handler())
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-router",
            daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None


def _retry_after(headers: dict) -> float:
    try:
        return float(headers.get("Retry-After", "inf"))
    except ValueError:
        return float("inf")


def _deadline_ms_header(headers: dict) -> Optional[float]:
    """The client's positive deadline budget, or None (absent/garbage —
    a malformed hint must not turn a routable request into an error)."""
    raw = headers.get("X-Request-Deadline-Ms")
    if raw is None:
        return None
    try:
        ms = float(raw)
    except ValueError:
        return None
    return ms if ms > 0 else None
