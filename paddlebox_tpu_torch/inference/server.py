"""HTTP scoring server over export_model artifacts (reference:
paddlebox_tpu/inference/server.py).

A threaded HTTP server that loads one or more artifacts and scores
canonical slot-text lines through the SAME parser and feed the trainer
uses, so a request line is scored exactly as training would have seen it.

Endpoints:
  POST /score               — body = slot-text lines; scores the default
                              (first-registered) model
  POST /score/<name>        — scores a named model
  POST /retrieve[/<name>]   — body = {"queries": [[f32...]...], "k": K,
                              "tier": "exact"|"int8"}; ANN top-k over a
                              retrieval index (inference/ann.py) behind
                              the same admission gate as /score
  GET  /healthz             — liveness + per-model metadata
  GET  /models              — registered model names + meta
  GET  /metrics             — Prometheus text exposition (request counts
                              by status class, request-latency histograms
                              by model, every process metric)

Per-scenario serving policy (config.ScenarioServingConfig via
``set_serving_policy``): a model name can carry its own request
deadline and micro-batch linger — the scenario plane's serving half
(a retrieval surface lingers differently than a CTR surface).

The models live on the server's device (``device="cuda"`` unless the
caller asks for the CPU), where the Predictor resolves keys and runs the
exported programs; one scoring lock serializes that device work, and
/retrieve runs outside it.  Clients need only HTTP (see
examples/serve_client.cpp for a C++ one).  Every thread the server starts
is a daemon, and ``stop()`` retires it.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import DataFeedConfig, flags
from paddlebox_tpu_torch.inference.admission import (
    AdmissionGate,
    BatchCoalescer,
    ShedRequest,
)
from paddlebox_tpu_torch.inference.predictor import Predictor
from paddlebox_tpu_torch.telemetry import context as trace_context
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.device import resolve_device
from paddlebox_tpu_torch.utils.monitor import stats

# per-request serving telemetry: counts split by HTTP status class and
# latency histograms split by (model, status class) — recorded on EVERY
# path including errors, so a 5xx storm is visible as a latency series,
# not just a count.
_REQUESTS = telemetry.counter(
    "server.requests", help="scoring requests by model + status class"
)
_REQUEST_SECONDS = telemetry.histogram(
    "server.request_seconds",
    help="scoring request latency (s) by model + status class",
)
# freshness: seconds since the live version of each model was published
# (set on every /models read and by the serving_sync syncer's poll tick)
_MODEL_AGE = telemetry.gauge(
    "serve.model_age_seconds",
    help="seconds since the serving model's current version was published",
)
# instances whose features were truncated to the batch key capacity —
# their scores ARE served (training would have clipped identically) but a
# sustained rate here means the capacity/ladder needs re-exporting
_CLIPPED = telemetry.counter(
    "server.clipped_instances",
    help="scored instances with key-capacity-truncated features",
)
# request-parsing hardening: bodies beyond the size cap answer 413
# without being read; a missing/garbage/negative Content-Length answers
# 400 instead of reading unbounded input
_OVERSIZED = telemetry.counter(
    "server.oversized_body",
    help="scoring requests rejected 413 for exceeding max_body_bytes",
)
_BAD_LENGTH = telemetry.counter(
    "server.bad_content_length",
    help="scoring requests rejected 400 for a missing/absurd "
         "Content-Length",
)
# degraded-mode flag: 1 while any subsystem (e.g. the serving_sync
# syncer falling behind or a broken delta chain) marked this replica
# degraded — it KEEPS serving its pinned last-good model; the fleet
# router reads the same flag from /healthz and deprioritizes it
_DEGRADED = telemetry.gauge(
    "serve.degraded",
    help="1 while this server advertises degraded-mode serving",
)
# the retrieval surface's own volume series (requests/latency ride the
# standard per-request counters; this one counts QUERIES, split by the
# scoring tier actually used)
_RETRIEVE_QUERIES = telemetry.counter(
    "server.retrieve_queries",
    help="ANN retrieval queries by model + tier (exact/int8)",
)


def _status_class(code: int) -> str:
    return f"{code // 100}xx"


def _entry_health(e) -> dict:
    """One model's /healthz record.  Deliberately defensive: the probe
    surface the whole fleet routes on must describe ANY registered entry
    (including partially-stubbed ones in embedders' tests) rather than
    500 on a missing attribute — a health endpoint that crashes is
    itself an outage."""
    age = e.age_seconds() if hasattr(e, "age_seconds") else None
    version = getattr(e, "version", None) or {}
    return {
        "requests": e.requests,
        "instances": e.instances,
        "buckets": e.predictor.bucket_shapes,
        "n_features": e.predictor.n_features,
        "age_seconds": age,
        "seq": version.get("seq"),
        "lineage": version.get("lineage"),
        # the quantization win, observable per replica: in-memory sparse
        # payload bytes + the embedding dtype serving them (getattr-
        # guarded: stub predictors in tests carry neither)
        "artifact_bytes": getattr(e.predictor, "artifact_bytes", None),
        "embedding_dtype": getattr(e.predictor, "embedding_dtype", None),
    }


class _Httpd(ThreadingHTTPServer):
    # the ADMISSION GATE does the overload bounding (fast 429s), so the
    # kernel listen backlog must not pre-empt it: socketserver's default
    # backlog of 5 drops SYNs under a concurrency burst, and the client's
    # 1s retransmit then masquerades as serving latency
    request_queue_size = 128


class ModelEntry:
    def __init__(self, name: str, predictor: Predictor,
                 feed_conf: Optional[DataFeedConfig],
                 version: Optional[dict] = None):
        self.name = name
        self.predictor = predictor
        self.feed_conf = feed_conf
        # one parser per model, reused across requests (thread-safe: the
        # lock below serializes scoring; parsing itself is stateless).
        # Retrieval (ANN) artifacts carry no feed schema — their queries
        # are raw vectors over POST /retrieve — so feed_conf may be None;
        # /score on such a model refuses cleanly.
        from paddlebox_tpu_torch.data.slot_parser import SlotParser

        self.parser = SlotParser(feed_conf) if feed_conf is not None else None
        self.requests = 0
        self.instances = 0
        # delivery lineage (serving_sync registry: base tag + applied
        # delta chain + publish time); None for directly-registered models
        self.version: Optional[dict] = dict(version) if version else None
        self.loaded_at = time.time()

    def age_seconds(self) -> float:
        """Freshness: seconds since this model's live version was
        published (falls back to load time for direct registrations)."""
        ref = (self.version or {}).get("published_at") or self.loaded_at
        return max(0.0, time.time() - float(ref))


class ScoringServer:
    """Threaded HTTP server over one or more (Predictor, DataFeedConfig)
    pairs on one device.  start() binds and serves on a background daemon
    thread; scoring is serialized by a lock (one device, one program per
    shape bucket: concurrent dispatch buys nothing on one card)."""

    def __init__(self, max_queue: Optional[int] = None,
                 max_concurrency: Optional[int] = None,
                 request_deadline_ms: Optional[float] = None,
                 max_body_bytes: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 batch_linger_ms: Optional[float] = None,
                 device="cuda") -> None:
        """Admission/parsing knobs default from the flag shim
        (PADDLEBOX_TORCH_SERVE_MAX_QUEUE / _SERVE_MAX_CONCURRENCY /
        _REQUEST_DEADLINE_MS / _SERVE_MAX_BODY_BYTES / _SERVE_MAX_BATCH /
        _SERVE_BATCH_LINGER_MS), so a deployment is tuned with environment
        variables.  ``device``: where register() loads models (the card
        unless the caller passes "cpu"; without a card that raises).

        max_batch > 1 turns on continuous micro-batching on the HTTP
        path: up to that many concurrently admitted requests coalesce
        into ONE padded-bucket device call (admission.BatchCoalescer) —
        the gate then admits ``max_concurrency * max_batch`` requests at
        once (a whole forming batch counts as one scoring call in
        flight), and its EWMA tracks per-BATCH service time, so the
        shed math keeps estimating per-request waits correctly."""
        self.device = resolve_device(device)
        self._models: dict[str, ModelEntry] = {}
        self._default: Optional[str] = None
        self._lock = threading.Lock()  # serializes scoring (device work)
        self._meta_lock = threading.Lock()  # registry/stats reads+writes
        deadline_ms = (flags.request_deadline_ms
                       if request_deadline_ms is None else request_deadline_ms)
        self.max_body_bytes = int(
            flags.serve_max_body_bytes if max_body_bytes is None
            else max_body_bytes
        )
        self.max_batch = max(1, int(
            flags.serve_max_batch if max_batch is None else max_batch
        ))
        linger_ms = float(
            flags.serve_batch_linger_ms
            if batch_linger_ms is None else batch_linger_ms
        )
        self.gate = AdmissionGate(
            max_concurrency=int(flags.serve_max_concurrency
                                if max_concurrency is None
                                else max_concurrency) * self.max_batch,
            max_queue=int(flags.serve_max_queue
                          if max_queue is None else max_queue),
            default_deadline_s=(deadline_ms / 1e3 if deadline_ms else None),
        )
        self._coalescer = (
            BatchCoalescer(self, self.max_batch, linger_ms / 1e3)
            if self.max_batch > 1 else None
        )
        # per-model serving policies (config.ScenarioServingConfig):
        # scenario-chosen deadline / linger overrides, consulted by the
        # request path and the micro-batch coalescer
        self._policies: dict = {}
        # degraded-mode advertisements: reason -> detail.  The server
        # keeps serving while any are set; /healthz carries them so the
        # fleet router deprioritizes-but-keeps this replica.
        self._degraded: dict[str, str] = {}
        # per-request scoring diagnostics (clipped-instance count): thread-
        # local so concurrent requests can't read each other's tallies, and
        # a monkeypatched/overridden score_lines simply leaves it at 0
        self._tls = threading.local()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # graceful-drain accounting: in-flight scoring requests, guarded by
        # a condition so stop() can wait for them with a bounded deadline
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._draining = False

    # -- registry ---------------------------------------------------------- #
    def register(self, name: str, artifact_dir: str,
                 feed_conf: Optional[DataFeedConfig] = None,
                 version: Optional[dict] = None) -> None:
        """Load an artifact under ``name`` (first registered = default).

        feed_conf: None reads the artifact's own feed.json (written by
        export_model(feed_conf=...)) — a self-contained artifact needs no
        Python-side config at all.

        Re-registering an existing name is a hot swap: the fully-built
        replacement entry is installed under the registry lock in one
        assignment (request/instance counters carry over), so an in-flight
        ``score_lines`` either sees the old model or the new one, never a
        half-registered mix."""
        if feed_conf is None:
            import os

            path = os.path.join(artifact_dir, "feed.json")
            if not os.path.exists(path):
                raise ValueError(
                    f"artifact {artifact_dir} carries no feed.json: either "
                    "re-export with export_model(feed_conf=...) or pass "
                    "feed_conf to register()"
                )
            with open(path) as f:
                feed_conf = DataFeedConfig.from_dict(json.load(f))
        self.register_predictor(
            name, Predictor.load(artifact_dir, device=self.device),
            feed_conf, version=version)

    def register_predictor(self, name: str, predictor: Predictor,
                           feed_conf: Optional[DataFeedConfig],
                           version: Optional[dict] = None) -> None:
        """Register an already-loaded Predictor (the serving_sync syncer's
        entry point: it builds predictors from publish-root artifacts and
        delta merges, then installs them here).  Same hot-swap semantics
        as register(): everything slow/fallible happens BEFORE the lock,
        the install is one guarded assignment.

        feed_conf None is valid ONLY for retrieval artifacts (predictors
        exposing ``search``): they take raw query vectors over /retrieve
        and have no slot-text feed to parse."""
        if feed_conf is None and not hasattr(predictor, "search"):
            raise ValueError(
                f"model {name!r}: a scoring predictor needs a feed schema "
                "(only retrieval/ANN artifacts register without one)"
            )
        entry = ModelEntry(name, predictor, feed_conf, version=version)
        if entry.predictor.meta.get("n_tasks", 1) > 1:
            raise ValueError(
                "multi-task artifacts are not servable over the slot-text "
                "endpoint yet (predict returns [b, n_tasks]); score them "
                "via Predictor.predict directly"
            )
        with self._meta_lock:
            prev = self._models.get(name)
            if prev is not None:
                # a replacement keeps the name's serving history: the
                # counters describe the NAME clients score against, not
                # one loaded artifact
                entry.requests = prev.requests
                entry.instances = prev.instances
            self._models[name] = entry
            if self._default is None:
                self._default = name

    def swap_model(self, name: str, predictor: Predictor,
                   version: Optional[dict] = None) -> None:
        """Atomically replace ONLY the predictor (and version lineage) of
        a registered model — the delta hot-apply path: parser, feed
        config and counters stay, so the swap costs one pointer write
        under the lock.  In-flight requests pinned the old predictor at
        entry and finish on it; no request ever mixes the two.  KeyError
        when ``name`` was never registered (a delta cannot create a
        model; the syncer full-reloads through register_predictor)."""
        with self._meta_lock:
            entry = self._models[name]
            entry.predictor = predictor
            entry.version = dict(version) if version else None
            entry.loaded_at = time.time()

    def model_names(self) -> list:
        with self._meta_lock:
            return list(self._models)

    def model_version(self, name: Optional[str] = None) -> Optional[dict]:
        """The lineage dict of a registered model (None when registered
        directly from an artifact, without delivery metadata)."""
        with self._meta_lock:
            entry = self._models[name or self._default]
            return dict(entry.version) if entry.version else None

    # -- per-scenario serving policy ------------------------------------------ #
    def set_serving_policy(self, name: str, policy) -> None:
        """Attach a per-scenario serving policy
        (config.ScenarioServingConfig) to a model name: its
        ``deadline_ms`` becomes that model's default request deadline
        (the X-Request-Deadline-Ms header still outranks it) and its
        ``batch_linger_ms`` overrides the coalescer's linger for that
        model's micro-batches.  The policy's ``embedding_dtype`` /
        ``max_staleness_s`` are publish-side knobs (Publisher /
        DeadlinePublishPolicy); they ride here only for /healthz
        introspection."""
        with self._meta_lock:
            self._policies[name] = policy

    def serving_policy(self, name: Optional[str]):
        with self._meta_lock:
            return self._policies.get(name or self._default)

    def _policy_deadline_s(self, name: Optional[str]):
        p = self.serving_policy(name)
        if p is not None and getattr(p, "deadline_ms", None):
            return float(p.deadline_ms) / 1e3
        return None

    def _policy_linger_s(self, name: Optional[str]):
        p = self.serving_policy(name)
        if p is not None and getattr(p, "batch_linger_ms", None) is not None:
            return max(0.0, float(p.batch_linger_ms) / 1e3)
        return None

    # -- degraded-mode advertisement ----------------------------------------- #
    def set_degraded(self, reason: str, detail: str = "") -> None:
        """Advertise degraded-mode serving under ``reason`` (e.g. the
        syncer fell behind, or its delta chain broke and the pinned
        last-good model is what's serving).  The server keeps answering
        /score — degrade, never 500 — but /healthz carries the flag so a
        fleet router deprioritizes this replica until it clears."""
        with self._meta_lock:
            self._degraded[reason] = detail
        _DEGRADED.set(1.0)

    def clear_degraded(self, reason: str) -> None:
        """Withdraw one degraded reason; the flag drops once none remain."""
        with self._meta_lock:
            self._degraded.pop(reason, None)
            remaining = bool(self._degraded)
        _DEGRADED.set(1.0 if remaining else 0.0)

    def degraded_reasons(self) -> dict:
        with self._meta_lock:
            return dict(self._degraded)

    # -- scoring ------------------------------------------------------------ #
    def score_lines_detail(self, text: bytes,
                           name: Optional[str] = None) -> dict:
        """score_lines plus request diagnostics: ``{"scores": [...],
        "clipped_instances": N}`` where N counts instances whose features
        were truncated to the batch key capacity before scoring (the HTTP
        handler surfaces it in the response when non-zero)."""
        tls = self._tls
        tls.clipped = 0
        scores = self.score_lines(text, name)
        return {"scores": scores,
                "clipped_instances": getattr(tls, "clipped", 0)}

    def score_lines(self, text: bytes, name: Optional[str] = None) -> list:
        """Scores for every instance in canonical slot-text ``text``.

        Arbitrary request shapes: instances are scored in feed-batch-size
        chunks, and a chunk whose KEY count overflows every exported shape
        bucket (key-dense instances) is split in half recursively until it
        fits — so any request serves as long as each single instance fits
        some bucket (the reference's freely-resizable feed tensors,
        analysis_predictor.cc, by decomposition instead of recompilation).

        Instances whose features exceeded the key capacity serve CLIPPED
        (training parity); the per-call count lands in thread-local state
        for score_lines_detail / the HTTP handler to surface."""
        with self._meta_lock:
            entry = self._models[name or self._default]
            # pin ONE predictor snapshot for the whole request: a
            # concurrent swap_model/register must never let a request mix
            # the old predictor's bucket ladder with the new one's
            # programs (every chunk of this request scores on the same
            # model version)
            predictor = entry.predictor
        from paddlebox_tpu_torch.data.feed import BatchBuilder

        if entry.parser is None:
            raise ValueError(
                f"model {entry.name!r} is a retrieval index with no feed "
                "schema: query it via POST /retrieve, not /score"
            )
        lines = [ln for ln in text.decode().splitlines() if ln.strip()]
        block = entry.parser.parse_lines(lines)
        builder = BatchBuilder(entry.feed_conf)
        scores: list = []
        B = entry.feed_conf.batch_size
        import numpy as np

        # per-instance key counts, read once from the parsed block
        # (key_offsets is per (instance, slot) — stride by S for the
        # instance totals): chunks whose totals overflow are split BEFORE
        # any batch is built, so each served chunk is packed exactly once
        # and schema/config errors from predict() propagate immediately
        # instead of surviving a split
        lens = np.diff(block.key_offsets[:: block.n_sparse_slots])
        buckets = predictor.bucket_shapes
        clipped = 0
        clipped_ids: list = []  # global instance indices that clipped —
        # the micro-batch coalescer attributes them back per request

        def score_ids(ids) -> list:
            nonlocal clipped
            nk = int(lens[ids].sum())
            overflow = nk > builder.key_capacity or not any(
                len(ids) <= bb and nk <= bk for bb, bk in buckets
            )
            if overflow and len(ids) > 1:
                mid = len(ids) // 2
                return score_ids(ids[:mid]) + score_ids(ids[mid:])
            # a SINGLE instance beyond key capacity serves clipped — exactly
            # what training would have done with it (dropped_keys counts it;
            # the per-request clipped_instances total rides the response)
            d0 = builder.dropped_keys
            batch = builder.build(block, ids)
            if builder.dropped_keys > d0:
                clipped += len(ids)
                clipped_ids.extend(int(i) for i in ids)
            return [float(s) for s in predictor.predict(batch)]

        with self._lock, telemetry.span(
            "server.score", model=entry.name, n_ins=block.n_ins
        ):  # scoring only: /healthz never waits on this
            for lo in range(0, block.n_ins, B):
                ids = np.arange(lo, min(lo + B, block.n_ins))
                scores.extend(score_ids(ids))
        if clipped:
            _CLIPPED.inc(clipped, model=entry.name)
        self._tls.clipped = clipped
        self._tls.clipped_ids = clipped_ids
        with self._meta_lock:
            entry.requests += 1
            entry.instances += len(scores)
        return scores

    # -- retrieval ----------------------------------------------------------- #
    def retrieve(self, body: bytes, name: Optional[str] = None) -> dict:
        """ANN top-k over a registered retrieval index (inference/ann.py).

        ``body`` is JSON: ``{"queries": [[f32...], ...], "k": 10,
        "tier": "exact" | "int8"}`` — queries are user-tower output
        vectors (the user tower runs client-side; the standard
        two-tower serving split).  Raises KeyError for an unknown model
        (404), ValueError for a non-retrieval model or malformed
        request (400).  Scoring runs on the index's device over a snapshot
        pinned at entry, outside the scoring lock: /retrieve never queues
        behind /score's device work."""
        with self._meta_lock:
            entry = self._models[name or self._default]
            # pin ONE index snapshot: a concurrent delta hot-swap must
            # never split a request across two index versions
            predictor = entry.predictor
        if not hasattr(predictor, "search"):
            raise ValueError(
                f"model {entry.name!r} is a scoring artifact, not a "
                "retrieval index: POST /score"
            )
        try:
            req = json.loads(body.decode())
        except json.JSONDecodeError as e:
            raise ValueError(f"retrieve body must be JSON: {e}") from e
        if not isinstance(req, dict) or "queries" not in req:
            raise ValueError(
                'retrieve body needs {"queries": [[f32...], ...]}'
            )
        import numpy as np

        queries = np.asarray(req["queries"], dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2 or queries.shape[0] == 0:
            raise ValueError(
                f"queries must be a non-empty [n, d] float matrix, got "
                f"shape {queries.shape}"
            )
        k = int(req.get("k", 10))
        tier = str(req.get("tier", "exact"))
        # chaos site: an injected fault here exercises the 5xx path +
        # the router's failover through a live /retrieve
        faults.inject("retrieve.query")
        with telemetry.span(
            "server.retrieve", model=entry.name,
            n_queries=int(queries.shape[0]), tier=tier,
        ):
            keys, scores = predictor.search(queries, k=k, tier=tier)
        _RETRIEVE_QUERIES.inc(
            int(queries.shape[0]), model=entry.name, tier=tier
        )
        with self._meta_lock:
            entry.requests += 1
            entry.instances += int(queries.shape[0])
        return {
            "results": [
                {"keys": [int(x) for x in kk],
                 "scores": [float(s) for s in ss]}
                for kk, ss in zip(keys, scores)
            ],
            "tier": tier,
            "n_items": int(predictor.n_features),
        }

    def _count_extra_requests(self, name: str, n: int) -> None:
        """The coalescer scored ``n + 1`` client requests as one combined
        score_lines call; keep the per-model request counter describing
        CLIENT requests, not device calls."""
        with self._meta_lock:
            entry = self._models.get(name)
            if entry is not None:
                entry.requests += n

    # -- http -------------------------------------------------------------- #
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            _status = 0  # last code sent (per-request telemetry label)
            _trace_id: Optional[str] = None  # active request's trace

            def _send(self, code: int, payload: dict,
                      headers: Optional[dict] = None) -> None:
                body = json.dumps(payload).encode()
                self._status = code
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if self._trace_id:
                    # echo the request's trace ID on EVERY outcome, so a
                    # client (or the fleet router's bench) can correlate
                    # any response — 200 or 500 — with server-side spans
                    self.send_header(
                        trace_context.TRACE_ID_RESPONSE_HEADER,
                        self._trace_id,
                    )
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    # Prometheus text exposition of the process registry
                    # (request histograms, drain counters, and every
                    # legacy stats.* counter) — the scrape surface a
                    # deployed scorer is monitored through
                    body = telemetry.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", telemetry.PROMETHEUS_CONTENT_TYPE
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/healthz":
                    # liveness + readiness + DEGRADATION: 200 only when at
                    # least one model is registered and scorable — a
                    # rolling deploy (and the fleet router's probe loop)
                    # reads this before routing traffic.  Freshness
                    # (per-model age/seq) and degraded reasons ride along
                    # so one probe carries the whole routing decision.
                    with server._meta_lock:
                        models = {
                            n: _entry_health(e)
                            for n, e in server._models.items()
                        }
                        degraded = dict(server._degraded)
                    ready = bool(models)
                    self._send(
                        200 if ready else 503,
                        {"ok": ready, "ready": ready, "models": models,
                         "degraded": bool(degraded),
                         "degraded_reasons": degraded,
                         "draining": server._draining,
                         "queue_depth": server.gate.queue_depth(),
                         # admission-wait estimate for the queue as it
                         # stands: the autoscaler's latency-pressure
                         # signal (EWMA service time × queue / width)
                         "estimated_wait_s": server.gate.estimated_wait_s(),
                         # run-health plane: this process's alert summary
                         # (telemetry/health.py) — the router's fleet view
                         # aggregates it across replicas
                         "health": telemetry.health_view()},
                    )
                elif self.path == "/models":
                    # per-model version lineage + freshness: base tag,
                    # applied delta chain length, publish time and age —
                    # the operator view of the delivery plane (and the
                    # serve.model_age_seconds gauge refresh point)
                    with server._meta_lock:
                        entries = list(server._models.items())
                    models = {}
                    for n, e in entries:
                        age = e.age_seconds()
                        _MODEL_AGE.set(age, model=n)
                        v = e.version or {}
                        models[n] = {
                            "requests": e.requests,
                            "instances": e.instances,
                            "base_tag": v.get("base_tag"),
                            "tag": v.get("tag"),
                            "deltas_applied": v.get("deltas_applied", 0),
                            "seq": v.get("seq"),
                            "published_at": v.get("published_at"),
                            "age_seconds": age,
                            "lineage": v.get("lineage"),
                            "artifact_bytes": getattr(
                                e.predictor, "artifact_bytes", None),
                            "embedding_dtype": getattr(
                                e.predictor, "embedding_dtype", None),
                        }
                    self._send(200, {"models": models,
                                     "default": server._default})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                # strict routing: exactly /score or /score/<name>.  Every
                # outcome — routing 404, drain 503, parse 400, scoring 200,
                # internal 500 — lands in the request counter/latency
                # histogram split by status class.  The whole request runs
                # under a trace context — the router's forwarded
                # traceparent when one arrives (server-side spans then
                # chain under the router's attempt span), a freshly-minted
                # trace for direct hits — and every response echoes
                # X-PBox-Trace-Id.
                ctx = trace_context.from_headers(self.headers) \
                    or trace_context.new_root()
                self._trace_id = ctx.trace_id
                with trace_context.activate(ctx), \
                        telemetry.span("server.request", path=self.path):
                    self._do_post_traced()

            def _do_post_traced(self):
                t0 = time.perf_counter()
                # strict routing: exactly /score[/<name>] or
                # /retrieve[/<name>].  Any other POST path is a clean 404
                # counted under the standard request split (model "-",
                # status 4xx) — never scoring-shaped error handling.
                op = name = None
                for prefix, handler in (("/score", self._do_score),
                                        ("/retrieve", self._do_retrieve)):
                    if self.path == prefix:
                        op, name = handler, None
                        break
                    if self.path.startswith(prefix + "/"):
                        name = self.path[len(prefix) + 1:]
                        if not name or "/" in name or "?" in name:
                            # malformed names also count under "-": raw
                            # client junk must not mint counter series
                            # (counted before the reply flushes so the
                            # counter is visible once the client has it)
                            server._record_request("-", 404, t0)
                            self._send(404, {"error": "not found"})
                            return
                        op = handler
                        break
                if op is None:
                    # unroutable path: count under "-", never the default
                    # model (its p99/error split must not absorb junk);
                    # counted before the reply flushes
                    server._record_request("-", 404, t0)
                    self._send(404, {"error": "not found"})
                    return
                if not server._begin_request():
                    # draining: a rolling deploy already unrouted us, but a
                    # straggler connection may still arrive — refuse loudly
                    # instead of racing the close
                    self._send(503, {"error": "server draining"})
                    server._record_request(name, self._status, t0)
                    return
                try:
                    op(name)
                finally:
                    server._end_request()
                    server._record_request(name, self._status, t0)

            def _read_body(self):
                """Validated request body, or None after an error reply.

                Refuses before reading: a missing / non-integer / negative
                Content-Length is 400 (a scorer never reads unbounded
                input on faith) and a body beyond ``max_body_bytes`` is
                413 — both counted, neither touches the payload."""
                raw = self.headers.get("Content-Length")
                try:
                    n = int(raw)
                except (TypeError, ValueError):
                    n = -1
                if n < 0:
                    _BAD_LENGTH.inc()
                    self._send(400, {"error": "missing or invalid "
                                              f"Content-Length {raw!r}"})
                    return None
                if n > server.max_body_bytes:
                    _OVERSIZED.inc()
                    self._send(413, {
                        "error": f"body of {n} bytes exceeds this server's "
                                 f"max_body_bytes={server.max_body_bytes}",
                    })
                    return None
                return self.rfile.read(n)

            def _deadline_s(self, name=None):
                """Per-request deadline: X-Request-Deadline-Ms header
                outranks the model's serving-policy deadline, which
                outranks the server default.  Unparsable header values
                fall back down the ladder (a malformed hint must not
                turn a scorable request into an error)."""
                raw = self.headers.get("X-Request-Deadline-Ms")
                if raw is not None:
                    try:
                        ms = float(raw)
                        if ms > 0:
                            return ms / 1e3
                    except ValueError:
                        pass
                policy = server._policy_deadline_s(name)
                if policy is not None:
                    return policy
                return server.gate.default_deadline_s

            def _do_score(self, name):
                try:
                    body = self._read_body()
                    if body is None:
                        return
                    t_arrival = time.monotonic()
                    deadline_s = self._deadline_s(name)
                    try:
                        server.gate.admit(deadline_s)
                    except ShedRequest as shed:
                        # overload: refuse LOUDLY and cheaply at admission
                        # (429 + Retry-After) instead of queuing past the
                        # client's patience — tail latency of admitted
                        # requests stays bounded by the queue cap
                        self._send(
                            429,
                            {"error": f"overloaded: {shed.reason}",
                             "retry_after_s": round(shed.retry_after_s, 3)},
                            headers={"Retry-After": shed.retry_after_header},
                        )
                        return
                    service_s = None
                    try:
                        try:
                            if server._coalescer is not None:
                                # continuous micro-batching: the request's
                                # deadline stays anchored at ARRIVAL, so
                                # gate-queue time and linger time both
                                # count against it
                                deadline_at = (
                                    t_arrival + deadline_s
                                    if deadline_s and deadline_s > 0
                                    else None
                                )
                                job = server._coalescer.score(
                                    body, name, deadline_at)
                                scores, clipped = job.scores, job.clipped
                                service_s = job.service_s
                            else:
                                t_score = time.perf_counter()
                                server._tls.clipped = 0
                                scores = server.score_lines(body, name)
                                clipped = getattr(server._tls, "clipped", 0)
                                service_s = time.perf_counter() - t_score
                        except ShedRequest as shed:
                            # the deadline expired while the micro-batch
                            # formed: shed with 429, never scored
                            self._send(
                                429,
                                {"error": f"overloaded: {shed.reason}",
                                 "retry_after_s":
                                     round(shed.retry_after_s, 3)},
                                headers={"Retry-After":
                                         shed.retry_after_header},
                            )
                            return
                    finally:
                        server.gate.release(service_s)
                    payload = {"scores": scores}
                    if clipped:
                        # surfaced only when capacity actually truncated
                        # features: callers alert on its presence
                        payload["clipped_instances"] = clipped
                    self._send(200, payload)
                except KeyError:
                    self._send(404, {"error": f"unknown model {name!r}"})
                except (ValueError, UnicodeDecodeError) as e:
                    # the client's fault: malformed slot-text / encoding —
                    # parse errors surface as ValueError from the same
                    # parser training uses
                    self._send(400, {"error": repr(e)[:300]})
                except Exception as e:
                    # OUR fault (predictor/runtime failure): distinguishable
                    # from bad input so callers alert on 5xx, and the
                    # server itself survives either way
                    logging.getLogger(__name__).exception(
                        "internal error scoring %s", self.path
                    )
                    self._send(500, {"error": repr(e)[:300]})

            def _do_retrieve(self, name):
                """/score's admission/error contract over the ANN
                surface: gate admit → server.retrieve → release.  No
                coalescer: one request's queries are one matrix product
                already."""
                try:
                    body = self._read_body()
                    if body is None:
                        return
                    deadline_s = self._deadline_s(name)
                    try:
                        server.gate.admit(deadline_s)
                    except ShedRequest as shed:
                        self._send(
                            429,
                            {"error": f"overloaded: {shed.reason}",
                             "retry_after_s": round(shed.retry_after_s, 3)},
                            headers={"Retry-After": shed.retry_after_header},
                        )
                        return
                    service_s = None
                    try:
                        t_q = time.perf_counter()
                        payload = server.retrieve(body, name)
                        service_s = time.perf_counter() - t_q
                    finally:
                        server.gate.release(service_s)
                    self._send(200, payload)
                except KeyError:
                    self._send(404, {"error": f"unknown model {name!r}"})
                except (ValueError, UnicodeDecodeError) as e:
                    self._send(400, {"error": repr(e)[:300]})
                except Exception as e:
                    logging.getLogger(__name__).exception(
                        "internal error retrieving %s", self.path
                    )
                    self._send(500, {"error": repr(e)[:300]})

            def log_message(self, *a):  # quiet by default
                pass

        return Handler

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Bind + serve on a background thread; returns the bound port."""
        if self._httpd is not None:
            raise RuntimeError("server already started")
        if not self._models:
            raise RuntimeError("register at least one model first")
        self._httpd = _Httpd((host, port), self._handler())
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="scoring-server",
            daemon=True,
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def wait(self) -> None:
        """Block the calling thread until stop() (foreground serving)."""
        t = self._thread
        if t is not None:
            t.join()

    # -- request telemetry -------------------------------------------------- #
    def _record_request(self, model: Optional[str], code: int,
                        t0: float) -> None:
        """Count + time one request.  The model label is the requested
        name (resolved to the default for bare /score) so per-model p99s
        split cleanly; unroutable requests label as "-"."""
        label = model or self._default or "-"
        cls = _status_class(code or 500)
        dt = time.perf_counter() - t0
        _REQUESTS.inc(model=label, status=cls)
        _REQUEST_SECONDS.observe(dt, model=label, status=cls)

    # -- drain bookkeeping -------------------------------------------------- #
    def _begin_request(self) -> bool:
        with self._inflight_cv:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def _end_request(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._inflight_cv.notify_all()

    def stop(self, drain_timeout_s: float = 5.0) -> None:
        """Graceful drain then close: stop accepting (new scoring requests
        get 503), let in-flight requests finish within ``drain_timeout_s``,
        then tear the listener down.  A drain that exceeds the deadline is
        counted (stats ``server.drain_timeout``) and the close proceeds —
        a stop() must never hang on a stuck request.  Idempotent."""
        if self._httpd is None:
            return
        with self._inflight_cv:
            self._draining = True
            deadline = time.monotonic() + max(drain_timeout_s, 0.0)
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    stats.add("server.drain_timeout")
                    logging.getLogger(__name__).warning(
                        "server stop: %d request(s) still in flight after "
                        "%.1fs drain deadline; closing anyway",
                        self._inflight, drain_timeout_s,
                    )
                    break
                self._inflight_cv.wait(timeout=remaining)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._inflight_cv:
            self._draining = False  # a re-start()ed server accepts again
