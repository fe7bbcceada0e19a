"""Admission control for the scoring server: bounded queue, deadline shed
(reference: paddlebox_tpu/inference/admission.py).

An overloaded scorer gains nothing by queuing deeper —
every queued request only inflates the tail of every request behind it.
The right overload response is to shed EARLY, at admission:

  * concurrency is capped at ``max_concurrency`` in-flight scoring calls
    (calibrated device batches; the device lock serializes anyway
    single-chip, so the default is 1);
  * at most ``max_queue`` requests wait for a slot, FIFO.  Arrival #
    ``max_queue+1`` is rejected immediately (429, reason ``queue_full``)
    — queue depth, and therefore worst-case admitted latency, is bounded
    by construction;
  * a request carrying a deadline is rejected up front when its
    ESTIMATED wait (queue position x EWMA service time / concurrency)
    already exceeds the deadline, and again if the deadline expires while
    it is still queued (reason ``deadline``) — a client that would time
    out anyway never occupies a slot.

Every shed carries a ``retry_after_s`` hint (the current wait estimate)
that the HTTP layer surfaces as ``Retry-After``.  Exported state:
``serve.queue_depth`` (gauge), ``serve.shed_total`` (counter by reason)
and ``serve.admission_wait_seconds`` (histogram of admitted waits).
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Optional

from paddlebox_tpu_torch import telemetry

_QUEUE_DEPTH = telemetry.gauge(
    "serve.queue_depth",
    help="scoring requests waiting for an admission slot",
)
_SHED = telemetry.counter(
    "serve.shed_total",
    help="scoring requests shed at admission, by reason",
)
_ADMIT_WAIT = telemetry.histogram(
    "serve.admission_wait_seconds",
    help="queue wait of ADMITTED scoring requests",
)
_BATCH_SIZE = telemetry.histogram(
    "serve.batch_size",
    help="requests coalesced per micro-batch device call",
)
_BATCH_FALLBACKS = telemetry.counter(
    "serve.batch_fallbacks",
    help="coalesced batches whose combined call raised and re-scored "
         "each request alone (per-request error isolation)",
)


class ShedRequest(Exception):
    """The gate refused this request; serve 429 with ``Retry-After``."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(f"shed ({reason}); retry after "
                         f"{retry_after_s:.2f}s")
        self.reason = reason
        self.retry_after_s = max(retry_after_s, 0.0)

    @property
    def retry_after_header(self) -> str:
        """Retry-After is delta-seconds, integral, and at least 1 — a
        zero would invite an immediate identical retry."""
        return str(max(1, math.ceil(self.retry_after_s)))


class AdmissionGate:
    """Bounded-FIFO admission for one server's scoring path.

    Usage::

        gate.admit(deadline_s)   # raises ShedRequest, else holds a slot
        try:  ... score ...
        finally: gate.release(service_s)

    ``release`` feeds the EWMA service-time estimate the wait predictions
    are built on; pass the measured scoring wall time.
    """

    def __init__(self, max_concurrency: int = 1, max_queue: int = 64,
                 default_deadline_s: Optional[float] = None,
                 initial_service_s: float = 0.05,
                 ewma_alpha: float = 0.2):
        if max_concurrency < 1:
            raise ValueError("max_concurrency must be >= 1")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self.max_concurrency = int(max_concurrency)
        self.max_queue = int(max_queue)
        self.default_deadline_s = default_deadline_s
        self._alpha = float(ewma_alpha)
        self._ewma_service_s = float(initial_service_s)
        self._cv = threading.Condition()
        self._active = 0
        self._queue: collections.deque = collections.deque()  # ticket FIFO
        self._next_ticket = 0

    # -- introspection ------------------------------------------------------ #
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def active(self) -> int:
        with self._cv:
            return self._active

    def service_estimate_s(self) -> float:
        with self._cv:
            return self._ewma_service_s

    def estimated_wait_s(self, n_ahead: Optional[int] = None) -> float:
        """Predicted queue wait for a request with ``n_ahead`` requests
        (active + queued) in front of it; defaults to the current line."""
        with self._cv:
            if n_ahead is None:
                n_ahead = self._active + len(self._queue)
            return n_ahead * self._ewma_service_s / self.max_concurrency

    # -- admit / release ----------------------------------------------------- #
    def admit(self, deadline_s: Optional[float] = None) -> None:
        """Block until a scoring slot is held, FIFO.  Raises
        :class:`ShedRequest` instead of queuing when the queue is full or
        the (estimated, then actual) wait exceeds the deadline."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        t0 = time.monotonic()
        with self._cv:
            ahead = self._active + len(self._queue)
            est = ahead * self._ewma_service_s / self.max_concurrency
            # the queue bound must hold even in the instant between a
            # release and the head waiter waking (active is transiently
            # below the cap while the queue is still full — admitting
            # then would grow the queue without bound)
            if len(self._queue) >= self.max_queue and (
                self._queue or self._active >= self.max_concurrency
            ):
                _SHED.inc(reason="queue_full")
                raise ShedRequest("queue_full", est)
            if deadline_s is not None and deadline_s > 0 \
                    and est > deadline_s:
                _SHED.inc(reason="deadline")
                raise ShedRequest("deadline", est)
            if self._active < self.max_concurrency and not self._queue:
                self._active += 1
                _ADMIT_WAIT.observe(0.0)
                return
            ticket = self._next_ticket
            self._next_ticket += 1
            self._queue.append(ticket)
            _QUEUE_DEPTH.set(len(self._queue))
            try:
                while True:
                    if self._queue and self._queue[0] == ticket \
                            and self._active < self.max_concurrency:
                        self._queue.popleft()
                        self._active += 1
                        _QUEUE_DEPTH.set(len(self._queue))
                        _ADMIT_WAIT.observe(time.monotonic() - t0)
                        # our departure may have made a successor eligible
                        self._cv.notify_all()
                        return
                    remaining = None
                    if deadline_s is not None and deadline_s > 0:
                        remaining = deadline_s - (time.monotonic() - t0)
                        if remaining <= 0:
                            _SHED.inc(reason="deadline")
                            raise ShedRequest(
                                "deadline",
                                self._position_wait_locked(ticket),
                            )
                    self._cv.wait(timeout=remaining)
            except BaseException:
                # ANY exit while queued (shed, KeyboardInterrupt into a
                # worker thread, ...) must remove the ticket: a dead
                # ticket left at the head would starve every successor
                # into deadline sheds forever
                self._queue.remove(ticket)
                _QUEUE_DEPTH.set(len(self._queue))
                self._cv.notify_all()
                raise

    def _position_wait_locked(self, ticket) -> float:
        """Wait estimate for a ticket still in line (cv held)."""
        try:
            pos = self._queue.index(ticket)
        except ValueError:
            pos = len(self._queue)
        return (self._active + pos) * self._ewma_service_s \
            / self.max_concurrency

    def release(self, service_s: Optional[float] = None) -> None:
        """Free the slot held by a completed (or failed) scoring call.
        ``service_s`` (measured scoring wall time) feeds the EWMA the
        shed decisions predict waits from."""
        with self._cv:
            self._active -= 1
            assert self._active >= 0, "release() without admit()"
            if service_s is not None and service_s >= 0:
                self._ewma_service_s += self._alpha * (
                    service_s - self._ewma_service_s
                )
            self._cv.notify_all()


# --------------------------------------------------------------------------- #
# Continuous micro-batching: batch-at-dequeue coalescing of ADMITTED
# requests.  The gate stays the admission/shed authority (every request
# still holds exactly one admit()ed slot for its whole life — the ticket
# protocol is untouched); what changes is what happens AFTER admission:
# instead of each request dispatching its own padded-bucket device call,
# concurrently admitted requests for the same model coalesce into ONE
# combined `score_lines` call and the scores demultiplex back to the
# waiting handlers in FIFO submission order.  Scoring stays per-instance
# row-independent (padding/segment rules in predictor.py), so batched
# scores equal sequential ones (tests/test_torch_server.py).
# --------------------------------------------------------------------------- #
_PENDING, _CLAIMED, _DONE = 0, 1, 2


class _Job:
    """One admitted request waiting for (or leading) a micro-batch."""

    __slots__ = ("body", "deadline_at", "state", "scores", "clipped",
                 "error", "service_s")

    def __init__(self, body: bytes, deadline_at: Optional[float]):
        self.body = body
        self.deadline_at = deadline_at  # monotonic; None = no deadline
        self.state = _PENDING
        self.scores: Optional[list] = None
        self.clipped = 0
        self.error: Optional[BaseException] = None
        self.service_s: Optional[float] = None


class BatchCoalescer:
    """Leader-elected micro-batcher for one ScoringServer.

    Lifecycle of a request: the HTTP handler admits at the gate, then
    submits a job here.  The first pending job for a model with no active
    leader becomes the LEADER: it lingers up to ``linger_s`` for the
    batch to fill (cutting immediately when nothing else is in flight —
    an idle queue never waits), claims up to ``max_batch`` jobs FIFO,
    sheds any whose deadline expired while the batch formed (429, never
    scored), and scores the rest through ONE ``server.score_lines`` call
    — which pins ONE predictor snapshot for the whole batch, so a
    concurrent hot swap can never split a batch across two predictors.
    Followers wait; the leader demultiplexes scores (and per-request
    clipped-instance attribution) back to them.

    Error isolation: a combined call that raises (one request's
    malformed payload would otherwise fail its batch mates) falls back
    to scoring each request alone, reproducing exact per-request error
    semantics.
    """

    def __init__(self, server, max_batch: int, linger_s: float):
        self._server = server
        self.max_batch = max(1, int(max_batch))
        self.linger_s = max(0.0, float(linger_s))
        self._cv = threading.Condition()
        self._pending: dict = {}  # model name -> FIFO [_Job, ...]
        self._leading: set = set()  # models with an active batch leader
        self._inside = 0  # jobs submitted here and not yet returned

    # -- request-thread entry ------------------------------------------------ #
    def score(self, body: bytes, name: Optional[str],
              deadline_at: Optional[float]) -> _Job:
        """Coalesce-and-score one admitted request; returns its finished
        job (scores + clipped count + measured batch service time).
        Raises the per-request error (ShedRequest for a deadline that
        expired mid-linger, parse/model errors otherwise)."""
        server = self._server
        with server._meta_lock:
            model = name or server._default
            if model not in server._models:
                raise KeyError(name)
        job = _Job(body, deadline_at)
        with self._cv:
            self._pending.setdefault(model, []).append(job)
            self._inside += 1
            self._cv.notify_all()
        try:
            while True:
                batch = None
                with self._cv:
                    # wait until our job finished, or the model has no
                    # leader and our job is still pending (then lead)
                    while job.state != _DONE and (
                        job.state != _PENDING or model in self._leading
                    ):
                        # bounded wait: insurance against a lost wakeup,
                        # never a pacing mechanism
                        self._cv.wait(0.05)
                    if job.state == _DONE:
                        break
                    self._leading.add(model)
                    batch = self._cut_batch_locked(model)
                try:
                    self._run_batch(model, batch)
                finally:
                    with self._cv:
                        self._leading.discard(model)
                        for j in batch:
                            j.state = _DONE
                            if j.error is None and j.scores is None:
                                # belt-and-braces: a leader crash between
                                # claim and demux must not strand mates
                                j.error = RuntimeError(
                                    "micro-batch leader failed before demux"
                                )
                        self._cv.notify_all()
        finally:
            with self._cv:
                self._inside -= 1
        if job.error is not None:
            raise job.error
        return job

    # -- leader internals ---------------------------------------------------- #
    def _cut_batch_locked(self, model: str) -> list:
        """Linger (cv held) until the forming batch fills, the linger
        window expires, or no further request is in flight; then claim
        up to ``max_batch`` jobs FIFO."""
        q = self._pending[model]
        gate = self._server.gate
        # per-scenario serving policy: a model's configured linger
        # (ScoringServer.set_serving_policy) overrides the server-wide
        # default — leaders are per-model, so the override is exact
        policy_fn = getattr(self._server, "_policy_linger_s", None)
        linger_s = policy_fn(model) if policy_fn is not None else None
        if linger_s is None:
            linger_s = self.linger_s
        deadline = time.monotonic() + linger_s
        while len(q) < self.max_batch:
            # an idle queue never waits: linger only while more requests
            # are demonstrably in flight (admitted at the gate but not
            # yet submitted here, or still queued behind the gate)
            if gate.active() <= self._inside and gate.queue_depth() == 0:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._cv.wait(remaining)
        batch = q[: self.max_batch]
        del q[: self.max_batch]
        for j in batch:
            j.state = _CLAIMED
        return batch

    def _run_batch(self, model: str, batch: list) -> None:
        """Shed expired jobs, score the rest as ONE combined call, and
        demultiplex scores/clipped attribution back per request."""
        server = self._server
        now = time.monotonic()
        live, counts, all_lines = [], [], []
        for j in batch:
            if j.deadline_at is not None and now > j.deadline_at:
                # the deadline expired while the batch formed (queued or
                # mid-linger): shed with 429, never scored — same
                # contract as the gate's in-queue deadline shed
                _SHED.inc(reason="deadline")
                j.error = ShedRequest(
                    "deadline", server.gate.estimated_wait_s())
                continue
            try:
                lines = [ln for ln in j.body.decode().splitlines()
                         if ln.strip()]
            except UnicodeDecodeError as e:
                j.error = e  # per-request 400; batch mates unaffected
                continue
            live.append(j)
            counts.append(len(lines))
            all_lines.extend(lines)
        if not live:
            return
        t0 = time.perf_counter()
        try:
            combined = ("\n".join(all_lines) + "\n").encode()
            scores = server.score_lines(combined, model)
            if len(scores) != len(all_lines):
                raise ValueError(
                    f"scorer returned {len(scores)} scores for "
                    f"{len(all_lines)} lines; cannot demultiplex"
                )
        except Exception:
            # one bad request must not fail its batch mates: re-score
            # each alone so the error lands on exactly the request that
            # caused it.  Counted + logged — a sustained rate here means
            # batches keep degrading to sequential and the win is gone.
            _BATCH_FALLBACKS.inc()
            logging.getLogger(__name__).debug(
                "micro-batch combined call failed; re-scoring %d "
                "request(s) individually", len(live), exc_info=True,
            )
            self._score_individually(live, model)
            return
        dt = time.perf_counter() - t0
        _BATCH_SIZE.observe(len(live))
        clipped_ids = getattr(server._tls, "clipped_ids", None) or ()
        lo = 0
        for j, n in zip(live, counts):
            j.scores = scores[lo: lo + n]
            j.clipped = sum(1 for i in clipped_ids if lo <= i < lo + n)
            j.service_s = dt
            lo += n
        if len(live) > 1:
            # score_lines counted the combined call as ONE request; the
            # per-model serving counters describe client requests
            server._count_extra_requests(model, len(live) - 1)

    def _score_individually(self, live: list, model: str) -> None:
        """Fallback when the combined call raises: score each request
        alone so errors (malformed lines, schema mismatches) attach to
        exactly the request that caused them — sequential semantics."""
        server = self._server
        for j in live:
            t0 = time.perf_counter()
            try:
                j.scores = server.score_lines(j.body, model)
                j.clipped = getattr(server._tls, "clipped", 0)
                j.service_s = time.perf_counter() - t0
            except Exception as e:
                j.error = e
