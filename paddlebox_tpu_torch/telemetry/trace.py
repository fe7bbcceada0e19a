"""Span tracing: ``span("name")`` -> Chrome-trace-format JSON (reference:
paddlebox_tpu/telemetry/trace.py).

The host-side counterpart of the torch.profiler device trace
(utils/profiler.device_trace): these spans show where a pass spent its
host wall clock (plan, feed, step, dump; checkpoint saves, reshards,
shuffle exchanges), with parent/child nesting.  The output is the Chrome
trace event format ("traceEvents" with complete "X" events) that Perfetto
and chrome://tracing open.

Tracing to files is off by default; the always-on flight ring (flight.py)
still receives every span.  Nesting is tracked with a per-thread span
stack: children carry their parent's name in ``args``.  Trace files carry
a wall-clock anchor (``pboxWallT0``) beside the perf-counter timestamps,
so tools/pbox_doctor.py can merge spans from many processes onto one wall
time axis.  Under an active distributed trace context (context.py, the
traceparent carriage of the serving plane) a span runs under a child span
ID of it, and both outputs carry ``trace_id``, ``span_id`` and
``parent_span_id``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, Optional

from paddlebox_tpu_torch.telemetry import context as _context
from paddlebox_tpu_torch.telemetry import flight as _flight


class Tracer:
    """Collects span events; ``write(path)`` emits one Chrome-trace JSON."""

    def __init__(self, process_name: str = "pbox", pid: int = 0):
        self._lock = threading.Lock()
        self._events: list = []
        self._t0 = time.perf_counter()
        # wall instant matching _t0: lets an offline reader place these
        # perf-counter timestamps on the same axis as other processes'
        self._wall_t0 = time.time()
        self._tls = threading.local()
        self.pid = int(pid)  # rank, so multi-rank traces merge cleanly
        self.process_name = process_name

    # -- recording ---------------------------------------------------------- #
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **meta) -> Iterator[None]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        start = self._now_us()
        try:
            yield
        finally:
            dur = self._now_us() - start
            stack.pop()
            args = {k: v for k, v in meta.items()}
            if parent is not None:
                args["parent"] = parent
            ev = {
                "name": name,
                "ph": "X",
                "ts": start,
                "dur": dur,
                "pid": self.pid,
                "tid": threading.get_ident() % 2**31,
            }
            if args:
                ev["args"] = args
            with self._lock:
                self._events.append(ev)

    def now_us(self) -> float:
        """The tracer clock (µs since tracer start) — pair with
        :meth:`add_span` for retroactive spans."""
        return self._now_us()

    def add_span(self, name: str, start_us: float, dur_us: float,
                 **meta) -> None:
        """Record a span measured externally (e.g. around a blocking wait
        instrumented with its own timer)."""
        ev = {
            "name": name, "ph": "X", "ts": start_us, "dur": dur_us,
            "pid": self.pid, "tid": threading.get_ident() % 2**31,
        }
        if meta:
            ev["args"] = dict(meta)
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, **meta) -> None:
        """A zero-duration marker (pass boundaries, aborts)."""
        ev = {
            "name": name, "ph": "i", "s": "t",
            "ts": self._now_us(), "pid": self.pid,
            "tid": threading.get_ident() % 2**31,
        }
        if meta:
            ev["args"] = dict(meta)
        with self._lock:
            self._events.append(ev)

    # -- output ------------------------------------------------------------- #
    def drain(self) -> list:
        with self._lock:
            evs, self._events = self._events, []
            return evs

    def to_dict(self, events: Optional[list] = None) -> dict:
        evs = self.drain() if events is None else events
        meta = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": f"{self.process_name}-r{self.pid}"},
        }]
        return {
            "traceEvents": meta + evs,
            "displayTimeUnit": "ms",
            # extra top-level keys are ignored by Perfetto/chrome://tracing
            # but give pbox_doctor the wall-clock anchor + identity it
            # needs to merge traces across processes
            "pboxWallT0": self._wall_t0,
            "pboxRank": self.pid,
            "pboxProcess": self.process_name,
        }

    def write(self, path: str) -> str:
        """Flush collected spans to ``path`` (Perfetto-loadable) and clear
        the buffer; returns the path."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


# --------------------------------------------------------------------------- #
# process-global tracer (None = tracing off; span() is then a no-op)
# --------------------------------------------------------------------------- #
_lock = threading.Lock()
_tracer: Optional[Tracer] = None


def enable_tracing(pid: int = 0, process_name: str = "pbox") -> Tracer:
    """Install (or return) the process tracer; idempotent."""
    global _tracer
    with _lock:
        if _tracer is None:
            _tracer = Tracer(process_name=process_name, pid=pid)
        return _tracer


def disable_tracing() -> None:
    global _tracer
    with _lock:
        _tracer = None


def get_tracer() -> Optional[Tracer]:
    return _tracer


@contextlib.contextmanager
def _recorded_span(t: Optional[Tracer], name: str, meta: dict):
    """One span, recorded everywhere it belongs: the tracer (when file
    tracing is on), the always-on flight ring, and, when a distributed
    trace context is active, under a freshly allocated child span ID of it
    so that the parentage survives into the dump files."""
    ctx = _context.current()
    child = ctx.child() if ctx is not None else None
    tf: dict = {}
    if child is not None:
        tf = {"trace_id": child.trace_id, "span_id": child.span_id}
        if child.parent_span_id:
            tf["parent_span_id"] = child.parent_span_id
    start_wall = time.time()
    t0 = time.perf_counter()
    try:
        with _context.activate(child):
            if t is not None:
                with t.span(name, **{**meta, **tf}):
                    yield
            else:
                yield
    finally:
        flat = {
            k: v for k, v in meta.items()
            if isinstance(v, (str, int, float, bool))
        }
        _flight.record(
            "span", name, t=start_wall,
            dur_s=time.perf_counter() - t0, **flat, **tf,
        )


def span(name: str, **meta):
    """Record a span: always into the flight ring, into the Chrome-trace
    tracer when one is enabled, and under the active distributed trace
    context when one is installed."""
    return _recorded_span(_tracer, name, meta)


def instant(name: str, **meta) -> None:
    flat = {
        k: v for k, v in meta.items()
        if isinstance(v, (str, int, float, bool))
    }
    _flight.record("instant", name, **flat)
    t = _tracer
    if t is not None:
        t.instant(name, **{**meta, **_context.trace_fields()})


def flush_trace(path: str) -> Optional[str]:
    """Write and clear the active tracer's spans (None when disabled)."""
    t = _tracer
    if t is None:
        return None
    return t.write(path)
