"""Trace-context propagation: one trace ID across a request's path
(reference: paddlebox_tpu/telemetry/context.py).

A :class:`TraceContext` carries a 128-bit trace ID and a 64-bit span ID,
carried over HTTP in the W3C Trace Context ``traceparent`` header
(``00-<trace 32hex>-<span 16hex>-<flags 2hex>``): the scoring server
(inference/server.py) continues a caller's trace or mints one, records its
spans under it, and echoes the trace ID to the client
(``X-PBox-Trace-Id``).

The active context is thread-local (each HTTP handler thread serves one
request): :func:`activate` installs a context for a ``with`` scope,
:func:`current` reads it, and spans recorded while one is active carry
``trace_id``/``span_id``/``parent_span_id`` in both the Chrome-trace
output and the always-on flight ring (trace.py, flight.py).

IDs come from ``os.urandom``; the all-zero values the W3C spec reserves
are never generated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Iterator, Optional

TRACEPARENT_HEADER = "traceparent"
TRACE_ID_RESPONSE_HEADER = "X-PBox-Trace-Id"
REPLICA_RESPONSE_HEADER = "X-PBox-Replica"

_VERSION = "00"
_FLAGS_SAMPLED = "01"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One node of a distributed trace: the trace it belongs to, its own
    span ID, and (when not the root) the parent span it hangs under."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    parent_span_id: Optional[str] = None

    def child(self) -> "TraceContext":
        """A new span under this one, in the same trace."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            parent_span_id=self.span_id,
        )

    def to_traceparent(self) -> str:
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{_FLAGS_SAMPLED}"


def new_trace_id() -> str:
    tid = os.urandom(16).hex()
    # the spec reserves all-zeros as "absent"; urandom producing it is a
    # 2^-128 event but the retry costs nothing
    return tid if tid != "0" * 32 else new_trace_id()


def new_span_id() -> str:
    sid = os.urandom(8).hex()
    return sid if sid != "0" * 16 else new_span_id()


def new_root() -> TraceContext:
    """Mint a fresh trace (the router does this when a client arrives
    without a ``traceparent``; a bare replica does it for direct hits)."""
    return TraceContext(trace_id=new_trace_id(), span_id=new_span_id())


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """A :class:`TraceContext` continuing the caller's trace, or None for
    a missing/malformed header (never raises: a bad header from an
    arbitrary client must not turn a scorable request into an error)."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    # the caller's span becomes our parent: work recorded here is a child
    # of whatever sent the header
    return TraceContext(
        trace_id=trace_id, span_id=new_span_id(), parent_span_id=span_id
    )


def from_headers(headers) -> Optional[TraceContext]:
    """Parse the ``traceparent`` out of any mapping with ``.get`` (an
    ``http.client`` response, a ``BaseHTTPRequestHandler.headers``)."""
    return parse_traceparent(headers.get(TRACEPARENT_HEADER))


# --------------------------------------------------------------------------- #
# thread-local active context
# --------------------------------------------------------------------------- #
_tls = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Install ``ctx`` as this thread's active trace context for the
    scope (None = no-op passthrough, so call-sites stay unconditional)."""
    if ctx is None:
        yield None
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def trace_fields() -> dict:
    """The active context as span/event metadata fields (empty when no
    context is active — the zero-cost common case for batch training)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return {}
    out = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    if ctx.parent_span_id:
        out["parent_span_id"] = ctx.parent_span_id
    return out
