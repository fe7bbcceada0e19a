"""Prometheus text exposition and the standalone ``/metrics`` listener
(reference: paddlebox_tpu/telemetry/export.py).

``render_prometheus`` turns the typed registry into the text exposition
format (version 0.0.4): counters as ``<name>_total``, histograms as
cumulative ``_bucket{le=}`` series plus ``_sum``/``_count``; names are
sanitized (``train.nan_rollback`` -> ``train_nan_rollback``) and label
values escaped.

``MetricsExporter`` serves exactly ``/metrics`` (and ``/healthz``) on
127.0.0.1 from a daemon thread that ``stop()`` retires.
``ensure_exporter()`` starts one a process from ``TelemetryConfig`` or
``PADDLEBOX_TORCH_METRICS_PORT``; both trainers call it at pass start.
Where the reference logs a failed bind and trains on without an exporter,
the port raises: a configured exporter that is not there is a fault, not
a fallback.
"""

from __future__ import annotations

import logging
import re
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    registry as _global_registry,
)

logger = logging.getLogger(__name__)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _labels_str(items, extra: str = "") -> str:
    parts = [
        f'{_LABEL_RE.sub("_", k)}="{_escape(v)}"' for k, v in items
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_prometheus(reg: Optional[MetricRegistry] = None) -> str:
    """The registry as Prometheus text exposition (one trailing newline)."""
    reg = reg or _global_registry
    lines: list = []
    for m in reg.metrics():
        pname = _name(m.name)
        if isinstance(m, Counter):
            pname += "_total"
        if m.help:
            lines.append(f"# HELP {pname} {_escape(m.help)}")
        lines.append(f"# TYPE {pname} "
                     f"{'untyped' if m.kind == 'untyped' else m.kind}")
        series = m.series()
        if isinstance(m, (Counter, Gauge)):
            for key, cell in sorted(series.items()):
                lines.append(
                    f"{pname}{_labels_str(key)} {_fmt_value(cell[0])}"
                )
        elif isinstance(m, Histogram):
            for key, s in sorted(series.items()):
                cum = 0
                for i, edge in enumerate(m.boundaries):
                    cum += s.counts[i]
                    le = _labels_str(key, f'le="{_fmt_value(edge)}"')
                    lines.append(f"{pname}_bucket{le} {cum}")
                cum += s.counts[len(m.boundaries)]
                le = _labels_str(key, 'le="+Inf"')
                lines.append(f"{pname}_bucket{le} {cum}")
                lines.append(f"{pname}_sum{_labels_str(key)} "
                             f"{_fmt_value(s.sum)}")
                lines.append(f"{pname}_count{_labels_str(key)} {s.count}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Minimal threaded HTTP listener serving ``GET /metrics``.

    For processes with no HTTP surface of their own (trainers).
    ``start(port)`` returns the bound port (0 picks a free one); ``stop()``
    tears the listener down.  The server thread holds the server and the
    registry, never the exporter, and an exporter that is collected
    without a ``stop()`` shuts its server down through a finalizer
    (utils/workers.py's rule for the port's threads).
    """

    def __init__(self, reg: Optional[MetricRegistry] = None):
        self._registry = reg or _global_registry
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._finalizer = None

    def _handler(self):
        registry = self._registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/metrics":
                    body = render_prometheus(registry).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                elif self.path == "/healthz":
                    body = b'{"ok": true}'
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are periodic: stay quiet
                pass

        return Handler

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        if self._httpd is not None:
            raise RuntimeError("exporter already started")
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        self._finalizer = weakref.finalize(
            self, _shutdown, self._httpd, self._thread)
        return self._httpd.server_address[1]

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None else self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._finalizer.detach()
        _shutdown(self._httpd, self._thread)
        self._httpd = self._thread = self._finalizer = None


def _shutdown(httpd: ThreadingHTTPServer, thread: threading.Thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=5.0)


# --------------------------------------------------------------------------- #
# per-process singleton (PADDLEBOX_TORCH_METRICS_PORT /
# TelemetryConfig.metrics_port)
# --------------------------------------------------------------------------- #
_exporter_lock = threading.Lock()
_exporter: Optional[MetricsExporter] = None


def ensure_exporter(port: Optional[int] = None) -> Optional[MetricsExporter]:
    """Start the process's exporter once (None = read the flag).  A port of
    0, or None with no flag, means "no exporter" and returns None; a bind
    failure raises OSError."""
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            return _exporter
        if port is None:
            port = flags.metrics_port
        if not port or port <= 0:
            return None
        exp = MetricsExporter()
        bound = exp.start(port=port)
        logger.info("metrics exporter listening on :%d/metrics", bound)
        _exporter = exp
        return _exporter


def stop_exporter() -> None:
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            _exporter.stop()
            _exporter = None
