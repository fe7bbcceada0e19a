"""Rank-tagged JSONL event and metrics log (reference:
paddlebox_tpu/telemetry/events.py).

One JSON object a line, each tagged with wall time and rank:

    {"t": <unix seconds>, "rank": <int>, "event": "<name>", ...fields}

The per-pass record the trainers emit is ``event="pass_end"`` carrying the
pass metrics and the registry's DELTA snapshot (this pass's counts, not
the job's cumulative ones).

Rotation: when the live file crosses ``PADDLEBOX_TORCH_EVENTS_MAX_MB`` (0
disables) it rotates shift-style (``events.jsonl`` -> ``events.jsonl.1``
-> ``.2`` ...), keeping the last ``keep_files`` generations, after a
completed record, so no line is torn by the rotation.

Every event also lands in the always-on flight ring (scalar fields only).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.telemetry import flight
from paddlebox_tpu_torch.telemetry.metrics import registry

DEFAULT_KEEP_FILES = 5


def _flight_fields(fields: dict) -> dict:
    """Scalar projection of an event for the flight ring (dict/list
    payloads like pass metrics stay in the JSONL, not the ring)."""
    return {
        k: v for k, v in fields.items()
        if isinstance(v, (str, int, float, bool))
    }


def _default_rank() -> int:
    """The launcher's rank (PADDLEBOX_TORCH_PROCESS_ID), read without
    touching the device."""
    try:
        return int(flags.process_id)
    except ValueError:
        return 0


class EventLog:
    """Append-only JSONL writer; every ``log`` line is flushed (a killed
    rank's artifact stays readable up to its last event)."""

    def __init__(self, path: str, rank: Optional[int] = None,
                 max_mb: Optional[float] = None,
                 keep_files: int = DEFAULT_KEEP_FILES):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self.rank = _default_rank() if rank is None else int(rank)
        if max_mb is None:
            max_mb = flags.events_max_mb
        self.max_bytes = int(float(max_mb) * 1e6)  # <= 0 disables rotation
        self.keep_files = max(int(keep_files), 1)
        self._lock = threading.Lock()
        self._f = open(path, "a")

    def log(self, event: str, **fields) -> None:
        rec = {"t": time.time(), "rank": self.rank, "event": event, **fields}
        line = json.dumps(rec, default=_json_default)
        flight.record("event", event, **_flight_fields(fields))
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            if self.max_bytes > 0 and self._f.tell() >= self.max_bytes:
                # rotation must be
                # atomic with the write stream: a writer admitted mid-
                # rotate would tear a line across generations
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Shift-rotate under the lock, after a completed record: the
        live file always ends on a whole line, and a reader following
        ``path`` only ever misses history, never sees a torn tail."""
        try:
            self._f.close()
            for i in range(self.keep_files - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        except OSError:
            # rotation is best-effort: a rename failure must not kill the
            # event stream — keep appending to whatever we can open
            pass
        self._f = open(self.path, "a")

    def log_pass(self, pass_metrics: dict, telemetry: dict = None,
                 **fields) -> dict:
        """The per-pass record: pass metrics + this pass's metric deltas.

        Returns the delta snapshot it logged: ``delta_snapshot()`` resets
        its baseline per call, so the health monitor must evaluate the
        SAME window the JSONL record carries, not take a second (empty)
        snapshot.  Callers that evaluate health FIRST (so the window's
        ``health_alert`` events precede its ``pass_end`` record in the
        stream) pass the snapshot they already took via ``telemetry``."""
        snap = registry.delta_snapshot() if telemetry is None else telemetry
        self.log("pass_end", metrics=pass_metrics, telemetry=snap, **fields)
        return snap

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _json_default(o):
    """Numpy scalars and other non-JSON leaves degrade to floats/strings
    instead of killing the event write."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return repr(o)


# --------------------------------------------------------------------------- #
# per-process singleton (PADDLEBOX_TORCH_EVENTS_PATH /
# TelemetryConfig.events_path)
# --------------------------------------------------------------------------- #
_lock = threading.Lock()
_event_log: Optional[EventLog] = None


def ensure_event_log(path: Optional[str] = None) -> Optional[EventLog]:
    """Open the process's event log once (None = read the flag; "" = off)."""
    global _event_log
    with _lock:
        if _event_log is not None:
            return _event_log
        if path is None:
            path = flags.events_path
        if not path:
            return None
        # ensure-singleton: the log
        # (and its open()) must be constructed under the module lock or
        # two racing callers each open the file
        _event_log = EventLog(path)
        return _event_log


def close_event_log() -> None:
    global _event_log
    with _lock:
        if _event_log is not None:
            _event_log.close()
            _event_log = None


def emit_event(event: str, **fields) -> None:
    """Log to the process event log if one is open; the flight ring gets
    the (scalar) record either way: post-mortems must not depend on an
    events path having been set."""
    el = _event_log
    if el is not None:
        el.log(event, **fields)
    else:
        flight.record("event", event, **_flight_fields(fields))
