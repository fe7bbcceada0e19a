"""Always-on flight recorder: the last N things this process did
(reference: paddlebox_tpu/telemetry/flight.py).

Record always, into a cheap bounded ring in memory, and dump the ring to a
timestamped JSON file only when something goes wrong: a ``PassRolledBack``
(the trainer dumps before raising), a ``DistributedStallError`` (the
liveness watchdog dumps as it trips the abort, parallel/watchdog.py), a
critical health alert, SIGTERM (:func:`install_signal_dump`).

Each record is a dict ``{"t": wall, "kind": span|event|instant, "name",
...fields}``.  The ring is a ``deque(maxlen=N)`` behind one lock;
evictions of never-dumped records are counted (``trace.dropped_spans``).

Dumps land in ``PADDLEBOX_TORCH_FLIGHT_DIR`` (else the JSONL event file's
directory when only an events path is set; with neither, dumping is a
no-op and only the in-memory ring exists).  The file carries the ring,
the full metric snapshot at dump time and the dump's reason and detail:
everything ``tools/pbox_doctor.py`` reads.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import socket
import subprocess
import threading
import time
from typing import Optional

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.telemetry import context as _context
from paddlebox_tpu_torch.telemetry.metrics import registry

logger = logging.getLogger(__name__)

_DROPPED = registry.counter(
    "trace.dropped_spans",
    help="flight-ring records evicted before any dump captured them",
)
_DUMPS = registry.counter(
    "flight.dumps", help="flight-recorder dumps written, by reason"
)

DEFAULT_RING = 512


def _default_rank() -> int:
    try:
        return int(flags.process_id)
    except ValueError:
        return 0


# --------------------------------------------------------------------------- #
# run identity: the correlation key across bench rows, dumps and history
# --------------------------------------------------------------------------- #
_identity_lock = threading.Lock()
_identity: Optional[dict] = None
_run_backend: Optional[str] = None


def set_run_backend(name: str) -> None:
    """Record the backend this run actually uses ("cuda", "cpu").  Identity
    stamping never initializes a device itself (a crash dump is exactly
    when it cannot afford to block): whoever does tells us, and until
    then it reads "unset"."""
    global _run_backend, _identity
    with _identity_lock:
        _run_backend = str(name)
        if _identity is not None:
            _identity["backend"] = _run_backend


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=5,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _device_name() -> str:
    """The first CUDA device's name, only where CUDA is already
    initialized (a dump never initializes the device)."""
    import torch

    if torch.cuda.is_initialized():
        return torch.cuda.get_device_name(0)
    return "none"


def run_identity() -> dict:
    """Who/what/when of this process's run: git sha, a wall timestamp
    anchored at first call, backend, torch version, CUDA device name,
    host.  Cached after the first call: cheap and hang-free from then on,
    so dumps can stamp it."""
    global _identity
    with _identity_lock:
        if _identity is not None:
            return dict(_identity)
    # resolve the slow pieces (a git subprocess spawn, the torch import)
    # outside the lock: two racing first callers just do the work twice
    sha = _git_sha()
    import torch

    torch_version = str(torch.__version__)
    device = _device_name()
    with _identity_lock:
        if _identity is None:
            _identity = {
                "git_sha": sha,
                "started_at": time.time(),
                "started_monotonic": time.monotonic(),
                "backend": _run_backend or "unset",
                "torch_version": torch_version,
                "device": device,
                "host": socket.gethostname(),
                "pid": os.getpid(),
            }
        return dict(_identity)


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry records + dump-to-JSON.

    ``name`` labels the process role in dumps (``router``, ``replica``,
    ``trainer`` ...) so the doctor's merged timeline reads as a story,
    not a pid list."""

    def __init__(self, capacity: int = DEFAULT_RING,
                 rank: Optional[int] = None, name: str = "pbox"):
        self.capacity = max(int(capacity), 1)
        self.rank = _default_rank() if rank is None else int(rank)
        self.name = name
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self._dumps = 0

    # -- recording ----------------------------------------------------------- #
    def record(self, kind: str, name: str, /, **fields) -> None:
        rec = {"t": time.time(), "kind": kind, "name": name}
        # the active distributed trace context's IDs (context.py); a span
        # passes its own child IDs in ``fields``, which override these
        rec.update(_context.trace_fields())
        for k, v in fields.items():
            if k in ("kind", "name"):
                # an event's own "kind"/"name" field (e.g. the published
                # event's kind=base) must not clobber the ring schema
                k = "field_" + k
            rec[k] = v  # "t" override IS allowed: spans record start time
        with self._lock:
            if len(self._ring) == self.capacity:
                _DROPPED.inc()
            self._ring.append(rec)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- dumping ------------------------------------------------------------- #
    def dump(self, reason: str, detail: Optional[dict] = None,
             dump_dir: Optional[str] = None) -> Optional[str]:
        """Write the ring + a full metric snapshot to
        ``flight-<name>-r<rank>-pid<pid>-<reason>-<ms>.json`` under the
        flight dir; returns the path (None when no dir is configured —
        recording still happened, there is just nowhere to put it).
        Never raises: a failing dump must not mask the failure that
        triggered it."""
        try:
            d = dump_dir or resolve_flight_dir()
            if not d:
                return None
            os.makedirs(d, exist_ok=True)
            now = time.time()
            payload = {
                "schema": "pbox-flight-1",
                "t": now,
                "proc": self.name,
                "rank": self.rank,
                "pid": os.getpid(),
                "reason": reason,
                "detail": dict(detail or {}),
                "run": run_identity(),
                "ring": self.snapshot(),
                "metrics": registry.snapshot(),
            }
            fname = (f"flight-{self.name}-r{self.rank}-pid{os.getpid()}"
                     f"-{reason}-{int(now * 1e3)}.json")
            path = os.path.join(d, fname)
            # two dumps in the same millisecond (e.g. two critical health
            # alerts from one window) must not overwrite each other
            seq = 1
            while os.path.exists(path):
                path = os.path.join(d, f"{fname[:-5]}-{seq}.json")
                seq += 1
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, default=_json_default)
            os.replace(tmp, path)
            self._dumps += 1
            _DUMPS.inc(reason=reason)
            logger.warning("flight recorder dumped (%s) -> %s", reason, path)
            return path
        except Exception:
            logger.exception("flight dump (%s) failed; continuing", reason)
            return None


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return repr(o)


def resolve_flight_dir() -> str:
    """Where dumps go: ``PADDLEBOX_TORCH_FLIGHT_DIR``, else the JSONL event
    file's directory (PADDLEBOX_TORCH_EVENTS_PATH), else "" (no
    dumping)."""
    d = flags.flight_dir
    if d:
        return d
    ev = flags.events_path
    if ev:
        return os.path.dirname(os.path.abspath(ev))
    return ""


# --------------------------------------------------------------------------- #
# process-global recorder: ALWAYS on (that is the point)
# --------------------------------------------------------------------------- #
_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None


def recorder() -> FlightRecorder:
    global _recorder
    r = _recorder
    if r is None:
        with _lock:
            if _recorder is None:
                _recorder = FlightRecorder(capacity=flags.flight_ring)
            r = _recorder
    return r


def set_process_name(name: str) -> None:
    """Label this process's dumps (``router``/``replica``/``trainer``)."""
    recorder().name = name


def record(kind: str, name: str, /, **fields) -> None:
    recorder().record(kind, name, **fields)


def dump_flight(reason: str, detail: Optional[dict] = None,
                dump_dir: Optional[str] = None) -> Optional[str]:
    return recorder().dump(reason, detail=detail, dump_dir=dump_dir)


def reset_for_tests(capacity: int = DEFAULT_RING) -> FlightRecorder:
    """Swap in a fresh ring (tests only; the global stays always-on)."""
    global _recorder
    with _lock:
        _recorder = FlightRecorder(capacity=capacity)
        return _recorder


# --------------------------------------------------------------------------- #
# SIGTERM dump hook
# --------------------------------------------------------------------------- #
_prev_sigterm = None
_sigterm_installed = False


def install_signal_dump() -> bool:
    """Dump the flight ring when SIGTERM arrives, then hand the signal to
    whatever handler was there before (default: terminate).  Only the
    main thread may install handlers; returns False (and stays silent)
    anywhere else — a replica's serve loop installs it at startup."""
    global _prev_sigterm, _sigterm_installed
    if _sigterm_installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False

    def _on_term(signum, frame):
        dump_flight("sigterm", {"signum": int(signum)})
        prev = _prev_sigterm
        if callable(prev):
            prev(signum, frame)
        else:
            # restore + re-raise so the default disposition still kills us
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
        _sigterm_installed = True
        return True
    except (ValueError, OSError):  # non-main thread raced us / no signals
        return False
