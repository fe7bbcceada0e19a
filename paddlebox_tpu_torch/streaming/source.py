"""Watermarked record sources over a bounded, backpressured buffer
(reference: paddlebox_tpu/streaming/source.py).

A :class:`StreamSource` turns a live feed into what the mini-pass
scheduler consumes: a bounded queue of ``StreamRecord(line, event_ts)``
with a watermark, the event time of the newest record handed downstream.
``stream.watermark_lag_seconds`` (now - watermark) says how far behind
live the training loop runs.

Backpressure, not loss: when the consumer lags, the producer blocks on the
bounded buffer and the watermark lag grows; the freshness policy reacts by
widening windows.  Shutdown has two phases: ``stop()`` is the graceful
drain (the producer makes one final sweep that ignores the stop flag, so
everything already written lands in the buffer), and ``close()`` kills
the producer only if that drain cannot finish within its timeout.

  * :class:`TailingFileSource` — follows growing part files and new shards
    under a root.  A last line without its newline is held back whole and
    read again on the next poll, never emitted torn
    (``stream.torn_tail_held``); ``*.tmp`` and hidden files are skipped.
    Fault site ``stream.tail`` fires once a poll: a failure is counted and
    retried next poll; a hang wedges the feed, the stall the watchdog's
    ``feed`` stage must catch.
  * :class:`SocketSource` — newline-delimited records over TCP; a sender
    that dies mid-line contributes nothing of that line.
  * :class:`IterableSource` — replays a fixed sequence (tests, the
    determinism checks).
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import threading
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.queues import bounded_put

logger = logging.getLogger(__name__)

_WATERMARK_LAG = telemetry.gauge(
    "stream.watermark_lag_seconds",
    help="now - event time of the newest record handed downstream",
)
_INGESTED = telemetry.counter(
    "stream.records_ingested", help="records emitted by stream sources"
)
_TORN_HELD = telemetry.counter(
    "stream.torn_tail_held",
    help="partially-written tail lines held back whole for the next poll",
)


@dataclass(frozen=True)
class StreamRecord:
    """One stream record: the raw slot-text line + its event time (the
    moment the record entered the system — arrival at the source)."""

    line: str
    event_ts: float


class StreamSource:
    """Bounded record buffer + watermark; subclasses produce into it.

    Lifecycle: ``start()`` spawns the producer thread(s); ``stop()``
    stops producing (the subclass performs ONE final drain poll first so
    everything already written is picked up) and marks EOF; the consumer
    keeps ``get()``-ing until ``drained``.
    """

    def __init__(self, buffer_records: int = 1 << 16):
        self._buf: "queue.Queue[StreamRecord]" = queue.Queue(
            maxsize=max(int(buffer_records), 1)
        )
        self._stop_evt = threading.Event()
        self._kill_evt = threading.Event()  # hard kill: abandon the drain
        self._eof = threading.Event()
        self._wm_lock = threading.Lock()
        self._watermark: Optional[float] = None

    # -- producer side ---------------------------------------------------- #
    def _emit(self, line: str, event_ts: Optional[float] = None,
              abort=None) -> bool:
        """Enqueue one record, blocking under backpressure.  ``abort`` is
        the predicate that gives up the wait (default: the graceful stop
        flag; the final drain passes the kill flag instead so stop()
        does not abort its own drain).  Returns False when aborted before
        the record fit."""
        rec = StreamRecord(line, time.time() if event_ts is None else event_ts)
        ok = bounded_put(
            self._buf, rec,
            self._stop_evt.is_set if abort is None else abort,
            poll_s=0.05,
        )
        if ok:
            _INGESTED.inc()
        return ok

    # -- consumer side ---------------------------------------------------- #
    def get(self, timeout: float = 0.2) -> Optional[StreamRecord]:
        """Next record, or None on timeout.  Advances the watermark."""
        try:
            rec = self._buf.get(timeout=timeout)
        except queue.Empty:
            return None
        with self._wm_lock:
            if self._watermark is None or rec.event_ts > self._watermark:
                self._watermark = rec.event_ts
        _WATERMARK_LAG.set(max(0.0, time.time() - rec.event_ts))
        return rec

    def watermark(self) -> Optional[float]:
        """Event time of the newest record handed downstream (None before
        the first record)."""
        with self._wm_lock:
            return self._watermark

    def watermark_lag(self) -> float:
        wm = self.watermark()
        return 0.0 if wm is None else max(0.0, time.time() - wm)

    def depth(self) -> int:
        return self._buf.qsize()

    @property
    def stopped(self) -> bool:
        return self._stop_evt.is_set()

    @property
    def drained(self) -> bool:
        """True once the producer finished AND the buffer is empty — the
        scheduler's cue to cut the final drain window."""
        return self._eof.is_set() and self._buf.empty()

    # -- lifecycle --------------------------------------------------------- #
    def start(self) -> "StreamSource":
        raise NotImplementedError

    def stop(self) -> None:
        """Stop producing.  Buffered records remain consumable; the
        subclass's producer performs its final drain and sets EOF."""
        self._stop_evt.set()

    def close(self, timeout_s: float = 10.0) -> None:
        """stop() + wait for the producer (drain included) to retire.  A
        drain that cannot finish within ``timeout_s`` — consumer gone,
        buffer full — is hard-killed so close() always returns."""
        self.stop()
        self._join(timeout_s)
        if not self._eof.is_set():
            self._kill_evt.set()
            self._join(min(timeout_s, 2.0))

    def _join(self, timeout_s: float) -> None:  # subclass threads
        pass


class IterableSource(StreamSource):
    """Replays a fixed line sequence then EOFs — tests, determinism pins,
    and offline reprocessing through the streaming plane."""

    def __init__(self, lines: Iterable[str], buffer_records: int = 1 << 16,
                 rate_per_s: float = 0.0):
        super().__init__(buffer_records)
        self._lines = list(lines)
        self._rate = float(rate_per_s)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "IterableSource":
        self._thread = threading.Thread(
            target=self._run, name="stream-iterable", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            delay = 1.0 / self._rate if self._rate > 0 else 0.0
            for line in self._lines:
                if self._stop_evt.is_set():
                    break
                if not self._emit(line):
                    break
                if delay:
                    self._stop_evt.wait(delay)
        finally:
            self._eof.set()

    def _join(self, timeout_s: float) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)


class TailingFileSource(StreamSource):
    """Follows growing part files + newly appearing shards under ``root``.

    Per poll, files are visited in sorted-name order; each is read from
    its saved byte offset up to the LAST newline — a torn tail (partial
    final line, writer mid-append) is held back whole and re-read next
    poll, never parsed malformed.  Files may grow forever; a file that
    shrinks (truncation — an upstream rewrite) restarts from zero with a
    warning.  Hidden files and ``*.tmp`` (write-then-rename staging) are
    skipped until they take their final name.
    """

    def __init__(
        self,
        root: str,
        poll_interval_s: float = 0.05,
        buffer_records: int = 1 << 16,
    ):
        super().__init__(buffer_records)
        self.root = root
        self.poll_interval_s = float(poll_interval_s)
        self._offsets: dict = {}  # path -> consumed byte offset
        self._thread: Optional[threading.Thread] = None
        self.torn_tails_held = 0  # introspection (tested)
        self.poll_errors = 0

    def start(self) -> "TailingFileSource":
        self._thread = threading.Thread(
            target=self._run, name="stream-tail", daemon=True
        )
        self._thread.start()
        return self

    def _files(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.root))
        except FileNotFoundError:
            return []  # the root may appear later; keep polling
        out = []
        for n in names:
            if n.startswith(".") or n.endswith(".tmp"):
                continue
            p = os.path.join(self.root, n)
            if os.path.isfile(p):
                out.append(p)
        return out

    def _poll_once(self, draining: bool = False) -> int:
        """One sweep over the file set; returns records emitted.

        ``draining=True`` is the final post-stop sweep: the graceful stop
        flag is IGNORED (it is already set — honouring it would make the
        drain a no-op) and only ``close()``'s hard kill aborts, so
        everything already written actually reaches the buffer."""
        halt = self._kill_evt.is_set if draining else self._stop_evt.is_set
        emitted = 0
        for path in self._files():
            if halt():
                break
            off = self._offsets.get(path, 0)
            try:
                size = os.path.getsize(path)
                if size < off:
                    logger.warning(
                        "tail source: %s shrank (%d -> %d); restarting "
                        "from 0", path, off, size,
                    )
                    off = 0
                if size == off:
                    continue
                with open(path, "rb") as fh:
                    fh.seek(off)
                    data = fh.read()
            except OSError as e:
                self.poll_errors += 1
                stats.add("stream.tail_errors")
                logger.warning("tail source: read of %s failed: %s", path, e)
                continue
            nl = data.rfind(b"\n")
            if nl < 0:
                # nothing but a torn tail: hold the whole fragment back
                if data:
                    self.torn_tails_held += 1
                    _TORN_HELD.inc()
                continue
            if nl != len(data) - 1:
                # complete lines followed by a torn tail: consume the
                # complete ones, hold the fragment (re-read whole next poll)
                self.torn_tails_held += 1
                _TORN_HELD.inc()
            now = time.time()
            consumed = off  # bytes actually handed downstream
            for raw in data[:nl].split(b"\n"):
                line = raw.decode("utf-8", errors="replace")
                if line.strip():
                    if not self._emit(line, event_ts=now, abort=halt):
                        # aborted mid-chunk: record only what was emitted
                        # so the rest is re-read (not skipped) next poll
                        self._offsets[path] = consumed
                        return emitted
                    emitted += 1
                consumed += len(raw) + 1
            self._offsets[path] = consumed
        return emitted

    def _run(self) -> None:
        try:
            while not self._stop_evt.is_set():
                try:
                    # chaos site: one check per poll.  A raising spec is a
                    # transient tail failure (counted, retried next poll);
                    # a "hang:" spec freezes the feed right here — the
                    # watchdog's `feed` stage must catch the ensuing stall.
                    faults.inject("stream.tail")
                    self._poll_once()
                except faults.FaultInjected:
                    self.poll_errors += 1
                    stats.add("stream.tail_errors")
                self._stop_evt.wait(self.poll_interval_s)
            # final drain poll: pick up everything already written (a
            # held torn tail stays held — it never became a full line).
            # Runs in draining mode — stop is already set; only close()'s
            # hard kill aborts — so stop() honours its drain contract.
            try:
                self._poll_once(draining=True)
            except Exception:
                self.poll_errors += 1
                stats.add("stream.tail_errors")
                logger.debug("final drain poll failed", exc_info=True)
        except BaseException:
            # a watchdog hang-interrupt (DistributedStallError) or any
            # other escape retires the producer; EOF below unblocks the
            # consumer's drain path
            logger.exception("tail source poll loop died")
        finally:
            self._eof.set()

    def _join(self, timeout_s: float) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)


class SocketSource(StreamSource):
    """Newline-delimited records over TCP — the push-feed shape.

    ``start()`` binds ``host:port`` (port 0 = ephemeral; read ``.port``),
    accepts any number of senders, and emits complete lines as they
    arrive.  A sender that disconnects mid-line contributes nothing for
    the torn fragment (socket framing's torn-tail discipline)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 buffer_records: int = 1 << 16):
        super().__init__(buffer_records)
        self.host = host
        self.port = int(port)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._active = 0  # live reader threads (EOF once 0 after stop)

    def start(self) -> "SocketSource":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="stream-socket-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        try:
            while not self._stop_evt.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                with self._conn_lock:
                    # re-check under the lock: a connection accepted after
                    # stop() swept _conns would otherwise never be shut
                    # down and its reader could block _eof forever
                    if self._stop_evt.is_set():
                        try:
                            conn.close()
                        except OSError:
                            pass
                        continue
                    self._conns.append(conn)
                    self._active += 1
                t = threading.Thread(
                    target=self._read_conn, args=(conn,),
                    name="stream-socket-read", daemon=True,
                )
                self._conn_threads.append(t)
                t.start()
        finally:
            with self._conn_lock:
                if self._active == 0:
                    self._eof.set()

    def _read_conn(self, conn: socket.socket) -> None:
        try:
            with conn, conn.makefile("rb") as fh:
                for raw in fh:
                    if self._stop_evt.is_set():
                        break
                    if not raw.endswith(b"\n"):
                        # sender died mid-line: the fragment is torn
                        _TORN_HELD.inc()
                        break
                    line = raw[:-1].decode("utf-8", errors="replace")
                    if line.strip() and not self._emit(line):
                        break
        except OSError:
            pass
        finally:
            with self._conn_lock:
                self._active -= 1
                if self._active == 0 and (
                    self._stop_evt.is_set()
                    or (self._accept_thread is not None
                        and not self._accept_thread.is_alive())
                ):
                    self._eof.set()

    def stop(self) -> None:
        super().stop()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # no live readers -> EOF immediately (readers otherwise set it)
        with self._conn_lock:
            if self._active == 0:
                self._eof.set()

    def _join(self, timeout_s: float) -> None:
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=timeout_s)
        for t in self._conn_threads:
            t.join(timeout=timeout_s)
