"""Sliding mini-pass scheduler: cut, parse and census windows off the
training thread (reference: paddlebox_tpu/streaming/minipass.py).

The mini-pass is the streaming plane's unit of work: a window of records
cut from the live stream by record count and/or wall-clock age, parsed
into one :class:`~paddlebox_tpu_torch.data.record.RecordBlock` with its
key census (the sorted ``np.unique`` of its keys), which is what
``SparseTable.begin_pass`` and the trainer need.  The port parses a
window with its default parser, the native one, as it loads a dataset
(the reference parses windows with ``SlotParser.parse_lines`` in Python;
the blocks are the same bit for bit).

The scheduler runs on its own thread, so window k+1 is parsed and
censused while window k trains.  The runner hands the pending census to
``SparseTable.prepare_pass`` through the trainer's ``next_pass_keys``
hook, so the table's staging thread overlaps the window boundary as it
overlaps a pass boundary; a stage whose census differs from the next
window's is thrown away by ``begin_pass``, never used.

Backpressure: at most ``max_pending`` cut windows wait; a stalled trainer
stalls the cutter, which stops draining the source buffer, which blocks
the tail poll or the socket reader.  Nothing drops.

Fault site ``stream.cut``: a failed cut is deferred; its records merge
into the next window (``stream.cut_deferred``).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import DataFeedConfig
from paddlebox_tpu_torch.data.feed import BatchBuilder, HostBatch
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.data.slot_parser import SlotParser
from paddlebox_tpu_torch.streaming.source import StreamSource
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.queues import bounded_put

logger = logging.getLogger(__name__)

_WINDOW_RECORDS = telemetry.histogram(
    "stream.window_records", help="records per cut mini-pass window"
)


@dataclasses.dataclass
class MiniPassWindow:
    """One cut window: parsed block + census + event-time bounds."""

    index: int
    block: RecordBlock
    census: np.ndarray  # sorted unique keys of the window
    n_records: int
    first_event_ts: float  # oldest record's event time
    last_event_ts: float  # newest record's event time
    cut_reason: str  # "count" | "time" | "drain"
    cut_ts: float  # wall time the cut happened


class WindowDataset:
    """The dataset-shaped view of one window the trainers consume
    (``batches()`` + ``unique_keys()``, the PadBoxSlotDataset protocol
    subset both trainer paths use)."""

    def __init__(self, window: MiniPassWindow, builder: BatchBuilder):
        self.window = window
        self.builder = builder

    def unique_keys(self) -> np.ndarray:
        return self.window.census

    def get_memory_data_size(self) -> int:
        return self.window.block.n_ins

    def batches(self, drop_last: bool = False) -> Iterator[HostBatch]:
        block = self.window.block
        B = self.builder.conf.batch_size
        n = block.n_ins
        for lo in range(0, n, B):
            ids = np.arange(lo, min(lo + B, n))
            if drop_last and ids.shape[0] < B:
                return
            yield self.builder.build(block, ids)


class MiniPassScheduler:
    """Pulls records from a :class:`StreamSource`, cuts mini-pass windows,
    parses + censuses them on this thread, and queues at most
    ``max_pending`` for the trainer.

    ``window_records`` is a LIVE attribute: the freshness policy widens
    it under publish backpressure; the change applies from the next cut.
    """

    _SENTINEL = object()

    def __init__(
        self,
        source: StreamSource,
        feed_conf: DataFeedConfig,
        window_records: int = 1024,
        window_seconds: float = 0.0,
        max_pending: int = 2,
    ):
        self.source = source
        self.conf = feed_conf
        self.parser = SlotParser(feed_conf)
        self.builder = BatchBuilder(feed_conf)
        self.window_records = int(window_records)
        self.window_seconds = float(window_seconds)
        self._out: "queue.Queue" = queue.Queue(maxsize=max(int(max_pending), 1))
        self._pending_census: list = []  # censuses queued but not consumed
        self._census_lock = threading.Lock()
        self._census_ready = threading.Condition(self._census_lock)
        self._stop_evt = threading.Event()
        self._done = threading.Event()  # sentinel enqueued
        self._thread: Optional[threading.Thread] = None
        self._n_windows = 0
        self.records_seen = 0
        self.cut_deferrals = 0

    # -- producer ---------------------------------------------------------- #
    def start(self) -> "MiniPassScheduler":
        self._thread = threading.Thread(
            target=self._run, name="minipass-cutter", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop cutting (the runner's hard teardown; for a graceful drain,
        stop the SOURCE and let the cutter emit its final window)."""
        self._stop_evt.set()
        with self._census_ready:
            self._census_ready.notify_all()

    def _run(self) -> None:
        lines: list = []
        ts: list = []
        window_open_t: Optional[float] = None
        try:
            while not self._stop_evt.is_set():
                rec = self.source.get(timeout=0.05)
                now = time.monotonic()
                if rec is not None:
                    if not lines:
                        window_open_t = now
                    lines.append(rec.line)
                    ts.append(rec.event_ts)
                    self.records_seen += 1
                drained = self.source.drained
                due = bool(lines) and (
                    len(lines) >= self.window_records
                    or (
                        self.window_seconds > 0
                        and window_open_t is not None
                        and now - window_open_t >= self.window_seconds
                    )
                    or drained
                )
                if due:
                    reason = (
                        "count" if len(lines) >= self.window_records
                        else ("drain" if drained else "time")
                    )
                    if self._cut(lines, ts, reason):
                        lines, ts, window_open_t = [], [], None
                    else:
                        # injected cut failure: defer — the records merge
                        # into the next window (backpressure holds them)
                        window_open_t = now
                if drained and not lines:
                    break
        except BaseException:
            logger.exception("mini-pass cutter died")
        finally:
            self._done.set()
            bounded_put(self._out, self._SENTINEL, self._stop_evt.is_set)

    def _cut(self, lines: list, ts: list, reason: str) -> bool:
        try:
            faults.inject("stream.cut")
        except faults.FaultInjected:
            self.cut_deferrals += 1
            stats.add("stream.cut_deferred")
            return False
        block = self._parse(lines, f"<window-{self._n_windows}>")
        window = MiniPassWindow(
            index=self._n_windows,
            block=block,
            census=np.unique(block.keys),
            n_records=len(lines),
            first_event_ts=min(ts),
            last_event_ts=max(ts),
            cut_reason=reason,
            cut_ts=time.time(),
        )
        self._n_windows += 1
        _WINDOW_RECORDS.observe(len(lines))
        with self._census_ready:
            self._pending_census.append(window.census)
            self._census_ready.notify_all()
        bounded_put(self._out, window, self._stop_evt.is_set)
        return True

    def _parse(self, lines: list, path: str):
        """The window's block: through the native parser, the port's
        default (``PADDLEBOX_TORCH_USE_NATIVE_PARSER``), in one buffer;
        through ``SlotParser.parse_lines`` where it is off or unbuilt, or
        the malformed policy is "skip".  The two give the same block bit
        for bit; the Python parse of a full-width window holds the GIL for
        seconds, beside the trainer's threads."""
        native = self.parser._native_parser()
        if native is None:
            return self.parser.parse_lines(lines, path=path)
        return native.parse_bytes(("\n".join(lines) + "\n").encode(),
                                  path=path)

    # -- consumer ---------------------------------------------------------- #
    @property
    def done(self) -> bool:
        """Producer finished (drain window, if any, already queued)."""
        return self._done.is_set()

    def next_window(self, timeout: float = 0.2) -> Optional[MiniPassWindow]:
        """Next cut window; None on timeout.  After the final window,
        returns None forever (check ``done`` to distinguish)."""
        try:
            item = self._out.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._SENTINEL:
            # keep later calls returning None immediately
            self._done.set()
            try:
                self._out.put_nowait(self._SENTINEL)
            except queue.Full:
                pass
            return None
        with self._census_ready:
            if self._pending_census:
                self._pending_census.pop(0)
        return item

    def dataset(self, window: MiniPassWindow) -> WindowDataset:
        return WindowDataset(window, self.builder)

    def wait_census(self, timeout: float = 1.0) -> np.ndarray:
        """Census of the next PENDING window, blocking up to ``timeout``
        for one to be cut — the ``next_pass_keys`` callable the runner
        hands the trainer (evaluated on the table's staging thread, so
        blocking here overlaps the current window's device tail).  Returns
        an empty census on timeout/shutdown; a mismatched stage is simply
        discarded by begin_pass (sync fallback), never wrong."""
        deadline = time.monotonic() + timeout
        with self._census_ready:
            while not self._pending_census:
                if self._done.is_set() or self._stop_evt.is_set():
                    return np.empty(0, dtype=np.uint64)
                left = deadline - time.monotonic()
                if left <= 0:
                    return np.empty(0, dtype=np.uint64)
                self._census_ready.wait(min(left, 0.1))
            return self._pending_census[0]

    def close(self, timeout_s: float = 10.0) -> None:
        self.stop()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
