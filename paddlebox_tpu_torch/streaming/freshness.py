"""Deadline-driven publishing: freshness as a budget, not a cadence
(reference: paddlebox_tpu/streaming/freshness.py).

:class:`DeadlinePublishPolicy` publishes when the budget demands it: once
the oldest unpublished event's age, plus an EWMA of the publish's own
cost, crosses ``trigger_fraction x max_staleness_s``, the next window
boundary calls ``publisher.publish_delta``.  Sparse-only deltas by
default (the delta tracker accumulates across windows, so a skipped
window loses nothing), health-gated through ``fleet_util.ModelMonitor``.

At least once: ``publish_delta`` clears the tracker only after the
donefile lands, so a failed publish (fault site
``stream.publish_deadline``) keeps every touched row tracked, and the
next window retries with more rows.

Backpressure: when a publish fails or costs more than its share of the
budget, the policy widens the scheduler's windows
(``stream.backpressure_widenings``); every publish whose freshness blew
the budget counts a ``stream.deadline_misses``.

Freshness is measured: each publish notes (seq, oldest event covered); a
serving confirmation, ``confirm_served(seq)`` from the runner's poller
(a Syncer's ``applied_seq``, or ``GET /models``' seq), records the event
to served-score latency in ``stream.freshness_seconds``.  Without one,
the publish time stands in (event to published).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Optional

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)

_FRESHNESS = telemetry.histogram(
    "stream.freshness_seconds",
    help="event-time -> served-score latency of published windows "
         "(event->published when no serving confirmation is wired)",
)
_DEADLINE_MISSES = telemetry.counter(
    "stream.deadline_misses",
    help="published windows whose freshness blew the max-staleness budget",
)
_WIDENINGS = telemetry.counter(
    "stream.backpressure_widenings",
    help="window widenings triggered by publish failure/lag",
)


class DeadlinePublishPolicy:
    """Owns WHEN to publish and what that does to the window size.

    scheduler: a :class:`~paddlebox_tpu_torch.streaming.minipass.
    MiniPassScheduler` (or anything with a mutable ``window_records``
    int) to widen under backpressure; None disables widening.
    served_confirmation: set True when a runner wires ``confirm_served``
    — deadline misses are then judged at serve time, not publish time.
    """

    def __init__(
        self,
        publisher,
        max_staleness_s: float,
        *,
        scheduler=None,
        trigger_fraction: float = 0.5,
        widen_factor: float = 2.0,
        max_window_records: int = 1 << 20,
        tag_prefix: str = "stream",
        publish_programs: bool = False,
    ):
        self.publisher = publisher
        self.max_staleness_s = float(max_staleness_s)
        self.scheduler = scheduler
        self.trigger_fraction = float(trigger_fraction)
        self.widen_factor = float(widen_factor)
        self.max_window_records = int(max_window_records)
        self.tag_prefix = tag_prefix
        self.publish_programs = publish_programs
        self._oldest_unpublished: Optional[float] = None
        self._newest_unpublished: Optional[float] = None
        # window-index bounds of the unpublished accumulation: becomes
        # the publish's lineage ID ("w3" / "w3-7"), so a served score is
        # attributable to the exact training windows inside it
        self._first_unpub_window: Optional[int] = None
        self._last_unpub_window: Optional[int] = None
        self._publish_ewma = 0.0
        self._outstanding = collections.deque()  # (seq, oldest_event_ts)
        self._track_served = False
        self.publishes = 0
        self.publish_failures = 0
        self.deadline_misses = 0
        self.widenings = 0
        self.last_freshness_s: Optional[float] = None

    # -- bookkeeping -------------------------------------------------------- #
    def observe_window(self, window) -> None:
        """Record a trained-but-unpublished window's event-time bounds."""
        if self._oldest_unpublished is None:
            self._oldest_unpublished = window.first_event_ts
        self._newest_unpublished = window.last_event_ts
        idx = getattr(window, "index", None)
        if idx is not None:
            if self._first_unpub_window is None:
                self._first_unpub_window = int(idx)
            self._last_unpub_window = int(idx)

    @property
    def pending_lineage(self) -> Optional[str]:
        """Lineage ID the next publish will carry: the unpublished
        window-index range ("w3", or "w3-7" when publishes skipped
        windows under backpressure)."""
        lo, hi = self._first_unpub_window, self._last_unpub_window
        if lo is None:
            return None
        return f"w{lo}" if (hi is None or hi == lo) else f"w{lo}-{hi}"

    @property
    def oldest_unpublished_age(self) -> float:
        if self._oldest_unpublished is None:
            return 0.0
        return max(0.0, time.time() - self._oldest_unpublished)

    def due(self, now: Optional[float] = None) -> bool:
        """Deadline check: is the oldest unpublished event's age, plus the
        expected publish cost, past its share of the budget?"""
        if self._oldest_unpublished is None:
            return False
        now = time.time() if now is None else now
        budget = self.max_staleness_s * self.trigger_fraction
        return (now - self._oldest_unpublished) + self._publish_ewma >= budget

    # -- publish ------------------------------------------------------------ #
    def maybe_publish(self, table, model=None, params=None,
                      metrics: Optional[dict] = None,
                      force: bool = False):
        """Publish the accumulated delta when due (or ``force``d, e.g. at
        drain shutdown).  Returns the PublishEntry, or None (not due /
        gated / failed — failure widens and retries next window)."""
        if not force and not self.due():
            return None
        if self._oldest_unpublished is None:
            return None
        oldest = self._oldest_unpublished
        tag = f"{self.tag_prefix}-{self.publisher.next_seq}"
        t0 = time.monotonic()
        try:
            # chaos site: a deadline-triggered publish that dies must
            # leave the delta tracker intact (publish_delta only clears
            # it after the donefile lands) — the next window re-ships
            # the same rows plus its own
            faults.inject("stream.publish_deadline")
            kw = {}
            if self.publish_programs and model is not None:
                kw = {"model": model, "params": params}
            entry = self.publisher.publish_delta(
                tag, table, metrics=metrics,
                lineage=self.pending_lineage, **kw
            )
        except Exception as e:
            self.publish_failures += 1
            stats.add("stream.publish_errors")
            logger.warning("deadline publish %s failed (%r); rows retained, "
                           "retrying next window", tag, e)
            self._backpressure()
            return None
        if entry is None:  # health gate held it back; rows stay tracked
            return None
        dt = time.monotonic() - t0
        self._publish_ewma = (
            dt if self._publish_ewma == 0.0
            else 0.7 * self._publish_ewma + 0.3 * dt
        )
        self.publishes += 1
        published_freshness = time.time() - oldest
        self.last_freshness_s = published_freshness
        if self._track_served:
            self._outstanding.append((entry.seq, oldest))
        else:
            _FRESHNESS.observe(published_freshness)
            if published_freshness > self.max_staleness_s:
                self.deadline_misses += 1
                _DEADLINE_MISSES.inc()
        # publish alone ate more than its share of the budget: the cadence
        # is unaffordable at this window size — widen
        if dt > self.max_staleness_s * (1.0 - self.trigger_fraction):
            self._backpressure()
        self._oldest_unpublished = None
        self._newest_unpublished = None
        self._first_unpub_window = None
        self._last_unpub_window = None
        return entry

    # -- serve-side confirmation -------------------------------------------- #
    def track_served(self) -> None:
        """Switch freshness accounting to event→served: misses and the
        ``stream.freshness_seconds`` histogram are judged when
        ``confirm_served`` reports the seq live, not at publish time."""
        self._track_served = True

    def confirm_served(self, seq: Optional[int],
                       now: Optional[float] = None) -> int:
        """The serving side reports ``seq`` (newest applied donefile seq)
        live; every outstanding publish at or below it is confirmed and
        its event→served freshness recorded.  Returns confirmations."""
        if seq is None:
            return 0
        now = time.time() if now is None else now
        n = 0
        while self._outstanding and self._outstanding[0][0] <= seq:
            _, oldest = self._outstanding.popleft()
            fresh = max(0.0, now - oldest)
            self.last_freshness_s = fresh
            _FRESHNESS.observe(fresh)
            if fresh > self.max_staleness_s:
                self.deadline_misses += 1
                _DEADLINE_MISSES.inc()
            n += 1
        return n

    @property
    def outstanding(self) -> int:
        return len(self._outstanding)

    # -- backpressure -------------------------------------------------------- #
    def _backpressure(self) -> None:
        if self.scheduler is None:
            return
        cur = int(self.scheduler.window_records)
        widened = min(int(cur * self.widen_factor), self.max_window_records)
        if widened > cur:
            self.scheduler.window_records = widened
            self.widenings += 1
            _WIDENINGS.inc()
            logger.warning(
                "publish backpressure: window widened %d -> %d records",
                cur, widened,
            )
