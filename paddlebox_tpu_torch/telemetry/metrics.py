"""Typed metrics: Counter / Gauge / Histogram with labels and a process
registry (reference: paddlebox_tpu/telemetry/metrics.py, copied: the port
keeps one vocabulary and one exposition with the reference).

Latencies are fixed-boundary bucket histograms with quantile estimation,
and every metric takes optional labels (``rank``, ``site``, ``stage``...).
Stdlib only: this module sits under utils/monitor.py, whose ``stats.add /
set / get`` surface forwards here, and is imported from every layer,
including the data pipeline's reader threads.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

# label sets are canonicalized to a sorted item tuple so ``inc(a=1, b=2)``
# and ``inc(b=2, a=1)`` hit the same series
LabelKey = Tuple[Tuple[str, str], ...]

# seconds-scale latency boundaries: sub-ms host work through multi-minute
# checkpoint publishes (Prometheus-style fixed boundaries; the +Inf bucket
# is implicit)
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: LabelKey) -> str:
    """Canonical flat series id: ``name`` or ``name{k=v,...}``."""
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class _Metric:
    """Shared series bookkeeping; subclasses define the per-series state."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock  # the owning registry's lock (one lock, no tiers)
        self._series: Dict[LabelKey, object] = {}

    def _get_series(self, labels: Dict[str, str]):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._new_series()
            self._series[key] = s
        return s

    def _new_series(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def remove(self, **labels: str) -> None:
        """Drop one labeled series (e.g. a stage-info gauge whose stage
        label rotated — without this, stale series accumulate forever)."""
        with self._lock:
            self._series.pop(_label_key(labels), None)

    def series(self) -> Dict[LabelKey, object]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically increasing count (negative increments rejected)."""

    kind = "counter"

    def _new_series(self):
        return [0.0]  # one-element list: mutable float cell

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        with self._lock:
            self._get_series(labels)[0] += value

    def value(self, **labels: str) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return 0.0 if s is None else s[0]


class Gauge(_Metric):
    """Point-in-time value (set/add; readable back)."""

    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._get_series(labels)[0] = float(value)

    def add(self, value: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._get_series(labels)[0] += value

    def value(self, **labels: str) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return 0.0 if s is None else s[0]


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-boundary buckets + the +Inf tail
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def copy(self) -> "_HistSeries":
        c = _HistSeries(0)
        c.counts = list(self.counts)
        c.sum, c.count = self.sum, self.count
        c.min, c.max = self.min, self.max
        return c


class Histogram(_Metric):
    """Fixed-boundary bucket histogram with quantile estimation.

    ``boundaries`` are upper edges (le semantics); one implicit +Inf bucket
    tails them.  Quantiles interpolate linearly inside the winning bucket
    and clamp to the observed [min, max], so a single sample reports that
    sample at every quantile and an empty histogram reports None.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 boundaries: Optional[Sequence[float]] = None):
        super().__init__(name, help, lock)
        bs = tuple(boundaries) if boundaries else DEFAULT_LATENCY_BUCKETS
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(
                f"histogram {name}: boundaries must be strictly increasing"
            )
        self.boundaries: Tuple[float, ...] = bs

    def _new_series(self):
        return _HistSeries(len(self.boundaries) + 1)

    def observe(self, value: float, **labels: str) -> None:
        value = float(value)
        with self._lock:
            s = self._get_series(labels)
            i = bisect.bisect_left(self.boundaries, value)
            s.counts[i] += 1
            s.sum += value
            s.count += 1
            if value < s.min:
                s.min = value
            if value > s.max:
                s.max = value

    def time(self, **labels: str):
        """Context manager observing the body's wall seconds."""
        return _HistTimer(self, labels)

    def _merged(self, labels: Optional[Dict[str, str]]) -> _HistSeries:
        """One series (exact label match) or the element-wise sum of all
        series (labels None) — the whole-metric distribution."""
        with self._lock:
            if labels is not None:
                s = self._series.get(_label_key(labels))
                return s.copy() if s is not None else self._new_series()
            out = self._new_series()
            for s in self._series.values():
                for i, c in enumerate(s.counts):
                    out.counts[i] += c
                out.sum += s.sum
                out.count += s.count
                out.min = min(out.min, s.min)
                out.max = max(out.max, s.max)
            return out

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Estimated q-quantile (0..1); None when no samples."""
        s = self._merged(labels if labels else None)
        return quantile_from_buckets(
            self.boundaries, s.counts, s.count, s.min, s.max, q
        )

    def summary(self, **labels: str) -> dict:
        """{count, sum, mean, min, max, p50, p95, p99} over the matching
        series (all series when no labels given)."""
        s = self._merged(labels if labels else None)
        qs = {
            f"p{int(q * 100)}": quantile_from_buckets(
                self.boundaries, s.counts, s.count, s.min, s.max, q
            )
            for q in (0.5, 0.95, 0.99)
        }
        return {
            "count": s.count,
            "sum": s.sum,
            "mean": (s.sum / s.count) if s.count else None,
            "min": None if s.count == 0 else s.min,
            "max": None if s.count == 0 else s.max,
            **qs,
        }


class _HistTimer:
    def __init__(self, hist: Histogram, labels: Dict[str, str]):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, **self._labels)
        return False


def quantile_from_buckets(
    boundaries: Sequence[float],
    counts: Sequence[int],
    total: int,
    observed_min: float,
    observed_max: float,
    q: float,
) -> Optional[float]:
    """Nearest-rank bucket + linear interpolation inside it.

    The +Inf bucket's upper edge is the observed max (tracked exactly), so
    tail quantiles stay finite; results clamp to [observed_min,
    observed_max] so a one-sample histogram answers that sample.
    """
    if total <= 0:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo_cum = cum
        cum += c
        if cum >= rank:
            lo = observed_min if i == 0 else boundaries[i - 1]
            hi = observed_max if i >= len(boundaries) else boundaries[i]
            frac = max(0.0, min(1.0, (rank - lo_cum) / c))
            est = lo + (hi - lo) * frac
            return max(observed_min, min(observed_max, est))
    # rank beyond the last non-empty bucket (fp roundoff): the max
    return observed_max


class Snapshot(dict):
    """Flat name->value dict (legacy ``stats.snapshot()`` shape) carrying
    the monotonic instant it was taken at, read under the registry lock."""

    monotonic_ts: float = 0.0


class MetricRegistry:
    """Process-global home of every typed metric.

    ``counter/gauge/histogram`` are get-or-create by name (the reference's
    STAT_INT macros register-on-first-touch the same way); re-requesting a
    name with a different kind is a programming error and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # delta baseline: series-name -> value (counters) / cumulative
        # bucket counts+sum+count (histograms)
        self._delta_base: Dict[str, object] = {}

    # -- registration ------------------------------------------------------- #
    def _get(self, name: str, cls, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, help, boundaries=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    # -- snapshots ---------------------------------------------------------- #
    def flat_values(self) -> Snapshot:
        """Legacy flat view: every counter/gauge series -> value (histograms
        excluded — a distribution has no single number)."""
        snap = Snapshot()
        with self._lock:
            snap.monotonic_ts = time.monotonic()
            for m in self._metrics.values():
                if isinstance(m, (Counter, Gauge)):
                    for key, cell in m._series.items():
                        snap[_series_name(m.name, key)] = cell[0]
        return snap

    def snapshot(self) -> dict:
        """Structured, JSON-able snapshot of everything (the fleet-gather
        payload and the JSONL per-pass record)."""
        with self._lock:
            out: dict = {
                "monotonic_ts": time.monotonic(),
                "time": time.time(),
                "counters": {},
                "gauges": {},
                "histograms": {},
            }
            for m in self._metrics.values():
                if isinstance(m, Counter):
                    for key, cell in m._series.items():
                        out["counters"][_series_name(m.name, key)] = cell[0]
                elif isinstance(m, Gauge):
                    for key, cell in m._series.items():
                        out["gauges"][_series_name(m.name, key)] = cell[0]
                elif isinstance(m, Histogram):
                    for key, s in m._series.items():
                        out["histograms"][_series_name(m.name, key)] = {
                            "boundaries": list(m.boundaries),
                            "counts": list(s.counts),
                            "sum": s.sum,
                            "count": s.count,
                            "min": None if s.count == 0 else s.min,
                            "max": None if s.count == 0 else s.max,
                        }
            return out

    def delta_snapshot(self) -> dict:
        """Like :meth:`snapshot` but counters/histograms report the change
        since the previous ``delta_snapshot`` call (gauges stay
        instantaneous) — the per-pass JSONL record that lets a pass be read
        in isolation instead of cumulatively."""
        snap = self.snapshot()
        base, self._delta_base = self._delta_base, {}
        for sname, v in snap["counters"].items():
            prev = base.get(("c", sname), 0.0)
            self._delta_base[("c", sname)] = v
            snap["counters"][sname] = v - prev
        for sname, h in snap["histograms"].items():
            prev = base.get(("h", sname))
            self._delta_base[("h", sname)] = (
                list(h["counts"]), h["sum"], h["count"]
            )
            if prev is not None:
                pc, ps, pn = prev
                h["counts"] = [a - b for a, b in zip(h["counts"], pc)]
                h["sum"] = h["sum"] - ps
                h["count"] = h["count"] - pn
        return snap

    def reset(self) -> None:
        """Zero every metric (all series dropped) and the delta baseline.

        Metric OBJECTS stay registered: modules cache handles at import
        time (``_REQUESTS = telemetry.counter(...)``), and dropping the
        registration would silently detach those handles from /metrics.
        Tests use this; a fresh pass in a long-lived process should read
        ``delta_snapshot`` instead."""
        with self._lock:
            for m in self._metrics.values():
                m._series.clear()
            self._delta_base.clear()


# the process-global registry: one per process, shared by utils/monitor's
# legacy ``stats`` facade, the exporters and the fleet gather
registry = MetricRegistry()


def counter(name: str, help: str = "") -> Counter:
    return registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return registry.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return registry.histogram(name, help, buckets)
