"""Run-health plane: declarative anomaly detection over pass deltas
(reference: paddlebox_tpu/telemetry/health.py; the rule catalog is the
reference's, copied literally, so that one rule name means one check in
both packages).

A checked-in catalog of declarative rules, each watching one signal per
pass, evaluated by a :class:`HealthMonitor` the trainers call at the pass
end with the window's delta snapshot.  Two check kinds:

* **EWMA z-score**: an exponentially weighted mean and variance per signal
  (``mean += a*(x-mean)``; ``var = (1-a)*(var + a*(x-mean)^2)``); a rule
  fires when a window deviates by ``threshold`` standard deviations in the
  rule's direction and past an absolute or relative noise floor
  (``min_delta`` / ``min_rel``).  A non-finite observation fires
  unconditionally.
* **absolute**: ``abs_max`` / ``abs_min`` bounds, and ``nonzero`` for
  signals whose steady state is exactly zero (``jit.compiles`` after
  warmup: in the port a kernel build or a CUDA graph capture).

A firing rule is counted (``health.alerts{rule,severity}``), emitted as a
``health_alert`` event (which also lands in the flight ring), kept in a
bounded ring, and at ``critical`` severity dumped through the flight
recorder with reason ``health``.

Flags: ``PADDLEBOX_TORCH_HEALTH_ENABLED`` (kill switch),
``_HEALTH_EWMA_ALPHA``, ``_HEALTH_WARMUP`` (windows before baseline rules
may fire), ``_HEALTH_MAX_ALERTS`` (ring bound).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence

from paddlebox_tpu_torch.telemetry import events, flight
from paddlebox_tpu_torch.telemetry.metrics import quantile_from_buckets, registry

_ALERTS = registry.counter(
    "health.alerts", help="health alerts fired, by rule and severity"
)
_WINDOWS = registry.counter(
    "health.windows",
    help="pass/window delta snapshots evaluated by the health monitor",
)

WARN = "warn"
CRITICAL = "critical"

# --------------------------------------------------------------------------- #
# The rule catalog: a pure literal, the reference's own
# (tests/test_torch_telemetry_names.py holds the names equal).  Signals
# address the flattened window dict built by
# :func:`flatten_window`:
#
#   metrics.<k>        pass metrics (auc, loss, steps, duration_s, samples)
#   counter.<name>     this window's counter delta, summed over label sets
#   gauge.<name>       instantaneous gauge (max over label sets)
#   hist.<name>.<q>    this window's histogram delta (mean / p99 / count)
#   table.<k>          SparseTable.health_stats() fields
#   derived.<k>        ratios computed from the above (rates, samples/s)
# --------------------------------------------------------------------------- #
_RULE_SPECS = [
    # -- training quality ------------------------------------------------- #
    {"name": "train.auc_drop", "family": "training",
     "signal": "metrics.auc", "kind": "zscore", "direction": "below",
     "threshold": 4.0, "min_delta": 0.01, "severity": "critical",
     "meaning": "pass AUC fell hard vs the EWMA baseline"},
    {"name": "train.loss_spike", "family": "training",
     "signal": "metrics.loss", "kind": "zscore", "direction": "above",
     "threshold": 4.0, "min_delta": 0.05, "severity": "critical",
     "meaning": "pass loss spiked vs baseline (a non-finite loss fires "
                "unconditionally)"},
    {"name": "train.nan_rate", "family": "training",
     "signal": "derived.nan_skip_rate", "kind": "abs_max",
     "threshold": 0.01, "severity": "warn",
     "meaning": "fraction of steps discarded non-finite by "
                "nan_policy=skip_batch"},
    {"name": "train.quarantine_rate", "family": "training",
     "signal": "derived.quarantine_rate", "kind": "abs_max",
     "threshold": 0.01, "severity": "warn",
     "meaning": "malformed input lines quarantined per trained sample"},
    {"name": "train.grad_norm_spike", "family": "training",
     "signal": "gauge.train.grad_norm", "kind": "zscore",
     "direction": "above", "threshold": 5.0, "min_rel": 0.5,
     "severity": "warn",
     "meaning": "per-pass RMS gradient norm jumped vs baseline"},
    {"name": "train.weight_norm_jump", "family": "training",
     "signal": "gauge.train.weight_norm", "kind": "zscore",
     "direction": "above", "threshold": 5.0, "min_rel": 0.25,
     "severity": "warn",
     "meaning": "dense parameter norm jumped vs baseline (divergence "
                "precursor)"},
    # -- table health ------------------------------------------------------ #
    {"name": "table.hit_rate_collapse", "family": "table",
     "signal": "table.cache_hit_rate", "kind": "zscore",
     "direction": "below", "threshold": 3.0, "min_delta": 0.2,
     "severity": "critical",
     "meaning": "HBM-cache hit rate collapsed vs baseline (promotion "
                "patch back to O(working set))"},
    {"name": "table.promotion_growth", "family": "table",
     "signal": "table.promotion_patch_rows", "kind": "zscore",
     "direction": "above", "threshold": 4.0, "min_delta": 64.0,
     "min_rel": 0.5, "severity": "warn",
     "meaning": "begin-pass promotion patch (cache-miss rows) growing"},
    {"name": "table.eviction_churn", "family": "table",
     "signal": "counter.cache.evicted_rows", "kind": "zscore",
     "direction": "above", "threshold": 4.0, "min_delta": 64.0,
     "min_rel": 0.5, "severity": "warn",
     "meaning": "HBM-cache eviction churn spiked (capacity thrash)"},
    {"name": "table.writeback_backlog", "family": "table",
     "signal": "table.merge_backlog", "kind": "abs_max", "threshold": 4.0,
     "severity": "warn",
     "meaning": "pending background write-back merges piling up behind "
                "the pass boundary"},
    {"name": "table.census_rejects", "family": "table",
     "signal": "counter.store.census_disk_rejects", "kind": "zscore",
     "direction": "above", "threshold": 4.0, "min_delta": 64.0,
     "min_rel": 0.5, "severity": "warn",
     "meaning": "census keys proven absent from the durable log spiking "
                "(new-key storm or upstream key corruption)"},
    {"name": "table.hot_set_churn", "family": "table",
     "signal": "counter.placement.plan_updates", "kind": "zscore",
     "direction": "above", "threshold": 4.0, "min_delta": 2.0,
     "severity": "warn",
     "meaning": "placement-plan hot-set mutating faster than its "
                "hysteresis baseline"},
    {"name": "table.hot_churn", "family": "table",
     "signal": "counter.placement.hot_churn_keys", "kind": "zscore",
     "direction": "above", "threshold": 4.0, "min_delta": 16.0,
     "min_rel": 0.5, "severity": "warn",
     "meaning": "realized hot-block promotions+demotions per boundary "
                "spiking — each churned key pays a host-plane row move, "
                "so a thrashing hot set erodes the replicated-hot win"},
    # -- pipeline health --------------------------------------------------- #
    {"name": "pipeline.pass_gap", "family": "pipeline",
     "signal": "hist.pass.boundary_gap_seconds.mean", "kind": "zscore",
     "direction": "above", "threshold": 4.0, "min_delta": 0.05,
     "min_rel": 0.5, "severity": "warn",
     "meaning": "device-idle pass transition regressing vs baseline"},
    {"name": "pipeline.stage_p99_drift", "family": "pipeline",
     "signal": "hist.trainer.stage_seconds.p99", "kind": "zscore",
     "direction": "above", "threshold": 4.0, "min_delta": 0.005,
     "min_rel": 0.5, "severity": "warn",
     "meaning": "host pipeline stage p99 drifting up vs baseline"},
    {"name": "pipeline.steady_state_recompile", "family": "pipeline",
     "signal": "counter.jit.compiles", "kind": "nonzero",
     "severity": "warn",
     "meaning": "XLA compiles observed past warmup — a silent retrace "
                "is paying compile time per step"},
    {"name": "pipeline.shed_rate", "family": "pipeline",
     "signal": "derived.shed_rate", "kind": "abs_max", "threshold": 0.05,
     "severity": "warn",
     "meaning": "admission-shed fraction of scoring traffic past budget"},
    {"name": "pipeline.publish_freshness", "family": "pipeline",
     "signal": "gauge.sync.lag_passes", "kind": "abs_max",
     "threshold": 8.0, "severity": "warn",
     "meaning": "publish→apply lag: donefile entries not yet applied by "
                "the syncer"},
]


@dataclasses.dataclass(frozen=True)
class HealthRule:
    """One declarative check over one window signal."""

    name: str
    family: str  # training | table | pipeline
    signal: str
    kind: str  # zscore | abs_max | abs_min | nonzero
    severity: str = WARN
    threshold: float = 4.0  # z threshold (zscore) or the absolute bound
    direction: str = "above"  # zscore: side that trips
    min_delta: float = 0.0  # zscore noise floor, absolute
    min_rel: float = 0.0  # zscore noise floor, fraction of |baseline|
    warmup: Optional[int] = None  # None = the monitor's warmup
    meaning: str = ""

    def __post_init__(self):
        if self.kind not in ("zscore", "abs_max", "abs_min", "nonzero"):
            raise ValueError(f"rule {self.name}: bad kind {self.kind!r}")
        if self.severity not in (WARN, CRITICAL):
            raise ValueError(
                f"rule {self.name}: bad severity {self.severity!r}")
        if self.direction not in ("above", "below"):
            raise ValueError(
                f"rule {self.name}: bad direction {self.direction!r}")


@dataclasses.dataclass(frozen=True)
class HealthAlert:
    """A rule that fired on one pass/window."""

    rule: str
    severity: str
    family: str
    signal: str
    observed: float
    baseline: Optional[float]  # EWMA mean (zscore) / bound (absolute)
    threshold: float
    window: object  # pass idx / global step / window id
    detail: str = ""

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # JSON-safe: a NaN observation must survive json.dumps/loads
        if not math.isfinite(self.observed):
            d["observed"] = repr(self.observed)
        return d


def default_rules() -> List[HealthRule]:
    """The checked-in catalog as rule objects (fresh list per call)."""
    return [HealthRule(**spec) for spec in _RULE_SPECS]


def rule_names() -> List[str]:
    return [spec["name"] for spec in _RULE_SPECS]


# --------------------------------------------------------------------------- #
# window flattening: one flat {signal: float} dict per pass
# --------------------------------------------------------------------------- #
def _base_name(series: str) -> str:
    return series.split("{", 1)[0]


def flatten_window(metrics: Optional[dict] = None,
                   telemetry: Optional[dict] = None,
                   table_stats: Optional[dict] = None,
                   extra: Optional[dict] = None) -> Dict[str, float]:
    """Flatten pass metrics + a registry delta snapshot + table health
    stats into the signal namespace the rule catalog addresses.  Label
    variants aggregate by base metric name (counters sum, gauges max,
    histogram deltas merge bucket-wise)."""
    sig: Dict[str, float] = {}
    for k, v in (metrics or {}).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        sig[f"metrics.{k}"] = float(v)  # NaN kept: non-finite must alert
    snap = telemetry or {}
    for series, v in (snap.get("counters") or {}).items():
        key = f"counter.{_base_name(series)}"
        sig[key] = sig.get(key, 0.0) + float(v)
    for series, v in (snap.get("gauges") or {}).items():
        key = f"gauge.{_base_name(series)}"
        sig[key] = max(sig.get(key, float(v)), float(v))
    merged: Dict[str, dict] = {}
    for series, h in (snap.get("histograms") or {}).items():
        base = _base_name(series)
        m = merged.get(base)
        if m is None:
            merged[base] = {
                "boundaries": list(h.get("boundaries") or []),
                "counts": list(h.get("counts") or []),
                "sum": float(h.get("sum") or 0.0),
                "count": int(h.get("count") or 0),
                "min": h.get("min"), "max": h.get("max"),
            }
        else:
            m["counts"] = [
                a + b for a, b in zip(m["counts"], h.get("counts") or [])
            ]
            m["sum"] += float(h.get("sum") or 0.0)
            m["count"] += int(h.get("count") or 0)
            for edge, pick in (("min", min), ("max", max)):
                if h.get(edge) is not None:
                    m[edge] = (h[edge] if m[edge] is None
                               else pick(m[edge], h[edge]))
    for base, m in merged.items():
        n = m["count"]
        if n <= 0:
            continue
        sig[f"hist.{base}.count"] = float(n)
        sig[f"hist.{base}.mean"] = m["sum"] / n
        lo = m["min"] if m["min"] is not None else 0.0
        hi = m["max"] if m["max"] is not None else 0.0
        p99 = quantile_from_buckets(
            m["boundaries"], m["counts"], n, lo, hi, 0.99)
        if p99 is not None:
            sig[f"hist.{base}.p99"] = float(p99)
    for k, v in (table_stats or {}).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        sig[f"table.{k}"] = float(v)
    for k, v in (extra or {}).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        sig[f"derived.{k}"] = float(v)

    # derived ratios (best-effort: absent inputs just skip the signal)
    steps = sig.get("metrics.steps", 0.0)
    skipped = sig.get("counter.train.nan_skipped_steps", 0.0)
    if steps + skipped > 0:
        sig["derived.nan_skip_rate"] = skipped / (steps + skipped)
    samples = sig.get("metrics.samples")
    if samples is not None and samples > 0:
        quarantined = sig.get("counter.data.quarantined_lines", 0.0)
        sig["derived.quarantine_rate"] = quarantined / samples
        dur = sig.get("metrics.duration_s")
        if dur is not None and dur > 0:
            sig["derived.samples_per_s"] = samples / dur
    shed = sig.get("counter.serve.shed_total")
    requests = sig.get("counter.server.requests", 0.0)
    if shed is not None and (shed + requests) > 0:
        sig["derived.shed_rate"] = shed / max(shed + requests, 1.0)
    return sig


# --------------------------------------------------------------------------- #
# the monitor
# --------------------------------------------------------------------------- #
class _Ewma:
    """EWMA mean + EWMA variance of one signal."""

    __slots__ = ("mean", "var", "n")

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float, alpha: float) -> None:
        if self.n == 0:
            self.mean = x
            self.var = 0.0
        else:
            d = x - self.mean
            self.mean += alpha * d
            self.var = (1.0 - alpha) * (self.var + alpha * d * d)
        self.n += 1


class HealthMonitor:
    """Evaluates the rule catalog against each pass/window's signals.

    One monitor per process (see :func:`get_monitor`); the trainers call
    :meth:`observe` right after logging ``pass_end`` with the SAME delta
    snapshot the JSONL record carries, so the alert and the record
    describe one window."""

    def __init__(self, rules: Optional[Sequence[HealthRule]] = None,
                 ewma_alpha: Optional[float] = None,
                 warmup: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 max_alerts: Optional[int] = None):
        from paddlebox_tpu_torch.config import flags

        self.rules = list(rules) if rules is not None else default_rules()
        self.ewma_alpha = float(
            flags.health_ewma_alpha if ewma_alpha is None else ewma_alpha)
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        self.warmup = int(flags.health_warmup if warmup is None else warmup)
        self.enabled = bool(
            flags.health_enabled if enabled is None else enabled)
        cap = int(flags.health_max_alerts if max_alerts is None
                  else max_alerts)
        self._lock = threading.Lock()
        self._state: Dict[str, _Ewma] = {}
        self._windows = 0
        self._alerts_by_sev: Dict[str, int] = {}
        self.alerts: collections.deque = collections.deque(
            maxlen=max(cap, 1))

    # -- evaluation --------------------------------------------------------- #
    def observe(self, window, metrics: Optional[dict] = None,
                telemetry: Optional[dict] = None, table=None,
                extra: Optional[dict] = None) -> List[HealthAlert]:
        """Evaluate every rule against one pass/window.  ``table`` is a
        SparseTable (its ``health_stats()`` is read) or a plain stats
        dict.  Returns (and emits) the alerts that fired."""
        if not self.enabled:
            return []
        table_stats = None
        if table is not None:
            hs = getattr(table, "health_stats", None)
            table_stats = hs() if callable(hs) else dict(table)
        signals = flatten_window(metrics, telemetry, table_stats, extra)
        alerts: List[HealthAlert] = []
        with self._lock:
            n_seen = self._windows
            self._windows += 1
            for rule in self.rules:
                a = self._eval_rule(rule, signals, window, n_seen)
                if a is not None:
                    alerts.append(a)
            for a in alerts:
                self.alerts.append(a)
                self._alerts_by_sev[a.severity] = (
                    self._alerts_by_sev.get(a.severity, 0) + 1)
        _WINDOWS.inc()
        for a in alerts:
            self._emit(a)
        return alerts

    def _eval_rule(self, rule: HealthRule, signals: Dict[str, float],
                   window, n_seen: int) -> Optional[HealthAlert]:
        x = signals.get(rule.signal)
        if x is None:
            if rule.signal.startswith("counter.") and rule.kind != "zscore":
                x = 0.0  # an absent counter delta is a zero delta
            else:
                return None
        warm = self.warmup if rule.warmup is None else rule.warmup
        if rule.kind == "nonzero":
            if n_seen >= warm and x > 0:
                return HealthAlert(
                    rule=rule.name, severity=rule.severity,
                    family=rule.family, signal=rule.signal, observed=x,
                    baseline=0.0, threshold=0.0, window=window,
                    detail=rule.meaning,
                )
            return None
        if rule.kind in ("abs_max", "abs_min"):
            if not math.isfinite(x):
                trips = True  # a NaN bound check is an incident, not a skip
            elif rule.kind == "abs_max":
                trips = x > rule.threshold
            else:
                trips = x < rule.threshold
            if trips:
                return HealthAlert(
                    rule=rule.name, severity=rule.severity,
                    family=rule.family, signal=rule.signal, observed=x,
                    baseline=rule.threshold, threshold=rule.threshold,
                    window=window, detail=rule.meaning,
                )
            return None
        # zscore
        st = self._state.get(rule.name)
        if st is None:
            st = self._state[rule.name] = _Ewma()
        alert = None
        if not math.isfinite(x):
            alert = HealthAlert(
                rule=rule.name, severity=rule.severity, family=rule.family,
                signal=rule.signal, observed=x,
                baseline=st.mean if st.n else None,
                threshold=rule.threshold, window=window,
                detail="non-finite observation",
            )
        elif st.n >= max(warm, 1):
            # max(warm, 1): even with warmup=0 an unseeded EWMA (n=0) has
            # no baseline to deviate from — the first sample only seeds it
            dev = x - st.mean
            if rule.direction == "below":
                dev = -dev
            floor = max(rule.min_delta, rule.min_rel * abs(st.mean))
            sd = math.sqrt(max(st.var, 0.0))
            z = (dev / sd) if sd > 0 else math.inf
            if dev > floor and z >= rule.threshold:
                alert = HealthAlert(
                    rule=rule.name, severity=rule.severity,
                    family=rule.family, signal=rule.signal, observed=x,
                    baseline=st.mean, threshold=rule.threshold,
                    window=window,
                    detail=f"z={z:.1f} over ewma baseline" if sd > 0
                    else "deviation from a zero-variance baseline",
                )
        if math.isfinite(x):
            st.update(x, self.ewma_alpha)
        return alert

    def _emit(self, alert: HealthAlert) -> None:
        _ALERTS.inc(rule=alert.rule, severity=alert.severity)
        events.emit_event("health_alert", **alert.to_dict())
        if alert.severity == CRITICAL:
            # postmortem capture: the doctor's health_report reconstructs
            # the first bad pass from these dumps alone
            flight.dump_flight("health", alert.to_dict())

    # -- introspection ------------------------------------------------------ #
    def snapshot(self) -> dict:
        """The /healthz + fleet-view summary: totals by severity and the
        most recent alerts (JSON-safe)."""
        with self._lock:
            recent = [a.to_dict() for a in list(self.alerts)[-8:]]
            by_sev = dict(self._alerts_by_sev)
            windows = self._windows
        return {
            "enabled": self.enabled,
            "windows": windows,
            "alerts_total": sum(by_sev.values()),
            "critical_total": by_sev.get(CRITICAL, 0),
            "by_severity": by_sev,
            "recent": recent,
        }


# --------------------------------------------------------------------------- #
# process singleton: the trainers feed it, /healthz and the router read it
# --------------------------------------------------------------------------- #
_mon_lock = threading.Lock()
_monitor: Optional[HealthMonitor] = None


def get_monitor() -> HealthMonitor:
    global _monitor
    m = _monitor
    if m is None:
        with _mon_lock:
            if _monitor is None:
                _monitor = HealthMonitor()
            m = _monitor
    return m


def observe_pass(window, metrics: Optional[dict] = None,
                 telemetry: Optional[dict] = None, table=None,
                 extra: Optional[dict] = None) -> List[HealthAlert]:
    """Module-level convenience the trainers call at pass end."""
    return get_monitor().observe(
        window, metrics=metrics, telemetry=telemetry, table=table,
        extra=extra,
    )


def health_view() -> dict:
    """The run-health summary /healthz and the router fleet view carry."""
    return get_monitor().snapshot()


def reset_for_tests(**kwargs) -> HealthMonitor:
    """Swap in a fresh monitor (tests only)."""
    global _monitor
    with _mon_lock:
        _monitor = HealthMonitor(**kwargs)
        return _monitor
