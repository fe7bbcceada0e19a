"""Named stat registry for counters and gauges (reference:
paddlebox_tpu/utils/monitor.py): a thin facade over the typed process
registry (telemetry/metrics.py).  ``stats.add`` feeds a typed Counter,
``stats.set`` a Gauge, so every call site shows up in ``/metrics`` and in
the pass's event record unchanged; new code uses
``telemetry.counter/gauge/histogram`` directly for labels and
distributions.
"""

from __future__ import annotations

from typing import Dict

from paddlebox_tpu_torch.telemetry import metrics as _tm


class StatRegistry:
    """The flat add/set/get surface, backed by a typed registry."""

    def __init__(self, registry: _tm.MetricRegistry = None):
        self._registry = registry if registry is not None else _tm.MetricRegistry()

    def add(self, name: str, value: float = 1) -> None:
        self._registry.counter(name).inc(value)

    def set(self, name: str, value: float) -> None:
        self._registry.gauge(name).set(value)

    def get(self, name: str) -> float:
        m = self._registry.get(name)
        if m is None or not isinstance(m, (_tm.Counter, _tm.Gauge)):
            return 0
        return m.value()

    def snapshot(self) -> Dict[str, float]:
        """Flat name->value dict (histograms excluded), carrying the
        monotonic instant it was taken at (``.monotonic_ts``)."""
        return self._registry.flat_values()

    def reset(self) -> None:
        self._registry.reset()


# the process-global instance shares the telemetry registry: flat counters
# and typed metrics are one catalog
stats = StatRegistry(_tm.registry)
