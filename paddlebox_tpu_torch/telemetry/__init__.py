"""Telemetry: typed metrics, Prometheus and JSONL export, span tracing, the
flight recorder, the run-health plane and the compile witness (reference:
paddlebox_tpu/telemetry/; the names of metrics, spans and health rules are
the reference's).

  * :mod:`metrics` — Counter / Gauge / Histogram with labels, quantile
    estimation, delta snapshots, one process-global :data:`registry`
    (``utils/monitor.stats`` forwards here);
  * :mod:`export` — Prometheus text (``render_prometheus``) and the
    ``/metrics`` listener (:class:`MetricsExporter`);
  * :mod:`events` — the rank-tagged JSONL event log (size-rotated);
  * :mod:`trace` — ``span("name")`` -> Chrome-trace JSON (Perfetto);
  * :mod:`flight` — the always-on flight recorder, dumped on rollbacks,
    critical health alerts and SIGTERM (``tools/pbox_doctor.py`` reads
    the dumps);
  * :mod:`health` — the run-health rule catalog evaluated each pass;
  * :mod:`compiles` — ``jit.compiles``: kernel builds and CUDA graph
    captures by stage.

  * :mod:`context` — the W3C ``traceparent`` trace context of the
    serving plane; spans under an active context carry its IDs.

  * :mod:`fleet` — the cross-rank snapshot gather over the job's KV store
    and the merged fleet view rank 0 logs at each pass end.
"""

from paddlebox_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    DEFAULT_LATENCY_BUCKETS,
    Gauge,
    Histogram,
    MetricRegistry,
    Snapshot,
    counter,
    gauge,
    histogram,
    quantile_from_buckets,
    registry,
)
from paddlebox_tpu_torch.telemetry.export import (  # noqa: F401
    MetricsExporter,
    PROMETHEUS_CONTENT_TYPE,
    ensure_exporter,
    render_prometheus,
    stop_exporter,
)
from paddlebox_tpu_torch.telemetry.events import (  # noqa: F401
    EventLog,
    close_event_log,
    emit_event,
    ensure_event_log,
)
from paddlebox_tpu_torch.telemetry.trace import (  # noqa: F401
    Tracer,
    disable_tracing,
    enable_tracing,
    flush_trace,
    get_tracer,
    instant,
    span,
)
from paddlebox_tpu_torch.telemetry import context  # noqa: F401
from paddlebox_tpu_torch.telemetry.context import (  # noqa: F401
    REPLICA_RESPONSE_HEADER,
    TRACE_ID_RESPONSE_HEADER,
    TRACEPARENT_HEADER,
    TraceContext,
)
from paddlebox_tpu_torch.telemetry.flight import (  # noqa: F401
    FlightRecorder,
    dump_flight,
    install_signal_dump,
    run_identity,
    set_process_name,
    set_run_backend,
)
from paddlebox_tpu_torch.telemetry.fleet import (  # noqa: F401
    FleetGatherTimeout,
    format_fleet_view,
    gather_fleet_snapshot,
    log_fleet_view,
    merge_snapshots,
)
from paddlebox_tpu_torch.telemetry.health import (  # noqa: F401
    HealthAlert,
    HealthMonitor,
    HealthRule,
    default_rules,
    get_monitor,
    health_view,
    observe_pass,
)
from paddlebox_tpu_torch.telemetry.compiles import (  # noqa: F401
    KERNEL_STAGES,
    compiles_by_stage,
    record_compile,
    stage_scope,
    total_compiles,
)
