"""The port's telemetry plane against the JAX package's, exactly: the same
observation sequence (made from a seed with numpy) gives the same
histogram summaries and quantiles, the same delta snapshots and
Prometheus text equal byte for byte; the same nested span sequence gives
the same Chrome-trace events once ts, dur, pid and tid are masked; the
same flight sequence gives the same dump keys; the same events the same
JSONL records.  Then the port's own parts: the exporter, the step
profiler, the compile witness, the torch.profiler device trace, the
config fields and the fleet utilities.
"""

import json
import math
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu import telemetry as ref_telemetry
from paddlebox_tpu.telemetry import events as ref_events
from paddlebox_tpu.telemetry import export as ref_export
from paddlebox_tpu.telemetry import flight as ref_flight
from paddlebox_tpu.telemetry import trace as ref_trace
from paddlebox_tpu.telemetry.metrics import MetricRegistry as RefRegistry
from paddlebox_tpu.utils import fleet_util as ref_fleet_util
from paddlebox_tpu.utils import profiler as ref_profiler
from paddlebox_tpu.utils.monitor import StatRegistry as RefStats
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import TelemetryConfig, TrainerConfig
from paddlebox_tpu_torch.ops import cuda_build
from paddlebox_tpu_torch.telemetry import (
    compiles,
    events,
    export,
    flight,
    health,
    trace,
)
from paddlebox_tpu_torch.telemetry.metrics import MetricRegistry
from paddlebox_tpu_torch.utils import fleet_util, profiler
from paddlebox_tpu_torch.utils.monitor import StatRegistry
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (None, (0.001, 0.01, 0.1, 1.0), (1.0, 8.0, 64.0, 512.0, 4096.0))


def _reset_both():
    for t in (telemetry, ref_telemetry):
        t.registry.reset()
        t.disable_tracing()
        t.close_event_log()
        t.stop_exporter()
    health.reset_for_tests()
    flight.reset_for_tests()
    ref_flight.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _reset_both()
    yield
    _reset_both()


def _observe(regs, seed: int, n_windows: int = 1):
    """Feed the same seeded sequence of counter, gauge and labeled
    histogram updates into every registry of ``regs``, yielding after
    each of ``n_windows`` windows."""
    rng = np.random.default_rng(seed)
    for w in range(n_windows):
        n = int(rng.integers(1, 60))
        vals = rng.lognormal(-4.0 + seed, 1.5, n)
        stages = rng.choice(["plan", "feed", "step"], n)
        incs = rng.integers(0, 9, n)
        for v, st, inc in zip(vals, stages, incs):
            for reg in regs:
                reg.histogram("h.latency", "latency",
                              buckets=BUCKETS[seed % 3]).observe(
                    float(v), stage=str(st))
                reg.counter("c.events", "events").inc(float(inc))
                reg.counter("c.by_site").inc(1.0, site=str(st))
                reg.gauge("g.level").set(float(v) * 100)
        yield w


@pytest.mark.parametrize("seed", range(4))
def test_histogram_summaries_and_quantiles_match_reference(seed):
    port, ref = MetricRegistry(), RefRegistry()
    for _ in _observe((port, ref), seed):
        pass
    ph, rh = port.get("h.latency"), ref.get("h.latency")
    for labels in ({}, {"stage": "plan"}, {"stage": "feed"},
                   {"stage": "step"}, {"stage": "absent"}):
        assert ph.summary(**labels) == rh.summary(**labels)
        for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert ph.quantile(q, **labels) == rh.quantile(q, **labels)
    assert port.flat_values() == ref.flat_values()


def _timeless(snap: dict) -> dict:
    return {k: v for k, v in snap.items()
            if k not in ("monotonic_ts", "time")}


@pytest.mark.parametrize("seed", range(3))
def test_delta_snapshots_match_reference(seed):
    port, ref = MetricRegistry(), RefRegistry()
    for _ in _observe((port, ref), seed, n_windows=4):
        assert _timeless(port.delta_snapshot()) == _timeless(
            ref.delta_snapshot())
    assert _timeless(port.snapshot()) == _timeless(ref.snapshot())
    port.reset()
    ref.reset()
    assert _timeless(port.delta_snapshot()) == _timeless(ref.delta_snapshot())


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_text_equal_byte_for_byte(seed):
    port, ref = MetricRegistry(), RefRegistry()
    for _ in _observe((port, ref), seed):
        pass
    for reg in (port, ref):
        reg.counter("train.nan_rollback", 'help with "quotes"\n').inc()
        reg.gauge("9lead.digit").set(float("inf"))
        reg.counter("esc").inc(2, path='a"b\\c\nd')
    text = export.render_prometheus(port)
    assert text == ref_export.render_prometheus(ref)
    assert "train_nan_rollback_total 1" in text
    assert "h_latency_bucket{stage=\"plan\",le=\"+Inf\"}" in text


def test_stats_facade_matches_reference():
    port, ref = StatRegistry(MetricRegistry()), RefStats(RefRegistry())
    for s in (port, ref):
        s.add("a.count")
        s.add("a.count", 4)
        s.set("a.level", 2.5)
        s._registry.histogram("a.hist").observe(1.0)
    for name in ("a.count", "a.level", "a.hist", "missing"):
        assert port.get(name) == ref.get(name)
    assert port.snapshot() == ref.snapshot()
    port.reset()
    ref.reset()
    assert port.snapshot() == ref.snapshot() == {}
    with pytest.raises(TypeError):
        port.set("a.count", 1.0)  # a counter stays a counter


def _masked(events_: list) -> list:
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                      "tid")}
            for e in events_]


def _nested(tel, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    with tel.span("pass", pass_idx=3, global_step=7):
        for i in range(int(rng.integers(2, 5))):
            with tel.span("plan"):
                pass
            with tel.span("step", i=i):
                if rng.random() < 0.5:
                    with tel.span("dump", path="x"):
                        tel.instant("marker", k=i)
        tel.instant("pass_boundary")
    with tel.span("ckpt.save.base", tag="t0"):
        pass


@pytest.mark.parametrize("seed", range(3))
def test_nested_spans_give_the_reference_chrome_trace(tmp_path, seed):
    trace.enable_tracing(pid=0, process_name="trainer")
    ref_trace.enable_tracing(pid=0, process_name="trainer")
    _nested(telemetry, seed)
    _nested(ref_telemetry, seed)
    telemetry.flush_trace(str(tmp_path / "port.json"))
    ref_telemetry.flush_trace(str(tmp_path / "ref.json"))
    port = json.load(open(tmp_path / "port.json"))
    ref = json.load(open(tmp_path / "ref.json"))
    assert _masked(port["traceEvents"]) == _masked(ref["traceEvents"])
    assert set(port) == set(ref)
    assert {k: port[k] for k in ("pboxRank", "pboxProcess",
                                 "displayTimeUnit")} == {
        k: ref[k] for k in ("pboxRank", "pboxProcess", "displayTimeUnit")}
    # a flushed tracer starts empty; disabled tracing writes nothing
    assert telemetry.get_tracer().drain() == []
    telemetry.disable_tracing()
    assert telemetry.flush_trace(str(tmp_path / "none.json")) is None


def _ring(records: list) -> list:
    return [{k: v for k, v in r.items() if k not in ("t", "dur_s")}
            for r in records]


@pytest.mark.parametrize("capacity", [4, 512])
def test_flight_dump_matches_reference(tmp_path, capacity):
    """The same spans, events and instants into both rings (4 records
    overflow, counted as dropped), dumped: the same top-level keys, the
    same ring records but for their times, and the run identity's keys
    but for the framework's (jax_version there; torch_version and the
    CUDA device here)."""
    port_rec = flight.reset_for_tests(capacity=capacity)
    ref_rec = ref_flight.reset_for_tests(capacity=capacity)
    port_rec.name = ref_rec.name = "trainer"
    for tel in (telemetry, ref_telemetry):
        _nested(tel, 0)
        tel.emit_event("pass_end", pass_idx=0, metrics={"auc": 0.5})
        tel.emit_event("custom", kind="base", name="n", x=1.5)
    assert _ring(port_rec.snapshot()) == _ring(ref_rec.snapshot())
    p = telemetry.dump_flight("health", {"rule": "r"},
                              dump_dir=str(tmp_path / "p"))
    r = ref_telemetry.dump_flight("health", {"rule": "r"},
                                  dump_dir=str(tmp_path / "r"))
    pd, rd = json.load(open(p)), json.load(open(r))
    assert set(pd) == set(rd)
    assert {k: pd[k] for k in ("schema", "proc", "rank", "reason",
                               "detail")} == {
        k: rd[k] for k in ("schema", "proc", "rank", "reason", "detail")}
    assert _ring(pd["ring"]) == _ring(rd["ring"])
    assert (set(pd["run"]) - {"torch_version", "device"}
            == set(rd["run"]) - {"jax_version"})
    assert os.path.basename(p).startswith("flight-trainer-r0-pid")
    dropped = telemetry.registry.get("trace.dropped_spans").value()
    assert dropped == ref_telemetry.registry.get(
        "trace.dropped_spans").value()
    assert (dropped > 0) == (capacity == 4)
    # no directory configured: the ring records, nothing is written
    assert telemetry.dump_flight("noop") is None


def test_event_log_records_and_rotation_match_reference(tmp_path):
    port = events.EventLog(str(tmp_path / "p" / "ev.jsonl"), rank=2,
                           max_mb=0.0004, keep_files=2)
    ref = ref_events.EventLog(str(tmp_path / "r" / "ev.jsonl"), rank=2,
                              max_mb=0.0004, keep_files=2)
    for log in (port, ref):
        for i in range(12):
            log.log("tick", i=i, v=np.float32(0.5), arr={"a": [1, 2]})
        log.close()
    for name in ("ev.jsonl", "ev.jsonl.1", "ev.jsonl.2"):
        p = [json.loads(ln) for ln in open(tmp_path / "p" / name)]
        r = [json.loads(ln) for ln in open(tmp_path / "r" / name)]
        for rec in p + r:
            rec.pop("t")
        assert p == r
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "r"))


def test_event_log_rank_and_path_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_PROCESS_ID", "3")
    monkeypatch.setenv("PADDLEBOX_TORCH_EVENTS_PATH",
                       str(tmp_path / "e.jsonl"))
    log = telemetry.ensure_event_log()
    assert log is not None and log.rank == 3
    assert telemetry.ensure_event_log("/elsewhere") is log  # a singleton
    telemetry.emit_event("hello", x=1)
    telemetry.close_event_log()
    (rec,) = [json.loads(ln) for ln in open(tmp_path / "e.jsonl")]
    assert rec["rank"] == 3 and rec["event"] == "hello" and rec["x"] == 1
    monkeypatch.delenv("PADDLEBOX_TORCH_EVENTS_PATH")
    assert telemetry.ensure_event_log() is None


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_exporter_serves_metrics_and_retires_its_thread():
    telemetry.counter("exp.hits").inc(3)
    exp = telemetry.ensure_exporter(0)
    assert exp is None  # port 0: no exporter, as in the reference
    exp = export.MetricsExporter()
    port = exp.start(0)
    try:
        st, ctype, text = _get(port, "/metrics")
        assert st == 200 and ctype == export.PROMETHEUS_CONTENT_TYPE
        assert text == telemetry.render_prometheus()
        assert "exp_hits_total 3" in text
        assert _get(port, "/healthz")[0] == 200
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nothing")
    finally:
        exp.stop()
    assert not any(t.name == "metrics-exporter" and t.is_alive()
                   for t in threading.enumerate())


def test_ensure_exporter_is_a_singleton_and_raises_on_a_taken_port():
    taken = export.MetricsExporter()
    port = taken.start(0)
    try:
        with pytest.raises(OSError):
            telemetry.ensure_exporter(port)
        exp = telemetry.ensure_exporter(_free_port())
        assert exp is not None and telemetry.ensure_exporter(1) is exp
        assert _get(exp.port, "/healthz")[0] == 200
    finally:
        taken.stop()
        telemetry.stop_exporter()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_collected_exporter_retires_its_thread():
    import gc
    import time

    exp = export.MetricsExporter()
    exp.start(0)
    del exp
    gc.collect()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name == "metrics-exporter" for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "metrics-exporter"
                   for t in threading.enumerate())


def _profile(mod, seed: int):
    rng = np.random.default_rng(seed)
    prof = mod.StepProfiler()
    for _ in range(int(rng.integers(2, 6))):
        for stage in ("plan", "feed", "feed", "step"):
            with prof.stage(stage):
                pass
        if rng.random() < 0.5:
            with prof.stage("custom"):
                pass
        prof.step_done()
    return prof


@pytest.mark.parametrize("seed", range(3))
def test_step_profiler_report_keys_match_reference(seed):
    port, ref = _profile(profiler, seed), _profile(ref_profiler, seed)
    pr, rr = port.report(), ref.report()
    assert list(pr) == list(rr)
    assert {k: v for k, v in pr.items() if k.endswith("_count")} == {
        k: v for k, v in rr.items() if k.endswith("_count")}
    assert pr["steps"] == rr["steps"]
    assert list(port.quantiles()) == list(ref.quantiles())
    assert ([p.split("=")[0] for p in port.log_line().split()]
            == [p.split("=")[0] for p in ref.log_line().split()])
    assert profiler.STAGE_BUCKETS == ref_profiler.STAGE_BUCKETS
    null = profiler.NullProfiler()
    with null.stage("x"):
        null.step_done()
    assert not profiler.StatsProfiler().enabled


def _reference_stages() -> dict:
    """{kernel def name: counted_jit stage} read from the reference's
    Pallas source."""
    import re

    src = open(os.path.join(REPO, "paddlebox_tpu", "ops",
                            "pallas_sparse.py")).read()
    return dict((name, stage) for stage, name in re.findall(
        r'@counted_jit\(stage="([^"]+)"[^\n]*\n(?:@[^\n]*\n)*def (\w+)',
        src))


@pytest.mark.parametrize("kernel", sorted(compiles.KERNEL_STAGES))
def test_compile_witness_counts_a_stubbed_build_once(kernel, monkeypatch):
    """A stubbed build and load of each kernel counts once under the
    stage of the reference kernel it ports; a second load counts
    nothing."""
    builds = []
    monkeypatch.setattr(cuda_build, "build",
                        lambda names: builds.append(list(names)) or {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(cuda_build, "_libs", {})
    lib = cuda_build.load(kernel)
    assert cuda_build.load(kernel) is lib
    assert builds == [[kernel]]
    stage = compiles.KERNEL_STAGES[kernel]
    assert compiles.compiles_by_stage() == {stage: 1}
    assert stage in _reference_stages().values()
    h = telemetry.registry.get("jit.compile_seconds")
    assert h.summary(stage=stage)["count"] == 1
    assert telemetry.total_compiles() == 1


def test_kernel_stages_are_the_reference_kernels():
    ref = _reference_stages()
    assert sorted(ref) == sorted(f"pallas_{k}" for k in (
        "pull_rows", "scatter_add", "gather_slots", "scatter_rows",
        "hot_cold_select", "sorted_search"))
    assert sorted(compiles.KERNEL_STAGES.values()) == sorted(ref.values())


def test_stage_scope_attributes_compile_events():
    with telemetry.stage_scope("outer"):
        with telemetry.stage_scope("train.scan"):
            telemetry.record_compile(0.5)
        telemetry.record_compile(0.25)
    telemetry.record_compile(0.125)
    telemetry.record_compile(0.1, stage="pallas.pull_rows")
    assert compiles.compiles_by_stage() == {
        "train.scan": 1, "outer": 1, compiles.UNTAGGED: 1,
        "pallas.pull_rows": 1}
    assert compiles.current_stage() == compiles.UNTAGGED


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiler.device_trace(None):
        pass
    with profiler.device_trace(str(tmp_path / "dt"), name="pass0"):
        torch.ones(64).cumsum(0)
    (f,) = os.listdir(tmp_path / "dt")
    assert f.startswith("pass0-pid") and f.endswith(".json")
    doc = json.load(open(tmp_path / "dt" / f))
    assert any(e.get("name", "").startswith("aten::")
               for e in doc["traceEvents"])


def test_telemetry_config_matches_reference(monkeypatch):
    import dataclasses

    ref_fields = {f.name: f.default
                  for f in dataclasses.fields(ref_config.TelemetryConfig)}
    assert {f.name: f.default for f in dataclasses.fields(
        TelemetryConfig)} == ref_fields
    for bad in (-1, 65536):
        with pytest.raises(ValueError):
            TelemetryConfig(metrics_port=bad)
    monkeypatch.setenv("PADDLEBOX_TORCH_METRICS_PORT", "9321")
    monkeypatch.setenv("PADDLEBOX_TORCH_TRACE_DIR", "/t")
    monkeypatch.setenv("PADDLEBOX_TORCH_EVENTS_PATH", "/e.jsonl")
    assert TelemetryConfig.from_flags() == TelemetryConfig(
        metrics_port=9321, trace_dir="/t", events_path="/e.jsonl")
    conf = TrainerConfig(telemetry=TelemetryConfig(metrics_port=1),
                         profile=True, trace_dir="/d")
    assert conf.profile and conf.trace_dir == "/d"
    ref_defaults = {f.name: f.default
                    for f in dataclasses.fields(ref_config.TrainerConfig)}
    for name in ("telemetry", "profile", "trace_dir"):
        assert getattr(TrainerConfig(), name) == ref_defaults[name]


def test_flags_of_the_telemetry_plane_match_reference():
    from paddlebox_tpu_torch.config import flags

    for name in ("metrics_port", "trace_dir", "events_path", "events_max_mb",
                 "flight_dir", "flight_ring", "health_enabled",
                 "health_ewma_alpha", "health_warmup", "health_max_alerts"):
        assert getattr(flags, name) == ref_config.flags._DEFAULTS[name], name


def _monitor_verdicts(mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    mon = mod.ModelMonitor()
    out = []
    for _ in range(8):
        m = {"auc": float(rng.uniform(0.4, 0.9)),
             "loss": float(rng.choice([rng.uniform(0.1, 12.0), math.nan])),
             "predicted_ctr": float(rng.uniform(0, 1)),
             "actual_ctr": float(rng.uniform(0, 1))}
        rep = mon.observe(m)
        out.append((bool(rep), tuple(rep.reasons),
                    mon.should_publish(m, min_auc_vs_best=0.05)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_model_monitor_matches_reference(seed):
    assert _monitor_verdicts(fleet_util, seed) == _monitor_verdicts(
        ref_fleet_util, seed)


def test_check_model_reads_the_table_and_the_torch_tower():
    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0)
    table = SparseTable(tconf, device="cpu")
    table.begin_pass(np.arange(1, 50, dtype=np.uint64))
    table.end_pass()
    model = CtrDnn(2, tconf.row_width, dense_dim=1, hidden=(4,), device="cpu")
    trainer = Trainer(model, tconf, TrainerConfig(), device="cpu")
    rep = fleet_util.check_model(table, trainer)
    table.close()
    n_params = sum(p.numel() for p in model.parameters())
    assert rep["n_features"] == 49 and rep["sparse_finite"]
    assert rep["dense_params"] == n_params
    assert rep["dense_bytes"] == 4 * n_params and rep["dense_finite"]
    assert set(rep) == {"n_features", "sparse_bytes", "sparse_finite",
                        "dense_params", "dense_bytes", "dense_finite"}
