"""The port's run-health plane against the JAX package's, exactly: the rule
catalog is the reference's literal, and the same sequence of pass windows
(counters, gauges, histograms and table stats made from a seed with
numpy, with a NaN pass and a cache hit-rate collapse among them) gives
equal ``flatten_window`` dicts and the same alerts, in the same order.
Then the port's wiring: a critical alert dumps the flight ring and lands
in the event log, the kill switch, and ``health_stats`` of both tables.
"""

import json
import math

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu import telemetry as ref_telemetry
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.telemetry import flight as ref_flight
from paddlebox_tpu.telemetry import health as ref_health
from paddlebox_tpu.telemetry.metrics import MetricRegistry as RefRegistry
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import SparseTableConfig
from paddlebox_tpu_torch.parallel import ShardedSparseTable, make_mesh
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.telemetry import flight, health
from paddlebox_tpu_torch.telemetry.metrics import MetricRegistry
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for t in (telemetry, ref_telemetry):
        t.registry.reset()
        t.close_event_log()
    health.reset_for_tests()
    ref_health.reset_for_tests()
    flight.reset_for_tests()
    ref_flight.reset_for_tests()
    yield
    telemetry.registry.reset()
    telemetry.close_event_log()
    health.reset_for_tests()
    flight.reset_for_tests()


def test_rule_catalog_is_the_reference_literal():
    assert health._RULE_SPECS == ref_health._RULE_SPECS
    assert health.rule_names() == ref_health.rule_names()
    assert [r.__dict__ for r in health.default_rules()] == [
        r.__dict__ for r in ref_health.default_rules()]


def _windows(seed: int, n: int = 12):
    """n pass windows: (metrics, table stats, registry ops).  Window 7 has
    a NaN loss, window 9 a hit-rate collapse and an eviction storm, window
    10 a compile past warmup and a merge backlog."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        steps = int(rng.integers(20, 40))
        metrics = {"auc": float(0.75 + rng.normal(0, 0.002)),
                   "loss": float(0.5 + rng.normal(0, 0.003)),
                   "steps": steps, "samples": float(steps * 64),
                   "duration_s": float(rng.uniform(1.0, 1.2)),
                   "profile": {"ignored": 1}, "flag": True}
        hits = int(rng.integers(900, 1000))
        table = {"cache_hits": hits, "cache_misses": 1000 - hits,
                 "promotion_patch_rows": 1000 - hits,
                 "cache_hit_rate": hits / 1000.0,
                 "merge_backlog": int(rng.integers(0, 2))}
        ops = {"gap": rng.uniform(0.01, 0.02, 2),
               "stage": rng.uniform(0.001, 0.002, 30),
               "evicted": int(rng.integers(10, 20)),
               "grad_norm": float(1.0 + rng.normal(0, 0.01)),
               "skipped": 0, "compiles": 0}
        if w == 7:
            metrics["loss"] = math.nan
            ops["skipped"] = 5
        if w == 9:
            table.update(cache_hits=10, cache_misses=990,
                         promotion_patch_rows=990, cache_hit_rate=0.01)
            ops["evicted"] = 5000
            ops["stage"] = rng.uniform(0.1, 0.2, 30)
        if w == 10:
            ops["compiles"] = 1
            table["merge_backlog"] = 9
            ops["grad_norm"] = 50.0
        out.append((metrics, table, ops))
    return out


def _apply(reg, ops: dict) -> None:
    for v in ops["gap"]:
        reg.histogram("pass.boundary_gap_seconds").observe(float(v))
    for i, v in enumerate(ops["stage"]):
        reg.histogram("trainer.stage_seconds").observe(
            float(v), stage=("plan", "feed", "step")[i % 3])
    reg.counter("cache.evicted_rows").inc(ops["evicted"])
    reg.gauge("train.grad_norm").set(ops["grad_norm"])
    if ops["skipped"]:
        reg.counter("train.nan_skipped_steps").inc(ops["skipped"])
    if ops["compiles"]:
        reg.counter("jit.compiles").inc(ops["compiles"], stage="train.scan")


def _same_signals(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k] for k in a)


@pytest.mark.parametrize("seed,warmup,alpha",
                         [(0, 3, 0.3), (1, 3, 0.3), (2, 0, 0.5),
                          (3, 5, 0.1)])
def test_windows_flatten_and_alert_as_the_reference(seed, warmup, alpha):
    port_reg, ref_reg = MetricRegistry(), RefRegistry()
    port_mon = health.HealthMonitor(warmup=warmup, ewma_alpha=alpha)
    ref_mon = ref_health.HealthMonitor(warmup=warmup, ewma_alpha=alpha)
    fired = []
    for w, (metrics, table, ops) in enumerate(_windows(seed)):
        _apply(port_reg, ops)
        _apply(ref_reg, ops)
        ps, rs = port_reg.delta_snapshot(), ref_reg.delta_snapshot()
        assert _same_signals(health.flatten_window(metrics, ps, table),
                             ref_health.flatten_window(metrics, rs, table))
        pa = port_mon.observe(w, metrics=metrics, telemetry=ps, table=table)
        ra = ref_mon.observe(w, metrics=metrics, telemetry=rs, table=table)
        assert [a.to_dict() for a in pa] == [a.to_dict() for a in ra]
        fired += [(w, a.rule, a.severity) for a in pa]
    assert (7, "train.loss_spike", "critical") in fired
    assert (9, "table.hit_rate_collapse", "critical") in fired
    assert (10, "pipeline.steady_state_recompile", "warn") in fired
    assert (10, "table.writeback_backlog", "warn") in fired
    p, r = port_mon.snapshot(), ref_mon.snapshot()
    assert p == r and p["critical_total"] >= 2


def test_critical_alert_dumps_the_flight_ring_and_logs_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_FLIGHT_DIR", str(tmp_path))
    log = telemetry.ensure_event_log(str(tmp_path / "ev.jsonl"))
    mon = health.reset_for_tests(warmup=0)
    alerts = health.observe_pass(0, metrics={"loss": math.nan})
    assert [(a.rule, a.severity) for a in alerts] == [
        ("train.loss_spike", "critical")]
    telemetry.close_event_log()
    (rec,) = [json.loads(ln) for ln in open(log.path)]
    assert rec["event"] == "health_alert"
    assert rec["rule"] == "train.loss_spike" and rec["observed"] == "nan"
    (dump,) = [f for f in tmp_path.iterdir() if f.name.startswith("flight-")]
    d = json.load(open(dump))
    assert d["reason"] == "health" and d["detail"]["rule"] == (
        "train.loss_spike")
    assert telemetry.registry.get("health.alerts").value(
        rule="train.loss_spike", severity="critical") == 1
    assert health.health_view() == mon.snapshot()
    assert health.health_view()["critical_total"] == 1


def test_health_kill_switch(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_HEALTH_ENABLED", "0")
    mon = health.reset_for_tests()
    assert not mon.enabled
    assert health.observe_pass(0, metrics={"loss": math.nan}) == []
    monkeypatch.setenv("PADDLEBOX_TORCH_HEALTH_WARMUP", "7")
    assert health.HealthMonitor().warmup == 7
    with pytest.raises(ValueError):
        health.HealthMonitor(ewma_alpha=0.0)


def _two_passes(table, censuses):
    """health_stats after two passes and a flush (the merge thread's
    progress would otherwise show in the store and backlog fields)."""
    for pk in censuses:
        table.begin_pass(pk)
        table.end_pass()
    table.flush()
    stats = table.health_stats()
    table.close()
    return stats


@pytest.mark.parametrize("cache_rows", [0, 64])
def test_table_health_stats_match_reference(cache_rows):
    """health_stats of both single-chip tables after the same two passes
    and a flush: the same keys and values."""
    rng = np.random.default_rng(cache_rows)
    censuses = [np.unique(rng.integers(1, 200, 120).astype(np.uint64))
                for _ in range(2)]
    kw = dict(embedding_dim=4, hbm_cache_rows=cache_rows)
    port = _two_passes(SparseTable(SparseTableConfig(**kw), device="cpu"),
                       censuses)
    ref = _two_passes(RefTable(ref_config.SparseTableConfig(**kw)), censuses)
    assert port == ref
    assert port["merge_backlog"] == port["overlay_entries"] == 0
    assert ("cache_hit_rate" in port) == bool(cache_rows)


def test_sharded_table_health_stats_sum_the_shards():
    table = ShardedSparseTable(SparseTableConfig(embedding_dim=4,
                                                 hbm_cache_rows=64),
                               make_mesh(2, device="cpu"))
    pk = np.arange(1, 40, dtype=np.uint64)
    stats = _two_passes(table, [pk, pk])
    assert stats["cache_capacity"] == 64
    assert stats["cache_hits"] + stats["cache_misses"] == 39
    assert stats["cache_hit_rate"] == stats["cache_hits"] / 39
