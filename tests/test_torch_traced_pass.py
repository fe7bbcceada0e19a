"""Traced training passes of both port trainers against the JAX package:
the reference's ``test_traced_training_pass_writes_nested_chrome_trace``
(tests/test_telemetry.py) at its tiny sizes, run through both packages.
The span names and parents of the host trace and the metric names of the
``pass_end`` record must be equal, but for a listed set whose counts differ
by design (``jit.*``: the port's compile events are kernel builds and graph
captures, none on the CPU), whose module comes with a later slice
(``hostplane.gather_seconds``: the multi-process host plane), or which
only the port records (its listed port-only names).  Telemetry on and off
train bit-equal runs, the default pass records its stage histograms and
runs the health rules, and ``tools/pbox_doctor.py`` reads the port's trace,
event and flight files.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu import telemetry as ref_telemetry
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.telemetry import health as ref_health
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import (
    SparseTableConfig,
    TelemetryConfig,
    TrainerConfig,
)
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.telemetry import flight, health
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference test's sizes
SLOTS, DENSE, BATCH, HIDDEN = 3, 2, 16, (8,)
# metric families left out of the name comparison, with why
NAME_EXCLUDED = (
    "jit.",  # compile events: XLA compiles there, kernel builds and graph
             # captures here (none on the CPU)
    "hostplane.gather_seconds",  # the multi-process host plane (item 8)
    # the port-only names (tests/test_torch_telemetry_names.py)
    "trainer.prefetched_feeds", "trainer.graph_captures",
    "trainer.graph_replays",
)


def _reset_both():
    for t in (telemetry, ref_telemetry):
        t.registry.reset()
        t.disable_tracing()
        t.close_event_log()
        t.stop_exporter()
    health.reset_for_tests()
    ref_health.reset_for_tests()
    flight.reset_for_tests()
    ref_telemetry.flight.reset_for_tests()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    _reset_both()
    yield
    _reset_both()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_synth_files(
        str(tmp_path_factory.mktemp("traced")), n_files=1, ins_per_file=64,
        n_sparse_slots=SLOTS, vocab_per_slot=40, dense_dim=DENSE, seed=3,
    )


def _load(files, ref: bool):
    conf = dict(n_sparse_slots=SLOTS, dense_dim=DENSE, batch_size=BATCH,
                max_feasigns_per_ins=8)
    ds = (RefDataset(ref_synth_config(**conf), read_threads=1) if ref else
          PadBoxSlotDataset(make_synth_config(**conf), read_threads=1))
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _spans(trace_file: str) -> set:
    doc = json.load(open(trace_file))
    return {(e["name"], e.get("args", {}).get("parent"))
            for e in doc["traceEvents"] if e.get("ph") == "X"}


def _names(snap: dict) -> set:
    out = set()
    for kind in ("counters", "gauges", "histograms"):
        for series in snap[kind]:
            if not series.startswith(NAME_EXCLUDED):
                out.add((kind, series))
    return out


def _ref_single(tmp, files, trconf_kw):
    ds = _load(files, ref=True)
    tconf = ref_config.SparseTableConfig(embedding_dim=4)
    trconf = ref_config.TrainerConfig(
        auc_buckets=1 << 10,
        telemetry=ref_config.TelemetryConfig(
            trace_dir=os.path.join(tmp, "ref-traces"),
            events_path=os.path.join(tmp, "ref-events.jsonl")),
        **trconf_kw)
    model = RefCtrDnn(SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN)
    table = RefTable(tconf, seed=0)
    trainer = RefTrainer(model, tconf, trconf, seed=0)
    table.begin_pass(ds.unique_keys())
    metrics = trainer.train_from_dataset(ds, table)
    table.end_pass()
    table.close()
    ds.close()
    ref_telemetry.close_event_log()
    tower = [{k: np.asarray(v) for k, v in layer.items()}
             for layer in trainer.params["tower"]]
    return metrics, tower


def _port_world(tower, trconf: TrainerConfig, multichip: bool = False):
    tconf = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   device="cpu")
    if tower is not None:
        model.load_state_dict(params_from_jax(tower))
    if multichip:
        mesh = make_mesh(2, device="cpu")
        return (ShardedSparseTable(tconf, mesh, seed=0),
                MultiChipTrainer(model, tconf, mesh, trconf))
    return (SparseTable(tconf, seed=0, device="cpu"),
            Trainer(model, tconf, trconf, device="cpu"))


def _port_passes(files, tower, trconf, n_passes=1, multichip=False):
    """(per-pass metrics, final state_dict) of n passes over the file."""
    table, trainer = _port_world(tower, trconf, multichip)
    out, auc = [], None
    for _ in range(n_passes):
        ds = _load(files, ref=False)
        table.begin_pass(ds.unique_keys())
        out.append(trainer.train_from_dataset(ds, table, auc_state=auc))
        auc = trainer.last_metric_state
        table.end_pass()
        ds.close()
    state = table.state_dict()
    table.close()
    return out, state


def _telemetry_conf(tmp, tag):
    return TelemetryConfig(trace_dir=os.path.join(tmp, f"{tag}-traces"),
                           events_path=os.path.join(tmp, f"{tag}-events.jsonl"))


@pytest.mark.parametrize("dump", [True, False])
def test_traced_single_chip_pass_matches_reference(tmp_path, files, dump):
    """The reference test's pass through both packages (with its field
    dump, and without): one trace file each, the same (span, parent) set
    with plan/feed/step(/dump) under pass, and the same pass_end metric
    names."""
    tmp = str(tmp_path)
    dump_kw = (dict(need_dump_field=True,
                    dump_fields_path=os.path.join(tmp, "dump"))
               if dump else {})
    ref_m, tower = _ref_single(tmp, files, dump_kw)
    ref_recs = [json.loads(ln) for ln in open(f"{tmp}/ref-events.jsonl")]

    trconf = TrainerConfig(auc_buckets=1 << 10,
                           telemetry=_telemetry_conf(tmp, "port"), **dump_kw)
    (m,), _ = _port_passes(files, tower, trconf)
    telemetry.close_event_log()
    tf = sorted(os.listdir(f"{tmp}/port-traces"))
    assert tf == sorted(os.listdir(f"{tmp}/ref-traces")) == [
        "host-trace-r0-pass0.json"]
    spans = _spans(f"{tmp}/port-traces/{tf[0]}")
    assert spans == _spans(f"{tmp}/ref-traces/{tf[0]}")
    stages = {"plan", "feed", "step"} | ({"dump"} if dump else set())
    assert {(s, "pass") for s in stages} | {("pass", None)} == spans
    recs = [json.loads(ln) for ln in open(f"{tmp}/port-events.jsonl")]
    assert [r["event"] for r in recs] == [r["event"] for r in ref_recs] == [
        "pass_end"]
    assert _names(recs[-1]["telemetry"]) == _names(ref_recs[-1]["telemetry"])
    assert set(recs[-1]["metrics"]) == set(ref_recs[-1]["metrics"])
    assert recs[-1]["pass_idx"] == 0 and recs[-1]["rank"] == 0
    # the profiled split, as the reference reports it
    assert set(m["profile"]) == set(ref_m["profile"])
    assert set(m["profile"]["stage_quantiles"]) == set(
        ref_m["profile"]["stage_quantiles"])
    assert m["profile"]["stage_quantiles"]["step"]["count"] == m["steps"]


def _ref_multichip(tmp, files, n_passes, reshard_to=None):
    ds0 = _load(files, ref=True)
    mesh = ref_make_mesh(2)
    tconf = ref_config.SparseTableConfig(embedding_dim=4)
    trconf = ref_config.TrainerConfig(
        auc_buckets=1 << 10,
        telemetry=ref_config.TelemetryConfig(
            events_path=os.path.join(tmp, "ref-events.jsonl")))
    tr = RefMultiChipTrainer(
        RefCtrDnn(SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN),
        tconf, mesh, trconf, seed=3)
    tower = [{k: np.asarray(v) for k, v in layer.items()}
             for layer in tr.dense_state()[0]["tower"]]
    table = RefShardedTable(tconf, mesh, seed=0)
    ds0.close()
    ref_telemetry.enable_tracing()
    for _ in range(n_passes):
        ds = _load(files, ref=True)
        table.begin_pass(ds.unique_keys())
        tr.train_from_dataset(ds, table)
        table.end_pass()
        table.flush()  # the merge lands before the next pass's record
        ds.close()
    if reshard_to is not None:
        table.reshard(ref_make_mesh(reshard_to))
    ref_telemetry.flush_trace(os.path.join(tmp, "ref-trace.json"))
    table.close()
    ref_telemetry.close_event_log()
    return tower


@pytest.mark.parametrize("reshard", [False, True])
def test_traced_multichip_pass_matches_reference(tmp_path, files, reshard):
    """Two passes of the multi-chip trainer on 2 positions at the default
    table (per-shard caches on), tracing on in both packages: the same
    (span, parent) set (the multi-chip pass records no stage span in
    either; a live reshard adds reshard.migrate and reshard.cutover) and
    the same pass_end metric names, placement and cache metrics
    included."""
    tmp = str(tmp_path)
    tower = _ref_multichip(tmp, files, 2, 4 if reshard else None)
    ref_recs = [json.loads(ln) for ln in open(f"{tmp}/ref-events.jsonl")]

    telemetry.enable_tracing()
    trconf = TrainerConfig(auc_buckets=1 << 10, telemetry=TelemetryConfig(
        events_path=os.path.join(tmp, "port-events.jsonl")))
    tconf = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    mesh = make_mesh(2, device="cpu")
    table = ShardedSparseTable(tconf, mesh, seed=0)
    trainer = MultiChipTrainer(model, tconf, mesh, trconf)
    for _ in range(2):
        ds = _load(files, ref=False)
        table.begin_pass(ds.unique_keys())
        trainer.train_from_dataset(ds, table)
        table.end_pass()
        table.flush()
        ds.close()
    if reshard:
        table.reshard(make_mesh(4, device="cpu"))
    telemetry.flush_trace(os.path.join(tmp, "port-trace.json"))
    table.close()
    telemetry.close_event_log()

    spans = _spans(f"{tmp}/port-trace.json")
    assert spans == _spans(f"{tmp}/ref-trace.json")
    assert spans == ({("reshard.migrate", None), ("reshard.cutover", None)}
                     if reshard else set())
    recs = [json.loads(ln) for ln in open(f"{tmp}/port-events.jsonl")]
    recs = [r for r in recs if r["event"] == "pass_end"]
    ref_recs = [r for r in ref_recs if r["event"] == "pass_end"]
    assert len(recs) == len(ref_recs) == 2
    for rec, ref_rec in zip(recs, ref_recs):
        assert _names(rec["telemetry"]) == _names(ref_rec["telemetry"])
        assert rec["global_step"] == ref_rec["global_step"]
    second = recs[-1]["telemetry"]
    assert "cache.hit_rate" in second["gauges"]
    assert "placement.hot_keys" in second["gauges"]


def _assert_runs_equal(a, b):
    (ma, sa), (mb, sb) = a, b
    for x, y in zip(ma, mb):
        for k in ("loss", "auc", "steps", "samples", "grad_norm",
                  "weight_norm"):
            assert x[k] == y[k], (k, x[k], y[k])
    np.testing.assert_array_equal(sa["keys"], sb["keys"])
    np.testing.assert_array_equal(sa["values"], sb["values"])


@pytest.mark.parametrize("multichip", [False, True])
def test_telemetry_on_and_off_train_bit_equal(tmp_path, files, multichip):
    """Three passes with the full telemetry (trace dir, events, exporter,
    and on the single chip the profiled serial single-step feed) against
    the same passes with none: losses, AUC, norms and rows bit-equal."""
    off = _port_passes(files, None,
                       TrainerConfig(auc_buckets=1 << 10, scan_steps=2),
                       n_passes=3, multichip=multichip)
    on_conf = TrainerConfig(
        auc_buckets=1 << 10, scan_steps=2, profile=True,
        telemetry=TelemetryConfig(
            trace_dir=str(tmp_path / "tr"),
            events_path=str(tmp_path / "ev.jsonl"), metrics_port=0))
    health.reset_for_tests()  # a run of its own: fresh health baselines
    on = _port_passes(files, None, on_conf, n_passes=3, multichip=multichip)
    _assert_runs_equal(off, on)
    recs = [json.loads(ln) for ln in open(tmp_path / "ev.jsonl")]
    # timing rules may alert on a loaded host; one pass_end a pass always
    assert [r["pass_idx" if not multichip else "global_step"]
            for r in recs if r["event"] == "pass_end"] == (
        [0, 1, 2] if not multichip else
        [on[0][0]["steps"] * (i + 1) for i in range(3)])


def test_default_pass_records_stages_cache_and_gap(files):
    """No telemetry config at all: a pass still records the stage
    histograms, the cache and boundary metrics, and runs the health
    rules, as the reference does by default."""
    (m1, m2), _ = _port_passes(files, None, TrainerConfig(auc_buckets=1 << 10),
                               n_passes=2)
    snap = telemetry.registry.snapshot()
    hists = snap["histograms"]
    for stage in ("plan", "feed", "step"):
        assert hists[f"trainer.stage_seconds{{stage={stage}}}"]["count"] > 0
    assert hists["pass.boundary_gap_seconds"]["count"] == 1
    assert hists["store.merge_seconds"]["count"] >= 1
    assert "cache.hit_rate" in snap["gauges"]
    assert snap["counters"]["pass.host_row_bytes_in"] > 0
    # the default cache admits the whole small census: end_pass writes
    # nothing back, and says so
    assert snap["counters"]["pass.host_row_bytes_out"] == 0
    assert snap["counters"]["health.windows"] == 2
    assert health.health_view()["windows"] == 2
    assert "profile" not in m1 and "profile" not in m2


def test_doctor_reads_the_port_artifacts(tmp_path, files, monkeypatch):
    """tools/pbox_doctor.py, stdlib only, run on one traced port pass's
    trace, event and flight files: it exits 0 and merges the port's trace
    with the flight dump on one timeline, as it does the reference's."""
    run = tmp_path / "run"
    monkeypatch.setenv("PADDLEBOX_TORCH_FLIGHT_DIR", str(run))
    telemetry.set_process_name("trainer")
    trconf = TrainerConfig(auc_buckets=1 << 10, telemetry=TelemetryConfig(
        trace_dir=str(run), events_path=str(run / "events.jsonl")))
    _port_passes(files, None, trconf)
    telemetry.close_event_log()
    assert telemetry.dump_flight("manual", {"pass_idx": 0})
    names = sorted(os.listdir(run))
    assert "host-trace-r0-pass0.json" in names and "events.jsonl" in names
    assert any(n.startswith("flight-trainer-r0-") for n in names)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "pbox_doctor.py"),
         str(run), "--json"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["sources"]["dumps"] == 1
    assert report["sources"]["events"] >= 1
    srcs = {r["src"] for r in report["timeline"]}
    assert {"trace", "dump"} <= srcs
    procs = {r["proc"] for r in report["timeline"] if r["src"] == "trace"}
    assert procs == {"pbox/r0"}
    plain = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "pbox_doctor.py"),
         str(run)], capture_output=True, text=True, timeout=120)
    assert plain.returncode == 0, plain.stderr
