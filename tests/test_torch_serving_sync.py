"""The port's delivery plane (paddlebox_tpu_torch/serving_sync/) held to the
reference's tests/test_serving_sync.py, on the CPU, plus its agreement
with the JAX package:

  * each package's ``parse_donefile`` reads the other's donefile, and a
    ``PublishEntry`` serializes to the same line in both;
  * one table state, loaded into both packages from the same numpy with
    the same census, publishes a delta whose ``sparse_delta.npz`` arrays
    (every npy member, byte for byte) and ``delta.json`` (but for its
    publish time) equal the reference's, in fp32, int8 and fp8;
  * the reference's publish-root lint (tools/pbox_analyze/publish.py)
    finds nothing on a root the port published;
  * a port Syncer on a CPU ScoringServer applies a base and deltas, and its
    rows equal a fresh export's bit for bit, its scores a fresh
    Predictor's at PR 16's tolerance (rtol 1e-5, atol 1e-6).

The trainer side is the port's own (3 slots, 2 dense, batch 8, tower 8,
as the reference's tests).
"""

import json
import os
import sys
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import SparseTableConfig as RefTableConfig
from paddlebox_tpu.serving_sync import PublishEntry as RefPublishEntry
from paddlebox_tpu.serving_sync import Publisher as RefPublisher
from paddlebox_tpu.serving_sync import parse_donefile as ref_parse_donefile
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.inference import Predictor, ScoringServer, export_model
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.serving_sync import (
    DONEFILE_NAME,
    ModelRegistry,
    ModelVersion,
    PublishEntry,
    Publisher,
    PublishError,
    Syncer,
    fleet_min_freshness,
    parse_donefile,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.train.trainer import Trainer
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.faults import fault_plan
from paddlebox_tpu_torch.utils.monitor import stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.pbox_analyze.publish import check_publish_root  # noqa: E402

torch.set_num_threads(1)

S, DENSE, B = 3, 2, 8
KCAP = B * 8
# scores of a synced and a freshly exported Predictor: PR 16's bound
TOL = dict(rtol=1e-5, atol=1e-6)


class _Job:
    """A tiny CTR job whose table and tower change every pass: the trainer
    side of the delivery plane."""

    def __init__(self, workdir, seed=0):
        self.workdir = str(workdir)
        self.conf = make_synth_config(
            n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
            max_feasigns_per_ins=8,
        )
        self.tconf = SparseTableConfig(embedding_dim=4)
        self.model = CtrDnn(S, self.tconf.row_width, dense_dim=DENSE,
                            hidden=(8,), seed=seed, device="cpu")
        self.table = SparseTable(self.tconf, seed=seed, device="cpu")
        self.trainer = Trainer(self.model, self.tconf,
                               TrainerConfig(auc_buckets=1 << 10),
                               device="cpu")

    def train_pass(self, i):
        files = write_synth_files(
            os.path.join(self.workdir, f"d{i}"), n_files=1, ins_per_file=32,
            n_sparse_slots=S, vocab_per_slot=60, dense_dim=DENSE,
            seed=100 + i,
        )
        ds = PadBoxSlotDataset(self.conf, read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        self.table.begin_pass(ds.unique_keys())
        self.trainer.train_from_dataset(ds, self.table)
        self.table.end_pass()
        ds.close()

    def publisher(self, root, **kw):
        return Publisher(
            root, staging_dir=os.path.join(self.workdir, "stage"), **kw
        )

    def publish_base(self, pub, tag, **kw):
        return pub.publish_base(
            tag, self.model, None, self.table,
            batch_size=B, key_capacity=KCAP, dense_dim=DENSE,
            feed_conf=self.conf, **kw,
        )

    def fresh_artifact(self, out, **kw):
        export_model(
            self.model, self.table, out,
            batch_size=B, key_capacity=KCAP, dense_dim=DENSE,
            feed_conf=self.conf, **kw,
        )
        return out


@pytest.fixture
def job(tmp_path):
    j = _Job(tmp_path)
    yield j
    j.table.close()


def _lines(n, seed=5, vocab=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = ["1 0"]
        for _s in range(S):
            ks = rng.integers(0, vocab, 2)
            parts.append(f"{len(ks)} " + " ".join(map(str, ks)))
        parts.append(f"{DENSE} " + " ".join(
            f"{v:.3f}" for v in rng.random(DENSE)))
        out.append(" ".join(parts))
    return ("\n".join(out) + "\n").encode()


def _syncer(root, srv, tmp_path, **kw):
    return Syncer(root, srv, "live",
                  cache_dir=str(tmp_path / "cache"),
                  poll_interval_s=0.05, **kw)


# --------------------------------------------------------------------------- #
# publisher: layout, donefile last, failure atomicity
# --------------------------------------------------------------------------- #
def test_publish_layout_and_sequenced_donefile(job, tmp_path):
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    e0 = job.publish_base(pub, "p0")
    job.train_pass(1)
    e1 = pub.publish_delta("p1", job.table)  # sparse only
    assert (e0.seq, e0.kind, e0.base_tag) == (0, "base", "p0")
    assert (e1.seq, e1.kind, e1.base_tag, e1.prev_tag) == (
        1, "delta", "p0", "p0")
    assert not e1.has_programs and e1.n_rows > 0 and e1.n_bytes > 0
    assert os.path.isdir(os.path.join(root, "base-p0", "sparse"))
    assert os.path.exists(os.path.join(root, "base-p0", "manifest.json"))
    assert os.path.exists(os.path.join(root, "base-p0", "serving.pt2"))
    assert os.path.exists(
        os.path.join(root, "delta-p1", "sparse_delta.npz"))
    assert os.path.exists(os.path.join(root, "delta-p1", "manifest.json"))
    with open(os.path.join(root, DONEFILE_NAME), "rb") as fh:
        entries = parse_donefile(fh.read())
    assert [e.seq for e in entries] == [0, 1]
    with open(os.path.join(root, "base-p0", "manifest.json")) as fh:
        files = json.load(fh)["files"]
    assert any(name.startswith("sparse/") for name in files)

    # resume: a new Publisher over the same root continues the sequence
    pub2 = job.publisher(root)
    assert pub2.next_seq == 2 and pub2.base_tag == "p0"
    assert pub2.last_tag == "p1"


def test_failed_delta_publish_keeps_tracker_and_donefile(job, tmp_path,
                                                         monkeypatch):
    """Donefile last under an injected upload failure: the failed delta
    never becomes visible, its rows stay tracked, and the retried publish
    ships them."""
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS", "1")
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.01")
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    job.train_pass(1)
    n_tracked = job.table.delta_state_dict()["keys"].shape[0]
    assert n_tracked > 0
    with fault_plan({"publish.delta": "first:1"}):
        with pytest.raises(faults.FaultInjected):
            pub.publish_delta("p1", job.table)
    with open(os.path.join(root, DONEFILE_NAME), "rb") as fh:
        assert len(parse_donefile(fh.read())) == 1
    assert job.table.delta_state_dict()["keys"].shape[0] == n_tracked
    e = pub.publish_delta("p1", job.table)
    assert e.seq == 1 and e.n_rows == n_tracked
    assert job.table.delta_state_dict()["keys"].shape[0] == 0


def test_failed_donefile_upload_is_unappended(job, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS", "1")
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    job.train_pass(1)
    with fault_plan({"publish.donefile": "first:1"}):
        with pytest.raises(faults.FaultInjected):
            pub.publish_delta("p1", job.table)
    assert pub.next_seq == 1
    with open(os.path.join(job.workdir, "stage", DONEFILE_NAME)) as fh:
        assert len(fh.read().splitlines()) == 1
    assert pub.publish_delta("p1", job.table).seq == 1


def test_delta_without_base_refused(job, tmp_path):
    pub = job.publisher(str(tmp_path / "pub"))
    job.train_pass(0)
    with pytest.raises(PublishError, match="publish_base first"):
        pub.publish_delta("p0", job.table)


def test_publish_health_gate(job, tmp_path):
    from paddlebox_tpu_torch.utils.fleet_util import (
        HealthPolicy,
        ModelMonitor,
    )

    pub = job.publisher(str(tmp_path / "pub"),
                        monitor=ModelMonitor(HealthPolicy(min_auc=0.5)))
    job.train_pass(0)
    gated = telemetry.counter("publish.gated")
    before = gated.value()
    assert job.publish_base(pub, "p0", metrics={"auc": 0.2,
                                                "loss": 0.5}) is None
    assert gated.value() == before + 1
    assert pub.next_seq == 0
    assert job.publish_base(pub, "p0", metrics={"auc": 0.7,
                                                "loss": 0.5}) is not None


# --------------------------------------------------------------------------- #
# syncer: the hot apply
# --------------------------------------------------------------------------- #
def test_sync_base_plus_deltas_equals_a_fresh_export(job, tmp_path):
    """A server that applied a base and 3 deltas holds the fresh export's
    keys and rows bit for bit, and scores as a fresh Predictor does."""
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    base_features = job.table.n_features
    for i in range(1, 4):
        job.train_pass(i)
        assert pub.publish_delta(f"p{i}", job.table, job.model).has_programs

    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    assert sync.poll_once() == 4
    version = sync.registry.current_version("live")
    assert version.base_tag == "p0" and version.deltas_applied == 3
    assert version.tag == "p3" and version.seq == 3
    assert sync.applied_seq == 3
    assert sync.last_apply["kind"] == "delta"
    assert {"fetch_s", "merge_s", "upload_s", "swap_s"} <= set(
        sync.last_apply)

    fresh = Predictor.load(job.fresh_artifact(str(tmp_path / "full")),
                           device="cpu")
    live = srv._models["live"].predictor
    assert live.n_features > base_features  # new keys, not only updates
    np.testing.assert_array_equal(live._keys, fresh._keys)
    np.testing.assert_array_equal(live._values, fresh._values)

    body = _lines(23)
    srv2 = ScoringServer(device="cpu")
    srv2.register("fresh", str(tmp_path / "full"))
    np.testing.assert_allclose(srv.score_lines(body, "live"),
                               srv2.score_lines(body, "fresh"), **TOL)

    assert telemetry.gauge("sync.lag_passes").value(model="live") == 0
    assert telemetry.gauge(
        "serve.model_age_seconds").value(model="live") >= 0.0
    assert sync.poll_once() == 0  # nothing new


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_chain_syncs_to_the_fresh_export(job, tmp_path, dtype):
    """A quantized chain ships quantized delta rows; base + deltas equal a
    fresh export in the same dtype, code for code."""
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    assert job.publish_base(pub, "p0",
                            embedding_dtype=dtype).embedding_dtype == dtype
    for i in (1, 2):
        job.train_pass(i)
        assert pub.publish_delta(f"p{i}", job.table).embedding_dtype == dtype
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    assert sync.poll_once() == 3
    live = srv._models["live"].predictor
    fresh = Predictor.load(job.fresh_artifact(str(tmp_path / "full"),
                                              embedding_dtype=dtype),
                           device="cpu")
    np.testing.assert_array_equal(live._keys, fresh._keys)
    np.testing.assert_array_equal(live._head, fresh._head)
    np.testing.assert_array_equal(live._q.view(np.uint8),
                                  fresh._q.view(np.uint8))
    np.testing.assert_array_equal(live._scales, fresh._scales)


def test_sparse_only_delta_updates_rows_keeps_programs(job, tmp_path):
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    sync.poll_once()
    before = srv._models["live"].predictor
    job.train_pass(1)
    pub.publish_delta("p1", job.table)
    assert sync.poll_once() == 1
    after = srv._models["live"].predictor
    assert after is not before  # built aside, swapped atomically
    assert after._programs is before._programs  # shared program cache
    assert not np.array_equal(after._values[: before.n_features],
                              before._values)
    state = job.table.state_dict()
    w = job.tconf.row_width
    np.testing.assert_array_equal(after._keys, state["keys"])
    np.testing.assert_array_equal(
        after._values, np.asarray(state["values"], np.float32)[:, :w])


def test_ann_chain_syncs_index_rows(job, tmp_path):
    """An ANN base and a delta: the syncer merges the item range's rows
    through AnnIndex.with_delta and registers the index for /retrieve."""
    from paddlebox_tpu_torch.inference import export_ann_index

    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    lo, hi = 0, 30
    e0 = pub.publish_ann_base("a0", job.table, item_key_lo=lo,
                              item_key_hi=hi)
    assert e0.meta["artifact_kind"] == "ann" and not e0.has_programs
    job.train_pass(1)
    pub.publish_delta("a1", job.table)
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    assert sync.poll_once() == 2
    live = srv._models["live"].predictor
    fresh = export_ann_index(str(tmp_path / "ann"), job.table,
                             item_key_lo=lo, item_key_hi=hi, device="cpu")
    np.testing.assert_array_equal(live.keys, fresh.keys)
    np.testing.assert_array_equal(live.emb, fresh.emb)


# --------------------------------------------------------------------------- #
# the fallback ladder
# --------------------------------------------------------------------------- #
def _corrupt(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(data))


def test_corrupt_delta_full_reload_no_failed_scores(job, tmp_path):
    """A delta whose remote bytes are wrong triggers the full reload, keeps
    the last good chain serving, and fails no score meanwhile."""
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    job.train_pass(1)
    pub.publish_delta("p1", job.table, job.model)
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    sync.poll_once()
    good_keys = srv._models["live"].predictor._keys.copy()

    job.train_pass(2)
    pub.publish_delta("p2", job.table, job.model)
    _corrupt(os.path.join(root, "delta-p2", "sparse_delta.npz"))

    body = _lines(5)
    want = srv.score_lines(body, "live")
    failures, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                got = srv.score_lines(body, "live")
                if len(got) != 5 or not all(0.0 < s < 1.0 for s in got):
                    failures.append(got)
            except Exception as e:  # any exception is a failed request
                failures.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    fallback = telemetry.counter("sync.full_reload_fallback")
    base = fallback.value()
    try:
        advanced = sync.poll_once()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not failures
    assert advanced == 0  # p2 unusable; the chain holds at p1
    assert fallback.value() == base + 1
    live = srv._models["live"].predictor
    np.testing.assert_array_equal(live._keys, good_keys)
    assert srv.score_lines(body, "live") == want
    assert sync.registry.current_version("live").tag == "p1"
    assert telemetry.gauge("sync.lag_passes").value(model="live") == 1

    # repaired (the staged copy uploaded again), the next poll catches up
    from paddlebox_tpu_torch.utils.fs import LocalFS

    LocalFS().upload(os.path.join(job.workdir, "stage", "delta-p2"),
                     os.path.join(root, "delta-p2"))
    assert sync.poll_once() == 1
    assert sync.registry.current_version("live").tag == "p2"


def test_chain_gap_triggers_full_reload(job, tmp_path):
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    job.train_pass(1)
    pub.publish_delta("p1", job.table, job.model)
    job.train_pass(2)
    pub.publish_delta("p2", job.table, job.model)
    done = os.path.join(root, DONEFILE_NAME)
    with open(done, "rb") as fh:
        entries = parse_donefile(fh.read())
    with open(done, "w") as fh:
        for e in entries:
            if e.tag != "p1":
                fh.write(e.to_json() + "\n")

    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    gaps = telemetry.counter("sync.chain_gap")
    before = gaps.value()
    sync.poll_once()
    assert gaps.value() == before + 1
    assert sync.registry.current_version("live").tag == "p0"
    assert srv.score_lines(_lines(3), "live")


def test_no_loadable_base_keeps_last_good_and_degrades(job, tmp_path):
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    sync.poll_once()
    job.train_pass(1)
    job.publish_base(pub, "p1")
    _corrupt(os.path.join(root, "base-p1", "sparse", "values-00000.npy"))
    _corrupt(os.path.join(root, "base-p0", "sparse", "values-00000.npy"))
    failed = telemetry.counter("sync.reload_failed")
    before = failed.value()
    assert sync.poll_once() == 0
    assert failed.value() == before + 1
    assert sync.registry.current_version("live").tag == "p0"
    assert "sync_chain:live" in srv.degraded_reasons()
    assert srv.score_lines(_lines(2), "live")


def test_injected_sync_faults_absorbed_and_counted(job, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.01")
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    for site in ("sync.poll", "sync.fetch", "sync.apply", "publish.delta",
                 "publish.upload", "publish.donefile", "publish.mkdir"):
        assert site in faults.KNOWN_SITES
    fallback = telemetry.counter("sync.full_reload_fallback")
    base = fallback.value()
    with fault_plan({"sync.poll": "first:1", "sync.apply": "first:1"}):
        assert sync.poll_once() == 1  # converged despite both faults
    assert fallback.value() == base + 1
    assert stats.get("retry.sync.poll.retries") >= 1
    assert sync.registry.current_version("live").base_tag == "p0"


def test_rollback_restores_previous_version(job, tmp_path):
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    sync.poll_once()
    p0_pred = srv._models["live"].predictor
    job.train_pass(1)
    pub.publish_delta("p1", job.table, job.model)
    sync.poll_once()
    assert srv._models["live"].predictor is not p0_pred
    restored = sync.rollback()
    assert restored.tag == "p0"
    assert srv._models["live"].predictor is p0_pred
    assert srv.model_version("live")["tag"] == "p0"
    with pytest.raises(LookupError):
        sync.rollback()


def test_wait_fresh_gates_on_the_first_model(job, tmp_path):
    root = str(tmp_path / "pub")
    srv = ScoringServer(device="cpu")
    sync = _syncer(root, srv, tmp_path)
    assert not sync.wait_fresh(timeout_s=0.2)
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    assert sync.wait_fresh(timeout_s=10.0)
    assert srv.model_names() == ["live"]


# --------------------------------------------------------------------------- #
# the registry and the donefile format
# --------------------------------------------------------------------------- #
def test_parse_donefile_torn_tail_and_corruption():
    good = PublishEntry(seq=0, kind="base", tag="t0", dir="base-t0",
                        base_tag="t0", prev_tag=None, published_at=1.0)
    blob = (good.to_json() + "\n").encode()
    torn = blob + b'{"seq": 1, "kind": "del'
    torn_before = telemetry.counter("sync.torn_donefile").value()
    entries = parse_donefile(torn)
    assert len(entries) == 1 and entries[0].tag == "t0"
    assert telemetry.counter("sync.torn_donefile").value() == \
        torn_before + 1
    with pytest.raises(ValueError):
        parse_donefile(torn, strict=True)
    with pytest.raises(ValueError):
        parse_donefile(b"not json\n" + blob)


def test_registry_history_bounded_and_lineage():
    reg = ModelRegistry(keep_versions=2)
    preds = [object() for _ in range(4)]
    v = ModelVersion(name="m", base_tag="b0", seq=0, published_at=1.0)
    reg.commit("m", v, preds[0])
    for i, e in enumerate([
        PublishEntry(seq=1, kind="delta", tag="d1", dir="x", base_tag="b0",
                     prev_tag="b0", published_at=2.0),
        PublishEntry(seq=2, kind="delta", tag="d2", dir="x", base_tag="b0",
                     prev_tag="d1", published_at=3.0),
        PublishEntry(seq=3, kind="delta", tag="d3", dir="x", base_tag="b0",
                     prev_tag="d2", published_at=4.0,
                     meta={"lineage": "w3"}),
    ]):
        v = v.extend(e)
        reg.commit("m", v, preds[i + 1])
    assert reg.lineage("m")["deltas_applied"] == 3
    assert reg.lineage("m")["lineage"] == "w3"
    assert reg.rollback("m")[0].tag == "d2"
    assert reg.rollback("m")[0].tag == "d1"
    with pytest.raises(LookupError):
        reg.rollback("m")


def test_version_extend_rejects_base():
    v = ModelVersion(name="m", base_tag="b0")
    with pytest.raises(ValueError):
        v.extend(PublishEntry(seq=1, kind="base", tag="b1", dir="x",
                              base_tag="b1", prev_tag="b0",
                              published_at=1.0))


def test_fleet_min_freshness():
    view = {"replicas": [
        {"state": "up", "models": {"live": {"seq": 4, "age_seconds": 2.0}}},
        {"state": "up", "models": {"live": {"seq": 3, "age_seconds": 9.0}}},
        {"state": "ejected", "models": {"live": {"seq": 0,
                                                 "age_seconds": 99.0}}},
    ]}
    assert fleet_min_freshness(view) == {
        "min_seq": 3, "max_age_seconds": 9.0, "n_serving": 2}
    assert fleet_min_freshness({"replicas": []})["min_seq"] is None


# --------------------------------------------------------------------------- #
# the background agent: it never dies silently
# --------------------------------------------------------------------------- #
def _wait_until(cond, timeout_s=10.0, interval_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return cond()


def test_agent_survives_poll_exhaustion_and_marks_degraded(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.001")
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS", "2")
    srv = ScoringServer(device="cpu")
    sync = Syncer(str(tmp_path / "pub"), srv, "live",
                  cache_dir=str(tmp_path / "cache"),
                  poll_interval_s=0.01, degraded_after_failures=2)
    errors = telemetry.counter("sync.poll_errors")
    exhausted_base = errors.value()
    plan_cm = fault_plan({"sync.poll": "first:100000"})
    plan_cm.__enter__()
    try:
        sync.start()
        assert _wait_until(lambda: errors.value() >= exhausted_base + 3)
        assert sync._thread.is_alive()
        assert _wait_until(
            lambda: "sync:live" in srv.degraded_reasons())
    finally:
        plan_cm.__exit__(None, None, None)
    restarts = telemetry.counter("sync.agent_restarts")
    r_base = restarts.value()
    assert _wait_until(
        lambda: "sync:live" not in srv.degraded_reasons(), timeout_s=20)
    assert sync._thread.is_alive()
    assert sync._thread.daemon
    assert restarts.value() == r_base
    sync.stop()
    assert sync._thread is None


def test_agent_outer_guard_restarts_dead_loop(tmp_path, monkeypatch):
    srv = ScoringServer(device="cpu")
    sync = Syncer(str(tmp_path / "pub"), srv, "live",
                  cache_dir=str(tmp_path / "cache"), poll_interval_s=0.01)
    real_loop = sync._agent_loop
    calls = {"n": 0}

    def flaky_loop():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise SystemExit("escaped the inner loop")
        real_loop()

    monkeypatch.setattr(sync, "_agent_loop", flaky_loop)
    restarts = telemetry.counter("sync.agent_restarts")
    base = restarts.value()
    sync.start()
    try:
        assert _wait_until(lambda: restarts.value() >= base + 2)
        assert _wait_until(lambda: calls["n"] >= 3)
        assert sync._thread.is_alive()
    finally:
        sync.stop()
    assert not sync._thread


def test_syncer_lag_marks_degraded(tmp_path):
    srv = ScoringServer(device="cpu")
    sync = Syncer(str(tmp_path / "pub"), srv, "live",
                  cache_dir=str(tmp_path / "cache"),
                  degraded_lag_entries=2)
    entries = [
        PublishEntry(seq=i, kind="delta", tag=f"t{i}", dir=f"d{i}",
                     base_tag="b", prev_tag=f"t{i - 1}", published_at=1.0)
        for i in range(5)
    ]
    sync._update_gauges(entries)  # applied -1: lag 5 > 2
    assert "sync_lag:live" in srv.degraded_reasons()
    sync._applied_seq = 4
    sync._update_gauges(entries)
    assert "sync_lag:live" not in srv.degraded_reasons()


def test_cache_dir_from_the_flag(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_SYNC_CACHE_DIR",
                       str(tmp_path / "flagged"))
    monkeypatch.setenv("PADDLEBOX_TORCH_SYNC_INTERVAL_S", "2.5")
    sync = Syncer(str(tmp_path / "pub"), ScoringServer(device="cpu"), "m")
    assert sync.cache == str(tmp_path / "flagged" / "m")
    assert sync.poll_interval_s == 2.5
    assert str(sync.device) == "cpu"


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #
def test_publish_entry_lines_equal_across_packages():
    kw = dict(seq=3, kind="delta", tag="w3", dir="delta-w3", base_tag="b",
              prev_tag="w2", published_at=1234.5, n_rows=7,
              has_programs=False, embedding_dtype="int8", n_bytes=99,
              meta={"lineage": "w3-4"})
    assert PublishEntry(**kw).to_json() == RefPublishEntry(**kw).to_json()


def test_donefiles_read_across_packages(job, tmp_path):
    """The port reads a donefile the reference wrote, and the reference
    reads the one a port publisher wrote."""
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0", lineage="pass0")
    job.train_pass(1)
    pub.publish_delta("p1", job.table, lineage="w1")
    with open(os.path.join(root, DONEFILE_NAME), "rb") as fh:
        blob = fh.read()
    ours, theirs = parse_donefile(blob), ref_parse_donefile(blob)
    assert [e.to_json() for e in ours] == [e.to_json() for e in theirs]
    assert theirs[1].meta["lineage"] == "w1"

    ref_blob = "".join(
        RefPublishEntry(seq=i, kind="base" if i == 0 else "delta",
                        tag=f"t{i}", dir=f"d{i}", base_tag="t0",
                        prev_tag=None if i == 0 else f"t{i - 1}",
                        published_at=float(i)).to_json() + "\n"
        for i in range(3)).encode()
    ported = parse_donefile(ref_blob)
    assert [e.tag for e in ported] == ["t0", "t1", "t2"]
    assert "".join(e.to_json() + "\n" for e in ported).encode() == ref_blob


def test_reference_lint_is_clean_on_a_port_root(job, tmp_path):
    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0")
    for i in (1, 2):
        job.train_pass(i)
        pub.publish_delta(f"p{i}", job.table, job.model if i == 2 else None)
    errors, warnings = check_publish_root(root)
    assert errors == [] and warnings == []


def _npz_members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp8"])
def test_delta_files_equal_across_packages(tmp_path, dtype):
    """One table state in both packages, the same census trained by
    neither: the published delta's arrays are the reference's bytes.  The
    zip container differs only in its members' write time."""
    rng = np.random.default_rng(7)
    emb = 4
    w = SparseTableConfig(embedding_dim=emb).row_width
    keys = np.unique(rng.integers(1, 2**64 - 1, 300, dtype=np.uint64))
    keys[-1] = np.uint64(2**64 - 1)
    state = {"keys": keys,
             "values": rng.normal(size=(keys.shape[0], w + 1))
             .astype(np.float32)}
    state["values"][:, 0] = np.abs(state["values"][:, 0])
    census = np.unique(np.concatenate([
        keys[rng.choice(keys.shape[0], 120, replace=False)],
        rng.integers(1, 2**64 - 1, 40, dtype=np.uint64)]))

    ref_table = RefTable(RefTableConfig(embedding_dim=emb), seed=5)
    table = SparseTable(SparseTableConfig(embedding_dim=emb), seed=5,
                        device="cpu")
    try:
        for t in (ref_table, table):
            t.load_state_dict(state)
            t.begin_pass(census)
            t.end_pass()
        base = RefPublishEntry(seq=0, kind="base", tag="b0", dir="base-b0",
                               base_tag="b0", prev_tag=None,
                               published_at=1.0, embedding_dtype=dtype)
        dirs = {}
        for name, cls, t in (("ref", RefPublisher, ref_table),
                             ("port", Publisher, table)):
            root = tmp_path / name / "pub"
            root.mkdir(parents=True)
            (root / DONEFILE_NAME).write_text(base.to_json() + "\n")
            pub = cls(str(root), staging_dir=str(tmp_path / name / "stage"),
                      verify=False)
            e = pub.publish_delta("d1", t)
            assert e.n_rows == census.shape[0] and e.embedding_dtype == dtype
            dirs[name] = root / "delta-d1"
    finally:
        table.close()
    ref_m = _npz_members(dirs["ref"] / "sparse_delta.npz")
    port_m = _npz_members(dirs["port"] / "sparse_delta.npz")
    want = {"fp32": {"keys.npy", "values.npy"}}.get(
        dtype, {"keys.npy", "head.npy", "embedx_q.npy", "scales.npy"})
    assert set(ref_m) == set(port_m) == want
    for n in want:
        assert port_m[n] == ref_m[n], n
    metas = []
    for name in ("ref", "port"):
        with open(dirs[name] / "delta.json") as fh:
            m = json.load(fh)
        m.pop("published_at")
        metas.append(m)
    assert metas[0] == metas[1]


# --------------------------------------------------------------------------- #
# python -m paddlebox_tpu_torch.serve --sync-root
# --------------------------------------------------------------------------- #
def test_serve_sync_root_serves_and_follows_the_root(job, tmp_path):
    """The serve command with only a sync root waits for the base, serves
    it, and hot-applies the next delta (GET /models shows its lineage)."""
    import subprocess
    import urllib.request

    root = str(tmp_path / "pub")
    pub = job.publisher(root)
    job.train_pass(0)
    job.publish_base(pub, "p0", lineage="pass0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.serve", "--sync-root",
         root, "--sync-model", "ctr", "--sync-interval", "0.1",
         "--sync-cache", str(tmp_path / "cache"), "--port", "0", "--cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))

    def models():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/models", timeout=30) as r:
            return json.loads(r.read())

    try:
        port, seen = None, []
        t0 = time.time()
        while time.time() - t0 < 120 and port is None:
            line = proc.stdout.readline()
            if not line:
                assert proc.poll() is None, "".join(seen)
                time.sleep(0.2)
                continue
            seen.append(line)
            if "serving on http://" in line:
                port = int(line.split(":")[2].split("/")[0])
        assert port, "".join(seen)
        assert any("syncing 'ctr'" in s for s in seen)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/score/ctr",
                                     data=_lines(3), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert len(json.loads(r.read())["scores"]) == 3
        assert models()["models"]["ctr"]["tag"] == "p0"

        job.train_pass(1)
        pub.publish_delta("p1", job.table, lineage="w1")
        assert _wait_until(lambda: models()["models"]["ctr"]["tag"] == "p1",
                           60.0, 0.1)
        version = models()["models"]["ctr"]
        assert version["deltas_applied"] == 1
        assert version["lineage"] == "w1"
        assert os.path.isdir(tmp_path / "cache" / "ctr" / "delta-p1")
    finally:
        proc.terminate()
        proc.wait(timeout=10)
