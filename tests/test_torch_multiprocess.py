"""The port's multi-process training against one process and against the
JAX package (reference: tests/test_multiprocess.py).

Two ranks of two positions each, launched on the CPU over gloo through the
port's launcher (rank program: tests/_torch_mp_child.py), train the same
global batch stream as the port's one process of four positions, over three
passes in which the hot block realizes and the per-shard caches hit, with
and without the slot LR map: every pass's metrics, both ranks' dense
parameters and the union of the two ranks' stores are bit-equal to the
one-process run.  Both agree with the JAX ``MultiChipTrainer`` on four of
conftest's forced CPU devices at the reference test's tolerances (equal
steps and counts, loss and the dense parameters' absolute sum within rtol
1e-4, AUC within 2e-3, equal feature totals).  The cross-process
collectives equal the in-process ones.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models.ctr_dnn import CtrDnn as RefCtrDnn
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.launch import launch
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    collectives,
    make_mesh,
)
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_mp_child.py")
S, DENSE, B, N_POS, PASSES = 3, 2, 8, 4, 3
LRMAP = ((1, 0.005), (2, 0.5))
METRICS = ("loss", "auc", "count", "steps", "samples", "missing_keys",
           "hot_occurrences", "grad_norm", "weight_norm")


@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    """Three passes over one small vocabulary (keys recur: the caches hit
    from the second begin_pass, the hot block realizes at the third and
    leaves a cold tail), 21 batches of 8 a pass: five full position
    groups and a ragged one."""
    d = tmp_path_factory.mktemp("mp")
    return [write_synth_files(str(d / f"p{p}"), n_files=2, ins_per_file=84,
                              n_sparse_slots=S, vocab_per_slot=200,
                              dense_dim=DENSE, seed=30 + p)
            for p in range(PASSES)]


def _ref_run(pass_files, lrmap):
    """The JAX MultiChipTrainer on four CPU devices, its tower (seed 0) the
    start of the port's runs."""
    mesh = ref_make_mesh(N_POS)
    conf = ref_config.SparseTableConfig(
        embedding_dim=8, placement_update_interval=1,
        slot_learning_rates=lrmap)
    tr = RefMultiChipTrainer(
        RefCtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(32, 16)),
        conf, mesh, ref_config.TrainerConfig(auc_buckets=1 << 10), seed=0)
    tower = [{k: np.array(v) for k, v in layer.items()}
             for layer in tr.dense_state()[0]["tower"]]
    table = RefShardedTable(conf, mesh, seed=5)
    out, auc = [], None
    for files in pass_files:
        ds = RefDataset(ref_synth_config(S, DENSE, B, 16), read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table, auc_state=auc)
        auc = tr.last_metric_state
        table.end_pass()
        ds.close()
        out.append(m)
    params = tr.dense_state()[0]
    abs_sum = float(sum(np.abs(np.asarray(layer[k])).sum()
                        for layer in params["tower"] for k in layer))
    total = table.n_features
    table.close()
    return out, abs_sum, total, tower


def _port_run(pass_files, lrmap, tower):
    """The port's one process of four positions."""
    mesh = make_mesh(N_POS, device="cpu")
    tconf = SparseTableConfig(embedding_dim=8, placement_update_interval=1,
                              slot_learning_rates=lrmap)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(32, 16),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = MultiChipTrainer(model, tconf, mesh,
                          TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(tconf, mesh, seed=5)
    passes, auc = [], None
    for files in pass_files:
        ds = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 16),
                               read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        table.begin_pass(ds.unique_keys())
        hits = int(sum(table.last_shard_hits))
        m = tr.train_from_dataset(ds, table, auc_state=auc)
        auc = tr.last_metric_state
        table.end_pass()
        ds.close()
        passes.append({k: m[k] for k in METRICS}
                      | {"hits": hits,
                         "hot": int(table.hot_resident_keys().shape[0])})
    state = table.state_dict()
    table.close()
    return passes, state, tr.dense_state()[0]


def _launch(tmp_path, args, nproc=2):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    logs = str(tmp_path / "logs")
    rc = launch([CHILD, args[0], str(out), *args[1:]], nproc=nproc,
                positions_per_proc=N_POS // nproc, device="cpu",
                backend="gloo", log_dir=logs, job_timeout_s=240.0)
    if rc != 0:
        text = "\n".join(
            f"--- {f} ---\n" + open(os.path.join(logs, f)).read()[-4000:]
            for f in sorted(os.listdir(logs)))
        pytest.fail(f"launch rc={rc}\n{text}")
    return out


@pytest.mark.parametrize("lrmap", [False, True])
def test_two_ranks_equal_one_process_and_the_reference(tmp_path, pass_files,
                                                       lrmap):
    slot_lr = LRMAP if lrmap else ()
    ref_passes, ref_abs, ref_total, tower = _ref_run(pass_files, slot_lr)
    one, one_state, one_dense = _port_run(pass_files, slot_lr, tower)
    np.savez(tmp_path / "tower.npz",
             **{f"{k}{i}": layer[k] for i, layer in enumerate(tower)
                for k in ("w", "b")})
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"passes": pass_files, "lrmap": slot_lr,
                                "tower": str(tmp_path / "tower.npz")}))
    out = _launch(tmp_path, ["train", str(spec)])
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    # rank 0 printed the merged fleet view of both ranks at each pass end
    log0 = (tmp_path / "logs" / "rank0.log").read_text()
    views = [ln for ln in log0.splitlines()
             if ln.startswith("[fleet pass step=")]
    assert len(views) == PASSES and all("world=2" in v for v in views)
    assert "[fleet" not in (tmp_path / "logs" / "rank1.log").read_text()
    npz = [np.load(out / f"rank{r}.npz") for r in range(2)]
    # bit-equal to the one-process run: every pass's metrics on both ranks
    for r in ranks:
        assert r["n_local"] == 2
        for p, (got, want) in enumerate(zip(r["passes"], one)):
            want = dict(want, hits=got["hits"])  # hits are per process
            assert got == want, (p, got, want)
    # the caches hit on both sides, the hot block realized and routed
    for p in (1, 2):
        assert sum(r["passes"][p]["hits"] for r in ranks) == one[p]["hits"]
        assert all(r["passes"][p]["hits"] > 0 for r in ranks)
    assert one[1]["hot"] == 0 < one[2]["hot"] and one[2]["hot_occurrences"]
    # dense parameters of both ranks
    for z in npz:
        for k, v in one_dense.items():
            np.testing.assert_array_equal(z[f"dense/{k}"], v.numpy())
    # the union of the ranks' stores is the one-process store, and the
    # ranks own disjoint keys
    keys = np.concatenate([z["keys"] for z in npz])
    vals = np.concatenate([z["values"] for z in npz])
    order = np.argsort(keys)
    assert np.unique(keys).shape[0] == keys.shape[0]
    np.testing.assert_array_equal(keys[order], one_state["keys"])
    np.testing.assert_array_equal(vals[order], one_state["values"])
    # against the JAX package at the reference test's tolerances
    abs_sum = float(sum(np.abs(v.numpy()).sum() for v in one_dense.values()))
    for got, want in zip(one, ref_passes):
        assert got["steps"] == want["steps"]
        assert got["count"] == want["count"]
        assert np.isclose(got["loss"], want["loss"], rtol=1e-4), (got, want)
        assert abs(got["auc"] - want["auc"]) < 2e-3, (got["auc"], want["auc"])
    assert np.isclose(abs_sum, ref_abs, rtol=1e-4), (abs_sum, ref_abs)
    assert keys.shape[0] == ref_total


def test_cross_process_collectives_equal_in_process(tmp_path):
    seed = 11
    out = _launch(tmp_path, ["collectives", str(seed)])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4, 4, 3, 5)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((4, 7)).astype(np.float32))
    z = torch.from_numpy(rng.integers(-9, 9, (4, 6)).astype(np.int64))
    want = {
        "all_to_all": collectives.all_to_all(x),
        "all_gather": collectives.all_gather(y),
        "psum": collectives.psum(y),
        "pmax": collectives.pmax(y),
        "psum_int": collectives.psum(z),
        "psum_many_1": collectives.psum(2 * y)[0],
    }
    got = [np.load(out / f"rank{r}.npz") for r in range(2)]
    for k, w in want.items():
        w = w.numpy()
        if k == "psum_many_1":
            for g in got:
                np.testing.assert_array_equal(g[k], w)
            continue
        # each rank holds its own two positions' results
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got]), w, err_msg=k)


@pytest.mark.parametrize("mask", [False, True])
def test_segment_sum_drops_the_spread_sink_bit_for_bit(mask):
    """The step's segment sums spread their dropped sink (padding and
    routed-away occurrences) over dropped rows: every kept segment's sum
    equals the plain segment sum's bit for bit."""
    from paddlebox_tpu_torch.sparse.table import (
        SINK_SPREAD,
        _segment_sum,
        segment_sum_before_sink,
    )

    rng = np.random.default_rng(3)
    n, k = 50, 3 * SINK_SPREAD + 7
    seg = rng.integers(0, n + 1, k)
    seg[rng.random(k) < 0.7] = n  # most entries fall into the sink
    seg = torch.from_numpy(seg.astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((k, 6)).astype(np.float32))
    dropped = None
    if mask:  # the serve fold's form: dropped entries by mask
        dropped = seg == n
        seg = torch.where(dropped, torch.zeros_like(seg), seg)
    got = segment_sum_before_sink(x, seg, n, dropped=dropped)
    keep = ~(dropped if mask else seg == n)
    want = _segment_sum(x[keep], seg[keep], n + 1)[:n]
    assert torch.equal(got, want)
