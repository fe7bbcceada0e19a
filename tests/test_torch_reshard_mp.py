"""The port's live reshard ACROSS PROCESSES (parallel/sharded_table.py,
the rows that change owner process crossing on a ``reshard-<k>``
KvChannel) against the port's one-process reshard, which is held against
the JAX package's single-process reshard (the reference's tests run the
reshard in one process only), so the chain reaches the reference.

Two ranks of two positions, launched on the CPU over gloo through the
port's launcher (rank program: tests/_torch_mp_child.py ``reshard``), train
a pass on 4 positions, reshard live 4 -> 2, train a pass on 2 (one a
rank), reshard 2 -> 4 and train a third pass:

  * every pass's metrics (fresh streams after each reshard: they are
    stacked by position) and the rows moved (summed over the ranks), both
    ranks' dense parameters and the union of the ranks' stores are
    bit-equal to the one-process run of the same schedule, and the ranks
    own disjoint keys;
  * the one-process run agrees with the JAX package's at
    test_torch_multiprocess.py's tolerances (equal steps, counts and rows
    moved; loss within rtol 1e-4, AUC within 2e-3; equal feature totals);
  * a migrate or a cutover fault on rank 0 aborts the reshard on BOTH
    ranks at once (well inside the channel's timeout) with the old map and
    store whole, and the retry then trains exactly as the run without the
    fault.
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
    make_mesh,
)
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_mp_child.py")
S, DENSE, B = 3, 2, 8
SCHEDULE = (4, 2, 4)
# the channel's bound in the launched jobs: a fault must abort well inside it
HOSTPLANE_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rsmp")
    return [write_synth_files(str(d / f"p{p}"), n_files=2, ins_per_file=64,
                              n_sparse_slots=S, vocab_per_slot=200,
                              dense_dim=DENSE, seed=40 + p)
            for p in range(len(SCHEDULE))]


@pytest.fixture(scope="module")
def reference(pass_files):
    """The JAX package's single-process live reshard over the schedule, a
    fresh seed-0 trainer a mesh continuing the dense state; its tower is
    the start of the port's runs."""
    conf = ref_config.SparseTableConfig(embedding_dim=8,
                                        placement_update_interval=1)
    tconf = ref_config.TrainerConfig(auc_buckets=1 << 10)

    def trainer(mesh):
        return RefMultiChipTrainer(
            RefCtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(32, 16)),
            conf, mesh, tconf, seed=0)

    mesh = ref_make_mesh(SCHEDULE[0])
    tr = trainer(mesh)
    tower = [{k: np.array(v) for k, v in layer.items()}
             for layer in tr.dense_state()[0]["tower"]]
    table = RefShardedTable(conf, mesh, seed=5)
    out, auc = [], None
    for files, n in zip(pass_files, SCHEDULE):
        moved = 0
        if n != table.n_shards:
            mesh = ref_make_mesh(n)
            moved = table.reshard(mesh)
            params, opt = tr.dense_state()
            tr = trainer(mesh)
            tr.load_dense_state(params, opt)
            auc = None  # the metric streams are stacked by position
        ds = RefDataset(ref_synth_config(S, DENSE, B, 16), read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table, auc_state=auc)
        auc = tr.last_metric_state
        table.end_pass()
        ds.close()
        out.append(dict(m, moved=moved))
    total = table.n_features
    table.close()
    return {"passes": out, "total": total, "tower": tower}


def _tower_npz(tmp_path, tower) -> str:
    path = str(tmp_path / "tower.npz")
    np.savez(path, **{f"{k}{i}": layer[k] for i, layer in enumerate(tower)
                      for k in ("w", "b")})
    return path


def _one_process(pass_files, tower):
    """The port's one process over the same schedule."""
    tconf = SparseTableConfig(embedding_dim=8, placement_update_interval=1)

    def trainer(mesh):
        model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(32, 16),
                       device="cpu")
        model.load_state_dict(params_from_jax(tower))
        return MultiChipTrainer(model, tconf, mesh,
                                TrainerConfig(auc_buckets=1 << 10))

    mesh = make_mesh(SCHEDULE[0], device="cpu")
    tr = trainer(mesh)
    table = ShardedSparseTable(tconf, mesh, seed=5)
    out, auc = [], None
    for files, n in zip(pass_files, SCHEDULE):
        moved = 0
        if n != table.n_shards:
            mesh = make_mesh(n, device="cpu")
            moved = table.reshard(mesh)
            dense = tr.dense_state()
            tr = trainer(mesh)
            tr.load_dense_state(*dense)
            auc = None  # the metric streams are stacked by position
        ds = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 16),
                               read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table, auc_state=auc)
        auc = tr.last_metric_state
        table.end_pass()
        ds.close()
        out.append({k: m[k] for k in ("loss", "auc", "count", "steps")}
                   | {"moved": moved})
    state = table.state_dict()
    table.close()
    return out, state, {k: v.numpy() for k, v in tr.dense_state()[0].items()}


@pytest.fixture(scope="module")
def one_process(pass_files, reference):
    return _one_process(pass_files, reference["tower"])


def _launch(tmp_path, spec):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    logs = str(tmp_path / "logs")
    env = dict(os.environ,
               PADDLEBOX_TORCH_HOSTPLANE_TIMEOUT_S=str(HOSTPLANE_TIMEOUT_S))
    rc = launch([CHILD, "reshard", str(out), str(spec_path)], nproc=2,
                positions_per_proc=2, device="cpu", backend="gloo",
                log_dir=logs, job_timeout_s=240.0, env=env)
    if rc != 0:
        text = "\n".join(
            f"--- {f} ---\n" + open(os.path.join(logs, f)).read()[-4000:]
            for f in sorted(os.listdir(logs)))
        pytest.fail(f"launch rc={rc}\n{text}")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    npz = [np.load(out / f"rank{r}.npz") for r in range(2)]
    return ranks, npz


def _assert_equals_one_process(ranks, npz, one_process):
    one, state, dense = one_process
    for p, want in enumerate(one):
        for r in ranks:
            got = r["passes"][p]
            assert {k: got[k] for k in ("loss", "auc", "count", "steps")} \
                == {k: want[k] for k in ("loss", "auc", "count", "steps")}, p
            assert got["n_local"] == SCHEDULE[p] // 2
        # each rank counts the rows that left its own store
        assert sum(r["passes"][p]["moved"] for r in ranks) == want["moved"]
    for z in npz:
        for k, v in dense.items():
            np.testing.assert_array_equal(z[f"dense/{k}"], v, err_msg=k)
    keys = np.concatenate([z["keys"] for z in npz])
    vals = np.concatenate([z["values"] for z in npz])
    order = np.argsort(keys)
    assert np.unique(keys).shape[0] == keys.shape[0]
    assert all(z["keys"].shape[0] for z in npz)
    np.testing.assert_array_equal(keys[order], state["keys"])
    np.testing.assert_array_equal(vals[order], state["values"])


def test_one_process_reshard_holds_against_the_reference(one_process,
                                                         reference):
    one, state, _ = one_process
    assert [p["moved"] for p in one] == [p["moved"]
                                         for p in reference["passes"]]
    assert one[1]["moved"] > 0 and one[2]["moved"] > 0
    for got, want in zip(one, reference["passes"]):
        assert got["steps"] == want["steps"]
        assert got["count"] == want["count"]
        assert np.isclose(got["loss"], want["loss"], rtol=1e-4), (got, want)
        assert abs(got["auc"] - want["auc"]) < 2e-3, (got, want)
    assert state["keys"].shape[0] == reference["total"]


def test_two_ranks_reshard_live_bit_equal_to_one_process(
        tmp_path, pass_files, reference, one_process):
    spec = {"passes": pass_files, "schedule": list(SCHEDULE),
            "tower": _tower_npz(tmp_path, reference["tower"])}
    ranks, npz = _launch(tmp_path, spec)
    assert all(r["fault"] is None for r in ranks)
    _assert_equals_one_process(ranks, npz, one_process)


@pytest.mark.parametrize("site", ["reshard.migrate", "reshard.cutover"])
def test_fault_on_one_rank_restores_the_old_map_on_both(
        tmp_path, pass_files, reference, one_process, site):
    spec = {"passes": pass_files, "schedule": list(SCHEDULE),
            "tower": _tower_npz(tmp_path, reference["tower"]),
            "fault": [0, site]}
    ranks, npz = _launch(tmp_path, spec)
    f0, f1 = ranks[0]["fault"], ranks[1]["fault"]
    assert f0["error"].startswith("FaultInjected"), f0
    assert f1["error"].startswith("RuntimeError"), f1
    assert "process(es) [0]" in f1["error"] and site.split(".")[1] in \
        f1["error"]
    for f in (f0, f1):
        assert f["old_map"] and f["store_whole"], f
        # the peer learned of the fault on the channel, not by timeout
        assert f["seconds"] < HOSTPLANE_TIMEOUT_S / 4, f
    # the retry commits and the run is the run without the fault
    _assert_equals_one_process(ranks, npz, one_process)
