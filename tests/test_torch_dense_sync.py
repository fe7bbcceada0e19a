"""The multi-chip trainer's "kstep" and "async" dense-sync modes and the
async dense table against the JAX package: ``AsyncDenseTable`` bit-equal to
the reference's on the same gradients, its thread's failures surfacing and
its retirement; "kstep" learning (port of
tests/test_multichip.py::test_kstep_sync_runs_and_learns), its copies equal
after a sync with Adam's step counts untouched, and its pass losses against
the reference's kstep run from the reference's per-position initial weights
(carried across by ``weights.params_from_jax_stacked``); "async" learning
(port of tests/test_async_dense.py::TestAsyncTrainingMode) and its losses
against the reference's where the pulls fall only at pass ends, which makes
both runs deterministic.
"""

import gc

import jax
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
from paddlebox_tpu.parallel.async_dense import AsyncDenseTable as RefAsyncTable
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.parallel.async_dense import AsyncDenseTable
from paddlebox_tpu_torch.weights import params_from_jax_stacked
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

N_DEV = 8
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


def _params():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": np.zeros(3, dtype=np.float32)}


# --------------------------------------------------------------------------- #
# the async dense table (port of tests/test_async_dense.py)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.1), ("adam", 0.01)])
def test_table_matches_reference(optimizer, lr):
    """The same gradients through the port's table and the reference's:
    the master parameters bit-equal after every drain."""
    p0 = _params()
    port = AsyncDenseTable(p0, optimizer=optimizer, lr=lr)
    ref = RefAsyncTable(p0, optimizer=optimizer, lr=lr)
    rng = np.random.default_rng(1)
    for _ in range(3):
        for _ in range(4):
            g = {"w": rng.normal(size=(4, 3)).astype(np.float32),
                 "b": rng.normal(size=3).astype(np.float32)}
            port.push(g)
            ref.push(g)
        port.drain()
        ref.drain()
        got, want = port.pull(), ref.pull()
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert port.pushes == port.applied == 12
    port.stop()
    ref.stop()


def test_sgd_matches_serial():
    p0 = _params()
    table = AsyncDenseTable(p0, optimizer="sgd", lr=0.1)
    for g in (1.0, -0.5, 0.25):
        table.push({"w": np.full((4, 3), g, np.float32),
                    "b": np.full(3, g, np.float32)})
    table.drain()
    got = table.pull()
    table.stop()
    np.testing.assert_allclose(got["w"], p0["w"] - 0.1 * (1.0 - 0.5 + 0.25),
                               rtol=1e-6)


def test_pull_is_snapshot():
    table = AsyncDenseTable(_params(), optimizer="sgd", lr=1.0)
    snap = table.pull()
    table.push({"w": np.ones((4, 3), np.float32), "b": np.ones(3, np.float32)})
    table.drain()
    after = table.pull()
    table.stop()
    assert not np.allclose(snap["w"], after["w"])


def test_error_surfaces_on_push():
    table = AsyncDenseTable(_params(), optimizer="sgd", lr=1.0)
    # a wrong leaf count kills the update thread; the next call raises
    table.push([np.ones(3, np.float32)] * 5)
    table._thread.join(timeout=5.0)
    assert not table._thread.is_alive()
    with pytest.raises(RuntimeError, match="died"):
        table.push({"w": np.ones((4, 3), np.float32),
                    "b": np.ones(3, np.float32)})
    with pytest.raises(RuntimeError, match="died"):
        table.pull()


def test_drain_and_stop_raise_when_thread_dead():
    """A dead update thread with gradients still queued turns drain() into
    a RuntimeError, not a hang at the pass boundary."""
    table = AsyncDenseTable(_params(), optimizer="sgd", lr=1.0, queue_depth=4)
    good = {"w": np.ones((4, 3), np.float32), "b": np.ones(3, np.float32)}
    table.push([np.ones(3, np.float32)] * 5)  # kills the thread
    try:
        table.push(good)  # may or may not land before the death
    except RuntimeError:
        pass
    table._thread.join(timeout=5.0)
    assert not table._thread.is_alive()
    with pytest.raises(RuntimeError):
        table.drain()
    with pytest.raises(RuntimeError):
        table.stop()


def test_threads_retire_on_stop_and_when_collected():
    table = AsyncDenseTable(_params(), optimizer="adam", lr=0.01)
    table.push({"w": np.ones((4, 3), np.float32), "b": np.ones(3, np.float32)})
    table.drain()
    master = table._thread
    table.stop()
    assert not master.is_alive()
    # a table nobody stopped retires its thread once it is collected
    table = AsyncDenseTable(_params(), optimizer="adam", lr=0.01)
    master = table._thread
    del table
    gc.collect()
    master.join(5.0)
    assert not master.is_alive()


# --------------------------------------------------------------------------- #
# the trainer's modes, against the reference
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's kstep data (tests/test_multichip.py:_make_data, 512
    instances, batch 16) in both packages; numpy planners on both sides."""
    files = write_synth_files(
        str(tmp_path_factory.mktemp("ds")), n_files=2, ins_per_file=256,
        n_sparse_slots=3, vocab_per_slot=50, dense_dim=2, seed=7)
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        mp.delenv("PBOX_HBM_CACHE", raising=False)
        ds = PadBoxSlotDataset(make_synth_config(3, 2, 16, 16), read_threads=2)
        rds = RefDataset(ref_synth_config(3, 2, 16, 16), read_threads=2)
        for d in (ds, rds):
            d.set_filelist(files)
            d.load_into_memory()
        yield {"ds": ds, "ref_ds": rds, "runs": {}}
    ds.close()
    rds.close()


TCONF = dict(embedding_dim=8, learning_rate=0.5, initial_range=0.05)


def _ref_run(world, mode, sws, passes=4):
    key = ("ref", mode, sws)
    if key not in world["runs"]:
        tconf = ref_config.SparseTableConfig(**TCONF)
        mesh = ref_make_mesh(N_DEV)
        tr = RefMultiChipTrainer(
            RefCtrDnn(3, tconf.row_width, dense_dim=2, hidden=(32, 16)),
            tconf, mesh, ref_config.TrainerConfig(
                sync_dense_mode=mode, sync_weight_step=sws, dense_lr=3e-3,
                auc_buckets=1 << 12), seed=0)
        stacked = jax.tree.map(np.asarray, tr.params)["tower"]
        table = RefShardedTable(tconf, mesh, seed=0)
        results = []
        for _ in range(passes):
            table.begin_pass(world["ref_ds"].unique_keys())
            results.append(tr.train_from_dataset(world["ref_ds"], table))
            table.end_pass()
        tr.close()
        table.close()
        world["runs"][key] = (stacked, results)
    return world["runs"][key]


def _port_run(world, mode, sws, tower_stacked, passes=4):
    tconf = SparseTableConfig(**TCONF)
    mesh = make_mesh(N_DEV, device="cpu")
    tr = MultiChipTrainer(
        CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(32, 16), device="cpu"),
        tconf, mesh, TrainerConfig(sync_dense_mode=mode, sync_weight_step=sws,
                                   dense_lr=3e-3, auc_buckets=1 << 12))
    tr.load_dense_state(params_from_jax_stacked(tower_stacked))
    table = ShardedSparseTable(tconf, mesh, seed=0)
    results = []
    for _ in range(passes):
        table.begin_pass(world["ds"].unique_keys())
        results.append(tr.train_from_dataset(world["ds"], table))
        table.end_pass()
    table.close()
    return tr, results


def test_kstep_runs_learns_and_matches_reference(world):
    """sync_weight_step=4 over 4 passes of 4 step groups on 8 positions:
    the loss falls, AUC passes 0.6, the copies are equal after the last
    sync (it falls on the last step), Adam's step counts stay untouched by
    the averaging; and every pass's loss agrees with the reference's kstep
    run from the same per-position weights within 1e-6 (float32 reordering
    over 16 Adam steps; measured 8.4e-8), its AUC within 1e-4 (a
    prediction that crosses a histogram bucket edge moves it by about
    1 / (positives x negatives), 1.5e-5 here; measured 8.1e-6)."""
    stacked, ref = _ref_run(world, "kstep", 4)
    tr, res = _port_run(world, "kstep", 4, stacked)
    assert len(tr.models) == N_DEV
    assert res[-1]["loss"] < res[0]["loss"]
    assert res[-1]["auc"] > 0.6
    for p0, p in zip(tr.models[0].parameters(), tr.models[-1].parameters()):
        np.testing.assert_array_equal(p0.detach().numpy(), p.detach().numpy())
    steps = sum(r["steps"] for r in res)
    for opt in tr.optimizers:
        for st in opt.state.values():
            assert float(st["step"]) == steps
    for a, b in zip(res, ref):
        assert a["steps"] == b["steps"] and a["count"] == b["count"]
        assert abs(a["loss"] - b["loss"]) < 1e-6, (a["loss"], b["loss"])
        assert abs(a["auc"] - b["auc"]) < 1e-4, (a["auc"], b["auc"])
    # dense_state is position 0's copy
    p, _ = tr.dense_state()
    np.testing.assert_array_equal(p["tower.0.weight"].numpy(),
                                  tr.models[0].tower[0].weight.detach().numpy())


def test_kstep_copies_drift_between_syncs(world):
    """With no sync inside the pass the copies train apart; the average
    then makes them equal again."""
    stacked, _ = _ref_run(world, "kstep", 4)
    tr, _ = _port_run(world, "kstep", 1000, stacked, passes=1)
    w = [m.tower[0].weight.detach().clone() for m in tr.models]
    assert not torch.equal(w[0], w[1])
    tr._average_copies()
    want = sum(w[1:], w[0]) / N_DEV
    for m in tr.models:
        torch.testing.assert_close(m.tower[0].weight.detach(), want,
                                   rtol=1e-6, atol=1e-7)


def test_async_matches_reference(world):
    """"async" with the pulls only at pass ends (sync_weight_step above the
    pass length): deterministic on both sides, so every pass's loss agrees
    with the reference's within 1e-6 (measured 6e-8) and its AUC within
    1e-4 (as in the kstep test; measured equal), and close() retires the
    table's thread."""
    stacked, ref = _ref_run(world, "async", 1000)
    tr, res = _port_run(world, "async", 1000, stacked)
    assert tr.async_dense is not None
    assert tr.async_dense.pushes == tr.async_dense.applied == sum(
        r["steps"] for r in res)
    for a, b in zip(res, ref):
        assert abs(a["loss"] - b["loss"]) < 1e-6, (a["loss"], b["loss"])
        assert abs(a["auc"] - b["auc"]) < 1e-4, (a["auc"], b["auc"])
    thread = tr.async_dense._thread
    tr.close()
    assert tr.async_dense is None and not thread.is_alive()


def test_async_pulls_every_sync_weight_step(world):
    """With sync_weight_step=2 the device parameters refresh inside the
    pass too (staleness bounded by the queue and the pull interval), and
    the run still learns."""
    stacked, _ = _ref_run(world, "kstep", 4)
    tr, res = _port_run(world, "async", 2, stacked, passes=3)
    assert all(np.isfinite(r["loss"]) for r in res)
    assert res[-1]["loss"] < res[0]["loss"]
    tr.close()
