"""The port's step policies against the JAX package: nan_policy
"skip_batch" (single steps and under step grouping), "rollback" with and
without a checkpointer, ``evaluate`` (no updates), ``dense_optimizer``
"sgd" on both trainers, and the ``grad_norm`` / ``weight_norm`` pass
metrics of both trainers (ports of tests/test_fault_tolerance.py
TestNanPolicy and tests/test_capability_tail.py::test_evaluate_no_updates).

Both packages read the same files (numpy planner and Python parser on
both sides) and start from the reference's tower, carried across by
``weights.params_from_jax``.  Float tolerances are those of
test_torch_trainer.py: the two CPU backends sum in other orders (~1e-7 a
step), so losses, norms and rows agree to rtol 1e-5 (rows also atol 1e-6)
and the AUC to 1e-4; show/clk counters and keys are exact.  Within the
port on the CPU the runs are deterministic, so the policies' own claims
(a skipped batch leaves the state of a run without it) are held bit for
bit.
"""

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu.utils import faults as ref_faults
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import AutoCheckpointer, Trainer
from paddlebox_tpu_torch.train.trainer import NonFiniteBatchError, PassRolledBack
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax, params_from_jax_stacked
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, B, EMB, HIDDEN = 3, 2, 16, 4, (16, 8)
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")
TKW = dict(embedding_dim=EMB, learning_rate=0.1, hbm_cache_rows=0,
           overlap_pass_boundary=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """128 instances (8 batches of 16) loaded into both packages, and the
    reference's seed-0 tower."""
    files = write_synth_files(
        str(tmp_path_factory.mktemp("pol")), n_files=2, ins_per_file=64,
        n_sparse_slots=S, vocab_per_slot=60, dense_dim=DENSE, seed=9,
    )
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        port = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 8),
                                 read_threads=1)
        ref = RefDataset(ref_synth_config(S, DENSE, B, 8), read_threads=1)
        for ds in (port, ref):
            ds.set_filelist(files)
            ds.load_into_memory()
        conf = ref_config.SparseTableConfig(**TKW)
        tr = RefTrainer(RefCtrDnn(S, conf.row_width, dense_dim=DENSE,
                                  hidden=HIDDEN), conf,
                        ref_config.TrainerConfig(), seed=0)
        tower = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in tr.params["tower"]]
        yield {"port": port, "ref": ref, "tower": tower, "mp": mp}
    port.close()
    ref.close()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def _port_world(world, table_kw=None, **trkw):
    tconf = SparseTableConfig(**{**TKW, **(table_kw or {})})
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   device="cpu")
    model.load_state_dict(params_from_jax(world["tower"]))
    trconf = TrainerConfig(auc_buckets=1 << 10, dense_lr=1e-2, **trkw)
    return (SparseTable(tconf, seed=3, device="cpu"),
            Trainer(model, tconf, trconf, device="cpu"))


def _ref_world(world, table_kw=None, **trkw):
    conf = ref_config.SparseTableConfig(**{**TKW, **(table_kw or {})})
    trconf = ref_config.TrainerConfig(auc_buckets=1 << 10, dense_lr=1e-2,
                                      **trkw)
    return (RefTable(conf, seed=3),
            RefTrainer(RefCtrDnn(S, conf.row_width, dense_dim=DENSE,
                                 hidden=HIDDEN), conf, trconf, seed=0))


def _pass(ds, table, trainer, auc_state=None):
    table.begin_pass(ds.unique_keys())
    m = trainer.train_from_dataset(ds, table, auc_state=auc_state)
    table.end_pass()
    return m


def _agree(port_m, ref_m, port_state, ref_state):
    assert port_m["steps"] == ref_m["steps"]
    assert port_m["count"] == ref_m["count"]
    np.testing.assert_allclose(port_m["loss"], ref_m["loss"], rtol=1e-5)
    assert abs(port_m["auc"] - ref_m["auc"]) < 1e-4
    np.testing.assert_array_equal(port_state["keys"], ref_state["keys"])
    np.testing.assert_array_equal(port_state["values"][:, :2],
                                  ref_state["values"][:, :2])
    np.testing.assert_allclose(port_state["values"], ref_state["values"],
                               rtol=1e-5, atol=1e-6)


def _assert_equal_state(a, b):
    np.testing.assert_array_equal(a["keys"], b["keys"])
    np.testing.assert_array_equal(a["values"], b["values"])


# --------------------------------------------------------------------------- #
# skip_batch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scan_steps", [1, 2])
def test_skip_batch_matches_reference(world, scan_steps):
    """The second batch poisoned (train.nan, at:1) under skip_batch, one
    step at a time and in groups of 2: the pass has one step and one
    batch's instances fewer, both packages agree, and the port counts the
    skipped step and instances."""
    steps0 = stats.get("train.nan_skipped_steps")
    ins0 = stats.get("train.nan_skipped_ins")
    table, tr = _port_world(world, nan_policy="skip_batch",
                            scan_steps=scan_steps)
    rtable, rtr = _ref_world(world, nan_policy="skip_batch",
                             scan_steps=scan_steps)
    tr.model.load_state_dict(params_from_jax(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in rtr.params["tower"]]))
    with faults.fault_plan({"train.nan": "at:1"}):
        m = _pass(world["port"], table, tr)
    with ref_faults.fault_plan({"train.nan": "at:1"}):
        rm = _pass(world["ref"], rtable, rtr)
    assert m["steps"] == 128 // B - 1 and tr.global_step == m["steps"]
    assert m["count"] == 128 - B
    assert stats.get("train.nan_skipped_steps") - steps0 == 1
    assert stats.get("train.nan_skipped_ins") - ins0 == B
    assert np.isfinite(m["loss"])
    _agree(m, rm, table.state_dict(), rtable.state_dict())


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_skip_batch_leaves_the_state_of_a_run_without_it(world, scan_steps):
    """Within the port, bit for bit: a pass whose third batch is poisoned
    under skip_batch leaves the table, the tower, the Adam state, the AUC
    stream and the loss of the same pass fed without that batch."""
    ds = world["port"]
    batches = list(ds.batches())
    table_a, tr_a = _port_world(world, nan_policy="skip_batch",
                                scan_steps=scan_steps)
    table_a.begin_pass(ds.unique_keys())
    with faults.fault_plan({"train.nan": "at:2"}):
        ma = tr_a.train_steps(table_a, batches)
    table_a.end_pass()
    table_b, tr_b = _port_world(world, scan_steps=scan_steps)
    table_b.begin_pass(ds.unique_keys())
    mb = tr_b.train_steps(table_b, batches[:2] + batches[3:])
    table_b.end_pass()
    _assert_equal_state(table_a.state_dict(), table_b.state_dict())
    for key in ("loss", "auc", "count", "steps", "grad_norm", "weight_norm"):
        assert ma[key] == mb[key], key
    for (k, a), (_, b) in zip(tr_a.model.state_dict().items(),
                              tr_b.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = (t.optimizer.state_dict()["state"] for t in (tr_a, tr_b))
    for i in sb:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)


def test_skip_batch_is_deterministic(world):
    runs = []
    for _ in range(2):
        table, tr = _port_world(world, nan_policy="skip_batch")
        with faults.fault_plan({"train.nan": "at:1"}):
            runs.append((_pass(world["port"], table, tr), table.state_dict()))
    assert runs[0][0]["auc"] == runs[1][0]["auc"]
    assert runs[0][0]["loss"] == runs[1][0]["loss"]
    _assert_equal_state(runs[0][1], runs[1][1])


def test_raise_policy_leaves_the_poisoned_step_unapplied(world):
    """check_nan_inf under "raise": the first batch poisoned raises, and
    the port applies nothing of it (the reference applies the poisoned
    step before its host reads the flag): the table and the tower are
    those of before the pass."""
    table, tr = _port_world(world, check_nan_inf=True)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    table.begin_pass(world["port"].unique_keys())
    rows_before = table.pass_state_dict()
    with faults.fault_plan({"train.nan": "first:1"}):
        with pytest.raises(FloatingPointError):
            tr.train_from_dataset(world["port"], table)
    _assert_equal_state(table.pass_state_dict(), rows_before)
    table.end_pass()
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tr.global_step == 0


# --------------------------------------------------------------------------- #
# rollback
# --------------------------------------------------------------------------- #
def test_rollback_restores_last_completed_pass(world, tmp_path):
    """Port of TestNanPolicy.test_rollback_restores_last_completed_pass:
    pass 1 hits a poisoned batch, the table and dense state return to pass
    0's checkpoint (PassRolledBack, the pass aborted), and the clean re-run
    of pass 1 reproduces the uninterrupted run bit for bit."""
    ds = world["port"]
    table0, tr0 = _port_world(world)
    _pass(ds, table0, tr0)
    ref = _pass(ds, table0, tr0)
    ref_state = table0.state_dict()

    rb0 = stats.get("train.nan_rollback")
    table, tr = _port_world(world, nan_policy="rollback")
    acp = AutoCheckpointer(str(tmp_path / "acp_rb"), job_id="rb")
    tr.checkpointer = acp
    _pass(ds, table, tr)
    acp.after_pass(0, table, tr)
    step_after_p0 = tr.global_step
    state_after_p0 = table.state_dict()
    table.begin_pass(ds.unique_keys())
    with faults.fault_plan({"train.nan": "first:1"}):
        with pytest.raises(PassRolledBack) as exc:
            tr.train_from_dataset(ds, table)
    assert exc.value.status["next_pass"] == 1
    assert not table._in_pass  # aborted: no end_pass
    assert tr.global_step == step_after_p0
    assert stats.get("train.nan_rollback") - rb0 == 1
    _assert_equal_state(table.state_dict(), state_after_p0)

    got = _pass(ds, table, tr)
    assert got["loss"] == ref["loss"] and got["auc"] == ref["auc"]
    _assert_equal_state(table.state_dict(), ref_state)


@pytest.mark.parametrize("completed_pass", [False, True])
def test_rollback_without_a_checkpoint_raises(world, tmp_path, completed_pass):
    """Without a checkpointer, or with one that recorded no pass, rollback
    raises the NonFiniteBatchError, as the reference does."""
    ds = world["port"]
    table, tr = _port_world(world, nan_policy="rollback")
    if completed_pass:
        tr.checkpointer = AutoCheckpointer(str(tmp_path / "empty"),
                                           job_id="none")
    table.begin_pass(ds.unique_keys())
    with faults.fault_plan({"train.nan": "first:1"}):
        with pytest.raises(NonFiniteBatchError):
            tr.train_from_dataset(ds, table)
    table.end_pass()


# --------------------------------------------------------------------------- #
# evaluate
# --------------------------------------------------------------------------- #
def test_evaluate_no_updates_single_chip(world):
    """Port of test_capability_tail.py::test_evaluate_no_updates: after two
    passes, evaluate changes no table row and no parameter, counts every
    instance, and its AUC equals the reference's evaluate of the same
    trained world."""
    ds, rds = world["port"], world["ref"]
    table, tr = _port_world(world)
    rtable, rtr = _ref_world(world)
    for _ in range(2):
        _pass(ds, table, tr)
        _pass(rds, rtable, rtr)
    store = table.state_dict()
    params = {k: v.clone() for k, v in tr.model.state_dict().items()}
    table.begin_pass(ds.unique_keys())
    m = tr.evaluate(ds, table)
    table.end_pass()
    rtable.begin_pass(rds.unique_keys())
    rm = rtr.evaluate(rds, rtable)
    rtable.end_pass()
    assert m["count"] == rm["count"] == 128
    assert abs(m["auc"] - rm["auc"]) < 1e-4
    _assert_equal_state(table.state_dict(), store)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    with pytest.raises(RuntimeError, match="begin_pass"):
        tr.evaluate(ds, table)


def _sharded_worlds(world, n=2, **trkw):
    conf = ref_config.SparseTableConfig(**TKW)
    rmesh = ref_make_mesh(n)
    rtr = RefMultiChipTrainer(
        RefCtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=HIDDEN), conf,
        rmesh, ref_config.TrainerConfig(auc_buckets=1 << 10, dense_lr=1e-2,
                                        **trkw), seed=0)
    rtable = RefShardedTable(conf, rmesh, seed=3, bucket_slack=8.0)
    tconf = SparseTableConfig(**TKW)
    mesh = make_mesh(n, device="cpu")
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   device="cpu")
    tr = MultiChipTrainer(model, tconf, mesh,
                          TrainerConfig(auc_buckets=1 << 10, dense_lr=1e-2,
                                        **trkw))
    tr.load_dense_state(params_from_jax_stacked(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in rtr.params["tower"]]))
    table = ShardedSparseTable(tconf, mesh, seed=3, bucket_slack=8.0)
    return table, tr, rtable, rtr


def test_evaluate_no_updates_multichip(world):
    ds, rds = world["port"], world["ref"]
    table, tr, rtable, rtr = _sharded_worlds(world)
    _pass(ds, table, tr)
    _pass(rds, rtable, rtr)
    store = table.state_dict()
    params = {k: v.clone() for k, v in tr.model.state_dict().items()}
    table.begin_pass(ds.unique_keys())
    m = tr.evaluate(ds, table)
    table.end_pass()
    rtable.begin_pass(rds.unique_keys())
    rm = rtr.evaluate(rds, rtable)
    rtable.end_pass()
    assert m["count"] == rm["count"] == 128
    assert abs(m["auc"] - rm["auc"]) < 1e-4
    _assert_equal_state(table.state_dict(), store)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    table.close()


# --------------------------------------------------------------------------- #
# SGD, and the grad-norm / weight-norm metrics
# --------------------------------------------------------------------------- #
def _norms_agree(m, rm):
    np.testing.assert_allclose(m["grad_norm"], rm["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(m["weight_norm"], rm["weight_norm"],
                               rtol=1e-5)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_single_chip_optimizer_and_norms_match_reference(world, optimizer):
    """Two passes, the second continuing the metric state (the grad-norm
    stream is read as a delta per pass): losses, AUC, rows and both norms
    agree with the reference, for Adam and for SGD."""
    ds, rds = world["port"], world["ref"]
    table, tr = _port_world(world, dense_optimizer=optimizer)
    rtable, rtr = _ref_world(world, dense_optimizer=optimizer)
    if optimizer == "sgd":
        assert isinstance(tr.optimizer, torch.optim.SGD)
    m = rm = None
    for _ in range(2):
        m = _pass(ds, table, tr, tr.last_metric_state)
        rm = _pass(rds, rtable, rtr, rtr.last_metric_state)
        _norms_agree(m, rm)
    _agree(m, rm, table.state_dict(), rtable.state_dict())
    assert m["grad_norm"] > 0 and m["weight_norm"] > 0


@pytest.mark.parametrize("mode,optimizer", [("step", "adam"),
                                            ("step", "sgd"),
                                            ("kstep", "adam"),
                                            ("async", "sgd")])
def test_multichip_optimizer_and_norms_match_reference(world, mode,
                                                       optimizer):
    """Two positions, two passes: the sharded trainer's losses, rows and
    both norms against the reference's, per dense-sync mode and
    optimizer.  ("async" keeps the pulls past the pass length, so it
    compares deterministically.)"""
    ds, rds = world["port"], world["ref"]
    kw = dict(sync_dense_mode=mode, dense_optimizer=optimizer,
              sync_weight_step=100 if mode == "async" else 2)
    table, tr, rtable, rtr = _sharded_worlds(world, **kw)
    try:
        for _ in range(2):
            m = _pass(ds, table, tr, tr.last_metric_state)
            rm = _pass(rds, rtable, rtr, rtr.last_metric_state)
            np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-5)
            _norms_agree(m, rm)
        sd, rsd = table.state_dict(), rtable.state_dict()
        np.testing.assert_array_equal(sd["keys"], rsd["keys"])
        np.testing.assert_allclose(sd["values"], rsd["values"], rtol=1e-5,
                                   atol=1e-6)
    finally:
        tr.close()
        rtr.close()
        table.close()


def test_no_step_no_grad_norm(world):
    """A pass of no batch reports weight_norm but no grad_norm, as the
    reference does."""
    table, tr = _port_world(world)
    table.begin_pass(world["port"].unique_keys())
    m = tr.train_steps(table, [])
    table.end_pass()
    assert "grad_norm" not in m and m["weight_norm"] > 0 and m["steps"] == 0
