"""Two-tower retrieval of the port against the JAX package, on the CPU:
TwoTower (models/two_tower.py) and RetrievalTrainer
(scenarios/retrieval.py).

  * the towers and the pointwise logits, forward and gradients, against
    the reference's ``apply_towers`` / ``apply``;
  * three RetrievalTrainer passes (loss, AUC, table rows) against the JAX
    RetrievalTrainer, then ``evaluate`` against its evaluate;
  * scan_steps 4 (the group body, eager on the CPU) bit-equal to single
    steps; a poisoned batch under skip_batch leaves the state of the run
    without it, and the reference agrees;
  * the constructor and the model's errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.scenarios import RetrievalTrainer as RefRetrievalTrainer
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.utils import faults as ref_faults
import paddlebox_tpu_torch.models as models
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.metrics.variants import MetricGroup, MetricSpec
from paddlebox_tpu_torch.scenarios import RetrievalTrainer
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, B, EMB = 3, 2, 16, 4
ITEMS = (2,)
KW = dict(item_slots=ITEMS, dense_dim=DENSE, hidden=(16,), temperature=0.1)
TOL = dict(rtol=1e-5, atol=1e-6)
TKW = dict(embedding_dim=EMB, learning_rate=0.2, initial_range=0.1)
TRKW = dict(dense_lr=1e-2, auc_buckets=1 << 10)
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def test_towers_match_reference():
    width = 2 + EMB
    ref = ref_models.TwoTower(S, width, **KW)
    port = models.TwoTower(S, width, device="cpu", **KW)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(5)))
    port.load_state_dict(params_from_jax_tree(params))
    assert port.user_slots == ref.user_slots == (0, 1)
    rng = np.random.default_rng(1)
    K = B * S * 2
    rows = rng.normal(size=(K, width)).astype(np.float32)
    segs = np.sort(rng.integers(0, B * S + 1, size=K)).astype(np.int32)
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    cu, ci, cl = (rng.normal(size=s).astype(np.float32)
                  for s in ((B, EMB), (B, EMB), (B,)))

    def loss(p, r):
        u, i = ref.apply_towers(p, r, segs, dense, B)
        lg = ref.apply(p, r, segs, dense, B)
        return (u * cu).sum() + (i * ci).sum() + (lg * cl).sum(), (u, i, lg)

    (_, want), (gp, gr) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(rows))
    r = torch.from_numpy(rows).requires_grad_(True)
    args = (torch.from_numpy(segs), torch.from_numpy(dense), B)
    u, i = port.apply_towers(r, *args)
    lg = port(r, *args)
    ((u * torch.from_numpy(cu)).sum() + (i * torch.from_numpy(ci)).sum()
     + (lg * torch.from_numpy(cl)).sum()).backward()
    for got, w in zip((u, i, lg), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(torch.linalg.norm(u, dim=1).detach().numpy(),
                               1.0, rtol=1e-6)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr), rtol=1e-5,
                               atol=1e-5)
    want_g = params_from_jax_tree(jax.tree.map(np.asarray, gp))
    for name, prm in port.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_model_errors():
    with pytest.raises(ValueError, match="out of range"):
        models.TwoTower(S, 6, item_slots=(3,), device="cpu")
    with pytest.raises(ValueError, match="proper non-empty subset"):
        models.TwoTower(S, 6, item_slots=(0, 1, 2), device="cpu")
    with pytest.raises(ValueError, match="proper non-empty subset"):
        models.TwoTower(S, 6, item_slots=(), device="cpu")
    with pytest.raises(ValueError, match="no embedding columns"):
        models.TwoTower(S, 2, item_slots=(1,), device="cpu")
    assert models.TwoTower(S, 6, item_slots=(1, 1), device="cpu").retrieval


# --------------------------------------------------------------------------- #
# the retrieval trainer
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """128 instances (8 batches of 16) in both packages' datasets, and the
    reference's seed-0 user tower."""
    files = write_synth_files(str(tmp_path_factory.mktemp("retr")),
                              n_files=2, ins_per_file=64, n_sparse_slots=S,
                              vocab_per_slot=40, dense_dim=DENSE, seed=17)
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        port = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 8),
                                 read_threads=1)
        ref = RefDataset(ref_synth_config(S, DENSE, B, 8), read_threads=1)
        for ds in (port, ref):
            ds.set_filelist(files)
            ds.load_into_memory()
        rconf = ref_config.SparseTableConfig(hbm_cache_rows=0, **TKW)
        params = jax.tree.map(np.array, RefRetrievalTrainer(
            ref_models.TwoTower(S, rconf.row_width, **KW), rconf,
            ref_config.TrainerConfig(**TRKW), seed=0).params)
        yield {"port": port, "ref": ref, "params": params, "mp": mp}
    port.close()
    ref.close()


def _port_world(world, **trkw):
    conf = SparseTableConfig(**TKW)
    model = models.TwoTower(S, conf.row_width, device="cpu", **KW)
    model.load_state_dict(params_from_jax_tree(world["params"]))
    return (SparseTable(conf, seed=3, device="cpu"),
            RetrievalTrainer(model, conf, TrainerConfig(**TRKW, **trkw),
                             device="cpu"))


def _ref_world(**trkw):
    conf = ref_config.SparseTableConfig(hbm_cache_rows=0,
                                        overlap_pass_boundary=False, **TKW)
    return (RefTable(conf, seed=3),
            RefRetrievalTrainer(ref_models.TwoTower(S, conf.row_width, **KW),
                                conf, ref_config.TrainerConfig(**TRKW, **trkw),
                                seed=0))


def _pass(ds, table, trainer):
    table.begin_pass(ds.unique_keys())
    m = trainer.train_from_dataset(ds, table)
    table.end_pass()
    return m


def _agree(m, rm, state, rstate):
    assert m["steps"] == rm["steps"] and m["count"] == rm["count"] > 0
    np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-5)
    pos = round(rm["actual_ctr"] * rm["count"])
    # two bucket crossings' worth of AUC (tests/test_torch_models.py)
    assert abs(m["auc"] - rm["auc"]) <= 2.0 / max(pos * (rm["count"] - pos),
                                                  1)
    np.testing.assert_array_equal(state["keys"], rstate["keys"])
    np.testing.assert_array_equal(state["values"][:, :2],
                                  rstate["values"][:, :2])
    # the in-batch softmax scales the row gradients by 1/temperature (10
    # here), and their float32 rounding with them: the zoo's row bounds
    # times 2 (relative, the g2sum column) and 10 (absolute)
    np.testing.assert_allclose(state["values"], rstate["values"], rtol=2e-5,
                               atol=1e-5)


def test_passes_and_evaluate_match_reference(world):
    table, tr = _port_world(world)
    rtable, rtr = _ref_world()
    try:
        for _ in range(3):
            m = _pass(world["port"], table, tr)
            rm = _pass(world["ref"], rtable, rtr)
            _agree(m, rm, table.state_dict(), rtable.state_dict())
            assert np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
        evals = []
        for t, ds, tb in ((tr, world["port"], table),
                          (rtr, world["ref"], rtable)):
            tb.begin_pass(ds.unique_keys())
            evals.append(t.evaluate(ds, tb))
            tb.end_pass()
        ev, rev = evals
        assert ev["count"] == rev["count"] == 128
        assert abs(ev["auc"] - rev["auc"]) < 1e-4
        # evaluate changed nothing
        assert tr.global_step == 3 * 8
    finally:
        table.close()


def test_scan_steps_match_single_steps(world):
    runs = []
    for k in (1, 4):
        table, tr = _port_world(world, scan_steps=k)
        ms = [_pass(world["port"], table, tr) for _ in range(2)]
        runs.append(([(m["loss"], m["auc"], m["grad_norm"]) for m in ms],
                     table.state_dict(),
                     [p.detach().clone() for p in tr.model.parameters()]))
        table.close()
    (m1, s1, p1), (m4, s4, p4) = runs
    assert m1 == m4
    np.testing.assert_array_equal(s1["values"], s4["values"])
    assert all(torch.equal(a, b) for a, b in zip(p1, p4))


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_skip_batch(world, scan_steps):
    """The third batch's labels poisoned (train.nan, at:2) under skip_batch:
    the pass equals, bit for bit, the same pass fed without that batch, and
    the reference skips it too."""
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
    sa, sb = table_a.state_dict(), table_b.state_dict()
    np.testing.assert_array_equal(sa["values"], sb["values"])
    for key in ("loss", "auc", "count", "steps", "grad_norm"):
        assert ma[key] == mb[key], key
    assert ma["steps"] == 7 and ma["count"] == 128 - B
    assert all(torch.equal(a, b) for a, b in zip(tr_a.model.parameters(),
                                                 tr_b.model.parameters()))
    if scan_steps == 1:
        rtable, rtr = _ref_world(nan_policy="skip_batch")
        with ref_faults.fault_plan({"train.nan": "at:2"}):
            rm = _pass(world["ref"], rtable, rtr)
        _agree(ma, rm, sa, rtable.state_dict())
    table_a.close()
    table_b.close()


def test_constructor_errors():
    conf = SparseTableConfig(**TKW)
    with pytest.raises(ValueError, match="apply_towers"):
        RetrievalTrainer(models.CtrDnn(S, conf.row_width, device="cpu"), conf,
                         device="cpu")
    tt = models.TwoTower(S, conf.row_width, device="cpu", **KW)
    with pytest.raises(ValueError, match="metric groups"):
        RetrievalTrainer(tt, conf, device="cpu",
                         metric_group=MetricGroup([MetricSpec("a")]))
    tt.n_tasks = 2
    with pytest.raises(ValueError, match="single-task"):
        RetrievalTrainer(tt, conf, device="cpu")
