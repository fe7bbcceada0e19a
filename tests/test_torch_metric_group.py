"""Metric groups (metrics/variants.py) against the JAX package: the
reference's tests/test_models.py::test_metric_group_cmatch_rank setup
trained two passes by both single-chip trainers from the reference's tower,
and a 4-position CtrDnn run of both multi-chip trainers with the same
group.  Within the port: the batched group update equals separate updates,
``all`` equals the primary stream bit for bit, grouped steps equal single
steps, and the reference's errors.
"""

import os

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.metrics import MetricGroup as RefGroup
from paddlebox_tpu.metrics import MetricSpec as RefSpec
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.metrics import MetricGroup, MetricSpec
from paddlebox_tpu_torch.metrics.auc import (
    compute_metrics,
    init_auc_state,
    update_auc_state_,
)
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

# the reference test's sizes (tests/test_models.py)
S, DENSE, B = 3, 2, 32
SPECS = [("all", None, None), ("cm222", (222,), None), ("rank1", None, (1,)),
         ("none", (999,), None)]
REF_NATIVE = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER")


def _group(ref=False):
    spec, group = (RefSpec, RefGroup) if ref else (MetricSpec, MetricGroup)
    return group([spec(n, cmatch_values=c, rank_values=r)
                  for n, c, r in SPECS], n_buckets=1 << 10)


def _files(d, n_ins=128, seed=11):
    return write_synth_files(str(d), n_files=1, ins_per_file=n_ins,
                             n_sparse_slots=S, vocab_per_slot=40,
                             dense_dim=DENSE, seed=seed, with_logkey=True)


def _dataset(files, ref=False, batch=B, **kw):
    conf = (ref_synth_config if ref else make_synth_config)(
        n_sparse_slots=S, dense_dim=DENSE, batch_size=batch,
        max_feasigns_per_ins=16, parse_logkey=True, **kw)
    ds = (RefDataset if ref else PadBoxSlotDataset)(conf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _check_group(m):
    """What the reference test asserts of a pass's group metrics, with
    ``all`` held to the primary stream bit for bit."""
    assert m["all/auc"] == m["auc"] and m["all/count"] == m["count"]
    assert 0 < m["cm222/count"] < m["all/count"]
    assert 0 < m["rank1/count"] < m["all/count"]
    assert m["none/count"] == 0.0


def test_group_update_equals_separate_updates():
    """One batched update of M streams: the integer counts equal M separate
    update_auc_state_ calls bit for bit, the Kahan sums to float32
    rounding."""
    rng = np.random.default_rng(0)
    preds = torch.from_numpy(rng.random(200).astype(np.float32))
    labels = torch.from_numpy((rng.random(200) < 0.3).astype(np.float32))
    masks = torch.from_numpy((rng.random((3, 200)) < 0.6).astype(np.float32))
    group = MetricGroup([MetricSpec(str(i)) for i in range(3)], 64)
    state = group.init_state("cpu")
    for _ in range(2):
        group.update(state, preds, labels, masks)
    for i in range(3):
        one = init_auc_state(64, "cpu")
        for _ in range(2):
            update_auc_state_(one, preds, labels, masks[i])
        for f in ("pos", "neg", "label_sum", "count"):
            assert torch.equal(getattr(state, f)[i], getattr(one, f)), f
        for f in ("abserr", "sqrerr", "pred_sum"):
            torch.testing.assert_close(getattr(state, f)[i], getattr(one, f),
                                       rtol=1e-6, atol=1e-6)
    gate = torch.tensor(False)
    before = [t.clone() for t in state]
    group.update(state, preds, labels, masks, gate)
    assert all(torch.equal(a, b) for a, b in zip(before, state))


def test_single_chip_matches_reference(tmp_path, monkeypatch):
    """Two passes of the reference test's setup from the reference's tower.
    Counts exact; loss within rtol 1e-5 and every AUC within 1e-4, the
    single-chip parity tolerances of tests/test_torch_trainer.py (float32
    sums in another order; a prediction that moves ~1e-7 can cross one of
    1024 bucket edges)."""
    for k in REF_NATIVE:
        monkeypatch.setenv(k, "0")
    files = _files(tmp_path)
    tconf = SparseTableConfig(embedding_dim=4)
    rconf = ref_config.SparseTableConfig(embedding_dim=4, hbm_cache_rows=0,
                                         overlap_pass_boundary=False)
    ref_tr = RefTrainer(RefCtrDnn(S, rconf.row_width, dense_dim=DENSE,
                                  hidden=(16,)), rconf,
                        ref_config.TrainerConfig(auc_buckets=1 << 10),
                        metric_group=_group(ref=True))
    tower = [{k: np.array(v) for k, v in layer.items()}
             for layer in ref_tr.params["tower"]]
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 10),
                 device="cpu", metric_group=_group())
    ref_table, table = RefTable(rconf, seed=0), SparseTable(tconf, seed=0,
                                                            device="cpu")
    ds, ref = _dataset(files), _dataset(files, ref=True)
    for _ in range(2):
        ref_table.begin_pass(ref.unique_keys())
        table.begin_pass(ds.unique_keys())
        rm = ref_tr.train_from_dataset(ref, ref_table)
        pm = tr.train_from_dataset(ds, table)
        ref_table.end_pass()
        table.end_pass()
        _check_group(pm)
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)
        for name, _, _ in SPECS:
            assert pm[f"{name}/count"] == rm[f"{name}/count"], name
            assert abs(pm[f"{name}/auc"] - rm[f"{name}/auc"]) < 1e-4, name
    # the group's streams continue through last_metric_state
    table.begin_pass(ds.unique_keys())
    pm2 = tr.train_from_dataset(ds, table, auc_state=tr.last_metric_state)
    assert pm2["cm222/count"] == 2 * pm["cm222/count"]
    with pytest.raises(ValueError, match="last_metric_state"):
        tr.train_from_dataset(ds, table, auc_state=tr.last_auc_state)
    table.end_pass()
    table.close()
    ds.close()
    ref.close()


@pytest.mark.parametrize("k", [2, 4])
def test_grouped_steps_equal_single_steps(tmp_path, k):
    """scan_steps groups on the CPU run the same body eagerly: every
    stream, the primary and the group's, bit-equal to one step at a
    time."""
    files = _files(tmp_path, n_ins=160)
    out = []
    for scan in (1, k):
        tconf = SparseTableConfig(embedding_dim=4)
        table = SparseTable(tconf, seed=2, device="cpu")
        tr = Trainer(CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                            seed=1, device="cpu"), tconf,
                     TrainerConfig(auc_buckets=1 << 10, scan_steps=scan),
                     device="cpu", metric_group=_group())
        ds = _dataset(files)
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table)
        table.end_pass()
        out.append((m, tr.last_metric_state["group"]))
        table.close()
        ds.close()
    (m1, g1), (mk, gk) = out
    assert m1["loss"] == mk["loss"] and m1["steps"] == mk["steps"] == 5
    for a, b in zip(g1, gk):
        assert torch.equal(a, b)
    _check_group(mk)


def test_metric_spec_requires_logkey(tmp_path):
    """The reference's error: a spec that filters by cmatch on batches
    without cmatches, from either trainer."""
    files = write_synth_files(str(tmp_path), n_files=1, ins_per_file=64,
                              n_sparse_slots=S, dense_dim=DENSE, seed=11)
    conf = make_synth_config(n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
                             max_feasigns_per_ins=16)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    group = MetricGroup([MetricSpec("cm", cmatch_values=(222,))], 1 << 8)
    tconf = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu")
    table = SparseTable(tconf, device="cpu")
    table.begin_pass(ds.unique_keys())
    with pytest.raises(ValueError, match="cmatch"):
        Trainer(model, tconf, device="cpu",
                metric_group=group).train_from_dataset(ds, table)
    table.end_pass()
    table.close()
    mesh = make_mesh(2, device="cpu")
    sharded = ShardedSparseTable(tconf, mesh)
    sharded.begin_pass(ds.unique_keys())
    with pytest.raises(ValueError, match="cmatch"):
        MultiChipTrainer(model, tconf, mesh,
                         metric_group=group).train_from_dataset(ds, sharded)
    sharded.end_pass()
    sharded.close()
    with pytest.raises(ValueError, match="rank"):
        MetricSpec("r", rank_values=(1,)).mask(next(iter(ds.batches())))
    ds.close()


def test_multichip_matches_reference(tmp_path, monkeypatch):
    """Three passes of CtrDnn on 4 positions with the hybrid placement
    (the hot block realizes at the third begin_pass), the group's streams
    stacked per position and merged, from the reference's tower.  Counts
    exact; loss and AUCs within 1e-6, as tests/test_torch_multichip.py
    holds the same path (dense gradients and segment sums add in another
    order, ~1e-7 a step)."""
    native = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
              "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
              "PADDLEBOX_TORCH_USE_NATIVE_PARSER")
    for k in native:
        monkeypatch.setenv(k, "0")
    kw = dict(embedding_dim=4, placement_update_interval=1,
              placement_hot_capacity=64, hbm_cache_rows=0,
              placement="loopback")
    pass_files = [_files(tmp_path / f"p{p}", n_ins=160, seed=30 + p)
                  for p in range(3)]
    rconf = ref_config.SparseTableConfig(**kw)
    ref_tr = RefMultiChipTrainer(
        RefCtrDnn(S, rconf.row_width, dense_dim=DENSE, hidden=(8,)), rconf,
        ref_make_mesh(4), ref_config.TrainerConfig(auc_buckets=1 << 10),
        seed=3, metric_group=_group(ref=True))
    tower = [{k: np.asarray(v) for k, v in layer.items()}
             for layer in ref_tr.dense_state()[0]["tower"]]
    ref_table = RefShardedTable(rconf, ref_tr.mesh, seed=5, bucket_slack=8.0)
    conf = SparseTableConfig(**kw)
    mesh = make_mesh(4, device="cpu")
    model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = MultiChipTrainer(model, conf, mesh,
                          TrainerConfig(auc_buckets=1 << 10),
                          metric_group=_group())
    table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    state = ref_state = None
    for files in pass_files:
        ds, ref = _dataset(files, batch=16), _dataset(files, ref=True,
                                                      batch=16)
        ref_table.begin_pass(ref.unique_keys())
        table.begin_pass(ds.unique_keys())
        rm = ref_tr.train_from_dataset(ref, ref_table, auc_state=ref_state,
                                       drop_last=True)
        pm = tr.train_from_dataset(ds, table, auc_state=state, drop_last=True)
        ref_state, state = ref_tr.last_metric_state, tr.last_metric_state
        ref_table.end_pass()
        table.end_pass()
        ds.close()
        ref.close()
        _check_group(pm)
        assert abs(pm["loss"] - rm["loss"]) < 1e-6
        for name, _, _ in SPECS:
            assert pm[f"{name}/count"] == rm[f"{name}/count"], name
            assert abs(pm[f"{name}/auc"] - rm[f"{name}/auc"]) < 1e-6, name
    assert pm["hot_occurrences"] > 0
    assert state["group"].pos.shape == (4, len(SPECS), 1 << 10)
    table.close()
    ref_table.close()
