"""The port's AUC runner (train/auc_runner.py) against the JAX package's,
on the CPU (reference: tests/test_capability_tail.py
test_auc_runner_slot_importance).

  * ``key_slot_map``, ``build_candidate_pools`` (with and without the
    reservoir cap) and ``replace_slots`` are bit-exact with the
    reference's on the same block and seed, and the replaced block leaves
    the original untouched;
  * ``AucRunner.run`` over two slot groups on a trained world (the port's
    table and tower carried over from the reference's): the baseline and
    each group's AUC within two bucket crossings of the reference's
    (tests/test_torch_retrieval.py's bound) and each delta within twice
    that; replacing every slot costs more AUC than replacing one, and the
    dataset's block comes back.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train import Trainer as RefTrainer
from paddlebox_tpu.train import auc_runner as ref_ar
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig, flags
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train import auc_runner as ar
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, B, VOCAB = 3, 2, 32, 30
FIELDS = ("keys", "key_offsets", "dense", "labels")
GROUPS = {"g_slot0": ["slot0"], "g_all": ["slot0", "slot1", "slot2"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A Zipf-free synth set both packages load, trained 6 passes in the
    JAX package; the port's table and tower take its state."""
    files = write_synth_files(str(tmp_path_factory.mktemp("aucr")),
                              n_files=2, ins_per_file=128, n_sparse_slots=S,
                              vocab_per_slot=VOCAB, dense_dim=DENSE, seed=2)
    rds = RefDataset(ref_synth_config(S, DENSE, B, 8), read_threads=1)
    ds = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 8), read_threads=1)
    for d in (rds, ds):
        d.set_filelist(files)
        d.load_into_memory()
    rtc = ref_config.SparseTableConfig(embedding_dim=4)
    rtr = RefTrainer(RefCtrDnn(S, rtc.row_width, dense_dim=DENSE,
                               hidden=(16,)), rtc,
                     ref_config.TrainerConfig(auc_buckets=1 << 12,
                                              dense_lr=1e-2), seed=0)
    rtable = RefTable(rtc, seed=0)
    for _ in range(6):
        rtable.begin_pass(rds.unique_keys())
        rtr.train_from_dataset(rds, rtable)
        rtable.end_pass()
    tc = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(S, tc.row_width, dense_dim=DENSE, hidden=(16,),
                   device="cpu")
    model.load_state_dict(params_from_jax_tree(
        jax.tree.map(np.array, rtr.params)))
    table = SparseTable(tc, device="cpu")
    table.load_state_dict(rtable.state_dict())
    tr = Trainer(model, tc, TrainerConfig(auc_buckets=1 << 12), device="cpu")
    yield {"ds": ds, "rds": rds, "tr": tr, "table": table, "rtr": rtr,
           "rtable": rtable}
    table.close()
    rtable.close()
    ds.close()
    rds.close()


def _same_block(a, b):
    assert (a.n_ins, a.n_sparse_slots) == (b.n_ins, b.n_sparse_slots)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.mark.parametrize("max_pool", [100_000, 7])
def test_pools_and_replacement_bit_exact(world, max_pool):
    block, rblock = world["ds"]._block, world["rds"]._block
    _same_block(block, rblock)
    ks, rks = ar.key_slot_map(block), ref_ar.key_slot_map(rblock)
    np.testing.assert_array_equal(ks, rks)
    pools = ar.build_candidate_pools(block, max_pool, seed=3, key_slots=ks)
    rpools = ref_ar.build_candidate_pools(rblock, max_pool, seed=3)
    assert len(pools) == len(rpools) == S
    for p, rp in zip(pools, rpools):
        np.testing.assert_array_equal(p, rp)
        assert p.shape[0] <= max_pool
    before = block.keys.copy()
    for idxs in ([0], [1, 2], [0, 1, 2]):
        got = ar.replace_slots(block, idxs, pools, seed=5, key_slots=ks)
        want = ref_ar.replace_slots(rblock, idxs, rpools, seed=5)
        _same_block(got, want)
        changed = ks[got.keys != block.keys]
        assert set(np.unique(changed)) <= set(idxs)
        np.testing.assert_array_equal(got.key_offsets, block.key_offsets)
    np.testing.assert_array_equal(block.keys, before)


def test_run_matches_the_reference(world):
    out = ar.AucRunner(world["tr"], world["table"], seed=3).run(
        world["ds"], GROUPS)
    rout = ref_ar.AucRunner(world["rtr"], world["rtable"], seed=3).run(
        world["rds"], GROUPS)
    assert set(out) == set(rout) == {"baseline", *GROUPS}
    for g in out:
        m, rm = out[g], rout[g]
        assert m["count"] == rm["count"] == 256
        pos = round(rm["actual_ctr"] * rm["count"])
        tol = 2.0 / max(pos * (rm["count"] - pos), 1)
        assert abs(m["auc"] - rm["auc"]) <= tol, (g, m["auc"], rm["auc"])
        if g != "baseline":
            assert abs(m["delta"] - rm["delta"]) <= 2 * tol, g
    assert out["baseline"]["auc"] > 0.55
    assert out["g_all"]["delta"] >= out["g_slot0"]["delta"] - 1e-6
    assert out["g_all"]["delta"] > 0.01
    # the dataset's block is back: a fresh evaluate reads the baseline
    t = world["table"]
    t.begin_pass(world["ds"].unique_keys())
    again = world["tr"].evaluate(world["ds"], t)
    t.end_pass()
    assert again["auc"] == out["baseline"]["auc"]


def test_run_refuses_an_unloaded_dataset(world):
    empty = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 8))
    with pytest.raises(RuntimeError, match="load the dataset"):
        ar.AucRunner(world["tr"], world["table"]).run(empty, GROUPS)
    assert flags.auc_runner_mode is False
    assert dataclasses.is_dataclass(world["ds"]._block)
