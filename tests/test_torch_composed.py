"""The composed data x inner mesh of the port (parallel/mesh.py,
parallel/trainer.py), on the CPU.

  * the mesh helpers and their errors;
  * MMoE(expert_mesh="inherit") on make_composed_mesh(4, 2, "expert") and
    LongSeqCtrDnn(seq_mesh="inherit") on make_composed_mesh(4, 2, "seq"),
    and MMoE on an odd 3 x 2 mesh, each against the JAX MultiChipTrainer
    on a data-only mesh of the same data positions with the serial model
    (the reference's composed mesh fails while tracing on this jax, so its
    own test's oracle is the comparison): show and click counters
    bit-equal, loss within rel 5e-3, AUC within 2e-2 and rows within 2e-2,
    the reference test's bounds; and against the port's own data-only run.
"""

import jax
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
import paddlebox_tpu_torch.models as models
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    data_axis_size,
    make_composed_mesh,
    make_mesh,
)
from paddlebox_tpu_torch.parallel.mesh import axis_positions, inner_mesh
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, B = 3, 2, 16
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


def test_mesh_helpers():
    mesh = make_composed_mesh(4, 2, "expert", device="cpu")
    assert mesh.axis_names == ("data", "expert")
    assert mesh.shape == {"data": 4, "expert": 2} and mesh.n == 4
    assert data_axis_size(mesh) == 4
    assert data_axis_size(make_mesh(8, device="cpu")) == 8
    # positions are not devices: any count fits one device
    assert make_composed_mesh(8, 2, "seq", device="cpu").shape["seq"] == 2
    with pytest.raises(ValueError, match="single-chip Trainer"):
        make_composed_mesh(1, 2, "expert", device="cpu")
    with pytest.raises(ValueError, match="needs a 'data' axis"):
        data_axis_size(make_mesh(4, device="cpu", axis_name="seq"))
    with pytest.raises(ValueError, match="needs a 'data' axis"):
        MultiChipTrainer(models.CtrDnn(S, 6, device="cpu"),
                         SparseTableConfig(embedding_dim=4),
                         make_mesh(4, device="cpu", axis_name="seq"))
    # "inherit" binds once, when the multi-chip trainer is built on the
    # composed mesh: unbound, or on a mesh without the axis, it raises
    assert inner_mesh(mesh, "expert").shape == {"expert": 2}
    with pytest.raises(ValueError, match="'seq'"):
        inner_mesh(mesh, "seq")
    with pytest.raises(ValueError, match="make_composed_mesh"):
        axis_positions("inherit", "expert")
    tconf = SparseTableConfig(embedding_dim=4)
    m = models.MMoE(S, 6, n_experts=4, expert_mesh="inherit", device="cpu")
    MultiChipTrainer(m, tconf, mesh)
    assert m.expert_mesh.shape == {"expert": 2}
    with pytest.raises(ValueError, match="n_experts 3 not divisible"):
        MultiChipTrainer(models.MMoE(S, 6, n_experts=3, expert_mesh="inherit",
                                     device="cpu"), tconf, mesh)
    with pytest.raises(ValueError, match="make_composed_mesh"):
        MultiChipTrainer(models.MMoE(S, 6, expert_mesh="inherit",
                                     device="cpu"), tconf,
                         make_mesh(4, device="cpu"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("composed")
    return {
        "tasks": write_synth_files(str(d / "tasks"), n_files=1,
                                   ins_per_file=256, n_sparse_slots=S,
                                   vocab_per_slot=50, dense_dim=DENSE, seed=9,
                                   n_task_labels=1),
        "seq": write_synth_files(str(d / "seq"), n_files=1, ins_per_file=256,
                                 n_sparse_slots=S, vocab_per_slot=50,
                                 dense_dim=DENSE, seed=9, max_keys_per_slot=9),
    }


MMOE = dict(dense_dim=DENSE, n_tasks=2, n_experts=4, expert_hidden=(16,),
            expert_dim=8, tower_hidden=(8,))
LONGSEQ = dict(dense_dim=DENSE, hidden=(16,), max_seq_len=8, n_heads=2,
               head_dim=4)
CASES = {
    # name -> (model class, kwargs, inner axis, inner kwarg, data kwargs,
    # feasigns per instance)
    "mmoe": ("MMoE", MMOE, "expert", dict(expert_mesh="inherit"),
             dict(n_task_labels=1), 8),
    "longseq_ring": ("LongSeqCtrDnn", LONGSEQ, "seq",
                     dict(seq_mesh="inherit", seq_impl="ring"),
                     dict(sequence_slot="slot0", max_seq_len=8), 12),
    "longseq_ulysses": ("LongSeqCtrDnn", LONGSEQ, "seq",
                        dict(seq_mesh="inherit", seq_impl="ulysses"),
                        dict(sequence_slot="slot0", max_seq_len=8), 12),
}


def _load(cls, mk, files, data_kw, feasigns):
    ds = cls(mk(S, DENSE, B, feasigns, **data_kw), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _drive(table, trainer, ds, passes):
    m = None
    for _ in range(passes):
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table)
        table.end_pass()
    state = table.state_dict()
    table.close()
    return m, state


@pytest.mark.parametrize("name,n_data,passes", [
    ("mmoe", 4, 2), ("longseq_ring", 4, 1), ("longseq_ulysses", 4, 1),
    ("mmoe", 3, 1)])
def test_composed_matches_data_only(name, n_data, passes, files, monkeypatch):
    for k in NATIVE_FLAGS:
        monkeypatch.setenv(k, "0")
    cls, kw, axis, inner, data_kw, feasigns = CASES[name]
    key = "tasks" if cls == "MMoE" else "seq"
    tkw = dict(embedding_dim=4)
    rconf = ref_config.SparseTableConfig(**tkw)
    rmesh = ref_make_mesh(n_data)
    ref_tr = RefMultiChipTrainer(
        getattr(ref_models, cls)(S, rconf.row_width, **kw), rconf, rmesh,
        ref_config.TrainerConfig(auc_buckets=1 << 10), seed=0)
    params = params_from_jax_tree(jax.tree.map(np.array,
                                               ref_tr.dense_state()[0]))
    ref_ds = _load(RefDataset, ref_synth_config, files[key], data_kw,
                   feasigns)
    rm, rs = _drive(RefShardedTable(rconf, rmesh, seed=0), ref_tr, ref_ds,
                    passes)
    ref_ds.close()
    conf = SparseTableConfig(**tkw)
    runs = {}
    for label, mesh, extra in (
            ("composed", make_composed_mesh(n_data, 2, axis, device="cpu"),
             inner),
            ("data", make_mesh(n_data, device="cpu"), {})):
        model = getattr(models, cls)(S, conf.row_width, device="cpu", **kw,
                                     **extra)
        model.load_state_dict(params)
        tr = MultiChipTrainer(model, conf, mesh,
                              TrainerConfig(auc_buckets=1 << 10))
        ds = _load(PadBoxSlotDataset, make_synth_config, files[key], data_kw,
                   feasigns)
        runs[label] = _drive(ShardedSparseTable(conf, mesh, seed=0), tr, ds,
                             passes)
        ds.close()
    (m, s), (md, sd) = runs["composed"], runs["data"]
    # exact: the data path (routing, counters) sees only the data axis
    assert m["steps"] == md["steps"] == rm["steps"] > 0
    assert m["count"] == rm["count"]
    np.testing.assert_array_equal(s["keys"], rs["keys"])
    np.testing.assert_array_equal(s["values"][:, :2], rs["values"][:, :2])
    np.testing.assert_array_equal(s["values"][:, :2], sd["values"][:, :2])
    # close: the reference test's bounds
    for other, os_ in ((rm, rs), (md, sd)):
        assert m["loss"] == pytest.approx(other["loss"], rel=5e-3)
        assert m["auc"] == pytest.approx(other["auc"], abs=2e-2)
        if cls == "MMoE":
            assert m["task1/auc"] == pytest.approx(other["task1/auc"],
                                                   abs=2e-2)
        np.testing.assert_allclose(s["values"], os_["values"], atol=2e-2)
