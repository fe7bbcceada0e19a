"""The zoo's multi-task and rank_offset models on the port's multi-chip
trainer against the JAX package's MultiChipTrainer (on the forced CPU
devices): MMoE (two tasks, per-task AUCs) and RankCtrDnn (PV-merged
batches, each position's rank_offset) on 4 shard positions, the hybrid
loopback placement realized, three passes from the reference's initial
parameters and an evaluate().
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
    make_mesh,
)
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, BSZ, N, PASSES = 3, 2, 16, 4, 3
TABLE_KW = dict(embedding_dim=4, placement="loopback",
                placement_update_interval=1, placement_hot_capacity=64,
                hbm_cache_rows=0)
MODELS = {
    "mmoe": ("MMoE", dict(n_tasks=2, n_experts=2, expert_hidden=(8,),
                          expert_dim=4, tower_hidden=(4,)),
             dict(n_task_labels=1, parse_logkey=True)),
    "rank_ctr": ("RankCtrDnn", dict(hidden=(8,), max_rank=3, att_out_dim=4),
                 dict(n_task_labels=1, parse_logkey=True,
                      enable_pv_merge=True, pv_batch_size=4,
                      rank_offset="rank_offset")),
}
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_mc")
    return write_synth_files(str(d), n_files=2, ins_per_file=128,
                             n_sparse_slots=S, vocab_per_slot=60,
                             dense_dim=DENSE, seed=21, with_logkey=True,
                             max_ads_per_pv=4, cmatch_values=(222, 223, 1),
                             n_task_labels=1)


def _load(files, data_kw, ref):
    ds = (RefDataset(ref_synth_config(S, DENSE, BSZ, 16, **data_kw),
                     read_threads=1) if ref else
          PadBoxSlotDataset(make_synth_config(S, DENSE, BSZ, 16, **data_kw),
                            read_threads=1))
    ds.set_filelist(files)
    ds.load_into_memory()
    if data_kw.get("enable_pv_merge"):
        ds.preprocess_instance()
    return ds


def _drive(table, trainer, ds):
    """PASSES passes over ``ds``, the metric streams continued, then an
    evaluate() in a pass of its own (the hot block realized)."""
    state, out = None, []
    for _ in range(PASSES):
        table.begin_pass(ds.unique_keys())
        out.append(trainer.train_from_dataset(ds, table, auc_state=state))
        state = trainer.last_metric_state
        table.end_pass()
        out[-1]["n_hot"] = table.hot_resident_keys().shape[0]
    table.begin_pass(ds.unique_keys())
    out.append(trainer.evaluate(ds, table))
    table.end_pass()
    return table.state_dict(), out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_model_matches_reference_multichip(name, files, monkeypatch):
    """Host-side state (keys, hot set, counters) identical; loss, AUC and
    per-task AUCs within 1e-6 and rows within 1e-7, the bounds of
    tests/test_torch_multichip.py (float32 sums in another order)."""
    cls, kw, data_kw = MODELS[name]
    for k in NATIVE_FLAGS:
        monkeypatch.setenv(k, "0")
    rconf = ref_config.SparseTableConfig(**TABLE_KW)
    rmesh = ref_make_mesh(N)
    ref_tr = RefMultiChipTrainer(
        getattr(ref_models, cls)(S, rconf.row_width, dense_dim=DENSE, **kw),
        rconf, rmesh, ref_config.TrainerConfig(auc_buckets=1 << 10), seed=3)
    # copies: the reference's step donates its parameter buffers
    params = jax.tree.map(np.array, ref_tr.dense_state()[0])
    ref_table = RefShardedTable(rconf, rmesh, seed=5, bucket_slack=8.0)
    ref_ds = _load(files, data_kw, ref=True)
    ref_state, ref_passes = _drive(ref_table, ref_tr, ref_ds)
    ref_table.close()
    ref_ds.close()

    conf = SparseTableConfig(**TABLE_KW)
    mesh = make_mesh(N, device="cpu")
    model = getattr(models, cls)(S, conf.row_width, dense_dim=DENSE,
                                 device="cpu", **kw)
    model.load_state_dict(params_from_jax_tree(params))
    tr = MultiChipTrainer(model, conf, mesh,
                          TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    ds = _load(files, data_kw, ref=False)
    state, passes = _drive(table, tr, ds)
    table.close()
    ds.close()

    (ev, ref_ev), passes, ref_passes = ((passes[-1], ref_passes[-1]),
                                        passes[:-1], ref_passes[:-1])
    assert ev["count"] == ref_ev["count"] > 0
    assert abs(ev["auc"] - ref_ev["auc"]) < 1e-6, (ev["auc"], ref_ev["auc"])
    for m, rm in zip(passes, ref_passes):
        assert m["steps"] == rm["steps"] and m["count"] == rm["count"] > 0
        assert m["n_hot"] == rm["n_hot"]
        assert abs(m["loss"] - rm["loss"]) < 1e-6, (m["loss"], rm["loss"])
        assert abs(m["auc"] - rm["auc"]) < 1e-6, (m["auc"], rm["auc"])
        tasks = sorted(k for k in rm if k.startswith("task"))
        assert tasks == sorted(k for k in m if k.startswith("task"))
        assert bool(tasks) == (name == "mmoe")
        for k in tasks:
            if k.endswith(("/auc", "/count")):
                assert abs(m[k] - rm[k]) < 1e-6, (k, m[k], rm[k])
    # the hot block realized at the third begin_pass and was routed
    assert passes[1]["n_hot"] == 0 < passes[2]["n_hot"]
    assert passes[2]["hot_occurrences"] > 0
    np.testing.assert_array_equal(state["keys"], ref_state["keys"])
    np.testing.assert_array_equal(state["values"][:, :2],
                                  ref_state["values"][:, :2])
    np.testing.assert_allclose(state["values"], ref_state["values"],
                               rtol=0, atol=1e-7)
    if name == "mmoe":
        assert tr.last_metric_state["task"].pos.shape == (N, 2, 1 << 10)
