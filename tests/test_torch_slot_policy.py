"""The port's slot policies against the JAX package: ``slot_mask`` (per-phase
slot participation) and the per-slot LR map
(``SparseTableConfig.slot_learning_rates``), on the single-chip Trainer
and on the MultiChipTrainer at 4 positions with the realized hot block
(ports of tests/test_slot_groups.py:77 and :202, the slot-gating check of
tests/test_two_phase.py and the single-trainer part of
tests/test_scenarios.py:141).

Synth keys are slot-disjoint (slot s owns [s*VOCAB+1, (s+1)*VOCAB]), so a
slot's effect shows in its own rows.  Both packages read the same files
through their numpy planners; the tower is the reference's.  Tolerances
are those of test_torch_trainer.py (single chip: loss and rows rtol 1e-5,
rows atol 1e-6) and test_torch_multichip.py (4 positions: loss 1e-6,
rows atol 1e-6); counters and keys exact.  Within the port, a uniform LR
map is bit-equal to the scalar lr.
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
from paddlebox_tpu.train.slot_policy import resolve_slot_lr_vec as ref_lr_vec
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu.train.trainer import _host_batch_dict
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable, _key_uniform
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train.slot_policy import (
    normalize_slot_mask,
    resolve_slot_lr_vec,
    slot_participation_vec,
)
from paddlebox_tpu_torch.train.trainer import host_feed
from paddlebox_tpu_torch.weights import params_from_jax, params_from_jax_stacked
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

N_SLOTS, DENSE, B, VOCAB, N_DEV = 4, 4, 64, 100, 4
HIDDEN = (16,)
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")
# the multi-chip pin of test_torch_multichip.py: a hot block that realizes
# at the third begin_pass
SHARD_KW = dict(placement="loopback", placement_update_interval=1,
                placement_hot_capacity=64, hbm_cache_rows=0)
SLOW_LR = ((2, 0.0005), (3, 0.0005))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """512 instances, loaded per package at batch B (single chip) and B / 4
    (4 positions: the same global batch), and the reference's tower."""
    files = write_synth_files(
        str(tmp_path_factory.mktemp("slotpol")), n_files=2,
        ins_per_file=4 * B, n_sparse_slots=N_SLOTS, vocab_per_slot=VOCAB,
        dense_dim=DENSE, seed=21,
    )
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        for bsz in (B, B // N_DEV):
            cap = bsz * N_SLOTS * 4
            port = PadBoxSlotDataset(make_synth_config(
                N_SLOTS, DENSE, bsz, batch_key_capacity=cap), read_threads=1)
            ref = RefDataset(ref_synth_config(
                N_SLOTS, DENSE, bsz, batch_key_capacity=cap), read_threads=1)
            for ds in (port, ref):
                ds.set_filelist(files)
                ds.load_into_memory()
            out[bsz] = (port, ref)
        conf = ref_config.SparseTableConfig(embedding_dim=8)
        tr = RefTrainer(RefCtrDnn(N_SLOTS, conf.row_width, dense_dim=DENSE,
                                  hidden=HIDDEN), conf,
                        ref_config.TrainerConfig(), seed=0)
        out["tower"] = [{k: np.asarray(v) for k, v in layer.items()}
                        for layer in tr.params["tower"]]
        yield out
    for bsz in (B, B // N_DEV):
        for ds in out[bsz]:
            ds.close()


def _single(world, side, tkw, slot_mask=None, passes=1):
    """(state_dict, last metrics) of ``passes`` single-chip passes."""
    port_ds, ref_ds = world[B]
    trkw = dict(auc_buckets=1 << 10)
    if side == "ref":
        conf = ref_config.SparseTableConfig(**tkw)
        table = RefTable(conf, seed=0)
        tr = RefTrainer(RefCtrDnn(N_SLOTS, conf.row_width, dense_dim=DENSE,
                                  hidden=HIDDEN), conf,
                        ref_config.TrainerConfig(**trkw), seed=0,
                        slot_mask=slot_mask)
        ds = ref_ds
    else:
        conf = SparseTableConfig(**tkw)
        table = SparseTable(conf, seed=0, device="cpu")
        model = CtrDnn(N_SLOTS, conf.row_width, dense_dim=DENSE,
                       hidden=HIDDEN, device="cpu")
        model.load_state_dict(params_from_jax(world["tower"]))
        tr = Trainer(model, conf, TrainerConfig(**trkw), device="cpu",
                     slot_mask=slot_mask)
        ds = port_ds
    m = None
    for _ in range(passes):
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table, auc_state=tr.last_metric_state)
        table.end_pass()
    return table.state_dict(), m


def _sharded(world, side, tkw, slot_mask=None, passes=3, probe=None):
    """(state_dict, per-pass metrics, probe results) of ``passes`` passes on
    4 positions.  ``probe(table, group)`` runs on the first group of the
    last pass right after its begin_pass."""
    port_ds, ref_ds = world[B // N_DEV]
    trkw = dict(auc_buckets=1 << 10)
    kw = {**SHARD_KW, **tkw}
    if side == "ref":
        conf = ref_config.SparseTableConfig(**kw)
        mesh = ref_make_mesh(N_DEV)
        tr = RefMultiChipTrainer(
            RefCtrDnn(N_SLOTS, conf.row_width, dense_dim=DENSE,
                      hidden=HIDDEN), conf, mesh,
            ref_config.TrainerConfig(**trkw), seed=0, slot_mask=slot_mask)
        table = RefShardedTable(conf, mesh, seed=0, bucket_slack=8.0)
        ds = ref_ds
    else:
        conf = SparseTableConfig(**kw)
        mesh = make_mesh(N_DEV, device="cpu")
        model = CtrDnn(N_SLOTS, conf.row_width, dense_dim=DENSE,
                       hidden=HIDDEN, device="cpu")
        tr = MultiChipTrainer(model, conf, mesh, TrainerConfig(**trkw),
                              slot_mask=slot_mask)
        tr.load_dense_state(params_from_jax_stacked(
            [{k: np.stack([v] * N_DEV) for k, v in layer.items()}
             for layer in world["tower"]]))
        table = ShardedSparseTable(conf, mesh, seed=0, bucket_slack=8.0)
        ds = port_ds
    out, probed = [], None
    for p in range(passes):
        table.begin_pass(ds.unique_keys())
        if probe is not None and p == passes - 1:
            probed = probe(table, tr, list(ds.batches())[:N_DEV])
        out.append(tr.train_from_dataset(ds, table,
                                         auc_state=tr.last_metric_state))
        table.end_pass()
    state = table.state_dict()
    if side == "port":
        table.close()
    return state, out, probed


def _slot_of(keys):
    return (np.asarray(keys, np.int64) - 1) // VOCAB


def _assert_close(sd, rsd, atol):
    np.testing.assert_array_equal(sd["keys"], rsd["keys"])
    np.testing.assert_array_equal(sd["values"][:, :2], rsd["values"][:, :2])
    np.testing.assert_allclose(sd["values"], rsd["values"], rtol=1e-5,
                               atol=atol)


# --------------------------------------------------------------------------- #
# the helpers
# --------------------------------------------------------------------------- #
def test_slot_mask_normalizes_and_validates():
    """The trainer's slot_mask is the sorted unique tuple (None = all
    slots), as tests/test_scenarios.py:141 reads it off each trainer."""
    assert normalize_slot_mask(None, 4) is None
    assert normalize_slot_mask([2, 0, 1, 1], 4) == (0, 1, 2)
    with pytest.raises(ValueError, match="out of range"):
        normalize_slot_mask([4], 4)
    assert slot_participation_vec(None, 4) is None
    assert slot_participation_vec((0, 2), 4).tolist() == [1.0, 0.0, 1.0, 0.0]
    tconf = SparseTableConfig(embedding_dim=8)
    model = CtrDnn(N_SLOTS, tconf.row_width, hidden=HIDDEN, device="cpu")
    assert Trainer(model, tconf, device="cpu",
                   slot_mask=(2, 0, 1)).slot_mask == (0, 1, 2)
    assert Trainer(model, tconf, device="cpu").slot_mask is None
    mesh = make_mesh(2, device="cpu")
    assert MultiChipTrainer(model, tconf, mesh,
                            slot_mask=[3, 1]).slot_mask == (1, 3)
    with pytest.raises(ValueError):
        MultiChipTrainer(model, tconf, mesh, slot_mask=[9])


def test_lr_vector_matches_reference():
    for lrs in ((), ((1, 0.5),), SLOW_LR):
        conf = SparseTableConfig(learning_rate=0.05, slot_learning_rates=lrs)
        rconf = ref_config.SparseTableConfig(learning_rate=0.05,
                                             slot_learning_rates=lrs)
        got, want = resolve_slot_lr_vec(conf, 4), ref_lr_vec(rconf, 4)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    model = CtrDnn(2, 10, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        Trainer(model, SparseTableConfig(embedding_dim=8,
                                         slot_learning_rates=((7, 0.1),)),
                device="cpu")


def test_host_feed_uniq_lr_matches_reference(world):
    """The feed's per-unique-key lr: the same array as the reference's
    _host_batch_dict builds from the same plan (padding the mean, the last
    assignment winning)."""
    port_ds, ref_ds = world[B]
    conf = SparseTableConfig(embedding_dim=8, slot_learning_rates=SLOW_LR)
    rconf = ref_config.SparseTableConfig(embedding_dim=8,
                                         slot_learning_rates=SLOW_LR)
    vec = resolve_slot_lr_vec(conf, N_SLOTS)
    table = SparseTable(conf, seed=0, device="cpu")
    rtable = RefTable(rconf, seed=0)
    table.begin_pass(port_ds.unique_keys())
    rtable.begin_pass(ref_ds.unique_keys())
    for b, rb in zip(port_ds.batches(), ref_ds.batches()):
        feed = host_feed(b, table.plan_batch(b), vec)
        rfeed = _host_batch_dict(rb, rtable.plan_batch(rb), N_SLOTS,
                                 slot_lr_vec=ref_lr_vec(rconf, N_SLOTS))
        for key in rfeed:
            np.testing.assert_array_equal(feed[key], rfeed[key], key)
    table.end_pass()
    rtable.end_pass()
    table.close()


# --------------------------------------------------------------------------- #
# slot_mask
# --------------------------------------------------------------------------- #
def _check_gated(sd, tconf, in_slots):
    """Excluded slots: zero show and clk, embeddings at the key-determined
    init, g2sum zero; participating slots saw traffic."""
    slot = _slot_of(sd["keys"])
    part = np.isin(slot, in_slots)
    assert sd["values"][part, 0].sum() > 0
    np.testing.assert_array_equal(sd["values"][~part, :2], 0.0)
    init = _key_uniform(sd["keys"][~part], seed=0,
                        n_cols=tconf.row_width - tconf.cvm_offset,
                        rng_range=tconf.initial_range)
    np.testing.assert_array_equal(
        sd["values"][~part, tconf.cvm_offset:tconf.row_width], init)
    np.testing.assert_array_equal(sd["values"][~part, -1], 0.0)


def test_slot_mask_matches_reference_single_chip(world):
    tkw = dict(embedding_dim=8)
    sd, m = _single(world, "port", tkw, slot_mask=(0, 1), passes=2)
    rsd, rm = _single(world, "ref", tkw, slot_mask=(0, 1), passes=2)
    _check_gated(sd, SparseTableConfig(**tkw), (0, 1))
    np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], rm["grad_norm"], rtol=1e-5)
    _assert_close(sd, rsd, 1e-6)


def test_slot_mask_matches_reference_multichip(world):
    """4 positions, 3 passes (the hot block routes in the third): excluded
    slots stay untouched, hot or cold, and the run agrees with the
    reference's."""
    tkw = dict(embedding_dim=8)
    sd, ms, _ = _sharded(world, "port", tkw, slot_mask=(1, 3))
    rsd, rms, _ = _sharded(world, "ref", tkw, slot_mask=(1, 3))
    assert ms[-1]["hot_occurrences"] > 0
    _check_gated(sd, SparseTableConfig(**tkw), (1, 3))
    for m, rm in zip(ms, rms):
        np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], rm["grad_norm"],
                                   rtol=1e-5)
    _assert_close(sd, rsd, 1e-6)


# --------------------------------------------------------------------------- #
# the LR map
# --------------------------------------------------------------------------- #
UNIFORM = tuple((s, 0.05) for s in range(N_SLOTS))


@pytest.mark.parametrize("path", ["single", "multichip"])
def test_uniform_lr_map_matches_scalar_lr(world, path):
    """An LR map giving every slot the default lr is bit-equal to the
    scalar path: the map's plumbing changes nothing."""
    base = dict(embedding_dim=8, learning_rate=0.05)
    mapped = dict(base, slot_learning_rates=UNIFORM)
    if path == "single":
        (sd1, m1), (sd2, m2) = (_single(world, "port", base),
                                _single(world, "port", mapped))
    else:
        sd1, m1, _ = _sharded(world, "port", base)
        sd2, m2, _ = _sharded(world, "port", mapped)
        m1, m2 = m1[-1], m2[-1]
    assert m1["loss"] == m2["loss"]
    np.testing.assert_array_equal(sd1["keys"], sd2["keys"])
    np.testing.assert_array_equal(sd1["values"], sd2["values"])


def _moved(sd, tconf):
    co, w = tconf.cvm_offset, tconf.row_width
    init = _key_uniform(sd["keys"], seed=0, n_cols=w - co,
                        rng_range=tconf.initial_range)
    moved = np.abs(sd["values"][:, co:w] - init).mean(axis=1)
    slot = _slot_of(sd["keys"])
    return moved[slot < 2].mean(), moved[slot >= 2].mean()


def test_per_slot_lr_matches_reference_single_chip(world):
    """Slots 2 and 3 at a 100x smaller lr move their embeddings far less,
    and the run agrees with the reference's."""
    tkw = dict(embedding_dim=8, learning_rate=0.05,
               slot_learning_rates=SLOW_LR)
    sd, m = _single(world, "port", tkw)
    rsd, rm = _single(world, "ref", tkw)
    fast, slow = _moved(sd, SparseTableConfig(**tkw))
    assert slow > 0 and fast > 20 * slow
    np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-5)
    _assert_close(sd, rsd, 1e-6)


def test_per_slot_lr_matches_reference_multichip(world):
    """The LR map through plan_group on 4 positions: the plan's serve_lr
    and hot_lr (probed on the third pass's first group, the hot block
    realized) equal the reference's, and the three passes agree."""
    tkw = dict(embedding_dim=8, learning_rate=0.05,
               slot_learning_rates=SLOW_LR)

    def probe(table, tr, group):
        plan = table.plan_group(group, slot_lr_vec=tr._slot_lr_vec,
                                n_slots=N_SLOTS)
        return plan.serve_lr, plan.hot_lr, plan.hot_occ

    sd, ms, (slr, hlr, hocc) = _sharded(world, "port", tkw, probe=probe)
    rsd, rms, (rslr, rhlr, rhocc) = _sharded(world, "ref", tkw, probe=probe)
    assert (hocc < hlr.shape[1]).any()  # the probe saw hot occurrences
    np.testing.assert_array_equal(hocc, rhocc)
    np.testing.assert_array_equal(hlr, rhlr)
    np.testing.assert_array_equal(slr, rslr)
    assert set(np.unique(hlr)) <= set(np.float32([0.0, 0.05, 0.0005]))
    fast, slow = _moved(sd, SparseTableConfig(**tkw))
    assert slow > 0 and fast > 20 * slow
    for m, rm in zip(ms, rms):
        np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-6)
    _assert_close(sd, rsd, 1e-6)
