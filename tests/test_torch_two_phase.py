"""The port's TwoPhaseTrainer (train/two_phase.py) against the JAX
package's, on the CPU (reference: tests/test_two_phase.py).

Join (slots 0 and 1) then update (slots 2 and 3) over the same data, each
phase its own CtrDnn from the reference trainer's seeded parameters:

  * the phase state API (phase, phase_name, phase_num, flip, set) and its
    errors;
  * two passes single-chip: per phase equal counts and steps, loss within
    rtol 1e-5 and AUC within two bucket crossings, the per-phase dense
    states within rtol 1e-5 / atol 1e-6 and the shared table's keys and
    counters equal, its rows within rtol 1e-5 / atol 1e-6
    (test_torch_models.py's bounds); the streams are per phase and carry
    across passes;
  * the same with ``mesh=`` on 4 CPU positions against the reference's
    MultiChipTrainer phases on 4 forced CPU devices, at
    test_torch_multiprocess.py's tolerances (equal counts, loss within rtol
    1e-4, AUC within 2e-3, equal feature totals);
  * PV gating: a ``use_pv`` phase refuses flat data, and a flat phase on a
    PV-merged dataset trains on instances and restores the PV grouping
    untouched; a PV join (RankCtrDnn) and flat update on the mesh;
  * excluded slots train nothing (zero counters, the key-deterministic
    init kept), and one phase with no mask is a plain Trainer bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train import PhaseSpec as RefPhase
from paddlebox_tpu.train import TwoPhaseTrainer as RefTwoPhase
import paddlebox_tpu_torch.models as models
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.parallel import ShardedSparseTable, make_mesh
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import PhaseSpec, Trainer, TwoPhaseTrainer
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

N_SLOTS, DENSE, B, VOCAB, N_POS = 4, 4, 32, 60, 4
EMB = 8
TRKW = dict(auc_buckets=1 << 10, dense_lr=3e-3)
SLOTS = {"join": (0, 1), "update": (2, 3)}
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_synth_files(
        str(tmp_path_factory.mktemp("twophase")), n_files=2,
        ins_per_file=2 * B, n_sparse_slots=N_SLOTS, vocab_per_slot=VOCAB,
        dense_dim=DENSE, seed=11)


@pytest.fixture(autouse=True)
def _numpy_planners(monkeypatch):
    for k in NATIVE_FLAGS:
        monkeypatch.setenv(k, "0")


def _conf(batch=B):
    return dict(n_sparse_slots=N_SLOTS, dense_dim=DENSE, batch_size=batch,
                batch_key_capacity=batch * N_SLOTS * 4)


def _load(cls, conf_fn, files, batch=B):
    ds = cls(conf_fn(**_conf(batch)), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _ref_phases(tconf):
    return [RefPhase(n, ref_models.CtrDnn(N_SLOTS, tconf.row_width,
                                          dense_dim=DENSE, hidden=(16,)),
                     slots=SLOTS[n]) for n in ("join", "update")]


def _port_phases(tconf, params):
    out = []
    for n in ("join", "update"):
        model = models.CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE,
                              hidden=(16,), device="cpu")
        model.load_state_dict(params_from_jax_tree(params[n]))
        out.append(PhaseSpec(n, model, slots=SLOTS[n]))
    return out


def _run(tp, table, ds, passes=2):
    out = []
    for _ in range(passes):
        table.begin_pass(ds.unique_keys())
        out.append(tp.train_pass(ds, table))
        table.end_pass()
        assert tp.phase == 0
    return out


def _auc_close(m, rm):
    pos = round(rm["actual_ctr"] * rm["count"])
    return abs(m["auc"] - rm["auc"]) <= 2.0 / max(pos * (rm["count"] - pos), 1)


def test_phase_state_api():
    tconf = SparseTableConfig(embedding_dim=EMB)
    mk = lambda: models.CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE,
                               hidden=(16,), device="cpu")
    tp = TwoPhaseTrainer([PhaseSpec("join", mk()), PhaseSpec("update", mk())],
                         tconf, TrainerConfig(auc_buckets=1 << 10),
                         device="cpu")
    assert tp.phase == 0 and tp.phase_name == "join" and tp.phase_num == 2
    tp.flip_phase()
    assert tp.phase == 1 and tp.phase_name == "update"
    tp.flip_phase()
    assert tp.phase == 0
    tp.set_phase(1)
    assert tp.phase_name == "update"
    with pytest.raises(ValueError):
        tp.set_phase(2)
    with pytest.raises(ValueError, match="duplicate"):
        TwoPhaseTrainer([PhaseSpec("x", mk()), PhaseSpec("x", mk())], tconf,
                        device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        TwoPhaseTrainer([], tconf, device="cpu")
    tp.close()


def test_single_chip_matches_the_reference(files):
    rconf = ref_config.SparseTableConfig(embedding_dim=EMB, hbm_cache_rows=0,
                                         overlap_pass_boundary=False)
    rtp = RefTwoPhase(_ref_phases(rconf), rconf,
                      ref_config.TrainerConfig(**TRKW), seed=0)
    params = {n: jax.tree.map(np.array, rtp.trainers[n].params)
              for n in SLOTS}
    tconf = SparseTableConfig(embedding_dim=EMB)
    tp = TwoPhaseTrainer(_port_phases(tconf, params), tconf,
                         TrainerConfig(**TRKW), device="cpu")
    ds = _load(PadBoxSlotDataset, make_synth_config, files)
    rds = _load(RefDataset, ref_synth_config, files)
    table, rtable = SparseTable(tconf, device="cpu"), RefTable(rconf)
    try:
        got, want = _run(tp, table, ds), _run(rtp, rtable, rds)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"join", "update"}
            for n in SLOTS:
                assert g[n]["count"] == w[n]["count"] > 0
                assert g[n]["steps"] == w[n]["steps"]
                np.testing.assert_allclose(g[n]["loss"], w[n]["loss"],
                                           rtol=1e-5)
                assert _auc_close(g[n], w[n]), (g[n]["auc"], w[n]["auc"])
        # the streams are per phase and carried across the passes
        for n in SLOTS:
            assert got[1][n]["count"] == 2 * got[0][n]["count"]
        assert tp.metrics("join")["join"] is not tp.metrics()["update"]
        for n in SLOTS:
            want_p = params_from_jax_tree(jax.tree.map(
                np.array, rtp.trainers[n].params))
            for k, v in tp.dense_states()[n][0].items():
                np.testing.assert_allclose(v.numpy(), want_p[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
        st, rst = table.state_dict(), rtable.state_dict()
        np.testing.assert_array_equal(st["keys"], rst["keys"])
        np.testing.assert_array_equal(st["values"][:, :2],
                                      rst["values"][:, :2])
        np.testing.assert_allclose(st["values"], rst["values"], rtol=1e-5,
                                   atol=1e-6)
    finally:
        table.close()
        rtable.close()
        ds.close()
        rds.close()
        tp.close()


def test_mesh_matches_the_reference(files):
    assert len(jax.devices()) >= N_POS, "conftest forces the CPU devices"
    rconf = ref_config.SparseTableConfig(embedding_dim=EMB)
    rmesh = ref_make_mesh(N_POS)
    rtp = RefTwoPhase(_ref_phases(rconf), rconf,
                      ref_config.TrainerConfig(**TRKW), seed=0, mesh=rmesh)
    params = {n: jax.tree.map(np.array, rtp.trainers[n].dense_state()[0])
              for n in SLOTS}
    tconf = SparseTableConfig(embedding_dim=EMB)
    mesh = make_mesh(N_POS, device="cpu")
    tp = TwoPhaseTrainer(_port_phases(tconf, params), tconf,
                         TrainerConfig(**TRKW), mesh=mesh)
    ds = _load(PadBoxSlotDataset, make_synth_config, files, B // N_POS)
    rds = _load(RefDataset, ref_synth_config, files, B // N_POS)
    table = ShardedSparseTable(tconf, mesh, seed=0)
    rtable = RefShardedTable(rconf, rmesh, seed=0)
    try:
        got, want = _run(tp, table, ds), _run(rtp, rtable, rds)
        for g, w in zip(got, want):
            for n in SLOTS:
                assert g[n]["count"] == w[n]["count"] > 0
                assert np.isclose(g[n]["loss"], w[n]["loss"], rtol=1e-4)
                assert abs(g[n]["auc"] - w[n]["auc"]) < 2e-3
        assert table.n_features == rtable.n_features
        # the phase gating through the sharded pull and push: every slot
        # took traffic in the pass, from the phase that owns it
        st = table.state_dict()
        slot = (np.asarray(st["keys"], np.int64) - 1) // VOCAB
        for s in range(N_SLOTS):
            assert st["values"][slot == s, 0].sum() > 0
    finally:
        table.close()
        rtable.close()
        ds.close()
        rds.close()
        tp.close()


def test_pv_gating(tmp_path):
    """A use_pv phase refuses a flat dataset; a PV join (RankCtrDnn) and a
    flat update on the 4-position mesh train, and the flat phase leaves
    the PV grouping exactly as it found it."""
    conf = make_synth_config(
        n_sparse_slots=3, dense_dim=2, batch_size=8,
        max_feasigns_per_ins=16, parse_logkey=True, enable_pv_merge=True,
        pv_batch_size=4, rank_cmatch_filter=(222, 223),
        rank_offset="rank_offset")
    fs = write_synth_files(str(tmp_path), n_files=2, ins_per_file=96,
                           n_sparse_slots=3, vocab_per_slot=50, dense_dim=2,
                           seed=3, with_logkey=True, max_ads_per_pv=3)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(fs)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=4)
    mesh = make_mesh(N_POS, device="cpu")
    join = models.RankCtrDnn(3, tconf.row_width, dense_dim=2, hidden=(16,),
                             max_rank=conf.max_rank, att_out_dim=8,
                             device="cpu")
    upd = models.CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(16,),
                        device="cpu")
    tp = TwoPhaseTrainer([PhaseSpec("join", join, slots=(0, 1), use_pv=True),
                          PhaseSpec("update", upd, slots=(2,))],
                         tconf, TrainerConfig(auc_buckets=1 << 10),
                         mesh=mesh)
    table = ShardedSparseTable(tconf, mesh, seed=0)
    try:
        table.begin_pass(ds.unique_keys())
        with pytest.raises(RuntimeError, match="PV batches"):
            tp.train_phase(ds, table)
        table.abort_pass()
        ds.preprocess_instance()
        before = ds.pv_state()
        for _ in range(2):
            table.begin_pass(ds.unique_keys())
            m = tp.train_pass(ds, table)
            table.end_pass()
        after = ds.pv_state()
        assert ds.pv_mode
        for a, b in zip(before, after):
            np.testing.assert_array_equal(a, b)
        assert np.isfinite(m["join"]["loss"]) and np.isfinite(
            m["update"]["loss"])
        assert m["join"]["count"] == m["update"]["count"] > 0
    finally:
        table.close()
        ds.close()
        tp.close()


def test_excluded_slots_train_nothing(files):
    tconf = SparseTableConfig(embedding_dim=EMB)
    tp = TwoPhaseTrainer(
        [PhaseSpec("join", models.CtrDnn(N_SLOTS, tconf.row_width,
                                         dense_dim=DENSE, hidden=(16,),
                                         device="cpu"), slots=(0, 1))],
        tconf, TrainerConfig(auc_buckets=1 << 10), device="cpu")
    table = SparseTable(tconf, device="cpu")
    ds = _load(PadBoxSlotDataset, make_synth_config, files)
    try:
        _run(tp, table, ds, passes=1)
        sd = table.state_dict()
        in_phase = sd["keys"] <= np.uint64(2 * VOCAB)
        assert sd["values"][in_phase, 0].sum() > 0
        np.testing.assert_array_equal(sd["values"][~in_phase, :2], 0.0)
        np.testing.assert_array_equal(sd["values"][~in_phase, -1], 0.0)
        # the key-deterministic init of the excluded rows: a fresh table
        # resolving the same keys holds the same embedding columns
        fresh = SparseTable(tconf, device="cpu")
        fresh.begin_pass(sd["keys"][~in_phase])
        fresh.end_pass()
        np.testing.assert_array_equal(
            fresh.state_dict()["values"][:, tconf.cvm_offset:tconf.row_width],
            sd["values"][~in_phase, tconf.cvm_offset:tconf.row_width])
        fresh.close()
    finally:
        table.close()
        ds.close()


def test_one_phase_is_a_plain_trainer(files):
    tconf = SparseTableConfig(embedding_dim=EMB)
    trconf = TrainerConfig(auc_buckets=1 << 10)

    def run(phased):
        model = models.CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE,
                              hidden=(16,), device="cpu", seed=0)
        table = SparseTable(tconf, device="cpu")
        ds = _load(PadBoxSlotDataset, make_synth_config, files)
        table.begin_pass(ds.unique_keys())
        if phased:
            tp = TwoPhaseTrainer([PhaseSpec("only", model)], tconf, trconf,
                                 device="cpu")
            m = tp.train_pass(ds, table)["only"]
            tp.close()
        else:
            m = Trainer(model, tconf, trconf, device="cpu").train_from_dataset(
                ds, table)
        table.end_pass()
        state = table.state_dict()
        table.close()
        ds.close()
        return m, state

    (a, sa), (b, sb) = run(False), run(True)
    assert (a["loss"], a["auc"]) == (b["loss"], b["auc"])
    np.testing.assert_array_equal(sa["values"], sb["values"])
