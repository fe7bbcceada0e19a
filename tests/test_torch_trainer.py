"""The PyTorch port's slice as a whole: the same synthetic pass through both
packages' Trainer, the port's own end-to-end learning gate, import
hygiene, the card as the default device, and the options this slice does
not support.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import (
    DataFeedConfig,
    SparseTableConfig,
    TrainerConfig,
)
from paddlebox_tpu_torch.data.dataset import DatasetFactory, PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, DENSE, BATCH, EMB, HIDDEN = 4, 3, 64, 4, (16, 8)
# synth draws at most 3 keys per slot; 8 more make the largest power-of-two
# divisor 8, so the Pallas kernels (interpret mode) compile 8-row tiles
KCAP = BATCH * SLOTS * 3 + 8


@pytest.fixture(scope="module")
def synth_files(tmp_path_factory):
    return write_synth_files(
        str(tmp_path_factory.mktemp("slice")), n_files=2, ins_per_file=192,
        n_sparse_slots=SLOTS, vocab_per_slot=40, dense_dim=DENSE, seed=11,
    )


@pytest.mark.parametrize("use_pallas", [False, True])
def test_slice_matches_reference_trainer(synth_files, monkeypatch, use_pallas):
    """Per-step loss, the final table rows and g2sum after end_pass, and the
    AUC of a continued pass, from the reference's initial tower.  The
    reference runs with the Pallas kernels on (interpret mode) and off."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PARSER", "0")
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    ref_config.flags.set("use_pallas_sparse", use_pallas)
    try:
        tkw = dict(embedding_dim=EMB, learning_rate=0.2, initial_range=0.1,
                   plan_scratch_rows=KCAP)
        rconf = ref_config.SparseTableConfig(
            hbm_cache_rows=0, overlap_pass_boundary=False, **tkw)
        trkw = dict(dense_lr=1e-2, auc_buckets=1 << 10)
        ref_ds = RefDataset(ref_synth_config(SLOTS, DENSE, BATCH, 16,
                                             batch_key_capacity=KCAP),
                            read_threads=1)
        ref_table = RefTable(rconf, seed=3)
        ref_tr = RefTrainer(RefCtrDnn(SLOTS, rconf.row_width, dense_dim=DENSE,
                                      hidden=HIDDEN),
                            rconf, ref_config.TrainerConfig(**trkw), seed=4)
        tower = [{k: np.array(v) for k, v in layer.items()}
                 for layer in ref_tr.params["tower"]]

        pconf = SparseTableConfig(**tkw)
        ds = PadBoxSlotDataset(make_synth_config(SLOTS, DENSE, BATCH, 16,
                                                 batch_key_capacity=KCAP),
                               read_threads=1)
        table = SparseTable(pconf, seed=3, device="cpu")
        model = CtrDnn(SLOTS, pconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                       device="cpu")
        model.load_state_dict(params_from_jax(tower))
        tr = Trainer(model, pconf, TrainerConfig(**trkw), device="cpu")

        for d in (ref_ds, ds):
            d.set_filelist(synth_files)
            d.load_into_memory()
        # pass 1 one step at a time: per-step losses
        ref_table.begin_pass(ref_ds.unique_keys())
        table.begin_pass(ds.unique_keys())
        ref_losses = [ref_tr.train_steps(ref_table, [b])["loss"]
                      for b in ref_ds.batches()]
        losses = [tr.train_steps(table, [b])["loss"] for b in ds.batches()]
        ref_table.end_pass()
        table.end_pass()
        # pass 2 through train_from_dataset: the pass metrics
        ref_ds.local_shuffle(seed=1)
        ds.local_shuffle(seed=1)
        ref_table.begin_pass(ref_ds.unique_keys())
        table.begin_pass(ds.unique_keys())
        rm = ref_tr.train_from_dataset(ref_ds, ref_table)
        pm = tr.train_from_dataset(ds, table)
        ref_table.end_pass()
        table.end_pass()
    finally:
        ref_config.flags.set("use_pallas_sparse", False)
        ref_ds.close()
        ds.close()

    assert len(losses) == len(ref_losses) == 6
    # float32 sums and matmuls run in another order on the two CPU backends
    # (~1e-7 per op); over 12 steps of lr 0.2 that stays well under 1e-5
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)
    # a prediction that moves by ~1e-7 can cross one of 1024 bucket edges
    # and move the AUC by ~1/(pos*neg) ~ 1e-5; 1e-4 leaves room
    assert abs(pm["auc"] - rm["auc"]) < 1e-4
    assert pm["count"] == rm["count"] == 384
    rs, ps = ref_table.state_dict(), table.state_dict()
    np.testing.assert_array_equal(rs["keys"], ps["keys"])
    # rows: embeddings + g2sum within the same float32 drift, counters exact
    np.testing.assert_array_equal(ps["values"][:, :2], rs["values"][:, :2])
    np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5, atol=1e-6)
    assert table.missing_key_count == ref_table.missing_key_count == 0


@pytest.fixture(scope="module")
def e2e_synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e")
    paths = write_synth_files(
        str(d), n_files=2, ins_per_file=512, n_sparse_slots=3,
        vocab_per_slot=50, dense_dim=4, seed=7,
    )
    conf = make_synth_config(n_sparse_slots=3, dense_dim=4, batch_size=64,
                             max_feasigns_per_ins=16)
    return paths, conf


# Port of tests/test_e2e_train.py::test_e2e_loss_decreases_and_auc_beats_chance,
# in the same world: the same files, table config and seed, and the
# reference's initial tower (JAX PRNG, seed 0) carried across by weights.py,
# since a torch.Generator draws other numbers from the same seed.
def test_e2e_loss_decreases_and_auc_beats_chance(e2e_synth):
    paths, conf = e2e_synth
    ds = DatasetFactory().create_dataset("BoxPSDataset", conf)
    ds.set_filelist(paths)
    ds.load_into_memory()
    assert ds.get_memory_data_size() == 1024
    tconf = SparseTableConfig(embedding_dim=8, learning_rate=0.5,
                              initial_range=0.05)
    rconf = ref_config.SparseTableConfig(embedding_dim=8)
    ref_tr = RefTrainer(RefCtrDnn(3, rconf.row_width, dense_dim=4,
                                  hidden=(32, 16)),
                        rconf, ref_config.TrainerConfig(), seed=0)
    table = SparseTable(tconf, seed=0, device="cpu")
    model = CtrDnn(3, tconf.row_width, dense_dim=4, hidden=(32, 16),
                   device="cpu")
    model.load_state_dict(params_from_jax(
        [{k: np.array(v) for k, v in layer.items()}
         for layer in ref_tr.params["tower"]]))
    trainer = Trainer(model, tconf,
                      TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 12),
                      device="cpu")
    per_pass = []
    for p in range(4):
        ds.local_shuffle(seed=p)
        table.begin_pass(ds.unique_keys())
        per_pass.append(trainer.train_from_dataset(ds, table))
        table.end_pass()
    ds.close()
    losses = [m["loss"] for m in per_pass]
    assert losses[-1] < losses[0] * 0.9, f"loss did not decrease: {losses}"
    assert per_pass[-1]["auc"] > 0.65, f"AUC barely above chance: {per_pass[-1]}"
    assert table.n_features > 0
    assert table.missing_key_count == 0


# --------------------------------------------------------------------------- #
# import hygiene
# --------------------------------------------------------------------------- #
def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(REPO, "paddlebox_tpu_torch")):
        out += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return sorted(out)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    """In a fresh interpreter where importing jax or optax fails, every
    module of the port (and chip_smoke.py) imports, and no paddlebox_tpu.*
    module gets loaded."""
    mods = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'paddlebox_tpu'"
        " or m.startswith('paddlebox_tpu.') or m.startswith('jax.')"
        " or m.startswith('jaxlib'))\n"
        "assert not bad, bad\n"
        "assert 'paddlebox_tpu_torch.train.trainer' in sys.modules\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_port_sources_name_no_jax_or_reference_module():
    import re

    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|optax|paddlebox_tpu)(\.|\s|$)",
        re.MULTILINE,
    )
    for path in _port_sources():
        with open(path) as fh:
            hits = pat.findall(fh.read())
        assert not hits, f"{path}: {hits}"


# --------------------------------------------------------------------------- #
# the card is the default device
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("entry", ["table", "model", "trainer"])
def test_cuda_is_the_default_and_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    tconf = SparseTableConfig(embedding_dim=4)
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "table":
            SparseTable(tconf)
        elif entry == "model":
            CtrDnn(SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN)
        else:
            model = CtrDnn(SLOTS, tconf.row_width, dense_dim=DENSE,
                           hidden=HIDDEN, device="cpu")
            Trainer(model, tconf)


def test_trainer_rejects_a_model_on_another_device():
    tconf = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(SLOTS, tconf.row_width, hidden=HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        Trainer(model, tconf, device="meta")


# --------------------------------------------------------------------------- #
# the model-zoo options, refused until the zoo slice, construct
# --------------------------------------------------------------------------- #
def _zoo_option(case, pkg):
    """One option as a reference config or model names it, built by the
    port (pkg "port") or the reference (pkg "ref")."""
    row = 2 + EMB
    if case == "expand_dim":
        return (ref_config.SparseTableConfig if pkg == "ref" else
                SparseTableConfig)(expand_dim=4)
    if case == "counter_label_tasks":
        return (ref_config.TrainerConfig if pkg == "ref" else
                TrainerConfig)(counter_label_tasks=(1,))
    kw = (dict(layout="conv", cvm_offset=3) if case == "layout_conv"
          else dict(slot_embed_dims=((0, 2),)))
    if pkg == "ref":
        return RefCtrDnn(SLOTS, row + kw.get("cvm_offset", 2) - 2, **kw)
    return CtrDnn(SLOTS, row + kw.get("cvm_offset", 2) - 2, device="cpu",
                  **kw)


@pytest.mark.parametrize("case", [
    "expand_dim", "layout_conv", "counter_label_tasks", "slot_embed_dims",
])
def test_unsupported_options_raise_not_implemented(case):
    """The four options this test once held to a NotImplementedError
    (until the model-zoo slice ported them) now construct, each equal to
    the reference's for the same fields: the configs field by field, the
    models by their input accounting and per-slot column mask."""
    got, want = _zoo_option(case, "port"), _zoo_option(case, "ref")
    if case == "expand_dim":
        assert (got.expand_dim, got.cvm_offset, got.embedding_dim) == (
            want.expand_dim, want.cvm_offset, want.embedding_dim)
        assert got.row_width == want.row_width == 2 + 8 + 4
        return
    if case == "counter_label_tasks":
        assert tuple(got.counter_label_tasks) == tuple(
            want.counter_label_tasks) == (1,)
        return
    assert got.input_dim == want.input_dim
    assert (got.layout, got.show_filter) == (want.layout, want.show_filter)
    if case == "slot_embed_dims":
        np.testing.assert_array_equal(got._dim_mask.numpy(), want._dim_mask)
    else:
        assert got._dim_mask is None and want._dim_mask is None


@pytest.mark.parametrize("case", [
    "rank_offset", "sequence_slot", "multi_task", "pipe_command",
    "parse_logkey", "pv_merge", "parse_ins_id",
])
def test_data_options_construct(case):
    """The data options refused until the data half of item 3 construct,
    each as a reference config names it, and the reference's own config
    with the same field takes it too."""
    kw = {
        "rank_offset": dict(rank_offset="rank_offset", enable_pv_merge=True),
        "sequence_slot": dict(sequence_slot="slot0", max_seq_len=8),
        "multi_task": dict(n_task_labels=1),
        "pipe_command": dict(pipe_command="gzip -d"),
        "parse_logkey": dict(parse_logkey=True),
        "pv_merge": dict(enable_pv_merge=True, pv_batch_size=4),
        "parse_ins_id": dict(parse_ins_id=True),
    }[case]
    conf = make_synth_config(SLOTS, DENSE, BATCH, **kw)
    ref = ref_synth_config(SLOTS, DENSE, BATCH, **kw)
    assert conf.to_dict() == ref.to_dict()


def test_reference_flags_do_not_steer_the_port(monkeypatch):
    """Reference tests leave PBOX_* flags set in the environment; the port's
    flag shim reads only its own names: PBOX_HBM_CACHE=0 leaves the port's
    cache on, PADDLEBOX_TORCH_HBM_CACHE=0 turns it off."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "1")
    monkeypatch.setenv("PBOX_HBM_CACHE", "0")
    table = SparseTable(SparseTableConfig(), device="cpu")
    assert table.conf.hbm_cache_rows == 1 << 16
    assert len(table._caches()) == 1
    monkeypatch.setenv("PADDLEBOX_TORCH_HBM_CACHE", "0")
    table = SparseTable(SparseTableConfig(), device="cpu")
    assert table._caches() == []


def test_check_nan_inf_raises_on_a_poisoned_batch(tmp_path):
    from paddlebox_tpu_torch.train.trainer import NonFiniteBatchError

    files = write_synth_files(str(tmp_path), n_files=1, ins_per_file=64,
                              n_sparse_slots=SLOTS, dense_dim=DENSE, seed=2)
    ds = PadBoxSlotDataset(make_synth_config(SLOTS, DENSE, BATCH, 16),
                           read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=EMB)
    table = SparseTable(tconf, device="cpu")
    model = CtrDnn(SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   device="cpu")
    tr = Trainer(model, tconf, TrainerConfig(check_nan_inf=True), device="cpu")
    table.begin_pass(ds.unique_keys())
    (batch,) = list(ds.batches())
    batch.dense[0, 0] = np.nan
    with pytest.raises(NonFiniteBatchError):
        tr.train_steps(table, [batch])
    table.end_pass()
    ds.close()


def test_jax_stays_on_the_cpu_here():
    # the parity tests above compare against JAX on the CPU backend
    assert jax.devices()[0].platform == "cpu"
