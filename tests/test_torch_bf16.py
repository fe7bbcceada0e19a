"""The port's compute dtype of the dense tower (bfloat16, float16) against
the JAX package (port of tests/test_bf16.py): the cast policy at the layer
level (float32 logits, float32 parameters and gradients) and training
parity, where a bf16 or fp16 run lands within the reference's own bounds
of the float32 run (AUC 0.03, loss 0.05, test_bf16_training_parity) and of
the reference's run in the same dtype.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.models.layers import init_mlp
from paddlebox_tpu.models.layers import mlp as ref_mlp
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.models.layers import (
    apply_compute_dtype_override,
    make_mlp,
    mlp,
    resolve_compute_dtype,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

B, S, DENSE = 64, 4, 3
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def test_resolve_compute_dtype(monkeypatch):
    assert resolve_compute_dtype("float32") is None
    assert resolve_compute_dtype("bf16") is torch.bfloat16
    assert resolve_compute_dtype("bfloat16") is torch.bfloat16
    assert resolve_compute_dtype("fp16") is torch.float16
    assert resolve_compute_dtype() is None  # the flag's default is float32
    monkeypatch.setenv("PADDLEBOX_TORCH_COMPUTE_DTYPE", "bf16")
    assert resolve_compute_dtype("") is torch.bfloat16
    with pytest.raises(ValueError):
        resolve_compute_dtype("int8")


def _tower(in_dim=16, hidden=(32, 16)):
    params = init_mlp(jax.random.PRNGKey(0), in_dim, hidden, 1)
    tower = make_mlp(in_dim, hidden, 1, torch.Generator().manual_seed(0),
                     "cpu")
    state = {k.replace("tower.", ""): v for k, v in params_from_jax(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in params]).items()}
    tower.load_state_dict(state)
    return params, tower


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_mlp_in_compute_dtype_close_to_f32_and_returns_f32(name):
    """One cast in, one cast out: float32 logits close to the float32
    tower's (the reference's bound, 0.15) and to the reference's own
    tower in the same dtype (a few of its ulps)."""
    tdt, jdt = DTYPES[name]
    params, tower = _tower()
    x = np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32)
    out32 = mlp(tower, torch.from_numpy(x))
    out = mlp(tower, torch.from_numpy(x), tdt)
    assert out.dtype == torch.float32  # logits upcast before the loss
    np.testing.assert_allclose(out.detach().numpy(), out32.detach().numpy(),
                               atol=0.15)
    ref = np.asarray(ref_mlp(params, jnp.asarray(x), jdt))
    np.testing.assert_allclose(out.detach().numpy(), ref,
                               atol=0.02 if name == "bfloat16" else 2e-3)


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_grads_and_params_stay_f32(name):
    tdt, _ = DTYPES[name]
    _, tower = _tower(8, (16,))
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32))
    mlp(tower, x, tdt).sum().backward()
    for p in tower.parameters():
        assert p.dtype == torch.float32
        assert p.grad.dtype == torch.float32  # the cast's transpose


def test_trainer_config_overrides_the_model():
    """TrainerConfig.compute_dtype sets the model's (the trainer owns the
    training-time policy); a model without the attribute warns."""
    tconf = SparseTableConfig(embedding_dim=8)
    model = CtrDnn(S, tconf.row_width, hidden=(8,), device="cpu")
    assert model.compute_dtype is None
    Trainer(model, tconf, TrainerConfig(compute_dtype="bf16"), device="cpu")
    assert model.compute_dtype is torch.bfloat16

    class Bare(torch.nn.Module):
        n_sparse_slots = S

    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        apply_compute_dtype_override(Bare(), "bf16")
    assert any("ignored" in str(w.message) for w in got)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_synth_files(
        str(tmp_path_factory.mktemp("bf16")), n_files=2, ins_per_file=256,
        n_sparse_slots=S, vocab_per_slot=100, dense_dim=DENSE, seed=3,
    )


def _train(files, side, compute_dtype, n_passes=3):
    """test_bf16.py's _train_auc, in either package, from the reference's
    seed-0 tower."""
    conf_kw = dict(n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
                   max_feasigns_per_ins=16)
    rconf = ref_config.SparseTableConfig(embedding_dim=8)
    rtr = RefTrainer(RefCtrDnn(S, rconf.row_width, dense_dim=DENSE,
                               hidden=(32, 16)), rconf,
                     ref_config.TrainerConfig(auc_buckets=1 << 12,
                                              compute_dtype=compute_dtype),
                     seed=0)
    if side == "ref":
        ds = RefDataset(ref_synth_config(**conf_kw), read_threads=2)
        table, tr = RefTable(rconf, seed=0), rtr
    else:
        tconf = SparseTableConfig(embedding_dim=8)
        model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(32, 16),
                       device="cpu")
        model.load_state_dict(params_from_jax(
            [{k: np.asarray(v) for k, v in layer.items()}
             for layer in rtr.params["tower"]]))
        ds = PadBoxSlotDataset(make_synth_config(**conf_kw), read_threads=2)
        table = SparseTable(tconf, seed=0, device="cpu")
        tr = Trainer(model, tconf, TrainerConfig(
            auc_buckets=1 << 12, compute_dtype=compute_dtype), device="cpu")
    ds.set_filelist(files)
    ds.load_into_memory()
    metrics = {}
    for _ in range(n_passes):
        table.begin_pass(ds.unique_keys())
        metrics = tr.train_from_dataset(ds, table)
        table.end_pass()
    ds.close()
    if side == "port":
        table.close()
        for p in tr.model.parameters():
            assert p.dtype == torch.float32
        for st in tr.optimizer.state.values():
            assert st["exp_avg"].dtype == torch.float32
    return metrics


@pytest.fixture(scope="module")
def f32_run(files):
    return _train(files, "port", "float32")


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_training_parity(files, f32_run, name):
    """Port of test_bf16_training_parity: three passes in the compute
    dtype land within the reference's bounds of the float32 run, and of
    the reference's run in the same dtype."""
    m = _train(files, "port", name)
    rm = _train(files, "ref", name)
    assert np.isfinite(m["loss"])
    for other in (f32_run, rm):
        assert abs(other["auc"] - m["auc"]) < 0.03, (other["auc"], m["auc"])
        assert abs(other["loss"] - m["loss"]) < 0.05
