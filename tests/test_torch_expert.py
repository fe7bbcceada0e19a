"""Expert parallelism of the port against the JAX package, on the CPU:
parallel/expert.py and MMoE's ``expert_mesh`` (models/mmoe.py).

  * ``serial_expert_forward``, ``expert_parallel_forward``,
    ``mix_local_experts`` and ``expert_parallel_mlp_mix`` against the
    reference's, the sharded ones under ``shard_map`` on 4 forced CPU
    devices, forward and gradients;
  * MMoE on 4 ``expert`` positions against the reference's MMoE on a
    4-device expert mesh and against the port's serial bank, in float32 and
    bf16; its errors;
  * two Trainer passes of the expert-parallel MMoE against the JAX Trainer
    with the reference's expert-parallel MMoE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as PS

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
import paddlebox_tpu.parallel.expert as ref_ep
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu.utils.jax_compat import shard_map
import paddlebox_tpu_torch.models as models
import paddlebox_tpu_torch.parallel.expert as ep
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.parallel import make_mesh
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

P, E, B, D_IN, D_HID, T = 4, 8, 16, 6, 5, 2
TOL = dict(rtol=1e-5, atol=1e-6)
EX = ref_ep.EXPERT_AXIS


def _jax_mesh(p=P):
    return JaxMesh(np.array(jax.devices()[:p]), (EX,))


def _mesh(p=P):
    return make_mesh(p, device="cpu", axis_name="expert")


def _local(x, axis):
    """[..., E, ...] -> [P, ..., E/P, ...]: position p's experts along
    ``axis``, the layout of the reference's ``P(..., "expert")`` spec."""
    parts = torch.chunk(torch.as_tensor(x), P, dim=axis)
    return torch.stack(parts)


def test_single_layer_expert_functions_match_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(E, D_IN, D_HID)).astype(np.float32)
    b = rng.normal(size=(E, D_HID)).astype(np.float32)
    x = rng.normal(size=(B, D_IN)).astype(np.float32)
    gates = jax.nn.softmax(rng.normal(size=(B, E)).astype(np.float32), -1)
    gates = np.array(gates)
    cot = rng.normal(size=(B, D_HID)).astype(np.float32)
    sharded = jax.jit(shard_map(
        ref_ep.expert_parallel_forward, mesh=_jax_mesh(),
        in_specs=(PS(EX), PS(EX), PS(), PS(None, EX)), out_specs=PS()))

    def loss(f, w_, b_, x_, g_):
        out = f(w_, b_, x_, g_)
        return (out * cot).sum(), out

    grads = {}
    for name, f in (("serial", ref_ep.serial_expert_forward),
                    ("sharded", sharded)):
        grads[name] = jax.value_and_grad(
            lambda *a: loss(f, *a), argnums=(0, 1, 2, 3), has_aux=True)(
            w, b, x, gates)
    tw, tb, tx, tg = (torch.from_numpy(a).requires_grad_(True)
                      for a in (w, b, x, gates))
    got = ep.serial_expert_forward(tw, tb, tx, tg)
    (got * torch.from_numpy(cot)).sum().backward()
    (_, want), want_g = grads["serial"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, wg in zip((tw.grad, tb.grad, tx.grad, tg.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)
    for t in (tw, tb, tx, tg):
        t.grad = None
    got = ep.expert_parallel_forward(_local(tw, 0), _local(tb, 0), tx,
                                     _local(tg, 1))
    assert got.shape == (P, B, D_HID)
    assert all(torch.equal(got[0], got[p]) for p in range(P))
    (got[0] * torch.from_numpy(cot)).sum().backward()
    (_, want), want_g = grads["sharded"]
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want),
                               **TOL)
    for g, wg in zip((tw.grad, tb.grad, tx.grad, tg.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("gate_dims", [2, 3])
def test_mix_and_mlp_mix_match_reference(gate_dims):
    rng = np.random.default_rng(1)
    h = rng.normal(size=(E, B, D_HID)).astype(np.float32)
    gshape = (B, E) if gate_dims == 2 else (T, B, E)
    gates = rng.random(size=gshape).astype(np.float32)
    spec = PS(None, EX) if gate_dims == 2 else PS(None, None, EX)
    want = shard_map(ref_ep.mix_local_experts, mesh=_jax_mesh(),
                     in_specs=(PS(EX), spec), out_specs=PS())(h, gates)
    got = ep.mix_local_experts(_local(h, 0), _local(gates, gate_dims - 1))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)
    if gate_dims == 2:
        return
    layers = [{"w": rng.normal(size=(E, a, c)).astype(np.float32) * 0.5,
               "b": rng.normal(size=(E, c)).astype(np.float32)}
              for a, c in ((D_IN, 7), (7, D_HID))]
    x = rng.normal(size=(B, D_IN)).astype(np.float32)
    want = jax.jit(shard_map(
        ref_ep.expert_parallel_mlp_mix, mesh=_jax_mesh(),
        in_specs=(PS(EX), PS(), spec), out_specs=PS()))(layers, x, gates)
    got = ep.expert_parallel_mlp_mix(
        [{k: _local(v, 0) for k, v in layer.items()} for layer in layers],
        torch.from_numpy(x), _local(gates, 2))
    assert got.dtype == torch.float32 and got.shape == (P, T, B, D_HID)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------- #
# MMoE with expert_mesh
# --------------------------------------------------------------------------- #
S, DENSE, MB = 3, 2, 32
KW = dict(dense_dim=DENSE, n_tasks=2, n_experts=4, expert_hidden=(16,),
          expert_dim=8, tower_hidden=(8,))


def _mmoe_inputs(width=6):
    rng = np.random.default_rng(3)
    K = MB * S * 2
    rows = np.zeros((K, width), np.float32)
    n = K - 10
    show = rng.integers(0, 9, size=n)
    rows[:n, 0] = show
    rows[:n, 1] = rng.integers(0, show + 1)
    rows[:n, 2:] = rng.normal(scale=0.5, size=(n, width - 2))
    segs = np.full(K, MB * S, np.int32)
    segs[:n] = np.sort(rng.integers(0, MB * S, size=n))
    return rows, segs, rng.normal(size=(MB, DENSE)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["", "bfloat16"])
def test_mmoe_expert_mesh_matches_reference(dtype):
    """Logits and gradients against the reference's expert-parallel MMoE
    (float32: the zoo's tolerance, gradients atol 1e-5; bf16: its own bf16
    bound, 2e-2) and against the port's serial bank (2e-5, the reference
    test's bound)."""
    ref = ref_models.MMoE(S, 6, expert_mesh=_jax_mesh(), compute_dtype=dtype,
                          **KW)
    port = models.MMoE(S, 6, expert_mesh=_mesh(), compute_dtype=dtype,
                       device="cpu", **KW)
    serial = models.MMoE(S, 6, compute_dtype=dtype, device="cpu", **KW)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(1)))
    state = params_from_jax_tree(params)
    port.load_state_dict(state)
    serial.load_state_dict(state)
    rows, segs, dense = _mmoe_inputs()
    cot = np.random.default_rng(4).normal(size=(MB, 2)).astype(np.float32)

    def loss(p, r):
        out = ref.apply(p, r, jnp.asarray(segs), jnp.asarray(dense), MB)
        return (out * cot).sum(), out

    (_, want), (gp, gr) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(rows))
    r = torch.from_numpy(rows).requires_grad_(True)
    args = (torch.from_numpy(segs), torch.from_numpy(dense), MB)
    got = port(r, *args)
    assert got.shape == (MB, 2) and got.dtype == torch.float32
    ftol = TOL if not dtype else dict(rtol=2e-2, atol=2e-2)
    gtol = dict(rtol=1e-5, atol=1e-5) if not dtype else ftol
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ftol)
    np.testing.assert_allclose(got.detach().numpy(),
                               serial(torch.from_numpy(rows), *args)
                               .detach().numpy(), rtol=2e-5, atol=2e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr), **gtol)
    want_g = params_from_jax_tree(jax.tree.map(np.asarray, gp))
    named = dict(port.named_parameters())
    assert set(named) == set(want_g)
    for name, prm in named.items():
        np.testing.assert_allclose(prm.grad.numpy(), want_g[name].numpy(),
                                   err_msg=name, **gtol)


def test_mmoe_expert_mesh_errors():
    with pytest.raises(ValueError, match="n_experts 6 not divisible"):
        models.MMoE(S, 6, n_experts=6, expert_mesh=_mesh(), device="cpu")
    with pytest.raises(ValueError, match="needs a 'expert' axis"):
        models.MMoE(S, 6, n_experts=4, expert_mesh=make_mesh(4, device="cpu"),
                    device="cpu")
    m = models.MMoE(S, 6, n_experts=4, expert_mesh="inherit", device="cpu")
    rows, segs, dense = _mmoe_inputs()
    with pytest.raises(ValueError, match="make_composed_mesh"):
        m(torch.from_numpy(rows), torch.from_numpy(segs),
          torch.zeros((MB, 0)), MB)


def test_mmoe_expert_mesh_trainer_matches_reference(tmp_path, monkeypatch):
    """Two passes: per-pass loss at rtol 1e-5, AUC and the task AUCs within
    two bucket crossings, the table's rows at rtol 1e-5 / atol 1e-6."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PARSER", "0")
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    files = write_synth_files(str(tmp_path), n_files=1, ins_per_file=128,
                              n_sparse_slots=S, vocab_per_slot=50,
                              dense_dim=DENSE, seed=4, n_task_labels=1)
    tkw = dict(embedding_dim=4, learning_rate=0.2, initial_range=0.1)
    trkw = dict(dense_lr=1e-2, auc_buckets=1 << 10)
    rconf = ref_config.SparseTableConfig(hbm_cache_rows=0,
                                         overlap_pass_boundary=False, **tkw)
    conf = SparseTableConfig(**tkw)
    ref_tr = RefTrainer(ref_models.MMoE(S, rconf.row_width,
                                        expert_mesh=_jax_mesh(), **KW),
                        rconf, ref_config.TrainerConfig(**trkw), seed=4)
    model = models.MMoE(S, conf.row_width, expert_mesh=_mesh(), device="cpu",
                        **KW)
    model.load_state_dict(params_from_jax_tree(
        jax.tree.map(np.array, ref_tr.params)))
    tr = Trainer(model, conf, TrainerConfig(**trkw), device="cpu")
    worlds = []
    for mk, cls, t, tb in ((ref_synth_config, RefDataset, ref_tr,
                            RefTable(rconf, seed=3)),
                           (make_synth_config, PadBoxSlotDataset, tr,
                            SparseTable(conf, seed=3, device="cpu"))):
        ds = cls(mk(S, DENSE, MB, 8, n_task_labels=1), read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        worlds.append((ds, t, tb))
    try:
        for _ in range(2):
            (rds, rt, rtb), (ds, t, tb) = worlds
            out = []
            for d, tt, tbl in ((rds, rt, rtb), (ds, t, tb)):
                tbl.begin_pass(d.unique_keys())
                out.append(tt.train_from_dataset(d, tbl))
                tbl.end_pass()
            rm, m = out
            assert m["steps"] == rm["steps"] and m["count"] == rm["count"] > 0
            np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-5)
            for key in ("auc", "task0/auc", "task1/auc"):
                t_ = key.split("/")[0] + "/" if "/" in key else ""
                pos = round(rm[f"{t_}actual_ctr"] * rm[f"{t_}count"])
                bound = 2.0 / max(pos * (rm[f"{t_}count"] - pos), 1)
                assert abs(m[key] - rm[key]) <= bound, key
        rs, ps = worlds[0][2].state_dict(), worlds[1][2].state_dict()
        np.testing.assert_array_equal(ps["keys"], rs["keys"])
        np.testing.assert_array_equal(ps["values"][:, :2], rs["values"][:, :2])
        np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5,
                                   atol=1e-6)
    finally:
        for ds, _, _ in worlds:
            ds.close()
        worlds[1][2].close()
