"""Pipeline parallelism of the port against the JAX package, on the CPU:
the GPipe schedule and PipelineTrainer (parallel/pipeline.py), and
PipelinedCtrDnn (models/pipelined_ctr.py), on 4 pipe positions.

  * ``gpipe_run``'s forward loss against the reference's
    ``pipeline_forward_loss`` under ``shard_map`` and against the
    sequential ``reference_forward_loss``;
  * a PipelineTrainer SGD step against one SGD step on the gradient of the
    reference's sequential oracle, ``jax.grad(reference_forward_loss)``:
    the port's step takes the true gradient (the reference's own
    ``train_step`` applies 1/P of it on this jax, so it is not the oracle);
    Adam training lowers the loss;
  * ``_split_stages``, the pack / unpack round trip through a CtrDnn tower;
  * PipelinedCtrDnn's logits and gradients against a CtrDnn holding the
    same layers and against the reference's PipelinedCtrDnn; two Trainer
    passes against the JAX Trainer; the ``B % M`` error; bf16;
  * the parameter trees of this slice's models (TwoTower, LongSeqCtrDnn,
    PipelinedCtrDnn, PipelineTrainer's stacked stages) carried across by
    ``weights.params_from_jax_tree``, written by ``dump_params`` under the
    reference's key paths and read back from a reference file by
    ``load_pytree``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PS

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.parallel.pipeline as ref_pipe
import paddlebox_tpu.models as ref_models
from paddlebox_tpu.checkpoint import save_pytree as ref_save_pytree
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models.pipelined_ctr import PipelinedCtrDnn as RefPipelinedCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.dump import dump_params as ref_dump_params
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu.utils.jax_compat import shard_map
import paddlebox_tpu_torch.models as models
import paddlebox_tpu_torch.parallel.pipeline as pipe
from paddlebox_tpu_torch.checkpoint import load_pytree
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn, PipelinedCtrDnn
from paddlebox_tpu_torch.models.layers import apply_compute_dtype_override
from paddlebox_tpu_torch.models.pipelined_ctr import _split_stages
from paddlebox_tpu_torch.parallel import make_mesh
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train.dump import dump_params
from paddlebox_tpu_torch.weights import params_from_jax_tree, params_to_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

P_STAGES, M, MB, D_IN, WIDTH = 4, 8, 16, 10, 32
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:P_STAGES]), (ref_pipe.PIPE_AXIS,))


def _mesh():
    return make_mesh(P_STAGES, device="cpu", axis_name="pipe")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, MB, D_IN)).astype(np.float32)
    y = (x.mean(-1) > 0).astype(np.float32)
    mask = np.ones((M, MB), np.float32)
    mask[-1, MB // 2:] = 0.0  # a ragged tail microbatch
    return x, y, mask


def _ref_params(seed):
    return jax.tree.map(np.asarray, ref_pipe.init_pipeline_params(
        jax.random.PRNGKey(seed), D_IN, WIDTH, 2, P_STAGES))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_forward_matches_reference_pipeline():
    params = _ref_params(0)
    x, y, mask = _data()
    piped = jax.jit(shard_map(
        lambda p, a, b, c: ref_pipe.pipeline_forward_loss(
            jax.tree.map(lambda l: l[0], p), a, b, c)[None],
        mesh=_jax_mesh(), in_specs=(PS(ref_pipe.PIPE_AXIS), PS(), PS(), PS()),
        out_specs=PS(ref_pipe.PIPE_AXIS)))
    shard = NamedSharding(_jax_mesh(), PS(ref_pipe.PIPE_AXIS))
    want = np.asarray(piped(jax.device_put(params, shard), x, y, mask))
    got = pipe.pipeline_forward_loss(_t(params), *map(torch.from_numpy,
                                                      (x, y, mask)))
    assert got.shape == (P_STAGES,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    seq = pipe.reference_forward_loss(_t(params), *map(torch.from_numpy,
                                                       (x, y, mask)))
    want_seq = ref_pipe.reference_forward_loss(
        jax.tree.map(jnp.asarray, params), x, y, mask)
    np.testing.assert_allclose(float(seq), float(want_seq), **TOL)
    np.testing.assert_allclose(got.numpy(), float(seq), rtol=1e-5)


def test_gpipe_run_schedule():
    """The emissions: microbatch t - (P-1) at tick t on the last stage,
    zeros elsewhere; the chain shift drops the last stage's output."""
    n, m = 3, 4
    act0 = torch.zeros((n, 1))

    def stage_fn(m_in, act, is_first):
        out = torch.where(is_first[:, None], float(m_in) + 1.0, act + 10.0)
        return out, out[:, 0]

    def emit_fn(aux, m_out, valid):
        return torch.where(valid, aux, 0.0), torch.where(valid, float(m_out),
                                                         -1.0)

    vals, mouts = pipe.gpipe_run(stage_fn, emit_fn, m, act0)
    assert vals.shape == (n, m + n - 1)
    # microbatch j enters as j + 1 and leaves two stages later as j + 21
    assert vals[-1, n - 1:].tolist() == [21.0, 22.0, 23.0, 24.0]
    assert not vals[:-1].any() and not vals[-1, :n - 1].any()
    assert mouts[-1, n - 1:].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_pipeline_trainer_step_is_the_true_gradient():
    """One SGD step equals one SGD step on jax.grad of the sequential
    oracle, at the reference test's bounds (rtol 2e-4, atol 1e-6)."""
    params = _ref_params(1)
    x, y, mask = _data(1)
    lr = 1e-2
    tr = pipe.PipelineTrainer(
        _mesh(), D_IN, WIDTH, 2, params=params,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    loss = tr.train_step(x, y, mask)
    opt = optax.sgd(lr)
    jp = jax.tree.map(jnp.asarray, params)
    want_loss, grads = jax.value_and_grad(ref_pipe.reference_forward_loss)(
        jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    upd, _ = opt.update(grads, opt.init(jp), jp)
    want = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    for k, v in tr.params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    # the gradient through the schedule is the oracle's, unscaled (the
    # reference's train_step would give a quarter of it here)
    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    pipe.pipeline_forward_loss(tp, *map(torch.from_numpy, (x, y, mask)))[
        0].backward()
    for k, v in tp.items():
        w = np.asarray(grads[k])
        np.testing.assert_allclose(v.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_pipeline_trainer_learns_and_validates():
    tr = pipe.PipelineTrainer(_mesh(), D_IN, WIDTH, 2, lr=5e-3, seed=3)
    x, y, mask = _data(3)
    losses = [tr.train_step(x, y, mask) for _ in range(30)]
    assert losses[-1] < losses[0] - 0.05, (losses[0], losses[-1])
    with pytest.raises(ValueError, match="params carry 4 stages"):
        pipe.PipelineTrainer(make_mesh(2, device="cpu", axis_name="pipe"),
                             D_IN, WIDTH, 2, params=_ref_params(0))
    with pytest.raises(ValueError, match="needs a 'pipe' axis"):
        pipe.PipelineTrainer(make_mesh(4, device="cpu"), D_IN)


# --------------------------------------------------------------------------- #
# PipelinedCtrDnn
# --------------------------------------------------------------------------- #
N_SLOTS, DENSE, B = 3, 2, 64
HIDDEN = (48, 32, 16)


def test_split_stages():
    assert _split_stages(4, 4) == [[0], [1], [2], [3]]
    assert _split_stages(6, 4) == [[0, 1], [2, 3], [4], [5]]
    with pytest.raises(ValueError, match="every stage needs"):
        _split_stages(3, 4)


def _pair(width=10, **kw):
    plain = CtrDnn(N_SLOTS, width, dense_dim=DENSE, hidden=HIDDEN, seed=7,
                   device="cpu", **kw)
    piped = PipelinedCtrDnn(_mesh(), N_SLOTS, width, dense_dim=DENSE,
                            hidden=HIDDEN, microbatches=8, seed=7,
                            device="cpu", **kw)
    return plain, piped


def _inputs(width=10, seed=0):
    rng = np.random.default_rng(seed)
    K = B * N_SLOTS
    rows = rng.normal(size=(K, width)).astype(np.float32)
    rows[:, :2] = np.abs(rows[:, :2])  # sane show/clk counters
    segs = (np.repeat(np.arange(B) * N_SLOTS, N_SLOTS)
            + np.tile(np.arange(N_SLOTS), B)).astype(np.int32)
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    return rows, segs, dense


def test_pack_unpack_roundtrip_through_ctr_dnn():
    plain, piped = _pair()
    # same seed, same function: the packed init is CtrDnn's tower
    packed = piped.pack_tower(plain.tower)
    assert torch.equal(packed["w"], piped.stages.w.detach())
    assert torch.equal(packed["b"], piped.stages.b.detach())
    back = piped.unpack_tower()
    assert len(back) == len(plain.tower) == 4
    for a, b in zip(back, plain.tower):
        assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    # the padding outside each layer's block is exactly zero
    for s, ls in enumerate(piped.stage_layers):
        for j, l in enumerate(ls):
            din, dout = piped.dims[l], piped.dims[l + 1]
            w = piped.stages.w[s, j].detach().clone()
            w[:din, :dout] = 0.0
            assert not w.any()


def test_logits_and_grads_match_ctr_dnn_and_reference():
    plain, piped = _pair()
    rows, segs, dense = _inputs()
    args = (torch.from_numpy(segs), torch.from_numpy(dense), B)
    r1 = torch.from_numpy(rows).requires_grad_(True)
    r2 = torch.from_numpy(rows).requires_grad_(True)
    l_plain, l_piped = plain(r1, *args), piped(r2, *args)
    np.testing.assert_allclose(l_piped.detach().numpy(),
                               l_plain.detach().numpy(), rtol=2e-5, atol=2e-5)
    cot = torch.from_numpy(np.random.default_rng(1).normal(size=B)
                           .astype(np.float32))
    (l_plain * cot).sum().backward()
    (l_piped * cot).sum().backward()
    np.testing.assert_allclose(r2.grad.numpy(), r1.grad.numpy(), rtol=2e-5,
                               atol=2e-5)
    # the reference's model from the same packed parameters
    ref = RefPipelinedCtrDnn(_jax_mesh(), N_SLOTS, 10, dense_dim=DENSE,
                             hidden=HIDDEN, microbatches=8)
    params = params_to_jax(piped.state_dict())
    assert set(params) == {"stages"} and set(params["stages"]) == {"w", "b"}
    cot_np = cot.numpy()

    def loss(p, rw):
        out = ref.apply(p, rw, jnp.asarray(segs), jnp.asarray(dense), B)
        return (out * cot_np).sum(), out

    (_, want), (gp, gr) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(rows))
    np.testing.assert_allclose(l_piped.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(r2.grad.numpy(), np.asarray(gr), rtol=1e-5,
                               atol=1e-5)
    want_g = params_from_jax_tree(jax.tree.map(np.asarray, gp))
    for name, prm in piped.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_batch_not_divisible_rejected():
    piped = PipelinedCtrDnn(_mesh(), N_SLOTS, 10, dense_dim=DENSE,
                            hidden=HIDDEN, microbatches=7, device="cpu")
    rows, segs, dense = _inputs()
    with pytest.raises(ValueError, match="not divisible by microbatches 7"):
        piped(torch.from_numpy(rows), torch.from_numpy(segs),
              torch.from_numpy(dense), B)
    with pytest.raises(ValueError, match="needs a 'pipe' axis"):
        PipelinedCtrDnn(make_mesh(4, device="cpu"), N_SLOTS, 10,
                        device="cpu")
    assert PipelinedCtrDnn(_mesh(), N_SLOTS, 10,
                           device="cpu").microbatches == 2 * P_STAGES


def test_bf16_compute_dtype_honored():
    """TrainerConfig.compute_dtype flips the pipelined tower to bf16, close
    to the bf16 CtrDnn (same cast policy) and to the reference's bf16
    PipelinedCtrDnn, at the reference test's 2e-2."""
    import warnings

    plain, piped = _pair()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the no-attribute path warns
        apply_compute_dtype_override(plain, "bfloat16")
        apply_compute_dtype_override(piped, "bfloat16")
    assert piped.compute_dtype is torch.bfloat16
    rows, segs, dense = _inputs()
    args = (torch.from_numpy(rows), torch.from_numpy(segs),
            torch.from_numpy(dense), B)
    lq, lp = piped(*args), plain(*args)
    assert lq.dtype == torch.float32
    np.testing.assert_allclose(lq.detach().numpy(), lp.detach().numpy(),
                               rtol=2e-2, atol=2e-2)
    ref = RefPipelinedCtrDnn(_jax_mesh(), N_SLOTS, 10, dense_dim=DENSE,
                             hidden=HIDDEN, microbatches=8,
                             compute_dtype="bfloat16")
    want = ref.apply(jax.tree.map(jnp.asarray,
                                  params_to_jax(piped.state_dict())),
                     rows, segs, dense, B)
    np.testing.assert_allclose(lq.detach().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_two_passes_match_reference_trainer(tmp_path, monkeypatch):
    """PipelinedCtrDnn through the Trainer against the JAX Trainer with the
    reference's model: per-pass loss at rtol 1e-5, AUC within two bucket
    crossings, the table's rows at rtol 1e-5 / atol 1e-6, counters exact;
    and within the reference test's bounds of a CtrDnn from the same
    layers (loss rel 1e-4, AUC 1e-4, rows rtol 1e-4)."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PARSER", "0")
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    files = write_synth_files(str(tmp_path), n_files=2, ins_per_file=2 * B,
                              n_sparse_slots=N_SLOTS, vocab_per_slot=60,
                              dense_dim=DENSE, seed=13)
    tkw = dict(embedding_dim=8, learning_rate=0.2, initial_range=0.1)
    trkw = dict(dense_lr=1e-2, auc_buckets=1 << 10)
    rconf = ref_config.SparseTableConfig(hbm_cache_rows=0,
                                         overlap_pass_boundary=False, **tkw)
    conf = SparseTableConfig(**tkw)

    def dataset(mk, cls):
        ds = cls(mk(N_SLOTS, DENSE, B, 16,
                    batch_key_capacity=B * N_SLOTS * 4), read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        return ds

    def drive(trainer, table, ds):
        out = []
        for _ in range(2):
            table.begin_pass(ds.unique_keys())
            out.append(trainer.train_from_dataset(ds, table))
            table.end_pass()
        return out, table.state_dict()

    ref_tr = RefTrainer(RefPipelinedCtrDnn(_jax_mesh(), N_SLOTS,
                                           conf.row_width, dense_dim=DENSE,
                                           hidden=HIDDEN, microbatches=8),
                        rconf, ref_config.TrainerConfig(**trkw), seed=4)
    params = jax.tree.map(np.array, ref_tr.params)
    ref_ds = dataset(ref_synth_config, RefDataset)
    rm, rs = drive(ref_tr, RefTable(rconf, seed=3), ref_ds)
    ref_ds.close()
    runs = []
    for cls in (PipelinedCtrDnn, CtrDnn):
        piped = PipelinedCtrDnn(_mesh(), N_SLOTS, conf.row_width,
                                dense_dim=DENSE, hidden=HIDDEN,
                                microbatches=8, device="cpu")
        piped.load_state_dict(params_from_jax_tree(params))
        if cls is PipelinedCtrDnn:
            model = piped
        else:
            model = CtrDnn(N_SLOTS, conf.row_width, dense_dim=DENSE,
                           hidden=HIDDEN, device="cpu")
            model.tower.load_state_dict(piped.unpack_tower().state_dict())
        ds = dataset(make_synth_config, PadBoxSlotDataset)
        table = SparseTable(conf, seed=3, device="cpu")
        runs.append(drive(Trainer(model, conf, TrainerConfig(**trkw),
                                  device="cpu"), table, ds))
        ds.close()
        table.close()
    (pm, ps), (cm, cs) = runs
    for a, b in zip(pm, rm):
        assert a["steps"] == b["steps"] and a["count"] == b["count"] > 0
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        pos = round(b["actual_ctr"] * b["count"])
        assert abs(a["auc"] - b["auc"]) <= 2.0 / max(pos * (b["count"] - pos),
                                                     1)
    np.testing.assert_array_equal(ps["keys"], rs["keys"])
    np.testing.assert_array_equal(ps["values"][:, :2], rs["values"][:, :2])
    np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5,
                               atol=1e-6)
    assert pm[-1]["loss"] == pytest.approx(cm[-1]["loss"], rel=1e-4)
    assert pm[-1]["auc"] == pytest.approx(cm[-1]["auc"], abs=1e-4)
    np.testing.assert_array_equal(ps["keys"], cs["keys"])
    np.testing.assert_allclose(ps["values"], cs["values"], rtol=1e-4,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #
def _param_pair(name):
    """(reference params as numpy, a port model or trainer factory)."""
    if name == "pipeline_trainer":
        return _ref_params(2), None
    if name == "pipelined_ctr":
        ref = RefPipelinedCtrDnn(_jax_mesh(), N_SLOTS, 10, dense_dim=DENSE,
                                 hidden=HIDDEN)
        make = lambda seed: PipelinedCtrDnn(_mesh(), N_SLOTS, 10,
                                            dense_dim=DENSE, hidden=HIDDEN,
                                            seed=seed, device="cpu")
    elif name == "two_tower":
        ref = ref_models.TwoTower(N_SLOTS, 10, item_slots=(1,),
                                  dense_dim=DENSE, hidden=(16,))
        make = lambda seed: models.TwoTower(N_SLOTS, 10, item_slots=(1,),
                                            dense_dim=DENSE, hidden=(16,),
                                            seed=seed, device="cpu")
    else:
        ref = ref_models.LongSeqCtrDnn(N_SLOTS, 10, dense_dim=DENSE,
                                       hidden=(16,), max_seq_len=8)
        make = lambda seed: models.LongSeqCtrDnn(
            N_SLOTS, 10, dense_dim=DENSE, hidden=(16,), max_seq_len=8,
            seed=seed, device="cpu")
    return jax.tree.map(np.array, ref.init(jax.random.PRNGKey(3))), make


@pytest.mark.parametrize("name", ["two_tower", "longseq_ctr",
                                  "pipelined_ctr", "pipeline_trainer"])
def test_params_keyed_by_reference_paths(name, tmp_path):
    """The reference's tree loads into the port (every leaf, nothing
    else), dump_params writes the reference's leaf names and values, and a
    reference parameter file loads through load_pytree."""
    params, make = _param_pair(name)
    state = params_from_jax_tree(params)
    if make is None:
        tr = pipe.PipelineTrainer(_mesh(), D_IN, WIDTH, 2, params=state)
        port_state = {k: v.detach() for k, v in tr.params.items()}
        template = {k: torch.zeros_like(v) for k, v in port_state.items()}
    else:
        model = make(0)
        model.load_state_dict(state)  # strict: the same leaves
        port_state = model.state_dict()
        template = make(99).state_dict()
    for k, v in port_state.items():
        assert torch.equal(v, state[k]), k
    ref_dump_params(str(tmp_path / "ref"), params)
    dump_params(str(tmp_path / "port"), port_state)
    with np.load(str(tmp_path / "ref.dense.npz")) as r, \
            np.load(str(tmp_path / "port.dense.npz")) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    ref_save_pytree(str(tmp_path / "params.npz"), params)
    loaded = load_pytree(str(tmp_path / "params.npz"), template)
    assert set(loaded) == set(port_state)
    for k in port_state:
        assert torch.equal(loaded[k], port_state[k]), k
