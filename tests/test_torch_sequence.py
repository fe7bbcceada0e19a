"""Sequence parallelism of the port against the JAX package, on the CPU:
full, ring and Ulysses attention (parallel/sequence.py) and LongSeqCtrDnn
(models/longseq_ctr.py).

  * the three attentions, forward and gradients, causal and key-masked (a
    batch row whose keys are all masked reads zeros), at 1, 2 and 4 seq
    positions, against the reference's functions (the sharded ones under
    ``shard_map`` on the forced CPU devices) at the zoo's tolerance, and
    against the port's own full attention at 2e-5 (sharded against serial:
    float32 sums in another order);
  * Ulysses' indivisible-heads error;
  * LongSeqCtrDnn's logits and gradients, single position, ring and Ulysses
    on 4 seq positions, against the reference's model; its errors;
  * three single-chip Trainer passes against the JAX Trainer, and the
    multi-chip trainer on 4 data positions against the JAX MultiChipTrainer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as PS

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
import paddlebox_tpu.parallel.sequence as ref_seq
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu.utils.jax_compat import shard_map
import paddlebox_tpu_torch.models as models
import paddlebox_tpu_torch.parallel.sequence as seq
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

B, T, H, D = 2, 16, 4, 8
# the zoo's forward tolerance; sharded against serial attention may take
# 2e-5 (float32 sums in another order)
TOL = dict(rtol=1e-5, atol=1e-6)
SHARD_TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_mesh(p):
    return JaxMesh(np.array(jax.devices()[:p]), (ref_seq.SEQ_AXIS,))


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v, tgt = (rng.normal(size=(B, T, H, D)).astype(np.float32) * 0.5
                    for _ in range(4))
    valid = None
    if masked:
        # row 0: ragged (the first 11 keys); row 1: every key masked
        valid = np.zeros((B, T), bool)
        valid[0, :11] = True
    return q, k, v, tgt, valid


def _ref_attention(impl, p, causal, q, k, v, valid):
    """The reference's attention on [B, T, H, D]: full, or its sharded
    function under shard_map over p seq devices."""
    fn = {"full": ref_seq.full_attention, "ring": ref_seq.ring_attention,
          "ulysses": ref_seq.ulysses_attention}[impl]
    if impl == "full":
        return fn(q, k, v, causal=causal, key_valid=valid)
    spec = PS(None, ref_seq.SEQ_AXIS)
    if valid is None:
        body = functools.partial(fn, causal=causal)
        args, specs = (q, k, v), (spec,) * 3
    else:
        body = lambda a, b, c, m: fn(a, b, c, causal=causal, key_valid=m)
        args, specs = (q, k, v, valid), (spec,) * 4
    return shard_map(body, mesh=_jax_mesh(p), in_specs=specs,
                     out_specs=spec)(*args)


def _port_attention(impl, p, causal, q, k, v, valid):
    if impl == "full":
        return seq.full_attention(q, k, v, causal=causal, key_valid=valid)
    fn = seq.ring_attention if impl == "ring" else seq.ulysses_attention
    kv = None if valid is None else seq.split_positions(valid, p)
    out = fn(*(seq.split_positions(x, p) for x in (q, k, v)), causal=causal,
             key_valid=kv)
    return seq.merge_positions(out)


CASES = [("full", 1)] + [(impl, p) for impl in ("ring", "ulysses")
                         for p in (1, 2, 4)]


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("impl,p", CASES)
def test_attention_matches_reference(impl, p, causal, masked):
    """Forward and the gradients of q, k and v of a squared-error loss."""
    q, k, v, tgt, valid = _inputs(3, masked)
    jv = None if valid is None else jnp.asarray(valid)

    def ref_loss(q_, k_, v_):
        out = _ref_attention(impl, p, causal, q_, k_, v_, jv)
        return jnp.mean((out - tgt) ** 2), out

    (_, want), want_g = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tval = None if valid is None else torch.from_numpy(valid)
    got = _port_attention(impl, p, causal, tq, tk, tv, tval)
    torch.mean((got - torch.from_numpy(tgt)) ** 2).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    if masked:
        # the query row whose keys are all masked reads zeros, not NaN
        assert not got[1].detach().abs().sum()
    # sharded against the port's own serial attention
    serial = seq.full_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal, key_valid=tval)
    np.testing.assert_allclose(got.detach().numpy(), serial.numpy(),
                               **SHARD_TOL)


def test_ring_attention_positions_ride_the_ring():
    """Explicit global positions give the default causal mask, and a chunk
    whose keys all lie in a query's future folds to nothing: the first
    chunk's output does not depend on the other chunks' keys."""
    q, k, v, _, _ = _inputs(5, False)
    qs, ks, vs = (seq.split_positions(torch.from_numpy(x), 4)
                  for x in (q, k, v))
    pos = torch.arange(T).reshape(4, T // 4)
    a = seq.ring_attention(qs, ks, vs, causal=True)
    b = seq.ring_attention(qs, ks, vs, causal=True, positions=pos)
    assert torch.equal(a, b)
    ks2, vs2 = ks.clone(), vs.clone()
    ks2[1:], vs2[1:] = 7.0, -3.0
    c = seq.ring_attention(qs, ks2, vs2, causal=True)
    assert torch.equal(a[0], c[0])


def test_ulysses_indivisible_heads_raise():
    x = torch.zeros((2, B, T // 2, 3, D))
    with pytest.raises(ValueError, match="heads 3 not divisible by seq "
                                         "axis size 2"):
        seq.ulysses_attention(x, x, x)
    xj = jnp.zeros((B, T, 3, D))
    with pytest.raises(ValueError, match="heads 3 not divisible by seq "
                                         "axis size 2"):
        _ref_attention("ulysses", 2, False, xj, xj, xj, None)


# --------------------------------------------------------------------------- #
# LongSeqCtrDnn
# --------------------------------------------------------------------------- #
S, DENSE, BSZ, SEQ_T, EMB = 3, 2, 32, 16, 8
KW = dict(dense_dim=DENSE, hidden=(16,), max_seq_len=SEQ_T, n_heads=4,
          head_dim=8)


def _model_inputs(rng, width):
    K = BSZ * S * 4
    rows = np.zeros((K, width), np.float32)
    n = K - 20
    show = rng.integers(0, 9, size=n)
    rows[:n, 0] = show
    rows[:n, 1] = rng.integers(0, show + 1)
    rows[:n, 2:] = rng.normal(scale=0.5, size=(n, width - 2))
    segs = np.full(K, BSZ * S, np.int32)
    segs[:n] = np.sort(rng.integers(0, BSZ * S, size=n))
    dense = rng.normal(size=(BSZ, DENSE)).astype(np.float32)
    # each instance's behaviour run: slot 0's occurrences in order, padded
    # with K; instance 3's is empty
    seq_pos = np.full((BSZ, SEQ_T), K, np.int32)
    for i in range(BSZ):
        own = np.nonzero(segs[:n] == i * S)[0][:SEQ_T]
        seq_pos[i, :own.shape[0]] = own
    seq_pos[3] = K
    return rows, segs, dense, seq_pos


@pytest.mark.parametrize("impl,p", [(None, 1), ("ring", 4), ("ulysses", 4),
                                    ("ring", 2)])
def test_longseq_logits_and_grads_match_reference(impl, p):
    width = 2 + EMB
    rkw = dict(KW)
    pkw = dict(KW)
    if impl is not None:
        rkw.update(seq_mesh=_jax_mesh(p), seq_impl=impl)
        pkw.update(seq_mesh=make_mesh(p, device="cpu", axis_name="seq"),
                   seq_impl=impl)
    ref = ref_models.LongSeqCtrDnn(S, width, **rkw)
    port = models.LongSeqCtrDnn(S, width, device="cpu", **pkw)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(7)))
    port.load_state_dict(params_from_jax_tree(params))
    rows, segs, dense, seq_pos = _model_inputs(np.random.default_rng(2), width)
    cot = np.random.default_rng(4).normal(size=BSZ).astype(np.float32)

    def loss(pr, rw):
        out = ref.apply(pr, rw, jnp.asarray(segs), jnp.asarray(dense), BSZ,
                        seq_pos=jnp.asarray(seq_pos))
        return (out * cot).sum(), out

    (_, want), (gp, gr) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(rows))
    r = torch.from_numpy(rows).requires_grad_(True)
    got = port(r, torch.from_numpy(segs), torch.from_numpy(dense), BSZ,
               seq_pos=torch.from_numpy(seq_pos))
    (got * torch.from_numpy(cot)).sum().backward()
    # a sharded attention folds its float32 sums in another order on each
    # side: 2e-5, as sharded against serial.  The tower's gradients sum 32
    # instances' products of up to about 10 each: atol 1e-5 (a millionth
    # of the largest) for an element that cancels to near zero
    tol = TOL if impl is None else SHARD_TOL
    gtol = dict(rtol=tol["rtol"], atol=max(tol["atol"], 1e-5))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gr), **gtol)
    want_grads = params_from_jax_tree(jax.tree.map(np.asarray, gp))
    named = dict(port.named_parameters())
    assert set(named) == set(want_grads) and "qkv" in named
    for name, prm in named.items():
        np.testing.assert_allclose(prm.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **gtol)
    if impl is not None:
        # sharded against the port's own single-position model
        single = models.LongSeqCtrDnn(S, width, device="cpu", **KW)
        single.load_state_dict(port.state_dict())
        serial = single(torch.from_numpy(rows), torch.from_numpy(segs),
                        torch.from_numpy(dense), BSZ,
                        seq_pos=torch.from_numpy(seq_pos))
        np.testing.assert_allclose(got.detach().numpy(),
                                   serial.detach().numpy(), **SHARD_TOL)


def test_longseq_errors():
    seq_mesh = make_mesh(4, device="cpu", axis_name="seq")
    with pytest.raises(ValueError, match="unknown seq_impl"):
        models.LongSeqCtrDnn(S, 10, seq_impl="tree", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        models.LongSeqCtrDnn(S, 10, max_seq_len=6, seq_mesh=seq_mesh,
                             device="cpu")
    with pytest.raises(ValueError, match="ulysses needs n_heads"):
        models.LongSeqCtrDnn(S, 10, n_heads=2, seq_mesh=seq_mesh,
                             seq_impl="ulysses", device="cpu")
    with pytest.raises(ValueError, match="needs a 'seq' axis"):
        models.LongSeqCtrDnn(S, 10, seq_mesh=make_mesh(4, device="cpu"),
                             device="cpu")
    with pytest.raises(ValueError, match="no embedding columns"):
        models.LongSeqCtrDnn(S, 2, device="cpu")
    m = models.LongSeqCtrDnn(S, 10, max_seq_len=8, device="cpu")
    rows = torch.zeros((12, 10))
    segs = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="seq_pos width 4 != model"):
        m(rows, segs, torch.zeros((2, 0)), 2,
          seq_pos=torch.zeros((2, 4), dtype=torch.int32))
    # "inherit" outside a composed mesh names what it needs
    inh = models.LongSeqCtrDnn(S, 10, max_seq_len=8, seq_mesh="inherit",
                               device="cpu")
    with pytest.raises(ValueError, match="make_composed_mesh"):
        inh(rows, segs, torch.zeros((2, 0)), 2,
            seq_pos=torch.full((2, 8), 12, dtype=torch.int32))
    assert m.uses_seq_pos


# --------------------------------------------------------------------------- #
# training against the reference's trainers
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def seq_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    return write_synth_files(str(d), n_files=1, ins_per_file=256,
                             n_sparse_slots=S, vocab_per_slot=50,
                             dense_dim=DENSE, seed=11, max_keys_per_slot=9)


def _datasets(files, batch=BSZ):
    out = []
    for mk, cls in ((make_synth_config, PadBoxSlotDataset),
                    (ref_synth_config, RefDataset)):
        ds = cls(mk(S, DENSE, batch, 24, sequence_slot="slot0",
                    max_seq_len=SEQ_T), read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        out.append(ds)
    return out


TKW = dict(embedding_dim=EMB, learning_rate=0.2, initial_range=0.1)
LKW = dict(dense_dim=DENSE, hidden=(16,), max_seq_len=SEQ_T, n_heads=2,
           head_dim=4)


def _auc_tol(m) -> float:
    """Two bucket crossings' worth of AUC (tests/test_torch_models.py)."""
    pos = round(m["actual_ctr"] * m["count"])
    return 2.0 / max(pos * (m["count"] - pos), 1)


def test_longseq_three_passes_match_reference_trainer(seq_files, monkeypatch):
    """Per-pass loss at rtol 1e-5, AUC within two bucket crossings, the
    table's rows at rtol 1e-5 / atol 1e-6 with the counters exact, qkv
    trained."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PARSER", "0")
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    ds, ref_ds = _datasets(seq_files)
    rconf = ref_config.SparseTableConfig(hbm_cache_rows=0,
                                         overlap_pass_boundary=False, **TKW)
    trkw = dict(dense_lr=1e-2, auc_buckets=1 << 10)
    ref_tr = RefTrainer(ref_models.LongSeqCtrDnn(S, rconf.row_width, **LKW),
                        rconf, ref_config.TrainerConfig(**trkw), seed=4)
    conf = SparseTableConfig(**TKW)
    model = models.LongSeqCtrDnn(S, conf.row_width, device="cpu", **LKW)
    model.load_state_dict(params_from_jax_tree(
        jax.tree.map(np.asarray, ref_tr.params)))
    qkv0 = model.qkv.detach().clone()
    tr = Trainer(model, conf, TrainerConfig(**trkw), device="cpu")
    ref_table, table = RefTable(rconf, seed=3), SparseTable(conf, seed=3,
                                                            device="cpu")
    try:
        for _ in range(3):
            out = []
            for t, d, tb in ((ref_tr, ref_ds, ref_table), (tr, ds, table)):
                tb.begin_pass(d.unique_keys())
                out.append(t.train_from_dataset(d, tb))
                tb.end_pass()
            b, a = out
            assert a["steps"] == b["steps"] and a["count"] == b["count"] > 0
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            assert abs(a["auc"] - b["auc"]) <= _auc_tol(b)
        rs, ps = ref_table.state_dict(), table.state_dict()
        np.testing.assert_array_equal(ps["keys"], rs["keys"])
        np.testing.assert_array_equal(ps["values"][:, :2], rs["values"][:, :2])
        np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5,
                                   atol=1e-6)
        assert (model.qkv - qkv0).abs().max() > 1e-6
    finally:
        ds.close()
        ref_ds.close()
        table.close()


def test_longseq_multichip_matches_reference(seq_files, monkeypatch):
    """LongSeqCtrDnn on the multi-chip trainer, 4 data positions, each
    position's seq_pos slice: two passes against the JAX MultiChipTrainer
    within tests/test_torch_multichip.py's bounds (loss and AUC 1e-6, rows
    1e-7)."""
    for k in ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
              "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
              "PADDLEBOX_TORCH_USE_NATIVE_PARSER"):
        monkeypatch.setenv(k, "0")
    tkw = dict(embedding_dim=4, hbm_cache_rows=0)
    rconf = ref_config.SparseTableConfig(**tkw)
    rmesh = ref_make_mesh(4)
    ref_tr = RefMultiChipTrainer(
        ref_models.LongSeqCtrDnn(S, rconf.row_width, **LKW), rconf, rmesh,
        ref_config.TrainerConfig(auc_buckets=1 << 10), seed=3)
    params = jax.tree.map(np.array, ref_tr.dense_state()[0])
    conf = SparseTableConfig(**tkw)
    mesh = make_mesh(4, device="cpu")
    model = models.LongSeqCtrDnn(S, conf.row_width, device="cpu", **LKW)
    model.load_state_dict(params_from_jax_tree(params))
    tr = MultiChipTrainer(model, conf, mesh,
                          TrainerConfig(auc_buckets=1 << 10))
    ds, ref_ds = _datasets(seq_files, batch=16)
    ref_table = RefShardedTable(rconf, rmesh, seed=5, bucket_slack=8.0)
    table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    try:
        for _ in range(2):
            out = []
            for t, d, tb in ((ref_tr, ref_ds, ref_table), (tr, ds, table)):
                tb.begin_pass(d.unique_keys())
                out.append(t.train_from_dataset(d, tb))
                tb.end_pass()
            rm, m = out
            assert m["steps"] == rm["steps"] and m["count"] == rm["count"] > 0
            assert abs(m["loss"] - rm["loss"]) < 1e-6, (m["loss"], rm["loss"])
            assert abs(m["auc"] - rm["auc"]) < 1e-6, (m["auc"], rm["auc"])
        rs, ps = ref_table.state_dict(), table.state_dict()
        np.testing.assert_array_equal(ps["keys"], rs["keys"])
        np.testing.assert_array_equal(ps["values"][:, :2], rs["values"][:, :2])
        np.testing.assert_allclose(ps["values"], rs["values"], rtol=0,
                                   atol=1e-7)
    finally:
        ds.close()
        ref_ds.close()
        table.close()
        ref_table.close()
