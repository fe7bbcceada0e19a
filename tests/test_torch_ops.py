"""Device-op parity of the PyTorch port with the JAX package, on the CPU:
pull_rows (create_threshold, pull_embedx_scale), push_and_update, sparse
adagrad, fused_seqpool_cvm and cvm (forward and gradient), the CTR-DNN
tower with the reference's parameters carried across by weights.py, BCE
and AUC.  Inputs come from numpy seeds and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import SparseTableConfig as RefTableConf
from paddlebox_tpu.metrics import auc as ref_auc
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.models.layers import bce_with_logits as ref_bce
from paddlebox_tpu.ops.cvm import cvm as ref_cvm
from paddlebox_tpu.ops.seqpool_cvm import fused_seqpool_cvm as ref_seqpool_cvm
from paddlebox_tpu.sparse.optimizer import sparse_adagrad_update as ref_adagrad
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.sparse.table import pull_rows as ref_pull_rows
from paddlebox_tpu.sparse.table import push_and_update as ref_push
from paddlebox_tpu_torch.config import SparseTableConfig
from paddlebox_tpu_torch.metrics import auc as port_auc
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.models.layers import bce_with_logits
from paddlebox_tpu_torch.ops.cvm import cvm
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.sparse.optimizer import sparse_adagrad_update
from paddlebox_tpu_torch.sparse.table import SparseTable, pull_rows, push_and_update
from paddlebox_tpu_torch.weights import params_from_jax, table_state_from_jax

torch.set_num_threads(1)

B, S, EMB = 16, 4, 4  # batch, slots, embedding_dim
W = 2 + EMB


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch_segments(rng, n_real, K):
    segs = np.full(K, B * S, dtype=np.int32)  # padding -> overflow bin
    segs[:n_real] = np.sort(rng.integers(0, B * S, size=n_real))
    return segs


@pytest.mark.parametrize("threshold,scale", [(0.0, 1.0), (2.0, 1.0),
                                             (0.0, 0.5), (2.0, 0.25)])
def test_pull_rows_column_rules(threshold, scale):
    rng = np.random.default_rng(0)
    values = rng.normal(size=(40, W)).astype(np.float32)
    values[:, 0] = rng.integers(0, 5, size=40)  # show counts
    idx = rng.integers(0, 40, size=24).astype(np.int32)
    want = ref_pull_rows(jnp.asarray(values), jnp.asarray(idx),
                         create_threshold=threshold, pull_embedx_scale=scale)
    got = pull_rows(_t(values), _t(idx), create_threshold=threshold,
                    pull_embedx_scale=scale)
    # one multiply per element at most on either side: bit-exact
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _push_case(rng, cvm_offset=2, scratch=64):
    """A live table + plan with duplicate keys, census misses and padding."""
    base = dict(embedding_dim=EMB, learning_rate=0.1, initial_g2sum=1.0,
                initial_range=0.5, grad_clip=0.5, cvm_offset=cvm_offset,
                plan_scratch_rows=scratch)
    rconf = RefTableConf(hbm_cache_rows=0, overlap_pass_boundary=False, **base)
    pconf = SparseTableConfig(**base)
    ref = RefTable(rconf, seed=1)
    census = np.unique(rng.integers(1, 60, size=30).astype(np.uint64))
    ref.begin_pass(census)
    K = 40
    keys = np.zeros(K, dtype=np.uint64)
    keys[:33] = rng.integers(1, 70, size=33)
    plan = ref.plan_keys(keys, 33)
    w = rconf.row_width
    grads = np.zeros((K, w), dtype=np.float32)
    grads[:33, cvm_offset:] = rng.normal(size=(33, w - cvm_offset))
    clicks = np.zeros(K, dtype=np.float32)
    clicks[:33] = rng.integers(0, 2, size=33)
    extras = np.zeros((K, max(cvm_offset - 2, 0)), dtype=np.float32)
    extras[:33] = rng.integers(0, 2, size=(33, extras.shape[1]))
    values = np.array(ref.values)
    values[: census.shape[0], :2] = rng.integers(0, 9, size=(census.shape[0], 2))
    g2 = np.zeros(values.shape[0], np.float32)
    g2[: census.shape[0]] = rng.random(census.shape[0])
    return rconf, pconf, plan, values, g2, grads, clicks, extras


@pytest.mark.parametrize("cvm_offset", [2, 3])
def test_push_and_update_matches_reference(cvm_offset, monkeypatch):
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    rng = np.random.default_rng(5 + cvm_offset)
    rconf, pconf, plan, values, g2, grads, clicks, extras = _push_case(
        rng, cvm_offset)
    kx = extras if cvm_offset > 2 else None
    rv, rg = ref_push(
        jnp.asarray(values), jnp.asarray(g2), jnp.asarray(grads),
        jnp.asarray(plan.idx), jnp.asarray(plan.uniq_idx),
        jnp.asarray(plan.inverse), jnp.asarray(plan.key_mask),
        jnp.asarray(clicks), rconf,
        key_extras=None if kx is None else jnp.asarray(kx),
    )
    state = table_state_from_jax(values, g2)
    pv, pg = push_and_update(
        state["values"], state["g2sum"], _t(grads), _t(plan.uniq_idx),
        _t(plan.inverse), _t(plan.key_mask), _t(clicks), pconf,
        key_extras=None if kx is None else _t(kx),
    )
    assert pv is state["values"] and pg is state["g2sum"]  # in place
    # duplicate-key gradients merge by segment sum in another order than
    # XLA's scatter: float32 reorder of a few unit-size terms
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-6, atol=1e-6)
    assert not pv[-1].any() and pg[-1] == 0  # dead row stays zero


def test_push_matches_numpy_adagrad_oracle():
    """Port of tests/test_sparse_table.py::test_push_matches_numpy_adagrad_oracle."""
    conf = SparseTableConfig(embedding_dim=4, learning_rate=0.1,
                             initial_g2sum=1.0, initial_range=0.5,
                             grad_clip=10.0)
    t = SparseTable(conf, seed=1, device="cpu")
    pk = np.array([5, 9, 14], dtype=np.uint64)
    t.begin_pass(pk)
    v0 = t.values.numpy().copy()
    K = 8
    keys = np.zeros(K, dtype=np.uint64)
    batch_keys = [9, 5, 9, 14]  # key 9 twice: grads must merge
    keys[:4] = batch_keys
    clicks = np.array([1.0, 0.0, 0.0, 1.0])
    plan = t.plan_keys(keys, 4)
    rng = np.random.default_rng(2)
    row_grads = np.zeros((K, conf.row_width), dtype=np.float32)
    row_grads[:4, 2:] = rng.normal(size=(4, 4)).astype(np.float32)
    key_clicks = np.zeros(K, dtype=np.float32)
    key_clicks[:4] = clicks
    new_v, new_g2 = push_and_update(
        t.values, t.g2sum, _t(row_grads), _t(plan.uniq_idx),
        _t(plan.inverse), _t(plan.key_mask), _t(key_clicks), conf,
    )
    new_v, new_g2 = new_v.numpy(), new_g2.numpy()
    exp_v, exp_g2 = v0.copy(), np.zeros(v0.shape[0], dtype=np.float32)
    for key in set(batch_keys):
        occ = [i for i, k in enumerate(batch_keys) if k == key]
        row = int(np.searchsorted(pk, key))
        g = np.clip(row_grads[occ, 2:].sum(axis=0), -conf.grad_clip, conf.grad_clip)
        add_g2 = float((g * g).mean())
        scale = conf.learning_rate * np.sqrt(
            conf.initial_g2sum / (conf.initial_g2sum + add_g2))
        exp_v[row, 2:] -= scale * g
        exp_v[row, 0] += len(occ)
        exp_v[row, 1] += clicks[occ].sum()
        exp_g2[row] += add_g2
    np.testing.assert_allclose(new_v, exp_v, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_g2, exp_g2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_v[t.dead_row], 0.0)


def test_missing_key_grads_do_not_corrupt_dead_row():
    conf = SparseTableConfig(embedding_dim=4)
    t = SparseTable(conf, device="cpu")
    t.begin_pass(np.array([1], dtype=np.uint64))
    keys = np.zeros(4, dtype=np.uint64)
    keys[:2] = [1, 777]  # 777 is not in the census: pulls the dead row
    plan = t.plan_keys(keys, 2)
    v, g = push_and_update(
        t.values, t.g2sum, torch.ones(4, conf.row_width), _t(plan.uniq_idx),
        _t(plan.inverse), _t(plan.key_mask), torch.zeros(4), conf,
    )
    assert not v[t.dead_row].any() and g[t.dead_row] == 0


@pytest.mark.parametrize("lr_per_row", [False, True])
def test_sparse_adagrad_update_matches(lr_per_row):
    rng = np.random.default_rng(4)
    g2 = rng.random(12).astype(np.float32)
    grad = (rng.normal(size=(12, 5)) * 3).astype(np.float32)
    lr = rng.random(12).astype(np.float32) if lr_per_row else 0.05
    rw, rg = ref_adagrad(jnp.asarray(g2), jnp.asarray(grad),
                         jnp.asarray(lr) if lr_per_row else lr, 3.0, 2.0)
    pw, pg = sparse_adagrad_update(_t(g2), _t(grad),
                                   _t(lr) if lr_per_row else lr, 3.0, 2.0)
    # mean over 5 columns and a sqrt: last-bit rounding differences
    np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_cvm", [True, False])
def test_fused_seqpool_cvm_forward_and_grad(use_cvm):
    rng = np.random.default_rng(6)
    K = 50
    rows = rng.normal(size=(K, W)).astype(np.float32)
    rows[:, :2] = rng.integers(0, 6, size=(K, 2))
    segs = _batch_segments(rng, 41, K)
    cot_w = (2 + EMB) if use_cvm else EMB
    cot = rng.normal(size=(B, S * cot_w)).astype(np.float32)

    out, vjp = jax.vjp(
        lambda r: ref_seqpool_cvm(r, jnp.asarray(segs), B, S, use_cvm=use_cvm),
        jnp.asarray(rows),
    )
    (want_grad,) = vjp(jnp.asarray(cot))
    r = _t(rows).requires_grad_(True)
    got = fused_seqpool_cvm(r, _t(segs), B, S, use_cvm=use_cvm)
    got.backward(_t(cot))
    # segment sums of <= ~4 rows in another order, then log: float32 noise
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    # the gradient is a gather of the cotangent: exact, counters get none
    np.testing.assert_array_equal(r.grad.numpy(), np.asarray(want_grad))
    assert not r.grad[:, :2].any()


def test_cvm_op_forward_and_grad():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, W)).astype(np.float32)
    x[:, :2] = rng.integers(0, 9, size=(6, 2))
    cot = rng.normal(size=(6, W)).astype(np.float32)
    out, vjp = jax.vjp(ref_cvm, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = cvm(xt)
    got.backward(_t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))
    np.testing.assert_array_equal(cvm(_t(x), use_cvm=False).numpy(), x[:, 2:])


def test_bce_with_logits_matches():
    rng = np.random.default_rng(8)
    logits = (rng.normal(size=64) * 20).astype(np.float32)
    labels = rng.integers(0, 2, size=64).astype(np.float32)
    np.testing.assert_allclose(
        bce_with_logits(_t(logits), _t(labels)).numpy(),
        np.asarray(ref_bce(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6, atol=1e-7,
    )


def test_ctr_dnn_forward_and_grads_with_reference_params():
    """The tower carried over by params_from_jax computes the reference's
    logits; one backward gives the reference's param and row gradients."""
    rng = np.random.default_rng(9)
    dense_dim, hidden = 3, (16, 8)
    ref = RefCtrDnn(S, W, dense_dim=dense_dim, hidden=hidden)
    params = ref.init(jax.random.PRNGKey(0))
    tower = [{k: np.asarray(v) for k, v in layer.items()}
             for layer in params["tower"]]
    port = CtrDnn(S, W, dense_dim=dense_dim, hidden=hidden, device="cpu")
    port.load_state_dict(params_from_jax(tower))
    K = 60
    rows = rng.normal(size=(K, W)).astype(np.float32)
    rows[:, :2] = rng.integers(0, 6, size=(K, 2))
    segs = _batch_segments(rng, 50, K)
    dense = rng.normal(size=(B, dense_dim)).astype(np.float32)
    labels = rng.integers(0, 2, size=B).astype(np.float32)

    def ref_loss(p, r):
        logits = ref.apply(p, r, jnp.asarray(segs), jnp.asarray(dense), B)
        return ref_bce(logits, jnp.asarray(labels)).mean(), logits

    (loss, logits), (pgrad, rgrad) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(rows))
    r = _t(rows).requires_grad_(True)
    got_logits = port(r, _t(segs), _t(dense), B)
    got_loss = bce_with_logits(got_logits, _t(labels)).mean()
    got_loss.backward()
    # float32 matmuls accumulate in another order on the two CPU backends
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(logits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-6)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(rgrad),
                               rtol=1e-4, atol=1e-6)
    for i, layer in enumerate(pgrad["tower"]):
        np.testing.assert_allclose(
            port.tower[i].weight.grad.numpy(), np.asarray(layer["w"]).T,
            rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            port.tower[i].bias.grad.numpy(), np.asarray(layer["b"]),
            rtol=1e-4, atol=1e-6)


def test_auc_matches_reference():
    rng = np.random.default_rng(10)
    nb = 1 << 10
    rs, ps = ref_auc.init_auc_state(nb), port_auc.init_auc_state(nb, device="cpu")
    for _ in range(4):
        preds = rng.random(32).astype(np.float32)
        labels = (rng.random(32) < preds).astype(np.float32)
        mask = np.ones(32, np.float32)
        mask[-5:] = 0.0
        rs = ref_auc.update_auc_state(rs, jnp.asarray(preds), jnp.asarray(labels),
                                      jnp.asarray(mask))
        ps = port_auc.update_auc_state(ps, _t(preds), _t(labels), _t(mask))
    np.testing.assert_array_equal(ps.pos.numpy(), np.asarray(rs.pos))
    np.testing.assert_array_equal(ps.neg.numpy(), np.asarray(rs.neg))
    rm, pm = ref_auc.compute_metrics(rs), port_auc.compute_metrics(ps)
    assert pm["auc"] == rm["auc"]  # same buckets, same host reduction
    assert pm["count"] == rm["count"] == 108
    for k in ("mae", "rmse", "actual_ctr", "predicted_ctr"):
        # float32 batch sums in another order before the Kahan add
        np.testing.assert_allclose(pm[k], rm[k], rtol=1e-6, err_msg=k)
    assert ps.pos.dtype == torch.int64  # exact past the reference's 2^32
