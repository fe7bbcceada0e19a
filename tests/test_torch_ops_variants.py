"""The CTR op set of the port against the JAX package, on the CPU: the
seqpool-CVM family (the show/clk and embed-norm filters, quantization,
per-slot thresholds, the conv, pcoc and extended layouts, use_cvm off),
``pooled_width`` against each op's output width, ``cvm_decayed_show``,
``fused_concat`` with its errors, ``rank_attention`` (forward and both
gradients, with unranked instances and missing peers) and ``ins_rank``.
Inputs come from numpy seeds and go to both packages; gradients are taken
of ``sum(out * cotangent)``, ``rows.grad`` against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.ops as ref_ops
import paddlebox_tpu_torch.ops as ops
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

B, S, K = 6, 4, 40  # batch, slots, occurrences (the last 6 are padding)
N_REAL = 34
# forwards: float32 pooling in another order (index_add against XLA's
# segment_sum); gradients: a few more reordered terms
FWD = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)


def _rows(rng, width, n_counters):
    """[K, width] pulled rows: integer counters with show >= click and
    every other counter <= click, normal embeds; padding rows zero."""
    rows = np.zeros((K, width), np.float32)
    show = rng.integers(0, 9, size=N_REAL)
    click = rng.integers(0, show + 1)
    rows[:N_REAL, 0], rows[:N_REAL, 1] = show, click
    for c in range(2, n_counters):
        rows[:N_REAL, c] = rng.integers(0, click + 1)
    rows[:N_REAL, n_counters:] = rng.normal(size=(N_REAL, width - n_counters))
    return rows


def _segments(rng):
    segs = np.full(K, B * S, np.int32)  # padding -> overflow bin
    segs[:N_REAL] = np.sort(rng.integers(0, B * S, size=N_REAL))
    return segs


def _embed_threshold(rows, co):
    """A threshold halfway across the widest gap between the middle
    occurrences' |embed_w| + ||embedx|| scores: no occurrence ties it in
    either package's last bit."""
    x = rows[:N_REAL].astype(np.float64)
    score = np.sort(np.sqrt((x[:, co + 1:] ** 2).sum(1)) + np.abs(x[:, co]))
    mid = score[N_REAL // 4: 3 * N_REAL // 4]
    i = int(np.argmax(np.diff(mid)))
    return float((mid[i] + mid[i + 1]) / 2)


# name -> (op, width, counters, kwargs); the filter thresholds sit between
# the scores' steps of 0.2 (integer counters, show_coeff 0.2, clk_coeff 1)
CASES = {
    "default": ("fused_seqpool_cvm", 6, 2, {}),
    "no_cvm": ("fused_seqpool_cvm", 6, 2, dict(use_cvm=False)),
    "wide_offset": ("fused_seqpool_cvm", 7, 3, dict(cvm_offset=3)),
    "filter": ("fused_seqpool_cvm", 6, 2, dict(need_filter=True,
                                               threshold=1.1)),
    "embed_threshold": ("fused_seqpool_cvm", 6, 2,
                        dict(need_filter=True, threshold=0.1,
                             embed_threshold="auto")),
    "quant": ("fused_seqpool_cvm", 6, 2, dict(quant_ratio=128)),
    "filter_quant_no_cvm": ("fused_seqpool_cvm", 6, 2,
                            dict(need_filter=True, threshold=0.5,
                                 quant_ratio=64, use_cvm=False)),
    "diff_thres": ("fused_seqpool_cvm_with_diff_thres", 6, 2,
                   dict(threshold_vec=(0.5, 1.1, 2.3, 0.1))),
    "diff_thres_quant": ("fused_seqpool_cvm_with_diff_thres", 7, 3,
                         dict(threshold_vec=(1.3, 0.1, 0.7, 2.1),
                              cvm_offset=3, quant_ratio=32)),
    "conv": ("fused_seqpool_cvm_with_conv", 7, 3, {}),
    "conv_show_filter": ("fused_seqpool_cvm_with_conv", 7, 3,
                         dict(show_filter=True)),
    "conv_filter_quant": ("fused_seqpool_cvm_with_conv", 8, 4,
                          dict(cvm_offset=4, need_filter=True, threshold=0.9,
                               quant_ratio=16)),
    "conv_no_cvm": ("fused_seqpool_cvm_with_conv", 7, 3, dict(use_cvm=False)),
    "pcoc1": ("fused_seqpool_cvm_with_pcoc", 9, 5, dict(pclk_num=1)),
    "pcoc2": ("fused_seqpool_cvm_with_pcoc", 10, 6, dict(pclk_num=2)),
    "pcoc2_filter": ("fused_seqpool_cvm_with_pcoc", 10, 6,
                     dict(pclk_num=2, need_filter=True, threshold=1.1,
                          quant_ratio=8)),
    "pcoc1_no_cvm": ("fused_seqpool_cvm_with_pcoc", 9, 5,
                     dict(pclk_num=1, use_cvm=False)),
    "extended": ("fused_seqpool_cvm_extended", 9, 2, dict(expand_dim=3)),
    "extended_no_cvm": ("fused_seqpool_cvm_extended", 10, 3,
                        dict(expand_dim=2, cvm_offset=3, use_cvm=False)),
}


def _case(name, seed=0):
    op, width, n_counters, kw = CASES[name]
    rng = np.random.default_rng(seed)
    rows = _rows(rng, width, n_counters)
    segs = _segments(rng)
    kw = dict(kw)
    if kw.get("embed_threshold") == "auto":
        kw["embed_threshold"] = _embed_threshold(rows, kw.get("cvm_offset", 2))
    return op, rows, segs, kw


def _ref(op, rows, segs, kw):
    return getattr(ref_ops, op)(jnp.asarray(rows), jnp.asarray(segs), B, S,
                                **kw)


def _port(op, rows, segs, kw):
    return getattr(ops, op)(rows, torch.from_numpy(segs), B, S, **kw)


def _outs(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("name", sorted(CASES))
def test_seqpool_variant_forward(name):
    op, rows, segs, kw = _case(name)
    want = _outs(_ref(op, rows, segs, kw))
    got = _outs(_port(op, torch.from_numpy(rows), segs, kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)
    if kw.get("need_filter"):
        # the filter dropped some occurrences and kept others
        assert 0 < np.abs(got[0].numpy()).sum()


@pytest.mark.parametrize("name", sorted(CASES))
def test_seqpool_variant_grad(name):
    """rows.grad against jax.grad: counters get none, filtered occurrences
    none, quantization the identity's."""
    op, rows, segs, kw = _case(name, seed=1)
    outs = _outs(_ref(op, rows, segs, kw))
    rng = np.random.default_rng(9)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def ref_loss(r):
        return sum((o * c).sum() for o, c in
                   zip(_outs(_ref(op, r, segs, kw)), cots))

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(rows)))
    r = torch.from_numpy(rows).requires_grad_(True)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in
               zip(_outs(_port(op, r, segs, kw)), cots))
    loss.backward()
    np.testing.assert_allclose(r.grad.numpy(), want, **GRAD)
    n_counters = CASES[name][2]
    assert not r.grad[:, :n_counters].any()  # counters are not learned
    assert not r.grad[N_REAL:].any()  # padding gets nothing
    if name == "quant":
        # straight-through: the pooled cotangent reaches every occurrence
        assert r.grad[:N_REAL, n_counters:].abs().sum() > 0


def test_quant_is_straight_through_and_rounds():
    """The quantized forward rounds like the reference's C cast, and the
    gradient is that of the identity."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(5, 7)).astype(np.float32)
    want = np.asarray(ref_ops.seqpool_cvm._quant_round(jnp.asarray(v), 128))
    t = torch.from_numpy(v).requires_grad_(True)
    got = ops.seqpool_cvm._quant_round(t, 128)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(v))


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if not n.startswith("pcoc")))
def test_pooled_width_matches_op_output(name):
    """pooled_width() is each op's per-slot width (the extended op's base
    block; the pcoc layout has its own 2 + 2 * pclk_num counter block)."""
    op, rows, segs, kw = _case(name)
    out = _outs(_port(op, torch.from_numpy(rows), segs, kw))[0]
    width = rows.shape[1] - kw.get("expand_dim", 0)
    layout = "conv" if op.endswith("_conv") else "default"
    co = kw.get("cvm_offset", 3 if layout == "conv" else 2)
    want = ops.pooled_width(width, co, kw.get("use_cvm", True), layout=layout,
                            show_filter=kw.get("show_filter", False))
    assert want == ref_ops.pooled_width(width, co, kw.get("use_cvm", True),
                                        layout=layout,
                                        show_filter=kw.get("show_filter",
                                                           False))
    assert out.shape == (B, S * want)


def test_extended_needs_expand_dim():
    rows = torch.zeros((K, 6))
    segs = torch.zeros(K, dtype=torch.int32)
    with pytest.raises(ValueError, match="expand_dim > 0"):
        ops.fused_seqpool_cvm_extended(rows, segs, B, S, 0)


@pytest.mark.parametrize("decay", [1.0, 0.98, 0.5])
def test_cvm_decayed_show(decay):
    rng = np.random.default_rng(4)
    x = _rows(rng, 6, 2)[:, None, :].repeat(2, axis=1)  # [K, 2, 6]
    want = ref_ops.cvm_decayed_show(jnp.asarray(x), decay)
    t = torch.from_numpy(x).requires_grad_(True)
    got = ops.cvm_decayed_show(t, decay)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    cot = rng.normal(size=want.shape).astype(np.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    g = jax.grad(lambda a: (ref_ops.cvm_decayed_show(a, decay) * cot).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(g))


def test_fused_concat_forward_and_grad():
    rng = np.random.default_rng(5)
    x1 = [rng.normal(size=(B, 4)).astype(np.float32) for _ in range(3)]
    x2 = [rng.normal(size=(B, 3)).astype(np.float32) for _ in range(3)]
    cols = [(0, 0), (1, 2), (0, 3), (1, 0), (0, 0)]
    want = ref_ops.fused_concat([jnp.asarray(a) for a in x1],
                                [jnp.asarray(a) for a in x2], cols)
    t1 = [torch.from_numpy(a).requires_grad_(True) for a in x1]
    t2 = [torch.from_numpy(a).requires_grad_(True) for a in x2]
    got = ops.fused_concat(t1, t2, cols)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    cots = [rng.normal(size=(B, len(cols))).astype(np.float32)
            for _ in range(3)]
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    g1, g2 = jax.grad(
        lambda a, b: sum((o * c).sum() for o, c in
                         zip(ref_ops.fused_concat(a, b, cols), cots)),
        argnums=(0, 1))([jnp.asarray(a) for a in x1],
                        [jnp.asarray(a) for a in x2])
    for t, w in zip(t1 + t2, list(g1) + list(g2)):
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(w))


@pytest.mark.parametrize("x2_len,cols,match", [
    (2, [(0, 0)], "slot count mismatch"),
    (3, [(0, 0), (2, 1)], "must be 0 \\(x1\\) or 1 \\(x2\\)"),
])
def test_fused_concat_errors(x2_len, cols, match):
    x1 = [torch.zeros((B, 2))] * 3
    x2 = [torch.zeros((B, 2))] * x2_len
    with pytest.raises(ValueError, match=match):
        ops.fused_concat(x1, x2, cols)
    with pytest.raises(ValueError, match=match):
        ref_ops.fused_concat([jnp.zeros((B, 2))] * 3,
                             [jnp.zeros((B, 2))] * x2_len, cols)


def _rank_case(seed, n=14, f=9, c=5, max_rank=3):
    """x [n, f], rank_offset [n, 2*max_rank+1] with unranked instances
    (own rank -1 or 0), missing peers (-1 rank or row) and peers of every
    rank, rank_param [max_rank^2 * f, c]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ro = np.full((n, 2 * max_rank + 1), -1, np.int32)
    ro[:, 0] = rng.choice([-1, 0, 1, 2, 3][: max_rank + 2], size=n)
    for k in range(max_rank):
        present = rng.random(n) < 0.7
        ro[present, 2 * k + 1] = k + 1
        ro[present, 2 * k + 2] = rng.integers(0, n, size=present.sum())
        gone = rng.random(n) < 0.15  # a rank without a row
        ro[gone & present, 2 * k + 2] = -1
    param = rng.normal(size=(max_rank * max_rank * f, c)).astype(np.float32)
    return x, ro, param, max_rank


# rank_attention sums the K * F products of a row in another order than the
# reference's single einsum (the f sum first, per parameter block):
# forward and gradients agree to rtol 1e-5, atol 1e-6
RANK_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_attention_forward_and_grads(seed):
    x, ro, param, r = _rank_case(seed)
    want = ref_ops.rank_attention(jnp.asarray(x), jnp.asarray(ro),
                                  jnp.asarray(param), r)
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = torch.from_numpy(param).requires_grad_(True)
    got = ops.rank_attention(tx, torch.from_numpy(ro), tp, r)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **RANK_TOL)
    # unranked instances, and instances none of whose peers is present,
    # read exact zeros
    peers = (ro[:, 1::2] > 0) & (ro[:, 2::2] >= 0)
    dead = (ro[:, 0] <= 0) | ~peers.any(1)
    assert dead.any() and (~dead).any()
    assert not got.detach().numpy()[dead].any()
    cot = np.random.default_rng(seed + 10).normal(
        size=want.shape).astype(np.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    gx, gp = jax.grad(
        lambda a, p: (ref_ops.rank_attention(a, jnp.asarray(ro), p, r)
                      * cot).sum(), argnums=(0, 1))(jnp.asarray(x),
                                                    jnp.asarray(param))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **RANK_TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), **RANK_TOL)
    assert ops.rank_attention2 is ops.rank_attention


def test_ins_rank():
    _, ro, _, _ = _rank_case(4)
    got = ops.ins_rank(torch.from_numpy(ro))
    want = ref_ops.ins_rank(jnp.asarray(ro))
    assert got.dtype == torch.float32 and got.shape == (ro.shape[0], 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_op_exports_match_reference():
    assert sorted(ops.__all__) == sorted(ref_ops.__all__)
