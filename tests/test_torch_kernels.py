"""The port's two sparse kernels (paddlebox_tpu_torch/ops/sparse_kernels.py)
against the Pallas kernels they replace and the reference's table routing.

On the CPU each wrapper computes its plain twin, so these tests pin the
twins' semantics to the Pallas kernels (run in interpret mode, as
tests/test_pallas_sparse.py runs them) and to the XLA path the reference
takes with the Pallas flag off.  The CUDA kernels themselves are held
against the twins on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as ref_flags
from paddlebox_tpu.ops.pallas_sparse import pallas_pull_rows, pallas_scatter_add
from paddlebox_tpu.sparse import table as ref_table
from paddlebox_tpu_torch.ops import sparse_kernels as sk
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def pallas_flag():
    ref_flags.set("use_pallas_sparse", True)
    yield
    ref_flags.set("use_pallas_sparse", False)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pull_rows_matches_pallas_pull_rows():
    rng = np.random.default_rng(0)
    values = rng.normal(size=(64, 12)).astype(np.float32)
    idx = rng.integers(0, 64, size=32).astype(np.int32)
    want = pallas_pull_rows(jnp.asarray(values), jnp.asarray(idx), interpret=True)
    got = sk.pull_rows(_t(values), _t(idx))
    # a gather copies bits: bit-exact
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_add_rows_matches_pallas_with_duplicates():
    rng = np.random.default_rng(1)
    values = rng.normal(size=(32, 8)).astype(np.float32)
    idx = np.array([3, 7, 3, 3, 31, 31, 0, 7], dtype=np.int32)
    delta = rng.normal(size=(8, 8)).astype(np.float32)
    want = pallas_scatter_add(
        jnp.asarray(values), jnp.asarray(idx), jnp.asarray(delta),
        interpret=True,
    )
    got = sk.scatter_add_rows(_t(values), _t(idx), _t(delta))
    # duplicates: the Pallas kernel sums them by matmul, the twin in index
    # order; float32 reorder of <= 3 terms of unit size stays below 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_scatter_add_rows_duplicates_across_tiles():
    rng = np.random.default_rng(2)
    values = rng.normal(size=(16, 8)).astype(np.float32)
    idx = np.concatenate([np.arange(16), np.arange(16)] * 2).astype(np.int32)
    delta = rng.normal(size=(64, 8)).astype(np.float32)
    want = pallas_scatter_add(
        jnp.asarray(values), jnp.asarray(idx), jnp.asarray(delta),
        interpret=True,
    )
    got = sk.scatter_add_rows(_t(values), _t(idx), _t(delta))
    # 4 hits per row, summed in another order than the tiles: float32 reorder
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 40, 1024])
def test_pull_rows_odd_and_large_shapes(k):
    rng = np.random.default_rng(3 + k)
    values = rng.normal(size=(128, 12)).astype(np.float32)
    idx = rng.integers(0, 128, size=k).astype(np.int32)
    want = pallas_pull_rows(jnp.asarray(values), jnp.asarray(idx), interpret=True)
    got = sk.pull_rows(_t(values), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), values[idx])


# the card kernel's paths: W = 10 and 2 take the float2 tiles (204 and
# 1024 rows a tile, K = 205 a last tile of one row), W = 3 and 11 the
# scalar path; K = 1 the smallest launch
@pytest.mark.parametrize("w, k", [(10, 1), (10, 205), (2, 1025), (3, 7),
                                  (11, 40), (11, 1)])
def test_pull_rows_card_path_shapes_match_pallas(w, k):
    rng = np.random.default_rng(5 + w + k)
    values = rng.normal(size=(300, w)).astype(np.float32)
    idx = rng.integers(0, 300, size=k).astype(np.int32)
    want = pallas_pull_rows(jnp.asarray(values), jnp.asarray(idx), interpret=True)
    got = sk.pull_rows(_t(values), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_rows_scratch_is_retired_not_freed(monkeypatch):
    """The scatter_rows scratch bookkeeping (plain Python, so CPU tensors
    stand in for the card's): sizes are the next power of two of the
    table's rows, a larger table swaps the scratch, and a swapped or
    dropped scratch stays referenced in the retired list, where a captured
    CUDA graph may still write to it.  After a drop the next scratch is
    fresh, zeroed and at least as large."""
    monkeypatch.setattr(sk, "_scatter_rows_tags", {})
    monkeypatch.setattr(sk, "_scatter_rows_retired", {})

    def retired():
        return [id(t) for t in sk._scatter_rows_retired.get(None, [])]

    t1 = sk._scatter_rows_tag(torch.empty(3000, 11))
    assert t1.shape == (4096,) and t1.dtype == torch.int32
    assert not bool(t1.any())
    assert sk._scatter_rows_tag(torch.empty(4096, 11)) is t1  # it fits
    assert sk._scatter_rows_tag(torch.empty(10, 11)) is t1
    assert retired() == []
    t2 = sk._scatter_rows_tag(torch.empty(4097, 11))  # swap
    assert t2.shape == (8192,) and retired() == [id(t1)]
    t2.fill_(5)  # tags a failed elect launch left set
    sk._retire_scatter_rows_tag(None)  # the failed call's drop
    assert retired() == [id(t1), id(t2)]
    assert None not in sk._scatter_rows_tags
    t3 = sk._scatter_rows_tag(torch.empty(100, 11))
    assert t3.shape == (8192,) and not bool(t3.any())
    assert retired() == [id(t1), id(t2)]
    t4 = sk._scatter_rows_tag(torch.empty(20000, 11))
    assert t4.shape == (32768,) and retired() == [id(t1), id(t2), id(t3)]
    sizes = [t.shape[0] for t in sk._scatter_rows_retired[None]]
    assert sizes == [4096, 8192, 8192]
    sk._retire_scatter_rows_tag(None)  # nothing live: a no-op after this
    sk._retire_scatter_rows_tag(None)
    assert len(retired()) == 4


# W = 10 and 11 are the card paths' widths (the float2 reductions on the
# step's 10-float rows, the scalar ones on the cache's 11)
@pytest.mark.parametrize("u, w", [
    pytest.param(3, 12, id="3"), pytest.param(40, 12, id="40"),
    pytest.param(256, 12, id="256"), pytest.param(3, 10, id="3-w10"),
    pytest.param(40, 10, id="40-w10"), pytest.param(3, 11, id="3-w11"),
    pytest.param(40, 11, id="40-w11"),
])
def test_scatter_add_rows_odd_and_large_shapes(u, w):
    rng = np.random.default_rng(7 + u)
    values = rng.normal(size=(128, w)).astype(np.float32)
    idx = rng.integers(0, 128, size=u).astype(np.int32)
    delta = rng.normal(size=(u, w)).astype(np.float32)
    want = pallas_scatter_add(
        jnp.asarray(values), jnp.asarray(idx), jnp.asarray(delta),
        interpret=True,
    )
    got = sk.scatter_add_rows(_t(values), _t(idx), _t(delta))
    # random duplicates (up to ~8 hits a row at u=256): float32 reorder
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_twins_match_reference_table_routing(use_pallas):
    """The reference's gather_rows / scatter_add_rows with the Pallas flag
    on (interpret mode) and off (XLA gather / scatter)."""
    ref_flags.set("use_pallas_sparse", use_pallas)
    try:
        rng = np.random.default_rng(11)
        values = rng.normal(size=(96, 11)).astype(np.float32)
        # 24 targets: 8-row Pallas tiles, three of them
        idx = rng.permutation(95)[:24].astype(np.int32)
        idx[-5:] = 95  # repeated dead-row targets ...
        delta = rng.normal(size=(24, 11)).astype(np.float32)
        delta[-5:] = 0.0  # ... whose deltas push_and_update zeroes
        want_pull = ref_table.gather_rows(jnp.asarray(values), jnp.asarray(idx))
        want_push = ref_table.scatter_add_rows(
            jnp.asarray(values), jnp.asarray(idx), jnp.asarray(delta),
            unique=True,
        )
    finally:
        ref_flags.set("use_pallas_sparse", False)
    np.testing.assert_array_equal(
        sk.pull_rows(_t(values), _t(idx)).numpy(), np.asarray(want_pull)
    )
    # unique targets plus adds of zero: one add per element, bit-exact
    np.testing.assert_array_equal(
        sk.scatter_add_rows(_t(values), _t(idx), _t(delta)).numpy(),
        np.asarray(want_push),
    )


def test_cpu_wrappers_take_the_twin_and_launch_nothing():
    sk.reset_launches()
    values = torch.randn(10, 4)
    idx = torch.tensor([1, 9, 1], dtype=torch.int32)
    out = sk.pull_rows(values, idx)
    assert torch.equal(out, values.index_select(0, idx))
    ret = sk.scatter_add_rows(values, idx, torch.ones(3, 4))
    assert ret is values  # in place
    assert sk.pull_rows(values, idx[:0]).shape == (0, 4)
    assert sk.launches == {name: 0 for name in sk.KERNELS}


@pytest.mark.parametrize("case", [
    "int64_idx", "f64_values", "2d_idx", "delta_shape", "delta_dtype",
])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    values = torch.zeros(8, 3)
    idx = torch.zeros(2, dtype=torch.int32)
    delta = torch.zeros(2, 3)
    if case == "int64_idx":
        idx = idx.long()
    elif case == "f64_values":
        values = values.double()
    elif case == "2d_idx":
        idx = idx[:, None]
    elif case == "delta_shape":
        delta = torch.zeros(3, 3)
    else:
        delta = delta.double()
    with pytest.raises(ValueError):
        if case.startswith("delta"):
            sk.scatter_add_rows(values, idx, delta)
        else:
            sk.pull_rows(values, idx)
