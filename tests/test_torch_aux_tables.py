"""InputTable and ReplicaCache of the port (sparse/aux_tables.py) against
the JAX package's, on the CPU: the cases of
tests/test_capability_tail.py::test_input_table_and_replica_cache, each
answer equal to the reference's."""

import jax.numpy as jnp
import numpy as np
import torch

from paddlebox_tpu.sparse.aux_tables import InputTable as RefInputTable
from paddlebox_tpu.sparse.aux_tables import ReplicaCache as RefReplicaCache
from paddlebox_tpu.sparse.aux_tables import pull_cache_value as ref_pull
from paddlebox_tpu_torch.sparse.aux_tables import (
    InputTable,
    ReplicaCache,
    pull_cache_value,
)
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)


def test_input_table_matches_reference():
    t, rt = InputTable(dim=3, device="cpu"), RefInputTable(dim=3)
    for table in (t, rt):
        assert table.add_row("ad-1", [1.0, 2.0, 3.0]) == 1
        assert table.add_row("ad-2", [4.0, 5.0, 6.0]) == 2
    idx = t.lookup_idx(["ad-2", "missing", "ad-1"])
    np.testing.assert_array_equal(idx, [2, 0, 1])
    np.testing.assert_array_equal(idx, rt.lookup_idx(["ad-2", "missing",
                                                      "ad-1"]))
    rows = t.lookup_rows(["ad-2", "missing"])
    np.testing.assert_allclose(rows, [[4, 5, 6], [0, 0, 0]])
    np.testing.assert_array_equal(rows, rt.lookup_rows(["ad-2", "missing"]))
    # the device gather
    dev = t.rows_device().index_select(0, torch.from_numpy(idx))
    np.testing.assert_allclose(dev.numpy(), [[4, 5, 6], [0, 0, 0], [1, 2, 3]])
    want = np.asarray(jnp.take(rt.rows_device(), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(dev.numpy(), want)
    # a re-added key overwrites its row and refreshes the device copy
    assert t.add_row("ad-1", [7.0, 8.0, 9.0]) == 1 and len(t) == 3
    np.testing.assert_array_equal(t.rows_device()[1].numpy(), [7, 8, 9])
    # state roundtrip, and across packages
    t2 = InputTable(dim=3, device="cpu")
    t2.load_state_dict(t.state_dict())
    np.testing.assert_array_equal(t2.lookup_idx(["ad-1", "ad-2"]), [1, 2])
    rt2 = RefInputTable(dim=3)
    rt2.load_state_dict(t.state_dict())
    np.testing.assert_array_equal(rt2.lookup_rows(["ad-1"]), [[7, 8, 9]])


def test_replica_cache_matches_reference():
    m = np.array([[1.0, 1.0], [2.0, 2.0]])
    cache, ref = ReplicaCache(m, device="cpu"), RefReplicaCache(m)
    assert cache.n_rows == ref.n_rows == 2
    ids = np.array([1, 2, 0, 99, -3])
    out = cache.pull(ids)
    np.testing.assert_allclose(out.numpy(), [[1, 1], [2, 2], [0, 0], [0, 0],
                                             [0, 0]])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref.pull(ids)))
    # any id shape: [*ids, dim]
    ids2 = np.array([[2, 5], [1, 0]], np.int32)
    got = pull_cache_value(cache.values, torch.from_numpy(ids2))
    assert got.shape == (2, 2, 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_pull(ref.values, jnp.asarray(ids2))))
