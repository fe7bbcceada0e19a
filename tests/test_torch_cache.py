"""The port's HBM cache tier against the JAX package: the three cache-tier
kernels' twins against the Pallas kernels (interpret mode), the cache
directory against the reference's, and the cached lifecycle, which must be
bit-exact with the uncached one within the port and agree with the
reference's cached run.  Plus the store's shrink/restore primitives and the
table barriers (shrink, load_state_dict, delta) against the reference.

On the CPU each kernel wrapper computes its plain twin; the CUDA kernels
are held against the twins on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.ops.pallas_sparse import (
    pallas_gather_slots,
    pallas_scatter_rows,
    pallas_sorted_search,
    split_u64,
)
from paddlebox_tpu.sparse.engine import HbmCache as RefCache
from paddlebox_tpu.sparse.store import BucketStore as RefStore
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ops import sparse_kernels as sk
from paddlebox_tpu_torch.sparse.engine import HbmCache
from paddlebox_tpu_torch.sparse.store import BucketStore
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

ALL_ONES = 2**64 - 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys_t(keys):
    """uint64 keys as the int64 tensor the port's sorted search takes."""
    return torch.from_numpy(np.asarray(keys, np.uint64).view(np.int64).copy())


def _pad_pow2(keys):
    n = keys.shape[0]
    cpad = 1 << max(0, (n - 1).bit_length()) if n else 0
    hay = np.full(cpad, ALL_ONES, np.uint64)
    hay[:n] = keys
    return hay


def _search_both(keys, q):
    """(port twin, Pallas kernel) positions of ``q`` in sorted ``keys``."""
    hay = _pad_pow2(keys)
    n = keys.shape[0]
    port = sk.sorted_search(_keys_t(hay), n, _keys_t(q)).numpy()
    ref_hay = (np.asarray(split_u64(hay)) if hay.shape[0]
               else np.zeros((0, 2), np.uint32))
    ref = pallas_sorted_search(
        jnp.asarray(ref_hay), jnp.asarray([n], jnp.int32), split_u64(q),
        interpret=True,
    )
    return port, np.asarray(ref)


# --------------------------------------------------------------------------- #
# kernel twins against the Pallas kernels (port of tests/test_pallas_sparse.py
# TestCacheKernels)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 8, 40])
def test_gather_slots_matches_pallas_with_misses(k):
    rng = np.random.default_rng(4 + k)
    table = rng.normal(size=(64, 12)).astype(np.float32)
    slots = rng.integers(-1, 64, size=k).astype(np.int32)
    slots[0] = -1
    want = pallas_gather_slots(jnp.asarray(table), jnp.asarray(slots),
                               interpret=True)
    got = sk.gather_slots(_t(table), _t(slots)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, np.where(slots[:, None] >= 0, table[np.maximum(slots, 0)], 0.0))


def test_gather_slots_all_miss_and_empty():
    table = np.arange(32, dtype=np.float32).reshape(8, 4)
    got = sk.gather_slots(_t(table), _t(np.full(8, -1, np.int32)))
    assert got.shape == (8, 4) and float(got.abs().sum()) == 0.0
    assert sk.gather_slots(_t(table), _t(np.zeros(0, np.int32))).shape == (0, 4)


# W = 10 and 11: the widths of the step's rows and of the cache's
@pytest.mark.parametrize("k, w", [
    pytest.param(8, 8, id="8"), pytest.param(16, 8, id="16"),
    pytest.param(8, 11, id="8-w11"), pytest.param(16, 10, id="16-w10"),
    pytest.param(16, 11, id="16-w11"),
])
def test_scatter_rows_matches_pallas_drops_negatives_last_wins(k, w):
    rng = np.random.default_rng(5 + k)
    table = rng.normal(size=(32, w)).astype(np.float32)
    slots = rng.integers(-1, 32, size=k).astype(np.int32)
    slots[k // 2] = slots[0] = 3  # a duplicate across the halves
    slots[1] = -1
    rows = rng.normal(size=(k, w)).astype(np.float32)
    want = pallas_scatter_rows(jnp.asarray(table), jnp.asarray(slots),
                               jnp.asarray(rows), interpret=True)
    port_table = _t(table)
    ret = sk.scatter_rows(port_table, _t(slots), _t(rows))
    assert ret is port_table  # in place
    np.testing.assert_array_equal(port_table.numpy(), np.asarray(want))
    seq = table.copy()
    for i, s in enumerate(slots):
        if s >= 0:
            seq[s] = rows[i]
    np.testing.assert_array_equal(port_table.numpy(), seq)


def test_sorted_search_matches_pallas_including_keys_above_2_63():
    rng = np.random.default_rng(6)
    keys = np.unique(np.concatenate([
        rng.integers(0, 2**63, size=60, dtype=np.uint64),
        rng.integers(0, 2**63, size=40, dtype=np.uint64) + np.uint64(2**63),
    ]))
    q = np.concatenate([
        keys[::3], np.asarray([12345, 2**63 + 17, 0, 2**63, ALL_ONES], np.uint64),
    ])
    port, ref = _search_both(keys, q)
    np.testing.assert_array_equal(port, ref)
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, keys.shape[0] - 1)
    np.testing.assert_array_equal(port, np.where(keys[pos_c] == q, pos_c, -1))
    assert port.dtype == np.int32 and (port[: keys[::3].shape[0]] >= 0).all()


def test_sorted_search_empty_miss_and_all_miss():
    keys = np.asarray([5, 9, 11, 40], np.uint64)
    port, ref = _search_both(keys, keys)
    np.testing.assert_array_equal(port, [0, 1, 2, 3])
    np.testing.assert_array_equal(port, ref)
    q = np.asarray([1, 6, 41, ALL_ONES], np.uint64)
    port, ref = _search_both(keys, q)
    np.testing.assert_array_equal(port, [-1, -1, -1, -1])
    np.testing.assert_array_equal(port, ref)
    port, ref = _search_both(np.empty(0, np.uint64), keys)
    np.testing.assert_array_equal(port, [-1] * 4)
    np.testing.assert_array_equal(port, ref)
    assert sk.sorted_search(_keys_t(keys), 4, _keys_t(keys[:0])).shape == (0,)


def test_sorted_search_max_key_vs_sentinel_padding():
    """A real all-ones key matches itself; a missing all-ones query does not
    match the all-ones padding."""
    keys = np.asarray([3, ALL_ONES], np.uint64)
    port, ref = _search_both(keys, keys)
    np.testing.assert_array_equal(port, [0, 1])
    np.testing.assert_array_equal(port, ref)
    keys2 = np.asarray([3, 9, 11], np.uint64)  # padded to 4 slots
    port, ref = _search_both(keys2, np.asarray([ALL_ONES], np.uint64))
    np.testing.assert_array_equal(port, [-1])
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_hbm_cache_lookup_matches_reference(use_pallas):
    """The port's lookup (sorted-search twin) gives the reference's plan,
    whether the reference resolves through numpy or the Pallas kernel."""
    rng = np.random.default_rng(7)
    ref, port = RefCache(64, 5), HbmCache(64, 5, device="cpu")
    high = np.uint64(2**63)
    keys = np.unique(np.concatenate([
        rng.integers(1, 500, size=40, dtype=np.uint64),
        rng.integers(0, 8, size=8, dtype=np.uint64) + high,
    ]))
    keys = np.append(keys, np.uint64(ALL_ONES))
    for c in (ref, port):
        c.keys[: keys.shape[0]] = keys
        c.used[: keys.shape[0]] = True
        c._rebuild_index()
    q = np.unique(np.concatenate([
        rng.integers(1, 600, size=80, dtype=np.uint64),
        rng.integers(0, 16, size=8, dtype=np.uint64) + high,
    ]))
    q = np.append(q, np.uint64(ALL_ONES))
    ref_config.flags.set("use_pallas_sparse", use_pallas)
    try:
        want = ref.lookup(q)
    finally:
        ref_config.flags.set("use_pallas_sparse", False)
    got = port.lookup(q)
    for f in ("hit_mask", "hit_pos", "hit_slots"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.n_hits > 8


def test_cpu_cache_wrappers_take_the_twin_and_launch_nothing():
    sk.reset_launches()
    table = torch.randn(10, 4)
    slots = torch.tensor([1, -1, 9], dtype=torch.int32)
    sk.gather_slots(table, slots)
    sk.scatter_rows(table, slots, torch.ones(3, 4))
    sk.sorted_search(_keys_t([2, 5]), 2, _keys_t([5]))
    assert sk.launches == {name: 0 for name in sk.KERNELS}


@pytest.mark.parametrize("case", [
    "gather_int64_slots", "rows_shape", "rows_dtype", "hay_not_pow2",
    "hay_int32", "n_real_past_hay",
])
def test_cache_wrappers_reject_what_the_kernels_do_not_take(case):
    table = torch.zeros(8, 3)
    slots = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        if case == "gather_int64_slots":
            sk.gather_slots(table, slots.long())
        elif case == "rows_shape":
            sk.scatter_rows(table, slots, torch.zeros(3, 3))
        elif case == "rows_dtype":
            sk.scatter_rows(table, slots, torch.zeros(2, 3, dtype=torch.float64))
        elif case == "hay_not_pow2":
            sk.sorted_search(_keys_t([1, 2, 3]), 3, _keys_t([2]))
        elif case == "hay_int32":
            sk.sorted_search(torch.zeros(2, dtype=torch.int32), 2, _keys_t([2]))
        else:
            sk.sorted_search(_keys_t([1, 2]), 3, _keys_t([2]))


# --------------------------------------------------------------------------- #
# the cache directory, decision by decision, against the reference's
# --------------------------------------------------------------------------- #
_DIRECTORY = ("keys", "used", "freq", "last_seen", "dirty", "_sorted_keys",
              "_sorted_slots")


def _assert_same_directory(ref, port):
    for f in _DIRECTORY:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ref.tick == port.tick
    np.testing.assert_array_equal(np.asarray(ref.rows), port.rows.numpy())


@pytest.mark.parametrize("capacity", [16, 64])
def test_hbm_cache_decisions_match_reference(capacity):
    """A scripted sequence of lookup / touch / plan_update / commit_update /
    drain / evict_keys / invalidate over overlapping censuses (keys above
    2^63 included): every plan array and the whole directory bit-equal,
    the rows equal."""
    rng = np.random.default_rng(capacity)
    n_cols = 5
    ref = RefCache(capacity, n_cols, aging=0.8)
    port = HbmCache(capacity, n_cols, aging=0.8, device="cpu")
    space = np.concatenate([
        np.arange(1, 40, dtype=np.uint64),
        np.arange(0, 10, dtype=np.uint64) + np.uint64(2**63),
        np.array([ALL_ONES], np.uint64),
    ])
    for p in range(7):
        pk = np.unique(rng.choice(space, size=24))
        plans = (ref.lookup(pk), port.lookup(pk))
        for f in ("hit_mask", "hit_pos", "hit_slots"):
            np.testing.assert_array_equal(getattr(plans[0], f),
                                          getattr(plans[1], f), err_msg=f)
        np.testing.assert_array_equal(
            np.asarray(ref.gather_rows(plans[0].hit_slots)),
            port.gather_rows(plans[1].hit_slots).numpy())
        ref.touch(plans[0])
        port.touch(plans[1])
        upds = (ref.plan_update(pk, plans[0]), port.plan_update(pk, plans[1]))
        for f in ("admit_pos", "admit_keys", "admit_slots", "victim_slots",
                  "victim_keys", "cold_pos"):
            a, b = getattr(upds[0], f), getattr(upds[1], f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        slots = np.concatenate([plans[1].hit_slots, upds[1].admit_slots])
        rows = rng.normal(size=(slots.shape[0], n_cols)).astype(np.float32)
        ref.set_rows(slots, jnp.asarray(rows))
        port.set_rows(slots, torch.from_numpy(rows))
        ref.commit_update(plans[0], upds[0])
        port.commit_update(plans[1], upds[1])
        _assert_same_directory(ref, port)
        if p == 2:
            (rk, rv), (pk2, pv) = ref.drain(), port.drain()
            np.testing.assert_array_equal(rk, pk2)
            np.testing.assert_array_equal(rv, pv)
            assert port.dirty_rows == 0 and pk2.shape[0] > 0
        if p == 4:
            gone = space[::3]
            assert ref.evict_keys(gone) == port.evict_keys(gone) > 0
        if p == 5:
            ref.invalidate()
            port.invalidate()
        _assert_same_directory(ref, port)
        assert ref.resident == port.resident <= capacity


# --------------------------------------------------------------------------- #
# the cached lifecycle: bit-exact with the uncached one, close to the
# reference's cached run (port of tests/test_hbm_cache.py TestBitExact)
# --------------------------------------------------------------------------- #
N_SLOTS, DENSE, N_PASSES = 3, 2, 3
TCONF = dict(embedding_dim=4, learning_rate=0.4, initial_range=0.05,
             store_buckets=16, plan_scratch_rows=64, show_decay_rate=0.5)
TRCONF = dict(dense_lr=3e-3, auc_buckets=1 << 12)


@pytest.fixture(scope="module")
def lifecycle_world(tmp_path_factory):
    """N_PASSES censuses over a shared key space (vocab 40: heavy overlap,
    so later passes hit), loaded into both packages, and the reference's
    initial tower."""
    files = [
        write_synth_files(
            str(tmp_path_factory.mktemp(f"cpass{p}")), n_files=2,
            ins_per_file=192, n_sparse_slots=N_SLOTS, vocab_per_slot=40,
            dense_dim=DENSE, seed=23 + p,
        )
        for p in range(N_PASSES)
    ]
    port_ds, ref_ds = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PBOX_USE_NATIVE_PARSER", "0")
        mp.setenv("PBOX_USE_NATIVE_PLANNER", "0")
        mp.delenv("PBOX_HBM_CACHE", raising=False)
        for fs in files:
            d = PadBoxSlotDataset(make_synth_config(N_SLOTS, DENSE, 64, 16),
                                  read_threads=2)
            r = RefDataset(ref_synth_config(N_SLOTS, DENSE, 64, 16),
                           read_threads=2)
            for ds in (d, r):
                ds.set_filelist(fs)
                ds.load_into_memory()
            port_ds.append(d)
            ref_ds.append(r)
        rconf = ref_config.SparseTableConfig(**TCONF)
        ref_trainer = RefTrainer(
            RefCtrDnn(N_SLOTS, rconf.row_width, dense_dim=DENSE, hidden=(16, 8)),
            rconf, ref_config.TrainerConfig(**TRCONF), seed=3,
        )
        tower = [{k: np.array(v) for k, v in layer.items()}
                 for layer in ref_trainer.params["tower"]]
        yield {"port": port_ds, "ref": ref_ds, "tower": tower, "runs": {}}
    for ds in port_ds + ref_ds:
        ds.close()


def _run(world, side: str, cache_rows: int):
    """Train N_PASSES with a checkpoint round-trip and a shrink after pass
    1; returns (state_dict, delta, last metrics, per-pass (hits, misses),
    table).  Runs are memoized per world."""
    key = (side, cache_rows)
    if key in world["runs"]:
        return world["runs"][key]
    if side == "port":
        tconf = SparseTableConfig(hbm_cache_rows=cache_rows, **TCONF)
        table = SparseTable(tconf, seed=3, device="cpu")
        model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE,
                       hidden=(16, 8), device="cpu")
        model.load_state_dict(params_from_jax(world["tower"]))
        trainer = Trainer(model, tconf, TrainerConfig(**TRCONF), device="cpu")
    else:
        tconf = ref_config.SparseTableConfig(
            hbm_cache_rows=cache_rows, placement="hash",
            overlap_pass_boundary=False, **TCONF)
        table = RefTable(tconf, seed=3)
        trainer = RefTrainer(
            RefCtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE, hidden=(16, 8)),
            tconf, ref_config.TrainerConfig(**TRCONF), seed=3,
        )
    auc_state, metrics, counts = None, None, []
    for p, ds in enumerate(world[side]):
        table.begin_pass(ds.unique_keys())
        counts.append((table.last_cache_hits, table.last_cache_misses))
        metrics = trainer.train_from_dataset(ds, table, auc_state=auc_state,
                                             drop_last=True)
        auc_state = (trainer.last_auc_state if side == "port"
                     else trainer.last_metric_state)
        table.end_pass()
        if p == 1:
            snap = table.state_dict()
            table.load_state_dict(snap)
            table.shrink()
    out = (table.state_dict(), table.pop_delta(), metrics, counts, table)
    world["runs"][key] = out
    return out


def _assert_state_equal(a, b):
    np.testing.assert_array_equal(a["keys"], b["keys"])
    # [show, clk, embed..., g2sum]: counters, embeddings and optimizer state
    np.testing.assert_array_equal(a["values"], b["values"])


@pytest.mark.parametrize("cache_rows", [1 << 16, 8])
def test_port_cached_lifecycle_bit_exact_with_uncached(lifecycle_world,
                                                       cache_rows):
    """At the default capacity and at 8 rows (admission and eviction every
    pass, rows bouncing between cache and store): keys, values, g2sum,
    the delta, loss and AUC all bit-exact."""
    sd_u, delta_u, m_u, _, _ = _run(lifecycle_world, "port", 0)
    sd_c, delta_c, m_c, counts, table = _run(lifecycle_world, "port",
                                             cache_rows)
    _assert_state_equal(sd_u, sd_c)
    _assert_state_equal(delta_u, delta_c)
    assert m_u["auc"] == m_c["auc"] and m_u["loss"] == m_c["loss"]
    assert table._caches()[0].resident <= cache_rows
    # pass 1 hits what pass 0 admitted; the shrink after pass 1 empties
    # the cache, so pass 2 re-warms it from misses only
    assert counts[0][0] == 0 and counts[1][0] > 0 and counts[2][0] == 0
    assert sum(h + m for h, m in counts) > 0


@pytest.mark.parametrize("cache_rows", [1 << 16, 8])
def test_port_cached_lifecycle_matches_reference_cached(lifecycle_world,
                                                        cache_rows):
    """The reference's cached run (serial, hash placement): keys, counters
    and per-pass hit and miss counts exact; float state at the tolerances
    of test_slice_matches_reference_trainer."""
    sd_r, delta_r, m_r, counts_r, _ = _run(lifecycle_world, "ref", cache_rows)
    sd_p, delta_p, m_p, counts_p, _ = _run(lifecycle_world, "port", cache_rows)
    assert counts_p == counts_r
    for a, b in ((sd_r, sd_p), (delta_r, delta_p)):
        np.testing.assert_array_equal(a["keys"], b["keys"])
        # counters are sums of 0/1 and their decay: exact
        np.testing.assert_array_equal(b["values"][:, :2], a["values"][:, :2])
        # float32 sums and matmuls run in another order on the two CPU
        # backends (~1e-7 per op), as in the single-pass slice test
        np.testing.assert_allclose(b["values"], a["values"], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(m_p["loss"], m_r["loss"], rtol=1e-5)
    assert abs(m_p["auc"] - m_r["auc"]) < 1e-4


# --------------------------------------------------------------------------- #
# cache behavior (port of tests/test_hbm_cache.py TestCacheBehavior)
# --------------------------------------------------------------------------- #
def _cached_table(cache_rows=1 << 16):
    return SparseTable(SparseTableConfig(hbm_cache_rows=cache_rows, **TCONF),
                       seed=0, device="cpu")


def test_promotion_patch_shrinks_to_cold_keys():
    t = _cached_table()
    keys = np.arange(1, 100, dtype=np.uint64)
    t.begin_pass(keys)
    assert t.last_cache_misses == 99 and t.last_cache_hits == 0
    t.values = t.values + 1.0
    t.end_pass()
    # the same census again: all hot, the host supplies nothing
    t.begin_pass(keys)
    assert t.last_cache_hits == 99 and t.last_cache_misses == 0
    assert (t.values[:99, 0] == 1.0).all()
    t.end_pass()
    # a half-new census fetches exactly the cold half
    t.begin_pass(np.arange(50, 150, dtype=np.uint64))
    assert t.last_cache_hits == 50 and t.last_cache_misses == 50
    t.end_pass()
    t.flush()


def test_hot_rows_skip_store_until_drain():
    """Hits never leave the device: the store stays empty across passes and
    only the flush barrier (drain) lands the rows."""
    t = _cached_table()
    keys = np.arange(1, 50, dtype=np.uint64)
    for _ in range(3):
        t.begin_pass(keys)
        t.values = t.values + 1.0
        t.end_pass()
    assert t._store.n == 0  # nothing cold, nothing evicted
    assert t.n_features == 49  # the barrier drains the dirty rows
    vals, found = t._store.lookup(keys)
    assert found.all() and (vals[:, 0] == 3.0).all()


def test_eviction_writes_rows_back():
    t = _cached_table(8)
    a = np.arange(1, 9, dtype=np.uint64)
    b = np.arange(100, 108, dtype=np.uint64)
    t.begin_pass(a)
    t.values = t.values + 7.0
    t.end_pass()
    assert t._store.n == 0  # all 8 admitted
    # a disjoint census twice: a's aged-out rows are evicted for b, and
    # their values are kept through the store
    for _ in range(2):
        t.begin_pass(b)
        t.end_pass()
    # the overlapped default merges on the table's thread: wait for the
    # merges alone (a flush would also drain the cache)
    for fut in t._merge_futures:
        fut.result()
    vals, found = t._store.lookup(a)
    assert found.all() and (vals[:, 0] == 7.0).all()  # before any flush
    assert t._caches()[0].resident <= 8
    assert set(t._caches()[0].snapshot_keys()) == set(b)
    # an evicted row is written back even when it is clean (drained, so
    # the store holds it already): a staged next pass relies on it
    t = _cached_table(8)
    t.begin_pass(a)
    t.end_pass()
    t.flush()
    t.begin_pass(b)
    t.end_pass()
    assert t.last_evicted_rows == 8 and t.last_write_back_rows == 8


def test_cache_is_on_by_default_and_its_kill_switch(monkeypatch):
    assert SparseTableConfig().hbm_cache_rows == 1 << 16
    keys = np.arange(1, 30, dtype=np.uint64)
    t = SparseTable(SparseTableConfig(embedding_dim=4), device="cpu")
    t.begin_pass(keys)
    t.end_pass()
    assert len(t._caches()) == 1 and t._store.n == 0
    monkeypatch.setenv("PADDLEBOX_TORCH_HBM_CACHE", "0")
    t = SparseTable(SparseTableConfig(embedding_dim=4), device="cpu")
    t.begin_pass(keys)
    t.end_pass()
    assert t._caches() == []
    t.flush()  # the overlapped default merges on its thread until a barrier
    assert t._store.n == 29  # the full write-back of the uncached lifecycle


# --------------------------------------------------------------------------- #
# store primitives and table barriers against the reference
# --------------------------------------------------------------------------- #
def test_store_decay_evict_load_bulk_and_clear_match_reference():
    rng = np.random.default_rng(9)
    ref, port = RefStore(n_cols=4, n_buckets=8), BucketStore(n_cols=4, n_buckets=8)
    q = np.unique(rng.integers(0, 300, size=150).astype(np.uint64))
    vals = rng.uniform(0, 2, size=(q.shape[0], 4)).astype(np.float32)
    for s in (ref, port):
        s.update(q, vals)
    assert (ref.decay_evict(2, 0.7, 0.5) == port.decay_evict(2, 0.7, 0.5) > 0)
    assert ref.decay_evict(2, 0.9, 0.0) == port.decay_evict(2, 0.9, 0.0) == 0
    for a, b in zip(ref.materialize(), port.materialize()):
        np.testing.assert_array_equal(a, b)
    # unsorted keys with duplicates: the last occurrence wins
    keys = np.array([9, 2**63 + 1, 4, 9, 4, 7], np.uint64)
    rows = rng.normal(size=(6, 4)).astype(np.float32)
    for s in (ref, port):
        s.load_bulk(keys, rows)
    for a, b in zip(ref.materialize(), port.materialize()):
        np.testing.assert_array_equal(a, b)
    assert port.n == 4
    np.testing.assert_array_equal(port.lookup(np.array([9], np.uint64))[0],
                                  rows[3:4])
    port.clear()
    assert port.n == 0 and port.materialize()[0].shape == (0,)


@pytest.mark.parametrize("barrier", ["shrink", "load_state_dict", "delta"])
def test_barriers_match_reference(barrier):
    """Two passes with a deterministic in-pass update, the barrier, one more
    pass: the store (and the delta, the evicted count) bit-exact against the
    reference's serial, uncached table.  The port runs both with and
    without its cache."""
    base = dict(embedding_dim=4, initial_range=0.5, plan_scratch_rows=64,
                store_buckets=8, show_decay_rate=0.5, delete_threshold=1.2)
    ref = RefTable(ref_config.SparseTableConfig(
        hbm_cache_rows=0, overlap_pass_boundary=False, **base), seed=2)
    ports = [SparseTable(SparseTableConfig(hbm_cache_rows=c, **base), seed=2,
                         device="cpu") for c in (0, 1 << 16)]
    censuses = [np.arange(1, 40, dtype=np.uint64),
                np.arange(20, 60, dtype=np.uint64),
                np.array([5, 50, 70, 2**63 + 3], np.uint64)]

    def one_pass(t, keys, is_ref):
        t.begin_pass(keys)
        n = keys.shape[0]
        if is_ref:
            t.values = t.values.at[:n].add(1.0)
            t.g2sum = t.g2sum.at[:n].add(0.5)
        else:
            t.values[:n] += 1.0
            t.g2sum[:n] += 0.5
        t.end_pass()

    results = []
    for t in [ref] + ports:
        is_ref = t is ref
        for keys in censuses[:2]:
            one_pass(t, keys, is_ref)
        out = {}
        if barrier == "shrink":
            out["evicted"] = t.shrink()
        elif barrier == "load_state_dict":
            snap = t.state_dict()
            snap["values"] = snap["values"] * np.float32(0.5)
            t.load_state_dict(snap)
        else:
            out["delta"] = t.pop_delta()
            t.apply_delta({"keys": out["delta"]["keys"],
                           "values": out["delta"]["values"] + np.float32(2)})
        one_pass(t, censuses[2], is_ref)
        out["state"] = t.state_dict()
        out["delta_after"] = t.delta_state_dict()
        results.append(out)
    want = results[0]
    for got in results[1:]:
        for k in want:
            if k == "evicted":
                assert got[k] == want[k] > 0
            else:
                _assert_state_equal(got[k], want[k])
