"""The port's per-shard HBM caches on the sharded table against the JAX
package: the metadata-only cache twin and ``take_rows`` against the
reference's HbmCache, the fleet cache mirror and the census wire against
the reference's (residents, censuses and wire bytes bit-equal), and the
cached sharded lifecycle, which must be bit-exact with the port's uncached
one (checkpoint round trip, shrink, staging and the fault-site fallbacks
included) and agree with the reference's cached run.  Plus the fault sites
of the single-chip cache (port of tests/test_hbm_cache.py TestChaos).

On the CPU every kernel wrapper computes its plain twin; chip_smoke.py
holds the CUDA kernels against the twins on the card and counts their
launches on the cached sharded path.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models.ctr_dnn import CtrDnn as RefCtrDnn
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.parallel.census import CensusExchange as RefExchange
from paddlebox_tpu.parallel.census import FleetCacheMirror as RefMirror
from paddlebox_tpu.parallel.census import InProcessCensusGroup as RefGroup
from paddlebox_tpu.sparse.engine import HbmCache as RefCache
from paddlebox_tpu.sparse.placement import PlacementPlanner as RefPlanner
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.parallel.census import (
    CensusExchange,
    FleetCacheMirror,
    InProcessCensusGroup,
    legacy_union,
)
from paddlebox_tpu_torch.sparse.engine import HbmCache
from paddlebox_tpu_torch.sparse.placement import PlacementPlanner
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, BSZ, VOCAB, PASSES = 3, 2, 16, 60, 3
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")
# the reference's placement pin (tests/test_placement.py:_train_sharded):
# a 64-row cache, 16 rows a shard at n = 4, so admission and eviction run
# every pass, and a hot block that realizes at the third begin_pass
TABLE_KW = dict(embedding_dim=4, placement_update_interval=1,
                placement_hot_capacity=64)


# --------------------------------------------------------------------------- #
# the cache twin and take_rows against the reference's HbmCache
# --------------------------------------------------------------------------- #
def _census_seq(rng, n_passes=6):
    space = np.concatenate([np.arange(1, 60, dtype=np.uint64),
                            np.arange(0, 8, dtype=np.uint64)
                            + np.uint64(2**63)])
    return [np.unique(rng.choice(space, size=30)) for _ in range(n_passes)]


def test_twin_has_no_rows_and_decides_like_the_reference():
    """A metadata-only twin holds no rows and no device (gather, set and
    drain raise, as the reference's do) and takes every directory decision
    the reference's twin takes."""
    ref = RefCache(16, 1, aging=0.8, materialize_rows=False)
    port = HbmCache(16, 1, aging=0.8, materialize_rows=False)
    assert port.rows is None and port.device is None
    for pk in _census_seq(np.random.default_rng(3)):
        plans = (ref.lookup(pk), port.lookup(pk))
        for f in ("hit_mask", "hit_pos", "hit_slots"):
            np.testing.assert_array_equal(getattr(plans[0], f),
                                          getattr(plans[1], f))
        ref.touch(plans[0])
        port.touch(plans[1])
        upds = (ref.plan_update(pk, plans[0]), port.plan_update(pk, plans[1]))
        ref.commit_update(plans[0], upds[0])
        port.commit_update(plans[1], upds[1])
        np.testing.assert_array_equal(ref.snapshot_keys(),
                                      port.snapshot_keys())
        np.testing.assert_array_equal(ref.freq, port.freq)
    for call in (lambda: port.gather_rows(np.array([0])),
                 lambda: port.set_rows(np.array([0]), torch.zeros((1, 1))),
                 port.drain):
        with pytest.raises(RuntimeError, match="metadata-only"):
            call()
    port.set_rows(np.empty(0, np.int32), torch.zeros((0, 1)))  # no-op


@pytest.mark.parametrize("pad_to", [None, 32])
def test_take_rows_matches_reference(pad_to):
    """Read and evict: the hit mask and rows equal the reference's, the
    taken keys leave the directory clean, and the rest stays."""
    rng = np.random.default_rng(7)
    ref = RefCache(32, 5, aging=0.8)
    port = HbmCache(32, 5, aging=0.8, device="cpu")
    pk = np.unique(rng.integers(1, 200, 40).astype(np.uint64))
    for c in (ref, port):
        plan = c.lookup(pk)
        c.touch(plan)
        upd = c.plan_update(pk, plan)
        rows = np.arange(upd.admit_slots.shape[0] * 5,
                         dtype=np.float32).reshape(-1, 5)
        c.set_rows(upd.admit_slots,
                   jnp.asarray(rows) if c is ref else torch.from_numpy(rows))
        c.commit_update(plan, upd)
    want = np.concatenate([pk[::3], np.array([9999], np.uint64)])
    (rh, rr), (ph, pr) = (ref.take_rows(want, pad_to=pad_to),
                          port.take_rows(want, pad_to=pad_to))
    np.testing.assert_array_equal(rh, ph)
    np.testing.assert_array_equal(np.asarray(rr), pr)
    assert ph.sum() > 0 and not ph[-1]
    np.testing.assert_array_equal(ref.snapshot_keys(), port.snapshot_keys())
    assert not np.isin(want, port.snapshot_keys()).any()
    assert port.dirty_rows == ref.dirty_rows
    # a second take finds nothing
    hit, rows = port.take_rows(want)
    assert not hit.any() and rows.shape == (0, 5)


# --------------------------------------------------------------------------- #
# the fleet cache mirror and the census wire (port of tests/test_placement.py)
# --------------------------------------------------------------------------- #
def _run_ranks(n, fn):
    out, errs = [None] * n, []

    def wrap(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    if errs:
        raise errs[0]
    return out


def _rank_censuses(n_ranks, n_passes, seed=5):
    rng = np.random.default_rng(seed)
    shared = np.arange(0, 400, 3, dtype=np.uint64)
    return [[np.unique(np.concatenate([
        shared, rng.integers(1000, 4000, 60, dtype=np.uint64)]))
        for _ in range(n_ranks)] for _ in range(n_passes)]


def _exchange_arm(group, exchange_cls, planner_cls, mirror_cls, censuses,
                  n, with_mirror, realize=False, cap=64):
    def rank_fn(r):
        ex = exchange_cls(
            group.transport(r),
            planner=planner_cls(hot_capacity=256, update_interval=1)
            if planner_cls else None,
            mirror=mirror_cls(n, cap, 0.8) if with_mirror else None,
            realize=realize,
        )
        out = []
        for p in range(len(censuses)):
            pk = ex.exchange(censuses[p][r])
            res = ([ex.mirror.shard_resident(o).copy() for o in range(n)]
                   if with_mirror else [])
            out.append((pk, ex.last_wire_bytes, res))
        return out

    return _run_ranks(n, rank_fn)


@pytest.mark.parametrize("planner,realize", [(False, False), (True, False),
                                             (True, True)])
def test_mirror_and_wire_match_reference(planner, realize):
    """Two ranks, five passes, a mirror of 64 rows a shard: the global
    census equals the legacy union and the reference's, the wire bytes
    equal the reference's (so the dictionary, planner hot set plus mirror
    residents, is the reference's), and every rank's mirror holds the
    reference's residents for every shard."""
    n, passes = 2, 5
    censuses = _rank_censuses(n, passes, seed=11)
    port = _exchange_arm(InProcessCensusGroup(n), CensusExchange,
                         PlacementPlanner if planner else None,
                         FleetCacheMirror, censuses, n, True, realize)
    ref = _exchange_arm(RefGroup(n), RefExchange,
                        RefPlanner if planner else None, RefMirror,
                        censuses, n, True, realize)
    for p in range(passes):
        want = legacy_union([censuses[p][r] for r in range(n)])
        for r in range(n):
            (pk, wire, res), (rpk, rwire, rres) = port[r][p], ref[r][p]
            np.testing.assert_array_equal(pk, want)
            np.testing.assert_array_equal(rpk, want)
            assert wire == rwire
            for a, b in zip(res, rres):
                np.testing.assert_array_equal(a, b)
    # the mirror joined the dictionary: later passes ship fewer bytes
    assert port[0][-1][1] < port[0][0][1]


def test_cached_vs_uncached_census_equality():
    """Cache state compresses the wire, never changes the census (port of
    tests/test_placement.py::test_cached_vs_uncached_lifecycle_equality)."""
    n, passes = 2, 5
    censuses = _rank_censuses(n, passes, seed=11)
    cached = _exchange_arm(InProcessCensusGroup(n), CensusExchange, None,
                           FleetCacheMirror, censuses, n, True, cap=128)
    uncached = _exchange_arm(InProcessCensusGroup(n), CensusExchange, None,
                             FleetCacheMirror, censuses, n, False)
    for p in range(passes):
        for r in range(n):
            np.testing.assert_array_equal(cached[r][p][0], uncached[0][p][0])


def test_mirror_tracks_real_cache_membership():
    """Each rank keeps a real HbmCache for its own shard: every rank's
    mirror predicts every shard's membership exactly."""
    n, passes, cap = 2, 5, 64
    censuses = _rank_censuses(n, passes)
    group = InProcessCensusGroup(n)

    def rank_fn(r):
        ex = CensusExchange(group.transport(r),
                            mirror=FleetCacheMirror(n, cap, 0.8))
        real = HbmCache(cap, 4, aging=0.8, device="cpu")
        for p in range(passes):
            pk = ex.exchange(censuses[p][r])
            sk = pk[pk % np.uint64(n) == np.uint64(r)]
            plan = real.lookup(sk)
            real.touch(plan)
            real.commit_update(plan, real.plan_update(sk, plan))
        return ex, real.snapshot_keys().copy()

    results = _run_ranks(n, rank_fn)
    for owner in range(n):
        for ex, _ in results:
            np.testing.assert_array_equal(ex.mirror.shard_resident(owner),
                                          results[owner][1])


# --------------------------------------------------------------------------- #
# the cached sharded lifecycle, against the reference and within the port
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """PASSES file sets, loaded into both packages (numpy planner and
    Python parser on both sides), and the reference's seed-3 tower."""
    d = tmp_path_factory.mktemp("shc")
    files = [write_synth_files(str(d / f"p{p}"), n_files=2, ins_per_file=128,
                               n_sparse_slots=S, vocab_per_slot=VOCAB,
                               dense_dim=DENSE, seed=20 + p)
             for p in range(PASSES)]
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        mp.delenv("PBOX_HBM_CACHE", raising=False)
        port, ref = [], []
        for fs in files:
            a = PadBoxSlotDataset(make_synth_config(S, DENSE, BSZ, 16),
                                  read_threads=2)
            b = RefDataset(ref_synth_config(S, DENSE, BSZ, 16), read_threads=2)
            for ds in (a, b):
                ds.set_filelist(fs)
                ds.load_into_memory()
            port.append(a)
            ref.append(b)
        conf = ref_config.SparseTableConfig(placement="loopback", **TABLE_KW)
        tr = RefMultiChipTrainer(
            RefCtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,)),
            conf, ref_make_mesh(4), ref_config.TrainerConfig(auc_buckets=1 << 10),
            seed=3)
        tower = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in tr.dense_state()[0]["tower"]]
        yield {"port": port, "ref": ref, "tower": tower, "runs": {}, "mp": mp}
    for ds in port + ref:
        ds.close()


def _drive(table, trainer, datasets, barrier_at=None):
    """One pass per dataset with the next census staged; per pass the
    metrics, the cache hits, each shard's residents, the mirror's residents
    and the resident hot keys.  ``barrier_at``: after that pass, a
    checkpoint round trip (state_dict -> load_state_dict) and a shrink."""
    auc, out = None, []
    for p, ds in enumerate(datasets):
        table.begin_pass(ds.unique_keys())
        hits = table.last_cache_hits
        nxt = datasets[p + 1].unique_keys if p + 1 < len(datasets) else None
        m = trainer.train_from_dataset(ds, table, auc_state=auc,
                                       drop_last=True, next_pass_keys=nxt)
        auc = trainer.last_metric_state
        table.end_pass()
        census = table._census
        mirror = None if census is None else census.mirror
        out.append(dict(
            m=m, hits=hits, hot=table.hot_resident_keys().copy(),
            residents=[c.snapshot_keys().copy() for c in table._caches()],
            mirror=None if mirror is None else [
                mirror.shard_resident(o).copy()
                for o in range(table.n_shards)]))
        if p == barrier_at:
            table.load_state_dict(table.state_dict())
            table.shrink()
    return table.state_dict(), table.pop_delta(), out


def _run(world, side, cache_rows, n=4, placement="loopback", plan=None,
         barrier_at=None):
    key = (side, cache_rows, n, placement, barrier_at)
    if plan is None and key in world["runs"]:
        return world["runs"][key]
    if side == "ref":
        conf = ref_config.SparseTableConfig(
            placement=placement, hbm_cache_rows=cache_rows, **TABLE_KW)
        mesh = ref_make_mesh(n)
        tr = RefMultiChipTrainer(
            RefCtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,)),
            conf, mesh, ref_config.TrainerConfig(auc_buckets=1 << 10), seed=3)
        table = RefShardedTable(conf, mesh, seed=5, bucket_slack=8.0)
    else:
        conf = SparseTableConfig(placement=placement,
                                 hbm_cache_rows=cache_rows, **TABLE_KW)
        mesh = make_mesh(n, device="cpu")
        model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,),
                       device="cpu")
        model.load_state_dict(params_from_jax(world["tower"]))
        tr = MultiChipTrainer(model, conf, mesh,
                              TrainerConfig(auc_buckets=1 << 10))
        table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    try:
        if plan is not None:
            with faults.fault_plan(plan) as fp:
                out = _drive(table, tr, world[side], barrier_at)
                out = out + (fp.hits(next(iter(plan))),)
        else:
            out = _drive(table, tr, world[side], barrier_at)
    finally:
        table.close()
    if plan is None:
        world["runs"][key] = out
    return out


def _assert_state_equal(a, b):
    np.testing.assert_array_equal(a["keys"], b["keys"])
    # [show, clk, embed..., g2sum]: counters, embeddings, optimizer state
    np.testing.assert_array_equal(a["values"], b["values"])


@pytest.mark.parametrize("cache_rows", [64, 1 << 16])
def test_cached_sharded_matches_reference(world, cache_rows):
    """Three passes of the hybrid loopback path at n = 4 with the cache on
    (16 rows a shard: admission and eviction every pass; and the default
    capacity), both packages on their numpy planners.  Host-side state is
    identical: per-pass cache hits, every shard's residents, the mirror's
    residents (equal to the real caches'), the hot set.  Floats agree at
    test_torch_multichip.py's tolerances: loss and AUC 1e-6, rows 1e-7."""
    sd_r, _, ref = _run(world, "ref", cache_rows)
    sd_p, _, port = _run(world, "port", cache_rows)
    for p, (a, b) in enumerate(zip(port, ref)):
        assert a["hits"] == b["hits"], p
        np.testing.assert_array_equal(a["hot"], b["hot"])
        for o in range(4):
            np.testing.assert_array_equal(a["residents"][o],
                                          b["residents"][o])
            np.testing.assert_array_equal(a["mirror"][o], a["residents"][o])
        assert abs(a["m"]["loss"] - b["m"]["loss"]) < 1e-6
        assert abs(a["m"]["auc"] - b["m"]["auc"]) < 1e-6
        assert a["m"]["steps"] == b["m"]["steps"]
    # the caches served hits, and the hot block realized and took keys out
    assert port[1]["hits"] > 0 and port[2]["hot"].shape[0] > 0
    assert not np.isin(port[2]["hot"],
                       np.concatenate(port[2]["residents"])).any()
    np.testing.assert_array_equal(sd_p["keys"], sd_r["keys"])
    np.testing.assert_array_equal(sd_p["values"][:, :2], sd_r["values"][:, :2])
    np.testing.assert_allclose(sd_p["values"], sd_r["values"], rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("placement,n", [("loopback", 4), ("hash", 4),
                                         ("loopback", 2)])
@pytest.mark.parametrize("cache_rows", [64, 1 << 16])
def test_cached_sharded_bit_exact_with_uncached(world, placement, n,
                                                cache_rows):
    """Within the port: the cached sharded lifecycle (staging, a checkpoint
    round trip and a shrink after pass 1) leaves keys, values, g2sum, the
    delta, loss and AUC bit-equal to the uncached run (port of
    tests/test_hbm_cache.py::TestBitExact::test_multichip_cached_matches_uncached)."""
    sd_u, delta_u, unc = _run(world, "port", 0, n, placement, barrier_at=1)
    sd_c, delta_c, cac = _run(world, "port", cache_rows, n, placement,
                              barrier_at=1)
    _assert_state_equal(sd_u, sd_c)
    _assert_state_equal(delta_u, delta_c)
    for a, b in zip(unc, cac):
        assert a["m"]["loss"] == b["m"]["loss"]
        assert a["m"]["auc"] == b["m"]["auc"]
    # pass 1 hit what pass 0 admitted; the shrink emptied the caches
    assert cac[1]["hits"] > 0 and cac[2]["hits"] == 0


# fetch hits, one per shard with misses: pass 0's synchronous resolve is
# 0-3 (every key misses), the stage of pass 1 (snapshot before pass 0's
# admission, so every key misses again) 4-7
@pytest.mark.parametrize("plan,counter", [
    ({"cache.fetch": "at:5"}, "pass.stage_discards"),
    ({"cache.fetch": "first:2"}, "cache.fetch_fallbacks"),
    ({"cache.fetch": "at:0,9"}, "cache.fetch_fallbacks"),
    ({"cache.admit": "at:1"}, "cache.admit_fallbacks"),
])
def test_sharded_fault_fallbacks_bit_exact(world, plan, counter):
    """An injected ``cache.fetch`` (in the stage, in the synchronous
    resolve, or both) or ``cache.admit`` failure degrades the pass to the
    uncached lifecycle: the run stays bit-equal to the uncached one and
    the fallback counts itself (port of tests/test_hbm_cache.py
    TestChaos, on the sharded path)."""
    sd_u, delta_u, unc = _run(world, "port", 0)
    before = stats.get(counter)
    sd_c, delta_c, cac, hits = _run(world, "port", 64, plan=plan)
    assert hits > 0
    assert stats.get(counter) > before
    _assert_state_equal(sd_u, sd_c)
    _assert_state_equal(delta_u, delta_c)
    for a, b in zip(unc, cac):
        assert (a["m"]["loss"], a["m"]["auc"]) == (b["m"]["loss"],
                                                  b["m"]["auc"])


def test_sharded_hot_rows_skip_store():
    """Cache hits never leave the device: the store stays empty over two
    passes of the same census, and the barrier lands every row (port of
    tests/test_hbm_cache.py::TestCacheBehavior::test_sharded_hot_rows_skip_store)."""
    t = ShardedSparseTable(SparseTableConfig(embedding_dim=4, placement="hash"),
                           make_mesh(8, device="cpu"), seed=0)
    keys = np.arange(1, 80, dtype=np.uint64)
    for _ in range(2):
        t.begin_pass(keys)
        t.values += 1.0
        t.end_pass()
    assert t.last_cache_hits == 79 and sum(t.last_shard_hits) == 79
    assert t.last_write_back_rows == 0 and t.last_promotion_rows == 0
    assert t._store.n == 0
    assert t.n_features == 79
    vals, found = t._store.lookup(keys)
    assert found.all() and (vals[:, 0] == 2.0).all()
    t.close()


def test_promotion_reads_the_cached_row():
    """A key that turns hot while resident and dirty in its shard's cache
    is promoted with the cache's row, not the store's older one, and
    leaves the cache (``take_rows``)."""
    conf = SparseTableConfig(embedding_dim=4, placement="loopback",
                             placement_update_interval=1,
                             placement_hot_capacity=16,
                             overlap_pass_boundary=False)
    t = ShardedSparseTable(conf, make_mesh(2, device="cpu"), seed=0)
    keys = np.arange(1, 11, dtype=np.uint64)
    for p in range(2):
        t.begin_pass(keys)
        t.values += 1.0
        t.end_pass()
    # the store never saw the updates: the rows are dirty in the caches
    assert t._store.n == 0
    t.begin_pass(keys)  # the third census realizes the hot block
    hot = t.hot_resident_keys()
    np.testing.assert_array_equal(hot, keys)
    np.testing.assert_array_equal(t._hot_rows()[:, 0], np.full(10, 2.0))
    assert all(c.resident == 0 for c in t._caches())
    t.end_pass()
    t.close()


def test_default_config_constructs_and_trains(world):
    """``SparseTableConfig()`` (the 65 536-row cache) on the sharded
    table and the multi-chip trainer: no refusal, a cache per shard."""
    conf = SparseTableConfig()
    mesh = make_mesh(2, device="cpu")
    t = ShardedSparseTable(conf, mesh, seed=0)
    tr = MultiChipTrainer(CtrDnn(S, conf.row_width, dense_dim=DENSE,
                                 hidden=(8,), device="cpu"), conf, mesh,
                          TrainerConfig(auc_buckets=1 << 10))
    ds = world["port"][0]
    for _ in range(2):
        t.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, t)
        t.end_pass()
    assert [c.capacity for c in t._caches()] == [conf.hbm_cache_rows // 2] * 2
    assert t.last_cache_hits > 0 and np.isfinite(m["loss"])
    t.close()


# --------------------------------------------------------------------------- #
# the single-chip cache's fault sites (port of tests/test_hbm_cache.py
# TestChaos): the fallbacks bit-exact with clean runs
# --------------------------------------------------------------------------- #
def _single_chip(datasets, cache_rows):
    tconf = SparseTableConfig(embedding_dim=4, learning_rate=0.4,
                              initial_range=0.05, show_decay_rate=0.5,
                              hbm_cache_rows=cache_rows)
    table = SparseTable(tconf, seed=3, device="cpu")
    tr = Trainer(CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(8,),
                        seed=3, device="cpu"), tconf,
                 TrainerConfig(auc_buckets=1 << 10), device="cpu")
    auc, metrics = None, []
    try:
        for p, ds in enumerate(datasets):
            table.begin_pass(ds.unique_keys())
            nxt = datasets[p + 1].unique_keys if p + 1 < len(datasets) else None
            metrics.append(tr.train_from_dataset(ds, table, auc_state=auc,
                                                 drop_last=True,
                                                 next_pass_keys=nxt))
            auc = tr.last_auc_state
            # the stage completes before end_pass, however late its thread
            # ran: the fault plans count cache.fetch hits in this order
            table.staged_pass_keys()
            table.end_pass()
        return table.state_dict(), table.pop_delta(), metrics
    finally:
        table.close()


@pytest.mark.parametrize("plan,counter", [
    ({"cache.fetch": "at:1"}, "pass.stage_discards"),
    ({"cache.fetch": "first:2"}, "cache.fetch_fallbacks"),
    ({"cache.admit": "at:1"}, "cache.admit_fallbacks"),
])
def test_single_chip_fault_fallbacks_bit_exact(world, plan, counter):
    sd_u, delta_u, m_u = _single_chip(world["port"], 0)
    before = stats.get(counter)
    with faults.fault_plan(plan) as fp:
        sd_c, delta_c, m_c = _single_chip(world["port"], 1 << 16)
        assert fp.hits(next(iter(plan))) > 0
    assert stats.get(counter) > before
    _assert_state_equal(sd_u, sd_c)
    _assert_state_equal(delta_u, delta_c)
    assert [(m["loss"], m["auc"]) for m in m_u] == [(m["loss"], m["auc"])
                                                   for m in m_c]


def test_fetch_fault_simple_lifecycle_values_survive():
    """Rows trained before an injected fetch failure are intact after the
    degraded pass (port of TestChaos::test_fetch_fault_simple_lifecycle_values_survive)."""
    with faults.fault_plan({"cache.fetch": "at:1"}):
        t = SparseTable(SparseTableConfig(embedding_dim=4, placement="hash"),
                        seed=0, device="cpu")
        keys = np.arange(1, 40, dtype=np.uint64)
        t.begin_pass(keys)  # fetch hit 0: clean
        t.values += 5.0
        t.end_pass()
        # ten new keys miss: fetch hit 1 is injected -> degraded resolve
        t.begin_pass(np.arange(1, 50, dtype=np.uint64))
        assert t._cache_plan is None
        assert (t.values[:39, 0] == 5.0).all()
        assert (t.values[39:49, 0] == 0.0).all()
        t.values += 1.0
        t.end_pass()
        sd = t.state_dict()
        np.testing.assert_array_equal(sd["values"][:, 0],
                                      np.repeat([6.0, 1.0], [39, 10]))
        # the degraded pass took its census out of the cache
        assert t._caches()[0].resident == 0
        t.close()


# --------------------------------------------------------------------------- #
# the hot set changing twice (ROADMAP C2): cached = uncached over every pass
# --------------------------------------------------------------------------- #
def _two_change_run(datasets, cache_rows):
    """Four passes of the hybrid path at n = 4 (hot capacity 16, update
    interval 1), each over its own Zipf set, the next census staged: per
    pass the metrics, the hot rows moved at begin_pass, the cache hits and
    the working set (cold and hot rows) right before end_pass."""
    conf = SparseTableConfig(embedding_dim=4, placement="loopback",
                             placement_update_interval=1,
                             placement_hot_capacity=16,
                             hbm_cache_rows=cache_rows)
    mesh = make_mesh(4, device="cpu")
    model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,),
                   seed=3, device="cpu")
    tr = MultiChipTrainer(model, conf, mesh, TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    out, auc = [], None
    try:
        for p, ds in enumerate(datasets):
            table.begin_pass(ds.unique_keys())
            moved, hits = table.last_hot_moved_rows, table.last_cache_hits
            nxt = datasets[p + 1].unique_keys if p + 1 < len(datasets) else None
            m = tr.train_from_dataset(ds, table, auc_state=auc,
                                      drop_last=True, next_pass_keys=nxt)
            auc = tr.last_metric_state
            out.append(dict(m=m, moved=moved, hits=hits,
                            hot=table.hot_resident_keys().copy(),
                            live=table.pass_state_dict()))
            table.end_pass()
        return table.state_dict(), out
    finally:
        table.close()


def test_cached_equals_uncached_over_two_hot_set_changes(tmp_path):
    """The case ROADMAP C2 asked for: four Zipf passes whose hot set
    realizes at the third begin_pass and changes again at the fourth (rows
    promoted and demoted while the caches hold rows).  The per-shard
    cached run equals the uncached one bit for bit in every pass's
    working set, loss and AUC, and in the final store."""
    datasets = []
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        for p in range(4):
            fs = write_synth_files(str(tmp_path / f"z{p}"), n_files=1,
                                   ins_per_file=128, n_sparse_slots=S,
                                   vocab_per_slot=VOCAB, dense_dim=DENSE,
                                   seed=40 + p, zipf_a=1.3)
            ds = PadBoxSlotDataset(make_synth_config(S, DENSE, BSZ, 16),
                                   read_threads=1)
            ds.set_filelist(fs)
            ds.load_into_memory()
            datasets.append(ds)
        try:
            sd_u, unc = _two_change_run(datasets, 0)
            sd_c, cac = _two_change_run(datasets, 32)
        finally:
            for ds in datasets:
                ds.close()
    assert [r["moved"] for r in unc][:2] == [0, 0]
    assert unc[2]["moved"] > 0 and unc[3]["moved"] > 0  # two changes
    assert not np.array_equal(unc[2]["hot"], unc[3]["hot"])
    assert all(r["hits"] > 0 for r in cac[1:])
    for p, (a, b) in enumerate(zip(unc, cac)):
        assert a["moved"] == b["moved"], p
        np.testing.assert_array_equal(a["hot"], b["hot"])
        _assert_state_equal(a["live"], b["live"])
        assert a["m"]["loss"] == b["m"]["loss"], p
        assert a["m"]["auc"] == b["m"]["auc"], p
    _assert_state_equal(sd_u, sd_c)
