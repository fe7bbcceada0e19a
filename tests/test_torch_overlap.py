"""The port's overlapped pass boundary (paddlebox_tpu_torch/sparse/table.py):
the async write-back behind the pending-merge overlay, prepare_pass staging
with begin_pass's patch, and the store's bucket pool.  Ported from
tests/test_pass_overlap.py, and held against the JAX package.

Tolerances: the overlapped lifecycle against the serial one is bit-exact
(state_dict, pop_delta, loss, AUC), single-chip and on four shard
positions.  Against the JAX package's overlapped run, keys and the show and
clk counters are bit-exact; rows and losses agree to rtol 1e-5, atol 1e-6
(float32 reordering, ROADMAP Queue C) and the AUC to 1e-4.

Every test closes the tables it builds and releases any hang it armed, so
no merge, stage or pool thread outlives it.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ops import sparse_kernels
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.store import BucketStore
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

N_SLOTS, DENSE, BATCH, N_PASSES = 3, 2, 64, 3
HIDDEN = (16, 8)


def _tconf(overlap: bool, cache_rows: int = 0, **kw) -> SparseTableConfig:
    return SparseTableConfig(
        embedding_dim=4, learning_rate=0.4, initial_range=0.05,
        store_buckets=16, plan_scratch_rows=64, hbm_cache_rows=cache_rows,
        overlap_pass_boundary=overlap, store_threads=4 if overlap else 0,
        **kw,
    )


def _table(overlap=True, **kw) -> SparseTable:
    return SparseTable(_tconf(overlap, **kw), seed=0, device="cpu")


@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    """N_PASSES file sets over a shared key space (vocab 40): heavy census
    overlap, so begin_pass's patch carries pass p's rows into pass p+1's
    staged buffer."""
    return [
        write_synth_files(
            str(tmp_path_factory.mktemp(f"pass{p}")), n_files=2,
            ins_per_file=192, n_sparse_slots=N_SLOTS, vocab_per_slot=40,
            dense_dim=DENSE, seed=11 + p,
        )
        for p in range(N_PASSES)
    ]


def _datasets(files, make=PadBoxSlotDataset, synth=make_synth_config):
    conf = synth(n_sparse_slots=N_SLOTS, dense_dim=DENSE, batch_size=BATCH,
                 max_feasigns_per_ins=16)
    out = []
    for f in files:
        ds = make(conf, read_threads=1)
        ds.set_filelist(f)
        ds.load_into_memory()
        out.append(ds)
    return out


def _run_single_chip(files, overlap, prepare, cache_rows=0, tower=None):
    datasets = _datasets(files)
    tconf = _tconf(overlap, cache_rows)
    table = SparseTable(tconf, seed=3, device="cpu")
    model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   seed=3, device="cpu")
    if tower is not None:
        model.load_state_dict(params_from_jax(tower))
    trainer = Trainer(model, tconf,
                      TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 12),
                      device="cpu")
    auc, metrics, staged = None, None, []
    try:
        for p, ds in enumerate(datasets):
            table.begin_pass(ds.unique_keys())
            staged.append(table.last_begin_breakdown["staged"])
            nxt = (datasets[p + 1].unique_keys
                   if prepare and p + 1 < len(datasets) else None)
            metrics = trainer.train_from_dataset(
                ds, table, auc_state=auc, drop_last=True, next_pass_keys=nxt)
            auc = trainer.last_auc_state
            table.end_pass()
        sd = table.state_dict()
        delta = table.pop_delta()
    finally:
        table.close()
        for ds in datasets:
            ds.close()
    return sd, delta, metrics, staged


def _assert_state_equal(a, b):
    np.testing.assert_array_equal(a["keys"], b["keys"])
    # [show, clk, embed..., g2sum]: the counters, the embeddings AND the
    # optimizer state, bit for bit
    np.testing.assert_array_equal(a["values"], b["values"])


# --------------------------------------------------------------------------- #
# bit-exactness against the serial lifecycle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cache_rows", [0, 64])
@pytest.mark.parametrize("prepare", [True, False])
def test_single_chip_overlap_matches_serial(pass_files, prepare, cache_rows):
    sd_s, delta_s, m_s, _ = _run_single_chip(pass_files, False, False,
                                             cache_rows)
    sd_o, delta_o, m_o, staged = _run_single_chip(pass_files, True, prepare,
                                                  cache_rows)
    _assert_state_equal(sd_s, sd_o)
    _assert_state_equal(delta_s, delta_o)
    assert m_s["auc"] == m_o["auc"]
    assert m_s["loss"] == m_o["loss"]
    # every pass after the first consumed its stage
    assert staged == [False] + [prepare] * (N_PASSES - 1)


def test_overlap_matches_the_jax_package_overlapped(pass_files):
    """Both packages overlapped, with next_pass_keys, from the reference's
    initial tower."""
    ref_ds = _datasets(pass_files, RefDataset, ref_synth_config)
    rconf = ref_config.SparseTableConfig(
        embedding_dim=4, learning_rate=0.4, initial_range=0.05,
        store_buckets=16, plan_scratch_rows=64, hbm_cache_rows=0,
        overlap_pass_boundary=True, store_threads=4)
    rtable = RefTable(rconf, seed=3)
    rtr = RefTrainer(RefCtrDnn(N_SLOTS, rconf.row_width, dense_dim=DENSE,
                               hidden=HIDDEN),
                     rconf, ref_config.TrainerConfig(dense_lr=3e-3,
                                                     auc_buckets=1 << 12),
                     seed=4)
    tower = [{k: np.array(v) for k, v in layer.items()}
             for layer in rtr.params["tower"]]
    mstate, rm = None, None
    try:
        for p, ds in enumerate(ref_ds):
            rtable.begin_pass(ds.unique_keys())
            nxt = ref_ds[p + 1].unique_keys if p + 1 < len(ref_ds) else None
            rm = rtr.train_from_dataset(ds, rtable, auc_state=mstate,
                                        drop_last=True, next_pass_keys=nxt)
            mstate = rtr.last_metric_state
            rtable.end_pass()
        rsd = rtable.state_dict()
    finally:
        rtable.close()
        for ds in ref_ds:
            ds.close()
    psd, _, pm, staged = _run_single_chip(pass_files, True, True, 0, tower)
    assert staged == [False, True, True]
    np.testing.assert_array_equal(psd["keys"], rsd["keys"])
    np.testing.assert_array_equal(psd["values"][:, :2], rsd["values"][:, :2])
    np.testing.assert_allclose(psd["values"], rsd["values"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)
    assert abs(pm["auc"] - rm["auc"]) < 1e-4
    assert pm["count"] == rm["count"]


def _run_multichip(files, overlap, prepare):
    datasets = _datasets(files)
    mesh = make_mesh(4, device="cpu")
    tconf = _tconf(overlap, placement_update_interval=1,
                   placement_hot_capacity=64)
    table = ShardedSparseTable(tconf, mesh, seed=3)
    model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   seed=3, device="cpu")
    trainer = MultiChipTrainer(
        model, tconf, mesh, TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 12))
    metrics, staged = None, []
    try:
        for p, ds in enumerate(datasets):
            table.begin_pass(ds.unique_keys())
            staged.append(table.last_begin_breakdown["staged"])
            nxt = (datasets[p + 1].unique_keys
                   if prepare and p + 1 < len(datasets) else None)
            metrics = trainer.train_from_dataset(ds, table, drop_last=True,
                                                 next_pass_keys=nxt)
            table.end_pass()
        sd = table.state_dict()
        hot = table.hot_resident_keys().shape[0]
    finally:
        table.close()
        for ds in datasets:
            ds.close()
    return sd, metrics, staged, hot


def test_four_positions_overlap_matches_serial(pass_files):
    sd_s, m_s, _, hot_s = _run_multichip(pass_files, False, False)
    sd_o, m_o, staged, hot_o = _run_multichip(pass_files, True, True)
    _assert_state_equal(sd_s, sd_o)
    assert m_s["auc"] == m_o["auc"] and m_s["loss"] == m_o["loss"]
    assert hot_s == hot_o > 0  # the hot block realized
    # the hot set changes at the second and third begin_pass here, so
    # their stages are discarded, never used stale
    assert staged[0] is False


def test_sharded_stage_is_consumed_and_patched():
    mesh = make_mesh(4, device="cpu")
    table = ShardedSparseTable(_tconf(True, placement="hash"), mesh)
    keys = np.arange(1, 80, dtype=np.uint64)
    try:
        table.begin_pass(keys)
        table.values += 5.0
        table.prepare_pass(keys)  # staged against the pre-pass store
        table.end_pass()
        table.begin_pass(keys)  # consumes the stage and patches it
        assert table.last_begin_breakdown["staged"]
        state = table.pass_state_dict()
        assert (state["values"][:, 0] == 5.0).all()
        table.end_pass()
    finally:
        table.close()


# --------------------------------------------------------------------------- #
# the overlay, the stage and the barriers
# --------------------------------------------------------------------------- #
def test_lookup_and_begin_pass_see_unmerged_writeback():
    t = _table()
    keys = np.arange(1, 60, dtype=np.uint64)
    try:
        with faults.fault_plan({"store.merge": "hang:first:1"}):
            try:
                t.begin_pass(keys)
                t.values += 2.0  # show col: 0 -> 2
                t0 = time.monotonic()
                t.end_pass()
                assert time.monotonic() - t0 < 2.0, "end_pass waited"
                vals, found = t._lookup_with_overlay(keys)
                assert found.all() and (vals[:, 0] == 2.0).all()
                # an overlapping census resolves from the overlay, not from
                # the (stale) store
                t.begin_pass(keys[:30])
                assert (t.values[:30, 0] == 2.0).all()
                t.abort_pass()
            finally:
                faults.release_hangs()
        t.flush()
        assert (t.state_dict()["values"][:, 0] == 2.0).all()
    finally:
        t.close()


@pytest.mark.parametrize("cache_rows", [0, 16])
def test_staged_pass_patched_with_final_rows(cache_rows):
    """prepare_pass before end_pass resolves the OLD rows; begin_pass must
    patch the census intersection from the finished pass's write-back (with
    a 16-row cache, from the evictions and cold rows)."""
    t = _table(cache_rows=cache_rows)
    keys = np.arange(1, 40, dtype=np.uint64)
    try:
        t.begin_pass(keys)
        t.values += 5.0
        t.prepare_pass(keys)
        t.end_pass()
        t.begin_pass(keys)
        assert t.last_begin_breakdown["staged"]
        assert (t.values[: len(keys), 0] == 5.0).all()
        t.end_pass()
    finally:
        t.close()


def test_stage_discarded_on_census_mismatch():
    t = _table()
    try:
        t.prepare_pass(np.arange(1, 10, dtype=np.uint64))
        before = stats.get("pass.stage_discards")
        t.begin_pass(np.arange(1, 30, dtype=np.uint64))  # another census
        assert stats.get("pass.stage_discards") == before + 1
        assert not t.last_begin_breakdown["staged"]
        assert t.capacity > 0  # the synchronous resolve still promoted
        t.end_pass()
    finally:
        t.close()


def test_staged_census_from_a_callable():
    t = _table()
    keys = np.arange(5, 50, dtype=np.uint64)
    try:
        t.prepare_pass(lambda: keys[::-1])  # evaluated on the staging thread
        np.testing.assert_array_equal(t.staged_pass_keys(), keys)
        t.begin_pass(keys)
        assert t.last_begin_breakdown["staged"]
        t.end_pass()
    finally:
        t.close()


def test_state_dict_waits_for_hung_merge():
    t = _table()
    keys = np.arange(1, 50, dtype=np.uint64)
    release = threading.Timer(0.3, faults.release_hangs)
    try:
        with faults.fault_plan({"store.merge": "hang:first:1"}):
            t.begin_pass(keys)
            t.values += 3.0
            t.end_pass()
            release.start()
            t0 = time.monotonic()
            sd = t.state_dict()  # barriers on the merge in flight
            assert time.monotonic() - t0 >= 0.25
            assert (sd["values"][:, 0] == 3.0).all()
    finally:
        release.cancel()
        faults.release_hangs()
        t.close()


def test_shrink_barriers_and_discards_stage():
    """The decay must see the write-back, and a stage resolved before the
    shrink must not bring undecayed rows back."""

    def run(overlap, prepare):
        t = _table(overlap, show_decay_rate=0.5)
        keys = np.arange(1, 30, dtype=np.uint64)
        try:
            t.begin_pass(keys)
            t.values += 4.0
            if prepare:
                t.prepare_pass(keys)
                t.staged_pass_keys()  # the stage resolved before the shrink
            t.end_pass()
            t.shrink()
            t.begin_pass(keys)
            vals = t.values.clone()
            t.end_pass()
        finally:
            t.close()
        return vals

    v_serial = run(False, False)
    v_overlap = run(True, True)
    assert (v_serial[:29, 0] == 2.0).all()  # 4.0 decayed by 0.5
    assert torch.equal(v_serial, v_overlap)


def test_merge_failure_surfaces_at_flush():
    t = _table()
    keys = np.arange(1, 20, dtype=np.uint64)
    with faults.fault_plan({"store.merge": "first:1"}):
        t.begin_pass(keys)
        t.values += 1.0
        t.end_pass()
        with pytest.raises(faults.FaultInjected):
            t.flush()
        # the failed write-back stays readable through the overlay
        vals, found = t._lookup_with_overlay(keys)
        assert found.all() and (vals[:, 0] == 1.0).all()
    t.close()  # the failure was surfaced: close quiesces cleanly


def test_failed_merge_poisons_later_merges_not_reads():
    """A later pass must not land on top of a missing one; reads keep
    seeing the newest write-back and every barrier raises."""
    t = _table()
    keys = np.arange(1, 20, dtype=np.uint64)
    try:
        with faults.fault_plan({"store.merge": "first:1"}):
            t.begin_pass(keys)
            t.values += 1.0
            t.end_pass()  # this merge fails
            t.begin_pass(keys)  # resolves 1.0 through the overlay
            assert (t.values[:19, 0] == 1.0).all()
            t.values += 1.0
            t.end_pass()  # this merge is poisoned
            t._merge_futures[-1].exception()  # wait for it to run
            vals, found = t._lookup_with_overlay(keys)
            assert found.all() and (vals[:, 0] == 2.0).all()  # newest wins
            assert t._store.n == 0  # nothing ever landed
            with pytest.raises(faults.FaultInjected):
                t.flush()
            with pytest.raises(RuntimeError, match="store merge disabled"):
                t.flush()
    finally:
        t._merge_futures.clear()
        t.close()


# --------------------------------------------------------------------------- #
# the parallel store and the threads' lifetime
# --------------------------------------------------------------------------- #
def test_parallel_store_matches_serial():
    rng = np.random.default_rng(0)
    serial = BucketStore(n_cols=5, n_buckets=32, n_threads=0)
    pooled = BucketStore(n_cols=5, n_buckets=32, n_threads=4)
    try:
        for _ in range(5):
            keys = np.unique(rng.integers(0, 10_000, size=2000).astype(np.uint64))
            vals = rng.normal(size=(keys.shape[0], 5)).astype(np.float32)
            serial.update(keys, vals)
            pooled.update(keys, vals)
        q = np.unique(rng.integers(0, 12_000, size=3000).astype(np.uint64))
        vs, fs = serial.lookup(q)
        vp, fp = pooled.lookup(q)
        assert np.array_equal(fs, fp) and np.array_equal(vs, vp)
        assert (serial.decay_evict(2, 0.5, 0.0)
                == pooled.decay_evict(2, 0.5, 0.0))
        ks, vvs = serial.materialize()
        kp, vvp = pooled.materialize()
        assert np.array_equal(ks, kp) and np.array_equal(vvs, vvp)
        assert serial.inserted == pooled.inserted
        assert serial.updated_in_place == pooled.updated_in_place
    finally:
        pooled.close()


def _live_threads(prefix):
    return [t for t in threading.enumerate()
            if t.name.startswith(prefix) and t.is_alive()]


def test_store_close_retires_pool_and_stays_usable():
    store = BucketStore(n_cols=3, n_buckets=16, n_threads=4)
    keys = np.arange(0, 2000, dtype=np.uint64)
    store.update(keys, np.ones((2000, 3), np.float32))
    pool = store._pool
    assert pool is not None and pool.started
    assert all(t.daemon for t in pool._threads)
    threads = list(pool._threads)
    store.close()
    assert store._pool is None
    store.close()  # idempotent
    for th in threads:
        th.join(5.0)
        assert not th.is_alive()
    v, f = store.lookup(keys)  # a new pool starts
    assert f.all() and (v == 1.0).all()
    assert store._pool is not None
    store.close()


def test_table_close_flushes_and_retires_every_thread():
    before = set(threading.enumerate())
    t = _table(cache_rows=0)
    keys = np.arange(1, 120, dtype=np.uint64)
    t.begin_pass(keys)
    t.prepare_pass(keys)
    with pytest.raises(RuntimeError):
        t.close()  # close inside a pass is a contract violation
    t.end_pass()
    t.close()
    assert t._store._pool is None
    assert not (set(threading.enumerate()) - before)
    # still usable after close: the threads start again on demand
    assert t.state_dict()["keys"].shape[0] == keys.shape[0]
    t.begin_pass(keys)
    t.end_pass()
    t.close()
    assert not (set(threading.enumerate()) - before)


def test_unclosed_table_threads_retire_when_collected():
    import gc

    before = set(threading.enumerate())
    t = _table()
    t.begin_pass(np.arange(1, 200, dtype=np.uint64))
    t.end_pass()
    t.flush()
    spawned = set(threading.enumerate()) - before
    assert spawned and all(th.daemon for th in spawned)
    del t
    gc.collect()
    for th in spawned:
        th.join(5.0)
        assert not th.is_alive()


def test_concurrent_lookup_update_disjoint_keys():
    """The merge thread (update) and the staging thread (lookup) on
    disjoint keys must not corrupt each other under the pool."""
    store = BucketStore(n_cols=3, n_buckets=16, n_threads=4)
    base = np.arange(0, 4000, dtype=np.uint64)
    store.update(base, np.ones((4000, 3), np.float32))
    errs = []

    def reader():
        try:
            for _ in range(20):
                v, f = store.lookup(base[:2000])
                assert f.all() and (v == 1.0).all()
        except Exception as e:  # pragma: no cover - the failure path
            errs.append(e)

    def writer():
        try:
            for i in range(20):
                store.update(base[2000:],
                             np.full((2000, 3), float(i + 2), np.float32))
        except Exception as e:  # pragma: no cover - the failure path
            errs.append(e)

    threads = [threading.Thread(target=reader), threading.Thread(target=writer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    try:
        assert not errs
        v, f = store.lookup(base[2000:])
        assert f.all() and (v == 21.0).all()
    finally:
        store.close()


def test_background_threads_launch_no_kernel(pass_files, monkeypatch):
    """The merge and stage threads do host work only: with the cache on,
    every kernel wrapper call of an overlapped, staged run happens on the
    calling thread."""
    callers = set()
    for name in ("pull_rows", "scatter_add_rows", "gather_slots",
                 "scatter_rows", "sorted_search"):
        real = getattr(sparse_kernels, name)

        def spy(*a, _real=real, **kw):
            callers.add(threading.get_ident())
            return _real(*a, **kw)

        monkeypatch.setattr(sparse_kernels, name, spy)
    _run_single_chip(pass_files, True, True, cache_rows=64)
    assert callers == {threading.get_ident()}


# --------------------------------------------------------------------------- #
# defaults and the kill switch
# --------------------------------------------------------------------------- #
def test_defaults_match_the_reference(tmp_path):
    ref, port = ref_config.SparseTableConfig(), SparseTableConfig()
    for f in ("overlap_pass_boundary", "store_threads", "store_max_resident",
              "store_log_buckets", "store_compact_threshold",
              "store_spill_dir", "store_log_dir"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.overlap_pass_boundary and port.store_threads == 4
    # a reference config's store, spill, log and overlap fields construct
    conf = SparseTableConfig(
        overlap_pass_boundary=True, store_threads=2, store_max_resident=3,
        store_spill_dir=str(tmp_path / "spill"), store_log_buckets=4,
        store_log_dir=str(tmp_path / "log"), store_compact_threshold=5)
    t = SparseTable(conf, device="cpu")
    assert t.overlap_enabled and t._log is not None
    t.close()


def test_overlap_kill_switch(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_OVERLAP_PASS_BOUNDARY", "0")
    t = _table(True)
    try:
        assert not t.overlap_enabled
        t.prepare_pass(np.arange(1, 9, dtype=np.uint64))  # a no-op
        assert t._stage_future is None
        t.begin_pass(np.arange(1, 9, dtype=np.uint64))
        t.end_pass()
        assert t._store.n == 8  # merged before end_pass returned
    finally:
        t.close()
