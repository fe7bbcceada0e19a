"""The port's persistence: the store's spill tier, the durable log
(paddlebox_tpu_torch/sparse/logstore.py), the table's recovery from it,
checkpoints (checkpoint.py) and the AutoCheckpointer.  Ported from
tests/test_store.py, test_logstore.py, test_durable_store.py,
test_checkpoint.py and test_auto_checkpoint.py, and held against the JAX
package: a log directory and a checkpoint directory written by either
package open in the other with equal content.

Tolerances: everything here is exact (bit-equal arrays, equal bytes,
equal AUC), except the dense half of a cross-package checkpoint, which is
the same float32 numbers carried through ``weights.params_from_jax``
(exact too).  Every table is closed, every fault plan uninstalled.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.checkpoint import CheckpointManager as RefCheckpointManager
from paddlebox_tpu.checkpoint import (
    IncrementalCheckpointManager as RefIncrementalManager,
)
from paddlebox_tpu.sparse.logstore import BloomFilter as RefBloom
from paddlebox_tpu.sparse.logstore import LogStore as RefLogStore
from paddlebox_tpu.sparse.store import BucketStore as RefStore
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu_torch.checkpoint import (
    CheckpointCorrupt,
    CheckpointManager,
    IncrementalCheckpointManager,
    load_pytree,
    save_pytree,
    verify_checkpoint_dir,
)
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.logstore import (
    BloomFilter,
    LogStore,
    LogStoreCorrupt,
    SegmentWriter,
    read_segment,
)
from paddlebox_tpu_torch.sparse.store import BucketStore, StoreCorrupt
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import AutoCheckpointer, Trainer
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.faults import fault_plan
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax, params_to_jax

torch.set_num_threads(1)

N_PASSES = 4


def _rows(keys, n_cols=3, salt=0.0):
    keys = np.asarray(keys, dtype=np.uint64)
    base = keys.astype(np.float64)[:, None] * np.arange(1, n_cols + 1)
    return (base * 0.001 + salt).astype(np.float32)


def _vals_for(keys, n_cols, salt=0):
    return (np.asarray(keys, np.float64)[:, None] % 97.0
            + np.arange(n_cols) + salt).astype(np.float32)


# --------------------------------------------------------------------------- #
# the store's spill tier
# --------------------------------------------------------------------------- #
def test_spill_mode_matches_ram_mode(tmp_path):
    rng = np.random.default_rng(3)
    ram = BucketStore(n_cols=2, n_buckets=32)
    disk = BucketStore(n_cols=2, n_buckets=32, n_threads=4,
                       spill_dir=str(tmp_path / "spill"), max_resident=4)
    try:
        for salt in range(4):
            k = np.unique(rng.integers(1, 1 << 40, size=600).astype(np.uint64))
            ram.update(k, _vals_for(k, 2, salt))
            disk.update(k, _vals_for(k, 2, salt))
        assert disk.spill_writes > 0  # 32 buckets through 4 resident slots
        rk, rv = ram.materialize()
        dk, dv = disk.materialize()
        np.testing.assert_array_equal(rk, dk)
        np.testing.assert_array_equal(rv, dv)
        q = rk[:: max(1, rk.shape[0] // 50)]
        g1, f1 = ram.lookup(q)
        g2, f2 = disk.lookup(q)
        assert f1.all() and f2.all()
        np.testing.assert_array_equal(g1, g2)
        st = disk.stats()
        assert st["n"] == rk.shape[0] and st["finite"]
        assert st["spilled_buckets"] > 0
    finally:
        disk.close()


def test_spill_files_match_the_reference_store(tmp_path):
    """The same updates through both packages' stores spill the same
    buckets with the same keys, rows and CRC."""
    k = np.arange(1, 300, dtype=np.uint64) * np.uint64(7919)
    port = BucketStore(n_cols=3, n_buckets=8, spill_dir=str(tmp_path / "p"),
                       max_resident=2)
    ref = RefStore(n_cols=3, n_buckets=8, spill_dir=str(tmp_path / "r"),
                   max_resident=2)
    for s in (port, ref):
        s.update(k, _vals_for(k, 3))
    np.testing.assert_array_equal(port._spilled, ref._spilled)
    for b in np.nonzero(port._spilled)[0]:
        with np.load(port._path(b)) as zp, np.load(ref._path(b)) as zr:
            for f in ("keys", "vals", "crc"):
                np.testing.assert_array_equal(zp[f], zr[f])
    ref.close()
    port.close()


def test_evicted_rows_do_not_resurrect_from_stale_spill(tmp_path):
    st = BucketStore(n_cols=1, n_buckets=4, spill_dir=str(tmp_path / "s"),
                     max_resident=1)
    k = np.arange(1, 64, dtype=np.uint64)
    st.update(k, np.full((k.shape[0], 1), 0.5, np.float32))
    assert st.spill_writes > 0
    assert st.decay_evict(decay_cols=1, decay=1.0, threshold=1.0) == 63
    got, found = st.lookup(k)  # every bucket through spill and reload
    assert not found.any() and (got == 0).all() and st.n == 0


def test_legacy_spill_without_crc_loads(tmp_path):
    st = BucketStore(n_cols=1, n_buckets=4, spill_dir=str(tmp_path / "s"),
                     max_resident=1)
    k = np.arange(1, 64, dtype=np.uint64)
    v = np.full((k.shape[0], 1), 2.5, np.float32)
    st.update(k, v)
    rewritten = 0
    for b in range(st.n_buckets):
        p = st._path(b)
        if os.path.exists(p):
            with np.load(p) as z:
                sk, sv = z["keys"], z["vals"]
            np.savez(p, keys=sk, vals=sv)  # the pre-checksum format
            rewritten += 1
    assert rewritten > 0
    before = stats.get("store.spill_corrupt")
    got, found = st.lookup(k)
    assert found.all()
    np.testing.assert_array_equal(got, v)
    assert stats.get("store.spill_corrupt") == before


@pytest.mark.parametrize("damage", ["garbage", "crc"])
def test_corrupt_spill_without_log_is_loud(tmp_path, damage):
    s = BucketStore(n_cols=3, n_buckets=2, max_resident=1,
                    spill_dir=str(tmp_path / "spill"))
    k = np.arange(1, 200, dtype=np.uint64)
    s.update(k, np.ones((199, 3), dtype=np.float32))
    for q in (k[:5], k[-5:], k[:5], k[-5:]):
        s.lookup(q)  # cycle the LRU so a bucket lands on disk
    b = int(np.nonzero(s._spilled)[0][0])
    if damage == "garbage":
        with open(s._path(b), "wb") as fh:
            fh.write(b"garbage")
    else:  # a valid npz whose rows no longer match their checksum
        with np.load(s._path(b)) as z:
            sk, sv, crc = z["keys"], z["vals"].copy(), z["crc"]
        sv[0, 0] += 1.0
        np.savez(s._path(b), keys=sk, vals=sv, crc=crc)
    with pytest.raises(StoreCorrupt, match="no durable tier"):
        s.lookup(k[s._bucket_of(k) == b])


def test_table_spill_pass_lifecycle(tmp_path):
    def run(conf):
        t = SparseTable(conf, seed=0, device="cpu")
        keys = np.arange(1, 200, dtype=np.uint64) * np.uint64(2 ** 55)
        try:
            t.begin_pass(keys)
            t.values[0, 2] += 1.0
            t.end_pass()
            t.begin_pass(keys[::2])
            t.end_pass()
            return t.state_dict()
        finally:
            t.close()

    a = run(SparseTableConfig(embedding_dim=4, store_buckets=16))
    b = run(SparseTableConfig(embedding_dim=4, store_buckets=16,
                              store_spill_dir=str(tmp_path / "s"),
                              store_max_resident=2))
    np.testing.assert_array_equal(a["keys"], b["keys"])
    np.testing.assert_array_equal(a["values"], b["values"])


# --------------------------------------------------------------------------- #
# the durable log
# --------------------------------------------------------------------------- #
def _store(root, cls=LogStore, **kw):
    kw.setdefault("n_cols", 3)
    kw.setdefault("n_buckets", 2)
    return cls(str(root), **kw)


def test_segment_roundtrip_and_typestate(tmp_path):
    k = np.array([3, 9, 11], dtype=np.uint64)
    w = SegmentWriter(str(tmp_path), 0, 1)
    with pytest.raises(RuntimeError, match="sealed"):
        w.info()
    w.append(k, _rows(k))
    info = w.seal()
    with pytest.raises(RuntimeError):
        w.append(k, _rows(k))
    blocks = read_segment(os.path.join(str(tmp_path), info.name),
                          expect_bytes=info.n_bytes, expect_crc=info.crc)
    assert len(blocks) == 1
    np.testing.assert_array_equal(blocks[0][0], k)
    np.testing.assert_array_equal(blocks[0][1], _rows(k))
    assert (info.min_key, info.max_key) == (3, 11)
    w2 = SegmentWriter(str(tmp_path), 0, 2)
    try:
        with pytest.raises(Exception):
            w2.append(np.array([9, 3], dtype=np.uint64), _rows([9, 3]))
    finally:
        w2.abort()


def test_torn_tail_byte_sweep(tmp_path):
    """A file cut at every byte: the orphan decode yields a prefix of the
    blocks and never raises; the strict decode always raises."""
    k1 = np.array([1, 5], dtype=np.uint64)
    k2 = np.array([2, 8, 12], dtype=np.uint64)
    w = SegmentWriter(str(tmp_path), 0, 1)
    w.append(k1, _rows(k1))
    w.append(k2, _rows(k2))
    info = w.seal()
    data = open(os.path.join(str(tmp_path), info.name), "rb").read()
    torn = os.path.join(str(tmp_path), "torn.seg")
    for cut in range(len(data)):
        with open(torn, "wb") as fh:
            fh.write(data[:cut])
        blocks = read_segment(torn)
        for got, want in zip(blocks, [k1, k2]):
            np.testing.assert_array_equal(got[0], want)
        with pytest.raises(LogStoreCorrupt):
            read_segment(torn, expect_bytes=info.n_bytes, expect_crc=info.crc)


def test_bloom_matches_the_reference_bits():
    present = np.arange(0, 4000, 2, dtype=np.uint64)
    absent = np.arange(1, 4001, 2, dtype=np.uint64)
    bf = BloomFilter.build(present)
    assert bf.might_contain(present).all()
    assert bf.might_contain(absent).mean() < 0.05
    assert bf.to_hex() == RefBloom.build(present).to_hex()
    np.testing.assert_array_equal(
        BloomFilter.from_hex(bf.to_hex()).might_contain(absent),
        bf.might_contain(absent))


def test_uncommitted_is_invisible_and_newest_wins(tmp_path):
    ls = _store(tmp_path / "a")
    ls.append(np.array([1, 2, 3], dtype=np.uint64), _rows([1, 2, 3]))
    ls.close()
    again = _store(tmp_path / "a")
    assert again.gen == 0 and again.materialize()[0].shape[0] == 0
    again.close()
    ls = _store(tmp_path / "b")
    k = np.arange(1, 40, dtype=np.uint64)
    ls.append(k, _rows(k))
    ls.commit()
    ls.append(k[:10], _rows(k[:10], salt=9.0))
    ls.commit()
    ls.close()
    again = _store(tmp_path / "b")
    mk, mv = again.materialize()
    np.testing.assert_array_equal(mk, k)
    np.testing.assert_array_equal(mv[:10], _rows(k[:10], salt=9.0))
    np.testing.assert_array_equal(mv[10:], _rows(k[10:]))
    vals, found = again.lookup(np.array([5, 999], dtype=np.uint64))
    assert found.tolist() == [True, False]
    assert not again.might_contain(np.array([777_777], np.uint64)).any()
    again.close()


def test_single_bucket_log_and_bounded_manifests(tmp_path):
    ls = _store(tmp_path / "one", n_buckets=1)
    k = np.array([1, 2 ** 63, 2 ** 64 - 1], dtype=np.uint64)
    ls.append(k, _rows(k))
    ls.commit()
    ls.close()
    again = _store(tmp_path / "one", n_buckets=1)
    np.testing.assert_array_equal(again.materialize()[0], k)
    again.close()
    flat = _store(tmp_path / "flat")
    for i in range(6):
        kk = np.arange(1 + i, 20 + i, dtype=np.uint64)
        flat.append(kk, _rows(kk, salt=float(i)))
        flat.commit()
    names = sorted(n for n in os.listdir(str(tmp_path / "flat"))
                   if n.startswith("manifest-"))
    assert names == [f"manifest-{flat.gen:08d}.json"]
    flat.close()


def test_compaction_is_content_preserving(tmp_path):
    ls = _store(tmp_path, compact_threshold=2)
    k = np.arange(1, 60, dtype=np.uint64)
    for p in range(4):
        ls.append(k, _rows(k, salt=float(p)))
        ls.commit()
    pre = ls.materialize()
    assert ls.buckets_over_threshold()
    assert ls.compact() > 0 and not ls.buckets_over_threshold()
    post = ls.materialize()
    ls.close()
    again = _store(tmp_path)
    rec = again.materialize()
    again.close()
    for got in (post, rec):
        np.testing.assert_array_equal(got[0], pre[0])
        np.testing.assert_array_equal(got[1], pre[1])


def test_verify_gen_and_time_travel(tmp_path):
    ls = _store(tmp_path, keep_history=True)
    k = np.arange(1, 20, dtype=np.uint64)
    gens = []
    for p in range(3):
        ls.append(k, _rows(k, salt=float(p)))
        gens.append(ls.commit())
    for p, g in enumerate(gens):
        assert ls.verify_gen(g)[0]
        gk, gv = ls.materialize_at(g)
        np.testing.assert_array_equal(gk, k)
        np.testing.assert_array_equal(gv, _rows(k, salt=float(p)))
    seg = sorted(n for n in os.listdir(str(tmp_path)) if n.endswith(".seg"))[-1]
    with open(os.path.join(str(tmp_path), seg), "r+b") as fh:
        fh.seek(-3, os.SEEK_END)
        fh.write(b"\x00\x00\x00")
    ok, reason = ls.verify_gen(gens[-1])
    assert not ok and "crc" in reason
    ls.close()


def _committed(root):
    probe = _store(root)
    try:
        return probe.gen, probe.materialize()
    finally:
        probe.close()


@pytest.mark.parametrize("site", ["store.segment_write",
                                  "store.manifest_commit"])
def test_append_commit_abort_then_retry(tmp_path, site):
    ls = _store(tmp_path)
    k0 = np.arange(1, 25, dtype=np.uint64)
    ls.append(k0, _rows(k0))
    ls.commit()
    gen0, (mk0, mv0) = _committed(tmp_path)
    k1 = np.arange(100, 125, dtype=np.uint64)
    with fault_plan({site: "first:1"}):
        with pytest.raises(faults.FaultInjected):
            ls.append(k1, _rows(k1))
            ls.commit()
        gen, (mk, mv) = _committed(tmp_path)
        assert gen == gen0
        np.testing.assert_array_equal(mk, mk0)
        np.testing.assert_array_equal(mv, mv0)
        ls.discard_pending()
        ls.append(k1, _rows(k1))
        ls.commit()
    gen, (mk, _) = _committed(tmp_path)
    assert gen > gen0
    np.testing.assert_array_equal(mk, np.concatenate([k0, k1]))
    ls.close()


def test_compact_abort_keeps_old_segments(tmp_path):
    ls = _store(tmp_path, compact_threshold=2)
    k = np.arange(1, 60, dtype=np.uint64)
    for p in range(3):
        ls.append(k, _rows(k, salt=float(p)))
        ls.commit()
    pre_gen, (mk, mv) = _committed(tmp_path)
    n_live = ls.n_live_segments
    with fault_plan({"store.compact": "first:1"}):
        with pytest.raises(faults.FaultInjected):
            ls.compact()
        assert ls.n_live_segments == n_live
        gen, (ak, av) = _committed(tmp_path)
        assert gen == pre_gen
        np.testing.assert_array_equal(av, mv)
        assert ls.compact() > 0
    gen, (ak, av) = _committed(tmp_path)
    np.testing.assert_array_equal(ak, mk)
    np.testing.assert_array_equal(av, mv)
    ls.close()


def test_crash_between_manifest_and_current(tmp_path):
    """A manifest that landed without its CURRENT swing is an orphan the
    reopen ignores: by byte surgery, and by a hang at the commit site that
    a crash ends (the store object is abandoned, never closed)."""
    ls = _store(tmp_path)
    k = np.arange(1, 30, dtype=np.uint64)
    ls.append(k, _rows(k))
    gen1 = ls.commit()
    man = open(os.path.join(str(tmp_path), f"manifest-{gen1:08d}.json")).read()
    with open(os.path.join(str(tmp_path), f"manifest-{gen1 + 1:08d}.json"),
              "w") as fh:
        fh.write(man.replace(f'"gen": {gen1}', f'"gen": {gen1 + 1}'))
    ls.close()
    again = _store(tmp_path)
    assert again.gen == gen1
    # the same window through the fault site: the manifest is written, the
    # CURRENT swing raises, and a fresh open sees the old generation
    with fault_plan({"store.manifest_commit": "first:1"}):
        again.append(k, _rows(k, salt=1.0))
        with pytest.raises(faults.FaultInjected):
            again.commit()
    assert os.path.exists(os.path.join(str(tmp_path),
                                       f"manifest-{gen1 + 1:08d}.json"))
    gen, (mk, mv) = _committed(tmp_path)
    assert gen == gen1
    np.testing.assert_array_equal(mv, _rows(k))
    again.close()


def test_known_sites_cover_the_ported_surface():
    for site in ("store.merge", "store.segment_write", "store.compact",
                 "store.manifest_commit", "ckpt.save", "ckpt.load",
                 "ckpt.delta_save"):
        assert site in faults.known_sites()


def _log_ops(ls):
    k = np.arange(1, 200, dtype=np.uint64) * np.uint64(104729)
    for p in range(3):
        ls.append(k[p::2], _rows(k[p::2], salt=float(p)))
        ls.commit()
    ls.compact(0)
    return k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_log_directory_is_byte_compatible(tmp_path, writer):
    """The same operations through both packages' logs write the same files,
    byte for byte, and each package opens the other's directory with equal
    content."""
    roots = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for name, cls in (("port", LogStore), ("jax", RefLogStore)):
        ls = _store(roots[name], cls)
        _log_ops(ls)
        ls.close()
    names = sorted(os.listdir(roots["port"]))
    assert names == sorted(os.listdir(roots["jax"]))
    for n in names:
        assert (open(roots["port"] / n, "rb").read()
                == open(roots["jax"] / n, "rb").read()), n
    reader = RefLogStore if writer == "port" else LogStore
    other = reader(str(roots[writer]), n_cols=3, n_buckets=2)
    own = _store(roots[writer])
    try:
        for got, want in zip(other.materialize(), own.materialize()):
            np.testing.assert_array_equal(got, want)
        assert other.gen == own.gen
    finally:
        other.close()
        own.close()


# --------------------------------------------------------------------------- #
# the table on its durable log
# --------------------------------------------------------------------------- #
def _dconf(root, **kw):
    base = dict(embedding_dim=4, learning_rate=0.1, initial_g2sum=1.0,
                initial_range=0.5, hbm_cache_rows=0,
                store_log_dir=os.path.join(str(root), "log"),
                store_log_buckets=2, store_compact_threshold=10_000)
    base.update(kw)
    return base


def _pass_keys(p):
    rs = np.random.RandomState(100 + p)
    return np.unique(rs.randint(1, 5000, size=400).astype(np.uint64))


def _delta(cap, width, p):
    d = ((np.arange(cap, dtype=np.float32)[:, None] % 7.0) + p) * 0.01
    return np.ascontiguousarray(np.broadcast_to(d, (cap, width)))


def _run_pass(t, p):
    t.begin_pass(_pass_keys(p))
    cap, width = t.values.shape
    t.values = t.values + torch.from_numpy(_delta(cap, width, p))
    t.g2sum = t.g2sum + 0.25
    t.end_pass()


def _run_ref_pass(t, p):
    t.begin_pass(_pass_keys(p))
    cap, width = t.values.shape
    t.values = t.values + jnp.asarray(_delta(cap, width, p))
    t.g2sum = t.g2sum + jnp.float32(0.25)
    t.end_pass()


def _table(root, **kw):
    return SparseTable(SparseTableConfig(**_dconf(root, **kw)), seed=7,
                       device="cpu")


def _reference_state(root, **kw):
    t = _table(root, **kw)
    try:
        for p in range(N_PASSES):
            _run_pass(t, p)
            t.flush()
        return t.state_dict()
    finally:
        t.close()


@pytest.mark.parametrize("overlap", [True, False])
def test_reopen_recovers_bit_exact(tmp_path, overlap):
    ref = _reference_state(tmp_path, overlap_pass_boundary=overlap)
    again = _table(tmp_path)
    try:
        got = again.state_dict()
        np.testing.assert_array_equal(got["keys"], ref["keys"])
        np.testing.assert_array_equal(got["values"], ref["values"])
    finally:
        again.close()


def test_kill_switch_disables_the_log(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_DURABLE_STORE", "0")
    t = _table(tmp_path)
    try:
        assert t._log is None
        _run_pass(t, 0)
        t.flush()
    finally:
        t.close()
    assert not os.path.exists(os.path.join(str(tmp_path), "log", "CURRENT"))


@pytest.mark.parametrize("site", ["store.segment_write",
                                  "store.manifest_commit", "store.compact"])
def test_crash_mid_mutation_recovers_bit_exact(tmp_path, site):
    """A raising fault interrupts pass 2's merge (or a compaction); the
    dying table is abandoned unclosed and a fresh one recovers the last
    committed generation, replays the rest, and lands bit-exact."""
    ref = _reference_state(tmp_path / "ref")
    victim = _table(tmp_path / "v")
    for p in range(2):
        _run_pass(victim, p)
        victim.flush()
    committed = 2
    with fault_plan({site: "first:1"}):
        if site == "store.compact":
            _run_pass(victim, 2)
            victim.flush()
            committed = 3
            with pytest.raises(faults.FaultInjected):
                victim._log.compact(0)
        else:
            with pytest.raises(faults.FaultInjected):
                _run_pass(victim, 2)
                victim.flush()
    victim._merge_futures.clear()  # the crash: nothing more lands
    victim._store.close()
    for wk in (victim._merge_worker, victim._stage_worker,
               victim._compact_worker):
        wk.close()
    del victim
    resumed = _table(tmp_path / "v")
    try:
        for p in range(committed, N_PASSES):
            _run_pass(resumed, p)
            resumed.flush()
        got = resumed.state_dict()
    finally:
        resumed.close()
    np.testing.assert_array_equal(got["keys"], ref["keys"])
    np.testing.assert_array_equal(got["values"], ref["values"])


def test_census_resolve_through_the_log(tmp_path):
    t = _table(tmp_path)
    try:
        _run_pass(t, 0)
        t.flush()
        before = stats.get("store.census_disk_rejects")
        t.begin_pass(np.arange(50_000, 50_200, dtype=np.uint64))
        t.end_pass()
        assert stats.get("store.census_disk_rejects") - before > 150
        # rows the RAM store lost but the log holds come back from the log
        full_k, full_v = t._store.materialize()
        half = full_k.shape[0] // 2
        t._store.load_bulk(full_k[:half], full_v[:half])
        before = stats.get("store.census_log_hits")
        t.begin_pass(full_k)
        vals = t.values.clone()
        t.end_pass()
        assert stats.get("store.census_log_hits") - before >= full_k.shape[0] - half
        np.testing.assert_array_equal(vals[: full_k.shape[0]].numpy(),
                                      full_v[:, :-1])
    finally:
        t.close()


def test_compact_failure_is_absorbed_and_counted(tmp_path):
    t = _table(tmp_path, store_compact_threshold=2)
    with fault_plan({"store.compact": "first:8"}):
        before = stats.get("store.compact_failures")
        for p in range(N_PASSES):
            _run_pass(t, p)
            t.flush()
        t.close()
        assert stats.get("store.compact_failures") - before > 0
    ref = _reference_state(tmp_path / "ref")
    again = _table(tmp_path)
    try:
        got = again.state_dict()
    finally:
        again.close()
    np.testing.assert_array_equal(got["keys"], ref["keys"])
    np.testing.assert_array_equal(got["values"], ref["values"])


def test_corrupt_spill_recovers_from_log(tmp_path):
    t = _table(tmp_path, store_spill_dir=os.path.join(str(tmp_path), "spill"),
               store_buckets=4, store_max_resident=1)
    try:
        _run_pass(t, 0)
        t.flush()
        oracle_k, oracle_v = t._log.materialize()
        b = int(np.nonzero(t._store._spilled)[0][0])
        with open(t._store._path(b), "wb") as fh:
            fh.write(b"not an npz at all")
        before_c = stats.get("store.spill_corrupt")
        before_r = stats.get("store.spill_recovered")
        keys_b = oracle_k[t._store._bucket_of(oracle_k) == b]
        vals, found = t._store.lookup(keys_b)
        assert found.all()
        np.testing.assert_array_equal(vals,
                                      oracle_v[np.searchsorted(oracle_k, keys_b)])
        assert stats.get("store.spill_corrupt") - before_c == 1
        assert stats.get("store.spill_recovered") - before_r == keys_b.shape[0]
    finally:
        t.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_table_log_opens_in_the_other_package(tmp_path, writer):
    """A durable table log written by one package recovers, bit for bit,
    in a table of the other."""
    root = tmp_path / writer
    kw = _dconf(root)
    if writer == "port":
        want = _reference_state(root)
        other = RefTable(ref_config.SparseTableConfig(
            **kw, overlap_pass_boundary=False), seed=7)
    else:
        rt = RefTable(ref_config.SparseTableConfig(**kw), seed=7)
        for p in range(N_PASSES):
            _run_ref_pass(rt, p)
            rt.flush()
        want = rt.state_dict()
        rt.close()
        other = _table(root)
    try:
        got = other.state_dict()
    finally:
        other.close()
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_array_equal(got["values"], want["values"])


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
S, DENSE, B = 3, 2, 16


def _dataset(tmp_path, seed=0, n_ins=64):
    conf = make_synth_config(n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
                             max_feasigns_per_ins=16)
    files = write_synth_files(
        str(tmp_path / f"d{seed}"), n_files=1, ins_per_file=n_ins,
        n_sparse_slots=S, vocab_per_slot=40, dense_dim=DENSE, seed=seed)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _world(seed=0, **tkw):
    tconf = SparseTableConfig(embedding_dim=4, **tkw)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                   seed=seed, device="cpu")
    trainer = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 10),
                      device="cpu")
    table = SparseTable(tconf, seed=seed, device="cpu")
    return trainer, table


def _train_pass(trainer, table, ds, auc=None):
    table.begin_pass(ds.unique_keys())
    m = trainer.train_from_dataset(ds, table, auc_state=auc)
    table.end_pass()
    return m


def _dense_equal(a, b):
    pa, oa = a.dense_state()
    pb, ob = b.dense_state()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_dense_state_npz_roundtrip(tmp_path):
    trainer, table = _world()
    ds = _dataset(tmp_path)
    try:
        _train_pass(trainer, table, ds)
        params, opt = trainer.dense_state()
        save_pytree(str(tmp_path / "dense.npz"), params)
        save_pytree(str(tmp_path / "opt.npz"), opt)
        auc = trainer.last_auc_state
        save_pytree(str(tmp_path / "m.npz"), auc)
        t2, tab2 = _world(seed=9)
        p2, o2 = t2.dense_state()
        t2.load_dense_state(load_pytree(str(tmp_path / "dense.npz"), p2),
                            load_pytree(str(tmp_path / "opt.npz"), o2))
        _dense_equal(trainer, t2)
        got = load_pytree(str(tmp_path / "m.npz"), t2.init_auc())
        assert type(got) is type(auc)
        for x, y in zip(got, auc):
            assert torch.equal(x, y)
        with pytest.raises(KeyError, match="missing leaf"):
            load_pytree(str(tmp_path / "dense.npz"),
                        {"tower.9.weight": torch.zeros(1)})
        tab2.close()
    finally:
        table.close()
        ds.close()


def test_base_roundtrip_and_delta_chain(tmp_path):
    ds1, ds2 = _dataset(tmp_path, 0), _dataset(tmp_path, 1)
    trainer, table = _world()
    t2, tab2 = _world(seed=99)
    try:
        _train_pass(trainer, table, ds1)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save_base("base0", table, *trainer.dense_state(),
                      meta={"step": trainer.global_step})
        _train_pass(trainer, table, ds2)
        mgr.save_delta("delta1", table, *trainer.dense_state())
        assert [c.kind for c in mgr.list_checkpoints()] == ["base", "delta"]
        p2, o2, meta = mgr.load(tab2, *t2.dense_state())
        t2.load_dense_state(p2, o2)
        assert meta["tag"] == "delta1" and meta["table_seed"] == 0
        sd, sd2 = table.state_dict(), tab2.state_dict()
        np.testing.assert_array_equal(sd2["keys"], sd["keys"])
        np.testing.assert_array_equal(sd2["values"], sd["values"])
        _dense_equal(trainer, t2)
        assert tab2._seed == 0  # the saved seed rides the meta
    finally:
        for t in (table, tab2):
            t.close()
        ds1.close()
        ds2.close()


def test_resume_matches_uninterrupted(tmp_path):
    """Save after pass 1, load into a fresh world, train pass 2: bit-equal
    to the run that never stopped."""
    ds1, ds2 = _dataset(tmp_path, 0), _dataset(tmp_path, 1)
    tr_a, tab_a = _world()
    tr_b, tab_b = _world()
    tr_c, tab_c = _world(seed=7)
    try:
        _train_pass(tr_a, tab_a, ds1)
        m_a = _train_pass(tr_a, tab_a, ds2)
        _train_pass(tr_b, tab_b, ds1)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save_base("mid", tab_b, *tr_b.dense_state())
        pc, oc, _ = mgr.load(tab_c, *tr_c.dense_state())
        tr_c.load_dense_state(pc, oc)
        m_c = _train_pass(tr_c, tab_c, ds2)
        assert m_c["loss"] == m_a["loss"] and m_c["auc"] == m_a["auc"]
        sd_a, sd_c = tab_a.state_dict(), tab_c.state_dict()
        np.testing.assert_array_equal(sd_c["keys"], sd_a["keys"])
        np.testing.assert_array_equal(sd_c["values"], sd_a["values"])
    finally:
        for t in (tab_a, tab_b, tab_c):
            t.close()
        ds1.close()
        ds2.close()


def test_load_upto_missing_and_corrupt(tmp_path):
    ds = _dataset(tmp_path)
    trainer, table = _world()
    _, t2 = _world(seed=3)
    try:
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        with pytest.raises(FileNotFoundError):
            mgr.load(table)
        _train_pass(trainer, table, ds)
        mgr.save_base("a", table)
        at_a = table.state_dict()
        _train_pass(trainer, table, ds)
        mgr.save_delta("b", table)
        mgr.load(t2, upto="a")
        np.testing.assert_array_equal(t2.state_dict()["values"], at_a["values"])
        with pytest.raises(FileNotFoundError):
            mgr.load(t2, upto="nope")
        assert mgr.find_valid_tag() == "b"
        with open(os.path.join(mgr.root, "delta-b", "sparse.npz"), "r+b") as fh:
            fh.seek(-2, os.SEEK_END)
            fh.write(b"\xff\xff")
        with pytest.raises(CheckpointCorrupt, match="sha256"):
            verify_checkpoint_dir(os.path.join(mgr.root, "delta-b"))
        assert mgr.find_valid_tag() == "a"
        with fault_plan({"ckpt.save": "first:1"}):
            with pytest.raises(faults.FaultInjected):
                mgr.save_base("c", table)
        assert [c.tag for c in mgr.list_checkpoints()] == ["a", "b"]
    finally:
        table.close()
        t2.close()
        ds.close()


def test_sharded_table_checkpoint(tmp_path):
    mesh = make_mesh(4, device="cpu")
    tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0)
    ds = _dataset(tmp_path, n_ins=B * 4 * 2)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                   device="cpu")
    trainer = MultiChipTrainer(model, tconf, mesh,
                               TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(tconf, mesh, seed=0)
    table2 = ShardedSparseTable(tconf, mesh, seed=9)
    try:
        _train_pass(trainer, table, ds)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save_base("x", table, *trainer.dense_state())
        model2 = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                        seed=9, device="cpu")
        trainer2 = MultiChipTrainer(model2, tconf, mesh,
                                    TrainerConfig(auc_buckets=1 << 10))
        p2, o2, _ = mgr.load(table2, *trainer2.dense_state())
        trainer2.load_dense_state(p2, o2)
        sd, sd2 = table.state_dict(), table2.state_dict()
        np.testing.assert_array_equal(sd2["keys"], sd["keys"])
        np.testing.assert_array_equal(sd2["values"], sd["values"])
        assert np.isfinite(_train_pass(trainer2, table2, ds)["loss"])
    finally:
        table.close()
        table2.close()
        ds.close()


def _ref_world(seed=0):
    from paddlebox_tpu.models import CtrDnn as RefCtrDnn
    from paddlebox_tpu.train.trainer import Trainer as RefTrainer

    rconf = ref_config.SparseTableConfig(embedding_dim=4)
    tr = RefTrainer(RefCtrDnn(S, rconf.row_width, dense_dim=DENSE,
                              hidden=(16,)),
                    rconf, ref_config.TrainerConfig(auc_buckets=1 << 10),
                    seed=seed)
    return tr, RefTable(rconf, seed=seed)


def test_checkpoint_directory_crosses_packages(tmp_path):
    """A checkpoint directory written by the JAX package loads in the port
    (sparse half equal, the dense half mapped by params_from_jax), and one
    written by the port loads in the JAX package (params_to_jax)."""
    from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
    from paddlebox_tpu.data.synth import make_synth_config as ref_synth

    ds = _dataset(tmp_path)
    ref_ds = RefDataset(ref_synth(n_sparse_slots=S, dense_dim=DENSE,
                                  batch_size=B, max_feasigns_per_ins=16),
                        read_threads=1)
    ref_ds.set_filelist(ds.filelist)
    ref_ds.load_into_memory()
    rtr, rtab = _ref_world()
    trainer, table = _world()
    try:
        rtab.begin_pass(ref_ds.unique_keys())
        rtr.train_from_dataset(ref_ds, rtab)
        rtab.end_pass()
        RefCheckpointManager(str(tmp_path / "from_jax")).save_base(
            "t", rtab, *rtr.dense_state())
        t2, tab2 = _world(seed=5)
        params, _, meta = CheckpointManager(str(tmp_path / "from_jax")).load(
            tab2, t2.dense_state()[0])
        want = rtab.state_dict()
        got = tab2.state_dict()
        np.testing.assert_array_equal(got["keys"], want["keys"])
        np.testing.assert_array_equal(got["values"], want["values"])
        tower = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in rtr.params["tower"]]
        for k, v in params_from_jax(tower).items():
            assert torch.equal(params[k], v), k
        assert meta["tag"] == "t"
        tab2.close()

        _train_pass(trainer, table, ds)
        CheckpointManager(str(tmp_path / "from_port")).save_base(
            "u", table, *trainer.dense_state())
        _, rtab2 = _ref_world(seed=5)
        _, _, rmeta = RefCheckpointManager(str(tmp_path / "from_port")).load(
            rtab2)
        want, got = table.state_dict(), rtab2.state_dict()
        np.testing.assert_array_equal(got["keys"], want["keys"])
        np.testing.assert_array_equal(got["values"], want["values"])
        with np.load(tmp_path / "from_port" / "base-u" / "dense.npz") as z:
            saved = {k: z[k] for k in z.files}
        mapped = params_to_jax(trainer.dense_state()[0])
        for i, layer in enumerate(mapped["tower"]):
            np.testing.assert_array_equal(
                layer["w"], saved[f"tower.{i}.weight"].T)
        assert rmeta["tag"] == "u" and rmeta["table_seed"] == 0
        rtab2.close()
    finally:
        rtab.close()
        table.close()
        ds.close()
        ref_ds.close()


# --------------------------------------------------------------------------- #
# incremental checkpoints over the durable log
# --------------------------------------------------------------------------- #
def _ckpt_world(root):
    t = _table(root, store_log_dir="")
    return t, IncrementalCheckpointManager(os.path.join(str(root), "ckpt"))


def _train_and_save(t, mgr, n=4):
    params = {"w": np.arange(3, dtype=np.float32)}
    for p in range(n):
        _run_pass(t, p)
        params = {"w": params["w"] + p}
        save = mgr.save_base if p == 0 else mgr.save_delta
        save(f"p{p:03d}", t, params=params, meta={"pass_index": p})
    return params


def test_incremental_restore_newest_and_time_travel(tmp_path):
    t, mgr = _ckpt_world(tmp_path)
    snaps = {}
    params = {"w": np.arange(3, dtype=np.float32)}
    try:
        for p in range(4):
            _run_pass(t, p)
            params = {"w": params["w"] + p}
            save = mgr.save_base if p == 0 else mgr.save_delta
            save(f"p{p:03d}", t, params=params, meta={"pass_index": p})
            snaps[f"p{p:03d}"] = t.state_dict()
    finally:
        t.close()
    t2, mgr2 = _ckpt_world(tmp_path)
    try:
        got_params, _, meta = mgr2.load(
            t2, params_template={"w": np.zeros(3, dtype=np.float32)})
        assert meta["tag"] == "p003" and meta["pass_index"] == 3
        np.testing.assert_array_equal(got_params["w"], params["w"])
        for tag in ("p003", "p001"):
            mgr2.load(t2, upto=tag)
            got = t2.state_dict()
            np.testing.assert_array_equal(got["keys"], snaps[tag]["keys"])
            np.testing.assert_array_equal(got["values"], snaps[tag]["values"])
    finally:
        t2.close()


def test_incremental_delta_save_fault_aborts_clean(tmp_path):
    t, mgr = _ckpt_world(tmp_path)
    try:
        _run_pass(t, 0)
        mgr.save_base("p000", t)
        _run_pass(t, 1)
        with fault_plan({"ckpt.delta_save": "first:1"}):
            with pytest.raises(faults.FaultInjected):
                mgr.save_delta("p001", t)
            assert mgr.find_valid_tag() == "p000"
            mgr.save_delta("p001", t)  # the retry commits the same rows
        assert mgr.find_valid_tag() == "p001"
        want = t.state_dict()
    finally:
        t.close()
    t2, mgr2 = _ckpt_world(tmp_path)
    try:
        mgr2.load(t2)
        got = t2.state_dict()
        np.testing.assert_array_equal(got["keys"], want["keys"])
        np.testing.assert_array_equal(got["values"], want["values"])
    finally:
        t2.close()


def test_incremental_bounded_restore_and_corrupt_generation(tmp_path):
    t, mgr = _ckpt_world(tmp_path / "b")
    try:
        mgr.compact_threshold = 2
        _train_and_save(t, mgr, n=6)
    finally:
        t.close()
    # compaction folded the history: about 2 segments a bucket, not 6
    # saves times 4 buckets
    assert mgr._log().n_live_segments <= 2 * 4
    t, mgr = _ckpt_world(tmp_path / "c")
    try:
        _train_and_save(t, mgr, n=4)
    finally:
        t.close()
    log_root = os.path.join(str(tmp_path / "c"), "ckpt", "sparse-log")
    segs = sorted(n for n in os.listdir(log_root) if n.endswith(".seg"))
    with open(os.path.join(log_root, segs[-1]), "r+b") as fh:
        fh.seek(-4, os.SEEK_END)
        fh.write(b"\xde\xad\xbe\xef")
    mgr2 = IncrementalCheckpointManager(
        os.path.join(str(tmp_path / "c"), "ckpt"))
    tag = mgr2.find_valid_tag()
    assert tag is not None and tag < "p003"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_incremental_directory_crosses_packages(tmp_path, writer):
    root = str(tmp_path / "ckpt")
    if writer == "port":
        t, mgr = _ckpt_world(tmp_path)
        try:
            _train_and_save(t, mgr, n=3)
            want = t.state_dict()
        finally:
            t.close()
        other = RefTable(ref_config.SparseTableConfig(embedding_dim=4),
                         seed=1)
        RefIncrementalManager(root).load(other)
    else:
        rt = RefTable(ref_config.SparseTableConfig(
            **_dconf(tmp_path, store_log_dir="")), seed=7)
        rmgr = RefIncrementalManager(root)
        for p in range(3):
            _run_ref_pass(rt, p)
            save = rmgr.save_base if p == 0 else rmgr.save_delta
            save(f"p{p:03d}", rt)
        want = rt.state_dict()
        rt.close()
        other = _table(tmp_path / "o", store_log_dir="")
        IncrementalCheckpointManager(root).load(other)
    try:
        got = other.state_dict()
        assert other._seed == 7
    finally:
        other.close()
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_array_equal(got["values"], want["values"])


# --------------------------------------------------------------------------- #
# the AutoCheckpointer
# --------------------------------------------------------------------------- #
AP = 4


def _acp_world(tmp_path, seed=0):
    conf = make_synth_config(n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
                             max_feasigns_per_ins=8)
    files = write_synth_files(
        str(tmp_path / "data"), n_files=2, ins_per_file=64,
        n_sparse_slots=S, vocab_per_slot=60, dense_dim=DENSE, seed=9)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    trainer, table = _world(seed)
    return ds, table, trainer


def _run_passes(ds, table, trainer, lo, hi, acp=None, mstate=None):
    m = None
    for p in range(lo, hi):
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table, auc_state=mstate)
        table.end_pass()
        mstate = trainer.last_auc_state
        if acp is not None:
            acp.after_pass(p, table, trainer, metric_state=mstate)
    return m, mstate


@pytest.mark.parametrize("incremental", [False, True])
def test_kill_and_resume_reproduces_uninterrupted(tmp_path, incremental):
    ds, table, trainer = _acp_world(tmp_path)
    ref, _ = _run_passes(ds, table, trainer, 0, AP)
    ref_state = table.state_dict()
    table.close()
    ds2, table_a, trainer_a = _acp_world(tmp_path)
    acp_a = AutoCheckpointer(str(tmp_path / "acp"), job_id="job1",
                             incremental=incremental)
    assert isinstance(acp_a.ckpt, IncrementalCheckpointManager) == incremental
    _run_passes(ds2, table_a, trainer_a, 0, 2, acp=acp_a)
    table_a.close()
    del table_a, trainer_a, acp_a  # the "kill"
    ds3, table_b, trainer_b = _acp_world(tmp_path)
    acp_b = AutoCheckpointer(str(tmp_path / "acp"), job_id="job1",
                             incremental=incremental)
    try:
        status, mstate = acp_b.resume(table_b, trainer_b,
                                      metric_template=trainer_b.init_auc())
        assert status is not None and status["next_pass"] == 2
        assert trainer_b.global_step == status["global_step"]
        got, _ = _run_passes(ds3, table_b, trainer_b, 2, AP, acp=acp_b,
                             mstate=mstate)
        # the CPU run is deterministic: the replay is bit-equal
        assert got["count"] == ref["count"]
        assert got["auc"] == ref["auc"] and got["loss"] == ref["loss"]
        got_state = table_b.state_dict()
        np.testing.assert_array_equal(got_state["keys"], ref_state["keys"])
        np.testing.assert_array_equal(got_state["values"], ref_state["values"])
    finally:
        table_b.close()
        for d in (ds, ds2, ds3):
            d.close()


def test_fresh_resume_and_crash_between_checkpoint_and_status(tmp_path):
    ds, table, trainer = _acp_world(tmp_path)
    acp = AutoCheckpointer(str(tmp_path / "acp"), job_id="job2")
    try:
        assert acp.resume(table, trainer) == (None, None)
        _run_passes(ds, table, trainer, 0, 1, acp=acp)
        # the checkpoint of pass 1 lands, its status line does not
        _run_passes(ds, table, trainer, 1, 2)
        acp.ckpt.save_delta("job2-p000001", table, *trainer.dense_state())
        ds2, table_b, trainer_b = _acp_world(tmp_path)
        status, _ = AutoCheckpointer(str(tmp_path / "acp"),
                                     job_id="job2").resume(table_b, trainer_b)
        assert status["next_pass"] == 1  # pass 1 runs again
        table_b.close()
        ds2.close()
        with open(os.path.join(str(tmp_path / "acp"),
                               "status-job2.json")) as fh:
            assert json.load(fh)["tag"] == "job2-p000000"
    finally:
        table.close()
        ds.close()


def test_resume_falls_back_past_a_corrupt_tag(tmp_path):
    ds, table, trainer = _acp_world(tmp_path)
    acp = AutoCheckpointer(str(tmp_path / "acp"), job_id="j", base_every=8)
    try:
        _run_passes(ds, table, trainer, 0, 3, acp=acp)
        d = os.path.join(str(tmp_path / "acp"), "delta-j-p000002")
        with open(os.path.join(d, "sparse.npz"), "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            last = fh.read(1)[0]
            fh.seek(-1, os.SEEK_END)
            fh.write(bytes([last ^ 0xFF]))
        ds2, table_b, trainer_b = _acp_world(tmp_path)
        before = stats.get("ckpt.resume_fallback")
        status, mstate = AutoCheckpointer(
            str(tmp_path / "acp"), job_id="j").resume(
                table_b, trainer_b, metric_template=trainer_b.init_auc())
        assert status["fallback"] and status["next_pass"] == 2
        assert mstate is None
        assert stats.get("ckpt.resume_fallback") == before + 1
        table_b.close()
        ds2.close()
    finally:
        table.close()
        ds.close()
