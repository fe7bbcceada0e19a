"""Host-side parity of the PyTorch port with the JAX package: synthetic
files, parsed batches, splitmix64, the key-deterministic row init, the
bucket store, pass promotion and the batch planner — all bit-exact.

Each test that reads files or plans keys runs twice: with both packages'
native parser and planner off (their pure numpy/Python paths), and with
both on (the defaults; the port builds the reference's C++ sources).  The
reference runs with the HBM cache and the pass-boundary overlap off (the
port's serial, uncached lifecycle; the reference pins both bit-exact
against their defaults).
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import SparseTableConfig as RefTableConf
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.slot_parser import SlotParser as RefParser
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.data.synth import write_synth_files as ref_write_synth
from paddlebox_tpu.sparse.store import BucketStore as RefStore
from paddlebox_tpu.sparse.store import splitmix64 as ref_splitmix64
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.sparse.table import _key_uniform as ref_key_uniform
from paddlebox_tpu_torch.config import SparseTableConfig
from paddlebox_tpu_torch.config import flags as port_flags
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.slot_parser import SlotParser
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.sparse.store import BucketStore, splitmix64
from paddlebox_tpu_torch.sparse.table import SparseTable, _key_uniform
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

SLOTS, DENSE, BATCH = 4, 3, 64


NATIVE = ("USE_NATIVE_PARSER", "USE_NATIVE_PLANNER")


@pytest.fixture
def ref_numpy_paths(monkeypatch):
    """Both packages on their numpy planner and Python parser."""
    for name in NATIVE:
        monkeypatch.setenv(f"PBOX_{name}", "0")
        monkeypatch.setenv(f"PADDLEBOX_TORCH_{name}", "0")


@pytest.fixture
def native_paths(monkeypatch):
    """Both packages on their native planner and parser."""
    for name in NATIVE:
        monkeypatch.setenv(f"PBOX_{name}", "1")
        monkeypatch.setenv(f"PADDLEBOX_TORCH_{name}", "1")


def _tconfs(**kw):
    base = dict(embedding_dim=4, initial_range=0.5, plan_scratch_rows=64)
    base.update(kw)
    return (
        RefTableConf(hbm_cache_rows=0, overlap_pass_boundary=False, **base),
        SparseTableConfig(**base),
    )


@pytest.mark.parametrize("zipf_a", [0.0, 1.3])
def test_synth_files_are_byte_identical(tmp_path, zipf_a):
    kw = dict(n_files=2, ins_per_file=50, n_sparse_slots=SLOTS,
              vocab_per_slot=30, dense_dim=DENSE, seed=4, zipf_a=zipf_a)
    ref = ref_write_synth(str(tmp_path / "ref"), **kw)
    port = write_synth_files(str(tmp_path / "port"), **kw)
    for a, b in zip(ref, port):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("shuffle_seed", [None, 5])
def test_host_batches_are_identical(tmp_path, ref_numpy_paths, shuffle_seed):
    files = write_synth_files(
        str(tmp_path), n_files=2, ins_per_file=150, n_sparse_slots=SLOTS,
        vocab_per_slot=40, dense_dim=DENSE, seed=1,
    )
    ref_ds = RefDataset(ref_synth_config(SLOTS, DENSE, BATCH, 8), read_threads=2)
    ds = PadBoxSlotDataset(make_synth_config(SLOTS, DENSE, BATCH, 8), read_threads=2)
    for d in (ref_ds, ds):
        d.set_filelist(files)
        d.load_into_memory()
        if shuffle_seed is not None:
            d.local_shuffle(seed=shuffle_seed)
    np.testing.assert_array_equal(ref_ds.unique_keys(), ds.unique_keys())
    ref_b = list(ref_ds.batches())
    port_b = list(ds.batches())
    assert len(ref_b) == len(port_b) == 5  # 300 instances, batch 64
    for rb, pb in zip(ref_b, port_b):
        assert rb.n_keys == pb.n_keys
        for f in ("keys", "key_segments", "dense", "labels", "ins_mask"):
            a, b = getattr(rb, f), getattr(pb, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert ref_ds.builder.dropped_keys == ds.builder.dropped_keys
    assert (ds.parser._native is not None) == port_flags.use_native_parser
    ref_ds.close()
    ds.close()


@pytest.mark.parametrize("shuffle_seed", [None, 5])
def test_host_batches_are_identical_native(tmp_path, native_paths,
                                           shuffle_seed):
    test_host_batches_are_identical(tmp_path, native_paths, shuffle_seed)


def test_key_capacity_clipping_matches(tmp_path, ref_numpy_paths):
    files = write_synth_files(
        str(tmp_path), n_files=1, ins_per_file=64, n_sparse_slots=SLOTS,
        vocab_per_slot=40, dense_dim=DENSE, seed=2,
    )
    ref_ds = RefDataset(ref_synth_config(SLOTS, DENSE, BATCH, 8,
                                         batch_key_capacity=100), read_threads=1)
    ds = PadBoxSlotDataset(make_synth_config(SLOTS, DENSE, BATCH, 8,
                                             batch_key_capacity=100), read_threads=1)
    for d in (ref_ds, ds):
        d.set_filelist(files)
        d.load_into_memory()
    (rb,), (pb,) = list(ref_ds.batches()), list(ds.batches())
    np.testing.assert_array_equal(rb.keys, pb.keys)
    np.testing.assert_array_equal(rb.key_segments, pb.key_segments)
    assert ds.builder.dropped_keys == ref_ds.builder.dropped_keys > 0
    ref_ds.close()
    ds.close()


def test_key_capacity_clipping_matches_native(tmp_path, native_paths):
    test_key_capacity_clipping_matches(tmp_path, native_paths)


@pytest.mark.parametrize("policy", ["raise", "skip"])
def test_parse_lines_malformed_policy_matches(policy):
    conf_kw = dict(malformed_policy=policy, quarantine_abort_frac=1.0)
    lines = [
        "1 1 2 5 6 1 7 1 9 1 10 3 0.1 0.2 0.3",
        "1 0 1 5 x 1 7 1 9 1 10 3 0.1 0.2 0.3",  # bad key
        "1 0 1 5 1 7 1 9 1 10 2 0.1 0.2",  # dense width
        "1 1 1 4 1 8 1 9 2 11 12 3 1 2 3",
    ]
    ref = RefParser(ref_synth_config(SLOTS, DENSE, BATCH, 8, **conf_kw))
    port = SlotParser(make_synth_config(SLOTS, DENSE, BATCH, 8, **conf_kw))
    if policy == "raise":
        for p in (ref, port):
            with pytest.raises(ValueError, match=r"<lines>:2: malformed"):
                p.parse_lines(lines)
        return
    before = stats.get("data.quarantined_lines")
    rb, pb = ref.parse_lines(lines), port.parse_lines(lines)
    assert rb.n_ins == pb.n_ins == 2
    assert port.quarantined_lines == ref.quarantined_lines == 2
    assert stats.get("data.quarantined_lines") - before == 2
    for f in ("keys", "key_offsets", "dense", "labels"):
        np.testing.assert_array_equal(getattr(rb, f), getattr(pb, f))


def test_splitmix64_and_key_uniform_bit_exact():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        rng.integers(0, 2**63, size=500, dtype=np.uint64) * np.uint64(2),
        np.array([0, 1, 2**64 - 1, 2**63], dtype=np.uint64),
    ])
    np.testing.assert_array_equal(splitmix64(keys), ref_splitmix64(keys))
    for seed, cols, rng_range in ((0, 4, 0.5), (3, 9, 0.02)):
        np.testing.assert_array_equal(
            _key_uniform(keys, seed, cols, rng_range),
            ref_key_uniform(keys, seed, cols, rng_range),
        )


def test_bucket_store_matches_reference():
    rng = np.random.default_rng(1)
    ref, port = RefStore(n_cols=5, n_buckets=8), BucketStore(n_cols=5, n_buckets=8)
    for _ in range(3):
        q = np.unique(rng.integers(0, 400, size=120).astype(np.uint64))
        vals = rng.normal(size=(q.shape[0], 5)).astype(np.float32)
        ref.update(q, vals)
        port.update(q, vals)
        probe = np.unique(rng.integers(0, 500, size=200).astype(np.uint64))
        (rv, rf), (pv, pf) = ref.lookup(probe), port.lookup(probe)
        np.testing.assert_array_equal(rf, pf)
        np.testing.assert_array_equal(rv, pv)
    assert port.n == ref.n
    for a, b in zip(ref.materialize(), port.materialize()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="sorted unique"):
        port.update(np.array([3, 2], np.uint64), np.zeros((2, 5), np.float32))


def test_begin_pass_rows_and_write_back_match(ref_numpy_paths):
    rconf, pconf = _tconfs()
    ref, port = RefTable(rconf, seed=2), SparseTable(pconf, seed=2, device="cpu")
    pass1 = np.array([7, 3, 3, 99, 2**63 + 5], dtype=np.uint64)
    for t in (ref, port):
        t.begin_pass(pass1)
    assert ref.capacity == port.capacity
    np.testing.assert_array_equal(np.asarray(ref.values), port.values.numpy())
    np.testing.assert_array_equal(np.asarray(ref.g2sum), port.g2sum.numpy())
    # a trained row must survive the write-back into the next pass
    ref.values = ref.values.at[1, 2:].set(7.0).at[1, 0].add(5.0)
    ref.g2sum = ref.g2sum.at[1].set(0.25)
    port.values[1, 2:] = 7.0
    port.values[1, 0] += 5.0
    port.g2sum[1] = 0.25
    for t in (ref, port):
        t.end_pass()
        t.begin_pass(np.array([7, 8, 2**63 + 5], dtype=np.uint64))
    np.testing.assert_array_equal(np.asarray(ref.values), port.values.numpy())
    np.testing.assert_array_equal(np.asarray(ref.g2sum), port.g2sum.numpy())
    for t in (ref, port):
        t.end_pass()
    assert port.n_features == ref.n_features == 5
    rs, ps = ref.state_dict(), port.state_dict()
    np.testing.assert_array_equal(rs["keys"], ps["keys"])
    np.testing.assert_array_equal(rs["values"], ps["values"])


def test_begin_pass_rows_and_write_back_match_native(native_paths):
    test_begin_pass_rows_and_write_back_match(native_paths)


@pytest.mark.parametrize("scratch", [64, 2])
def test_plan_keys_bit_exact(ref_numpy_paths, scratch):
    """idx / uniq_idx / inverse / key_mask / n_missing, including census
    misses and (scratch=2) push slots clamped onto the dead row."""
    rconf, pconf = _tconfs(plan_scratch_rows=scratch)
    ref, port = RefTable(rconf), SparseTable(pconf, device="cpu")
    rng = np.random.default_rng(3)
    # 1000 odd keys: with scratch=2 the table is 1024 rows, so push slots
    # past row 1022 clamp onto the dead row
    census = np.arange(1, 2001, 2, dtype=np.uint64)
    for t in (ref, port):
        t.begin_pass(census)
    assert ref.capacity == port.capacity == (1024 if scratch == 2 else 2048)
    K = 48
    for n_real in (0, 17, 40):
        keys = np.zeros(K, dtype=np.uint64)
        keys[:n_real] = rng.integers(1, 2200, size=n_real)  # evens miss
        rp, pp = ref.plan_keys(keys, n_real), port.plan_keys(keys, n_real)
        for f in ("idx", "uniq_idx", "inverse", "key_mask"):
            a, b = getattr(rp, f), getattr(pp, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert rp.n_missing == pp.n_missing
    assert ref.missing_key_count == port.missing_key_count > 0
    assert (port._census_index is not None) == port_flags.use_native_planner


@pytest.mark.parametrize("scratch", [64, 2])
def test_plan_keys_bit_exact_native(native_paths, scratch):
    """The native plans of the two packages, bit for bit (one C++ source)."""
    test_plan_keys_bit_exact(native_paths, scratch)
