"""The port's native host libraries against the JAX package's: the batch
planner (``_native/plan_resolve.cpp``) and the slot parser
(``_native/slot_parser.cpp``), both built by the port with g++ into
``paddlebox_tpu_torch/_build/``.

Ports of tests/test_native_planner.py and tests/test_native_parser.py.  The
port's native plans and blocks are held bit-exact against the reference's
native ones (the same C++ source), and against the port's own numpy planner
and Python parser: the planner under the reference's order-free
equivalence (the native planner numbers unique slots in first-seen order),
whole training passes bit for bit.
"""

import gzip
import os

import numpy as np
import pytest
import torch

import paddlebox_tpu._native as ref_native
import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.slot_parser import SlotParser as RefParser
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu_torch import _native
from paddlebox_tpu_torch.config import (
    DataFeedConfig,
    SlotConfig,
    SparseTableConfig,
    TrainerConfig,
)
from paddlebox_tpu_torch.data import slot_parser as port_slot_parser
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.slot_parser import SlotParser
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer

torch.set_num_threads(1)

PLANNER = "PADDLEBOX_TORCH_USE_NATIVE_PLANNER"
PARSER = "PADDLEBOX_TORCH_USE_NATIVE_PARSER"


@pytest.fixture(autouse=True)
def reference_defaults(monkeypatch):
    """The reference's native planner and parser on, as its defaults have
    them (other tests in the process may have left them off)."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "1")
    monkeypatch.setenv("PBOX_USE_NATIVE_PARSER", "1")


# --------------------------------------------------------------------------- #
# the build
# --------------------------------------------------------------------------- #
def test_libraries_build_into_the_build_dir():
    """Both libraries build from the port's sources into _build/ under a
    hashed name, and nothing lands beside the sources."""
    assert _native.get_lib() is not None
    assert _native.get_plan_lib() is not None
    for name in ("slot_parser", "plan_resolve"):
        so = _native.library_path(name)
        assert so.parent == _native.BUILD_DIR and so.exists()
        assert so.name.startswith(f"lib{name}-")
    assert not [f for f in os.listdir(_native.SRC_DIR) if f.endswith(".so")]
    assert _native.compiler_version().startswith("g++")


# --------------------------------------------------------------------------- #
# the planner
# --------------------------------------------------------------------------- #
def _plans(pass_keys, keys, n_real, monkeypatch, scratch=64):
    """(native plan, numpy plan) of the port for identical inputs, through
    SparseTable.plan_keys with the flag flipped (so the test also pins that
    the flag routes), and the reference's native plan."""
    plans = {}
    for native in ("1", "0"):
        monkeypatch.setenv(PLANNER, native)
        t = SparseTable(SparseTableConfig(embedding_dim=4,
                                          plan_scratch_rows=scratch),
                        seed=0, device="cpu")
        t.begin_pass(pass_keys)
        plans[native] = (t.plan_keys(keys, n_real), t.missing_key_count)
        assert (t._census_index is not None) == (native == "1")
        t.end_pass()
    ref = RefTable(ref_config.SparseTableConfig(
        embedding_dim=4, plan_scratch_rows=scratch, hbm_cache_rows=0,
        overlap_pass_boundary=False), seed=0)
    ref.begin_pass(pass_keys)
    ref_plan = ref.plan_keys(keys, n_real)
    assert ref._census_index is not None
    ref.end_pass()
    for f in ("idx", "uniq_idx", "inverse", "key_mask"):
        a, b = getattr(plans["1"][0], f), getattr(ref_plan, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert plans["1"][0].n_missing == ref_plan.n_missing
    return plans["1"], plans["0"]


def _assert_equal(a, b):
    """The reference's order-free plan equivalence
    (tests/test_native_planner.py): idx, the mask and the missing counts
    equal; the per-occurrence push target uniq_idx[inverse[occ]] equal
    wherever it is a live row; occurrences of one key share one slot."""
    plan_a, miss_a = a
    plan_b, miss_b = b
    np.testing.assert_array_equal(plan_a.idx, plan_b.idx)
    np.testing.assert_array_equal(plan_a.key_mask, plan_b.key_mask)
    assert plan_a.n_missing == plan_b.n_missing
    assert miss_a == miss_b
    tgt_a = plan_a.uniq_idx[plan_a.inverse]
    tgt_b = plan_b.uniq_idx[plan_b.inverse]
    found_a = (plan_a.idx == tgt_a) & (plan_a.key_mask > 0)
    found_b = (plan_b.idx == tgt_b) & (plan_b.key_mask > 0)
    np.testing.assert_array_equal(found_a, found_b)
    np.testing.assert_array_equal(tgt_a[found_a], plan_b.idx[found_b])
    for plan in (plan_a, plan_b):
        real = plan.key_mask > 0
        inv = plan.inverse[real]
        assert len(set(zip(inv.tolist(), plan.idx[real].tolist()))) == \
            len(set(inv.tolist()))


def test_parity_random_batches(monkeypatch):
    rng = np.random.default_rng(0)
    pass_keys = np.unique(rng.integers(1, 1 << 40, 5000).astype(np.uint64))
    for _ in range(5):
        K = int(rng.integers(64, 512))
        n_real = int(rng.integers(0, K + 1))
        keys = np.zeros(K, np.uint64)
        # census keys with duplicates, and unseen keys
        n_hit = n_real * 3 // 4
        keys[:n_hit] = rng.choice(pass_keys, n_hit)
        keys[n_hit:n_real] = rng.integers(1 << 41, 1 << 42,
                                          n_real - n_hit).astype(np.uint64)
        _assert_equal(*_plans(pass_keys, keys, n_real, monkeypatch))


def test_parity_edge_cases(monkeypatch):
    pass_keys = np.array([5, 9, 12, 700, 2**63 + 1], dtype=np.uint64)
    K = 16
    # all padding
    _assert_equal(*_plans(pass_keys, np.zeros(K, np.uint64), 0, monkeypatch))
    # one key throughout
    _assert_equal(*_plans(pass_keys, np.full(K, 9, np.uint64), K,
                          monkeypatch))
    # keys below and above the whole census, and at or above 2^63
    keys = np.array([1, 1, 900, 900, 5, 700, 2**63 + 1, 2**64 - 1]
                    + [0] * 8, np.uint64)
    _assert_equal(*_plans(pass_keys, keys, 8, monkeypatch))
    # an empty census: everything is missing
    _assert_equal(*_plans(np.empty(0, np.uint64), keys, 8, monkeypatch))


def test_parity_under_provisioned_scratch(monkeypatch):
    """Push slots past the scratch region clamp onto the dead row, the
    same in every planner."""
    pass_keys = np.arange(1, 900, dtype=np.uint64)
    rng = np.random.default_rng(1)
    keys = np.zeros(256, np.uint64)
    keys[:100] = rng.choice(pass_keys, 100)
    keys[90:100] = np.arange(5000, 5010, dtype=np.uint64)  # misses
    _assert_equal(*_plans(pass_keys, keys, 100, monkeypatch, scratch=2))


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    return write_synth_files(
        str(tmp_path_factory.mktemp("native")), n_files=1, ins_per_file=256,
        n_sparse_slots=3, vocab_per_slot=40, dense_dim=2, seed=6,
    )


def _train(files, monkeypatch, native, positions=0, prefetch=2):
    """One pass, single chip or on ``positions`` shard positions, with the
    native planner on or off: (metrics, state_dict)."""
    monkeypatch.setenv(PLANNER, native)
    conf = make_synth_config(n_sparse_slots=3, dense_dim=2,
                             batch_size=16 if positions else 32,
                             max_feasigns_per_ins=8)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0)
    model = CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(8,), seed=0,
                   device="cpu")
    trconf = TrainerConfig(auc_buckets=1 << 10, prefetch_batches=prefetch)
    if positions:
        mesh = make_mesh(positions, device="cpu")
        table = ShardedSparseTable(tconf, mesh, seed=0)
        trainer = MultiChipTrainer(model, tconf, mesh, trconf)
    else:
        table = SparseTable(tconf, seed=0, device="cpu")
        trainer = Trainer(model, tconf, trconf, device="cpu")
    table.begin_pass(ds.unique_keys())
    m = trainer.train_from_dataset(ds, table)
    assert (table._census_index is not None) == (native == "1")
    table.end_pass()
    state = table.state_dict()
    ds.close()
    return m, state


def test_e2e_training_same_result(small_files, monkeypatch):
    """One training pass, native against numpy planner: the same loss, AUC
    and table, bit for bit."""
    m1, s1 = _train(small_files, monkeypatch, "1")
    m2, s2 = _train(small_files, monkeypatch, "0")
    assert m1["loss"] == m2["loss"] and m1["auc"] == m2["auc"]
    np.testing.assert_array_equal(s1["keys"], s2["keys"])
    np.testing.assert_array_equal(s1["values"], s2["values"])


def test_sharded_plan_native_matches_numpy(small_files, monkeypatch):
    """The sharded plan_group, native against numpy, over one pass on four
    positions (hybrid placement, its planner's first pass): identical
    metrics and table."""
    m1, s1 = _train(small_files, monkeypatch, "1", positions=4)
    m2, s2 = _train(small_files, monkeypatch, "0", positions=4)
    assert m1["loss"] == m2["loss"] and m1["auc"] == m2["auc"]
    np.testing.assert_array_equal(s1["keys"], s2["keys"])
    np.testing.assert_array_equal(s1["values"], s2["values"])


def test_lookup_unique_and_dedup_rows_match_reference():
    """The sharded planner's two native calls, bit for bit against the
    reference's: census lookups in first-seen order, and the serve-side
    first-seen dedup."""
    rng = np.random.default_rng(4)
    census = np.unique(rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64))
    port_ix = _native.build_census_index(census)
    ref_ix = ref_native.build_census_index(census)
    for n_real in (0, 1, 200, 512):
        keys = np.zeros(512, np.uint64)
        keys[:n_real] = rng.choice(
            np.concatenate([census[:300], np.arange(1, 40, dtype=np.uint64)]),
            n_real)
        got = port_ix.lookup_unique(keys, n_real)
        want = ref_ix.lookup_unique(keys, n_real)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for shape in ((0,), (1,), (4, 4, 40)):
        rows = rng.integers(0, 50, shape).astype(np.int32)
        for a, b in zip(_native.dedup_rows_native(rows),
                        ref_native.dedup_rows_native(rows)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_census_index_is_dropped_not_closed_at_pass_end(monkeypatch):
    """end_pass and abort_pass drop the table's index without freeing it:
    a holder (a late prefetch producer) still resolves against it; the
    next pass builds its own over the new census."""
    monkeypatch.setenv(PLANNER, "1")
    t = SparseTable(SparseTableConfig(embedding_dim=4, hbm_cache_rows=0),
                    device="cpu")
    keys = np.array([3, 9, 11, 3], np.uint64)
    for end in ("end_pass", "abort_pass"):
        t.begin_pass(np.array([3, 9], np.uint64))
        t.plan_keys(keys, 4)
        held = t._census_index
        getattr(t, end)()
        assert t._census_index is None
        out = held.resolve(keys, 4, 99, 2)
        np.testing.assert_array_equal(out[0], [0, 1, 99, 0])
        held.close()
        assert held.resolve(keys, 4, 99, 2) is None
    t.begin_pass(np.array([11], np.uint64))
    assert t.plan_keys(keys, 4).idx[2] == 0
    t.end_pass()


# --------------------------------------------------------------------------- #
# the parser
# --------------------------------------------------------------------------- #
def _slots():
    return [
        SlotConfig(name="click", type="float", is_dense=True, shape=(1,)),
        SlotConfig(name="sa", type="uint64"),
        SlotConfig(name="unused", type="uint64", is_used=False),
        SlotConfig(name="sb", type="uint64"),
        SlotConfig(name="dx", type="float", is_dense=True, shape=(3,)),
    ]


def _conf(**kw):
    return DataFeedConfig(slots=_slots(), label_slot="click", **kw)


def _ref_conf(**kw):
    slots = [ref_config.SlotConfig(name=s.name, type=s.type,
                                   is_dense=s.is_dense, is_used=s.is_used,
                                   shape=s.shape) for s in _slots()]
    return ref_config.DataFeedConfig(slots=slots, label_slot="click", **kw)


LINES = [
    "1 1 2 11 12 1 5 1 21 3 0.1 -0.2 3e-1",
    "1 0 1 13 0 0 3 0.4 0.5 0.6",
    "1 1 3 14 15 18446744073709551615 2 9 9 2 22 23 3 -0.7 0.8 0.9",
    "1 0.5 0 0 1 7 3 1.25e-3 123456.789 -0.000001",
]


def _assert_same(got, want):
    assert got.n_ins == want.n_ins
    assert got.n_sparse_slots == want.n_sparse_slots
    for f in ("keys", "key_offsets", "dense", "labels"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _three(text: str):
    """The port's native block, the port's Python block and the
    reference's native block of the same text."""
    native = SlotParser(_conf())._native_parser()
    assert native is not None
    ref = RefParser(_ref_conf())._native_parser()
    assert ref is not None
    return (native.parse_bytes(text.encode()),
            SlotParser(_conf()).parse_lines(text.splitlines()),
            ref.parse_bytes(text.encode()))


def test_parity_plain():
    got, py, ref = _three("\n".join(LINES) + "\n")
    _assert_same(got, py)
    _assert_same(got, ref)
    assert got.keys.max() == np.uint64(18446744073709551615)
    assert got.n_ins == 4


def test_hash_ids_match_reference():
    """FNV-1a 64 of instance ids, bit for bit (the shuffle's routing hash;
    the port parses no ins_id yet, so this stands in for the reference's
    ins_id/logkey case)."""
    ids = ["", "a", "id-0", "ünïcode", "x" * 1000]
    got = _native.hash_ids_native(ids)
    np.testing.assert_array_equal(got, ref_native.hash_ids_native(ids))
    assert got.dtype == np.uint64
    h = 14695981039346656037
    for byte in b"a":
        h = ((h ^ byte) * 1099511628211) % (1 << 64)
    assert int(got[1]) == h


def test_parity_blank_lines_and_no_trailing_newline():
    got, py, ref = _three(LINES[0] + "\n\n  \n" + LINES[1])
    _assert_same(got, py)
    _assert_same(got, ref)
    assert got.n_ins == 2


@pytest.mark.parametrize("line", [
    "1 1 2 11",  # truncated sparse
    "1 1 2 11 x 1 5 1 21 3 0.1 0.2 0.3",  # bad feasign
    "2 1 1 2 11 1 5 1 21 3 0.1 0.2 0.3",  # label width mismatch
    "1 1 1 11 1 5 1 21 2 0.1 0.2",  # dense width mismatch
    LINES[0] + " 9 9",  # trailing tokens
])
def test_native_errors_match_python(line):
    """A malformed line raises ValueError in both parsers of the port, with
    the reference native parser's message."""
    text = (LINES[1] + "\n" + line + "\n").encode()
    with pytest.raises(ValueError) as got:
        SlotParser(_conf())._native_parser().parse_bytes(text, path="p")
    with pytest.raises(ValueError) as want:
        RefParser(_ref_conf())._native_parser().parse_bytes(text, path="p")
    assert str(got.value) == str(want.value)
    assert "line 2" in str(got.value) or ":2" in str(got.value)
    with pytest.raises(ValueError, match=r"p:2: malformed"):
        SlotParser(_conf()).parse_lines(text.decode().splitlines(), path="p")


def test_gz_and_dataset_path(tmp_path, monkeypatch):
    """parse_file takes the native parser for plain and .gz files, and a
    .gz stream read in chunks much smaller than the file (the tail after
    each chunk's last newline carried over) gives the same block."""
    text = "\n".join(LINES * 50) + "\n"
    gz = tmp_path / "part-0.gz"
    with gzip.open(gz, "wt") as f:
        f.write(text)
    plain = tmp_path / "part-1"
    plain.write_text(text)
    want = SlotParser(_conf()).parse_lines(LINES * 50)
    parser = SlotParser(_conf())
    _assert_same(parser.parse_file(str(gz)), want)
    _assert_same(parser.parse_file(str(plain)), want)
    assert parser._native is not None
    monkeypatch.setattr(port_slot_parser, "_NATIVE_CHUNK", 37)
    _assert_same(SlotParser(_conf()).parse_file(str(gz)), want)
    ref = RefParser(_ref_conf()).parse_file(str(gz))
    _assert_same(SlotParser(_conf()).parse_file(str(gz)), ref)


def test_empty_input(tmp_path):
    got, py, ref = _three("")
    assert got.n_ins == py.n_ins == ref.n_ins == 0
    _assert_same(got, py)
    empty = tmp_path / "empty.gz"
    with gzip.open(empty, "wt"):
        pass
    assert SlotParser(_conf()).parse_file(str(empty)).n_ins == 0


def test_python_parser_where_the_reference_takes_it(monkeypatch):
    """The native parser only under malformed_policy "raise" and with the
    flag on, as in the reference."""
    assert SlotParser(_conf())._native_parser() is not None
    assert SlotParser(_conf(malformed_policy="skip"))._native_parser() is None
    monkeypatch.setenv(PARSER, "0")
    assert SlotParser(_conf())._native_parser() is None


def test_dataset_load_native_matches_python(small_files, monkeypatch):
    """A whole synthetic file set through the dataset: the same block with
    the native and the Python parser, and the reference's native one."""
    conf = make_synth_config(n_sparse_slots=3, dense_dim=2, batch_size=32,
                             max_feasigns_per_ins=8)
    blocks = {}
    for native in ("1", "0"):
        monkeypatch.setenv(PARSER, native)
        ds = PadBoxSlotDataset(conf, read_threads=2)
        ds.set_filelist(small_files)
        ds.load_into_memory()
        assert (ds.parser._native is not None) == (native == "1")
        blocks[native] = ds._block
        ds.close()
    _assert_same(blocks["1"], blocks["0"])
    from paddlebox_tpu.data.synth import make_synth_config as ref_synth

    ref = RefParser(ref_synth(3, 2, 32, 8)).parse_file(small_files[0])
    _assert_same(blocks["1"], ref)


def test_census_index_refuses_n_real_past_the_buffer():
    ix = _native.build_census_index(np.arange(4, dtype=np.uint64))
    keys = np.zeros(8, np.uint64)
    for n_real in (-1, 9):
        with pytest.raises(ValueError, match="n_real"):
            ix.resolve(keys, n_real, 10, 4)
        with pytest.raises(ValueError, match="n_real"):
            ix.lookup_unique(keys, n_real)
    assert ix.resolve(keys, 8, 10, 4)[4] == 0  # key 0 is in the census
