"""Live resharding of the port's ShardedSparseTable against the JAX package
(port of tests/test_reshard.py): the migration frame byte-equal to the
reference's, the lifecycle guards, a live reshard bit-equal to a
teardown-and-rebuild at 2 -> 4 and 4 -> 2 (and close to the reference's
live reshard), no new kernel build or shape once the new split settles, a
checkpoint saved mid-roll restoring onto the new shard count, and injected
migrate and cutover failures aborting back to the old shard map.

Every table runs the reference's defaults (``SparseTableConfig
(embedding_dim=8)``: the per-shard caches on, the realized hybrid
placement), as the reference's tests do.
"""

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
from paddlebox_tpu.parallel.sharded_table import (
    _encode_migration as ref_encode_migration,
)
from paddlebox_tpu_torch.checkpoint import CheckpointManager
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ops import cuda_build
from paddlebox_tpu_torch.parallel import (
    Mesh,
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.parallel import sharded_table as st
from paddlebox_tpu_torch.parallel.sharded_table import (
    _decode_migration,
    _encode_migration,
)
from paddlebox_tpu_torch.utils.faults import FaultInjected, fault_plan
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE = 3, 2
N_INS, B = 128, 8  # 16 per-position batches: divisible by 2 and by 4
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


def _tconf():
    return SparseTableConfig(embedding_dim=8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's data set (tests/test_reshard.py:_data) in both
    packages, and the reference's seed-3 tower; both planners numpy."""
    files = write_synth_files(
        str(tmp_path_factory.mktemp("rs")), n_files=2, ins_per_file=N_INS // 2,
        n_sparse_slots=S, vocab_per_slot=50, dense_dim=DENSE, seed=7,
    )
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        mp.delenv("PBOX_HBM_CACHE", raising=False)
        ds = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 16),
                               read_threads=2)
        rds = RefDataset(ref_synth_config(S, DENSE, B, 16), read_threads=2)
        for d in (ds, rds):
            d.set_filelist(files)
            d.load_into_memory()
        conf = ref_config.SparseTableConfig(embedding_dim=8)
        tr = RefMultiChipTrainer(
            RefCtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(16,)),
            conf, ref_make_mesh(2), ref_config.TrainerConfig(auc_buckets=1 << 10),
            seed=3)
        tower = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in tr.dense_state()[0]["tower"]]
        yield {"ds": ds, "ref_ds": rds, "tower": tower}
    ds.close()
    rds.close()


def _trainer(world, mesh):
    """A fresh trainer from the reference's seed-3 tower (the reference's
    tests build a fresh seed-3 trainer for every phase)."""
    conf = _tconf()
    model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(16,),
                   device="cpu")
    model.load_state_dict(params_from_jax(world["tower"]))
    return MultiChipTrainer(model, conf, mesh,
                            TrainerConfig(auc_buckets=1 << 10))


def _run_pass(trainer, table, ds):
    table.begin_pass(ds.unique_keys())
    m = trainer.train_from_dataset(ds, table)
    table.end_pass()
    return m


# --------------------------------------------------------------------------- #
# the migration frame (the PBR1 wire format)
# --------------------------------------------------------------------------- #
def test_round_trip_preserves_hottest_first_order_and_reference_bytes():
    keys = np.array([901, 3, 77, 41, 500, 2**63 + 9], dtype=np.uint64)
    rows = np.arange(6 * 6, dtype=np.float32).reshape(6, 6) * 0.25
    buf = _encode_migration(keys, rows)
    assert buf == ref_encode_migration(keys, rows)
    dk, dr = _decode_migration(buf)
    np.testing.assert_array_equal(dk, keys)
    np.testing.assert_array_equal(dr, rows)


def test_empty_payload_round_trips():
    dk, dr = _decode_migration(_encode_migration(
        np.empty(0, np.uint64), np.empty((0, 5), np.float32)))
    assert dk.shape == (0,) and dr.shape == (0, 5)


def test_bad_magic_raises():
    buf = bytearray(_encode_migration(np.array([1, 2], dtype=np.uint64),
                                      np.zeros((2, 3), np.float32)))
    buf[:4] = b"XXXX"
    with pytest.raises(ValueError, match="magic"):
        _decode_migration(bytes(buf))


def test_truncated_payload_raises():
    buf = _encode_migration(np.array([1, 2], dtype=np.uint64),
                            np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError):
        _decode_migration(buf + b"\x00\x00\x00\x00")


# --------------------------------------------------------------------------- #
# lifecycle guards
# --------------------------------------------------------------------------- #
def test_reshard_inside_pass_refused_then_works():
    table = ShardedSparseTable(SparseTableConfig(embedding_dim=4),
                               make_mesh(2, device="cpu"), seed=0)
    table.begin_pass(np.arange(1, 60, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="between passes"):
        table.reshard(make_mesh(4, device="cpu"))
    table.end_pass()
    assert table.reshard(make_mesh(4, device="cpu")) > 0
    assert table.n_shards == 4 and len(table._caches()) == 4
    table.close()


def test_reshard_refuses_another_device():
    table = ShardedSparseTable(SparseTableConfig(embedding_dim=4),
                               make_mesh(2, device="cpu"), seed=0)
    with pytest.raises(ValueError, match="device"):
        table.reshard(Mesh(4, torch.device("meta")))
    assert table.n_shards == 2
    table.close()


def test_migrate_verifies_the_frame_and_changes_nothing(monkeypatch):
    """The migration counts the owner-changed rows and holds their frame
    to a bit-exact round trip without touching the store; a frame that
    decodes to other rows aborts the reshard with the old map whole."""
    tconf = SparseTableConfig(embedding_dim=4)
    table = ShardedSparseTable(tconf, make_mesh(2, device="cpu"), seed=0)
    keys = np.arange(1, 200, dtype=np.uint64)
    table.begin_pass(keys)
    table.end_pass()
    table.flush()
    before = table._store.materialize()
    moved = table._reshard_migrate(make_mesh(4, device="cpu"))
    assert moved == int((keys % np.uint64(2) != keys % np.uint64(4)).sum())
    after = table._store.materialize()
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])

    decode = st._decode_migration

    def corrupt(buf):
        k, rows = decode(buf)
        rows = rows.copy()
        rows[:1] += 1.0
        return k, rows

    monkeypatch.setattr(st, "_decode_migration", corrupt)
    with pytest.raises(RuntimeError, match="round-trip"):
        table.reshard(make_mesh(4, device="cpu"))
    assert table.n_shards == 2 and len(table._caches()) == 2
    monkeypatch.undo()
    assert table.reshard(make_mesh(4, device="cpu")) == moved
    table.close()


def test_same_mesh_reshard_is_a_no_op():
    mesh2 = make_mesh(2, device="cpu")
    table = ShardedSparseTable(SparseTableConfig(embedding_dim=4), mesh2,
                               seed=0)
    table.begin_pass(np.arange(1, 40, dtype=np.uint64))
    table.end_pass()
    caches = table._caches()
    assert table.reshard(make_mesh(2, device="cpu")) == 0
    assert table.n_shards == 2 and table._caches() is caches
    table.close()


# --------------------------------------------------------------------------- #
# live reshard == teardown-and-rebuild, and against the reference
# --------------------------------------------------------------------------- #
def _live_vs_rebuilt(world, n_old, n_new):
    """Pass 1 on the old split, then pass 2 on the new one: once through a
    live reshard, once through state_dict -> a fresh table at the new
    count.  Returns (moved, live metrics, live state)."""
    ds = world["ds"]
    mesh_old, mesh_new = make_mesh(n_old, device="cpu"), make_mesh(
        n_new, device="cpu")
    tconf = _tconf()
    live = ShardedSparseTable(tconf, mesh_old, seed=5)
    m_live0 = _run_pass(_trainer(world, mesh_old), live, ds)
    moved = live.reshard(mesh_new)
    assert moved > 0, "growing or shrinking the split must move owners"
    assert live.n_shards == n_new and live.mesh is mesh_new
    m_live = _run_pass(_trainer(world, mesh_new), live, ds)

    base = ShardedSparseTable(tconf, mesh_old, seed=5)
    _run_pass(_trainer(world, mesh_old), base, ds)
    rebuilt = ShardedSparseTable(tconf, mesh_new, seed=5)
    rebuilt.load_state_dict(base.state_dict())
    m_base = _run_pass(_trainer(world, mesh_new), rebuilt, ds)

    s_live, s_base = live.state_dict(), rebuilt.state_dict()
    np.testing.assert_array_equal(s_live["keys"], s_base["keys"])
    # full rows, embeddings and the g2sum column: bit-exact
    np.testing.assert_array_equal(s_live["values"], s_base["values"])
    assert m_live["steps"] == m_base["steps"] > 0
    assert m_live["loss"] == m_base["loss"]
    assert m_live["auc"] == m_base["auc"]
    for t in (live, base, rebuilt):
        t.close()
    return moved, (m_live0, m_live), s_live


def _ref_live(world, n_old, n_new):
    rds = world["ref_ds"]
    tconf = ref_config.SparseTableConfig(embedding_dim=8)
    out = []
    table = RefShardedTable(tconf, ref_make_mesh(n_old), seed=5)
    for n in (n_old, n_new):
        mesh = ref_make_mesh(n)
        if n is n_new:
            moved = table.reshard(mesh)
        tr = RefMultiChipTrainer(
            RefCtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,)),
            tconf, mesh, ref_config.TrainerConfig(auc_buckets=1 << 10), seed=3)
        out.append(_run_pass(tr, table, rds))
    state = table.state_dict()
    table.close()
    return moved, out, state


@pytest.mark.parametrize("n_old,n_new", [(2, 4), (4, 2)])
def test_live_reshard_bit_exact_with_rebuilt(world, n_old, n_new):
    """At the reference's defaults (caches and hybrid placement on), a live
    reshard trains bit-equal to the rebuilt table; and against the
    reference's live reshard the moved rows are equal, and loss, AUC and
    rows agree at test_torch_multichip.py's tolerances (1e-6; rows 1e-7)."""
    moved, (m0, m1), state = _live_vs_rebuilt(world, n_old, n_new)
    r_moved, (r0, r1), r_state = _ref_live(world, n_old, n_new)
    assert moved == r_moved
    for a, b in ((m0, r0), (m1, r1)):
        assert abs(a["loss"] - b["loss"]) < 1e-6, (a["loss"], b["loss"])
        assert abs(a["auc"] - b["auc"]) < 1e-6, (a["auc"], b["auc"])
        assert a["steps"] == b["steps"]
    np.testing.assert_array_equal(state["keys"], r_state["keys"])
    np.testing.assert_array_equal(state["values"][:, :2],
                                  r_state["values"][:, :2])
    np.testing.assert_allclose(state["values"], r_state["values"], rtol=0,
                               atol=1e-7)


# --------------------------------------------------------------------------- #
# steady state after the cutover: no new kernel build, no new shape
# --------------------------------------------------------------------------- #
def test_no_new_build_or_shape_after_cutover(world):
    """Two passes after the cutover settle the new split's sizing (the
    scratch region learns its serve buffer; the hot block realizes at the
    third census); a fourth pass then builds no kernel and plans no new
    shape: the same bucket capacity, shard capacity and serve sizing (the
    port of test_zero_retrace_after_cutover, whose compiles are the
    port's kernel builds and plan shapes)."""
    ds = world["ds"]
    mesh2, mesh4 = make_mesh(2, device="cpu"), make_mesh(4, device="cpu")
    table = ShardedSparseTable(_tconf(), mesh2, seed=5, bucket_slack=8.0)
    _run_pass(_trainer(world, mesh2), table, ds)
    assert table.reshard(mesh4) > 0
    tr = _trainer(world, mesh4)
    for _ in range(3):
        _run_pass(tr, table, ds)
    before = (sorted(cuda_build.build_log), table.capacity_bumps,
              table._last_serve_n)
    table.begin_pass(ds.unique_keys())
    cap = table.shard_capacity
    tr.train_from_dataset(ds, table)
    table.end_pass()
    assert (sorted(cuda_build.build_log), table.capacity_bumps,
            table._last_serve_n) == before
    table.begin_pass(ds.unique_keys())
    assert table.shard_capacity == cap
    table.end_pass()
    table.close()


# --------------------------------------------------------------------------- #
# a checkpoint saved mid-roll restores on the new shard count
# --------------------------------------------------------------------------- #
def test_checkpoint_mid_roll_restores_on_new_shard_count(world, tmp_path):
    ds = world["ds"]
    mesh2, mesh4 = make_mesh(2, device="cpu"), make_mesh(4, device="cpu")
    table = ShardedSparseTable(_tconf(), mesh2, seed=5)
    _run_pass(_trainer(world, mesh2), table, ds)
    assert table.reshard(mesh4) > 0
    tr = _trainer(world, mesh4)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_base("midroll", table, *tr.dense_state())
    # the restored world starts directly on the new shard count
    table2 = ShardedSparseTable(_tconf(), mesh4, seed=5)
    tr2 = _trainer(world, mesh4)
    p2, o2, _ = mgr.load(table2, *tr2.dense_state())
    tr2.load_dense_state(p2, o2)
    s1, s2 = table.state_dict(), table2.state_dict()
    np.testing.assert_array_equal(s1["keys"], s2["keys"])
    np.testing.assert_array_equal(s1["values"], s2["values"])
    m = _run_pass(tr2, table2, ds)
    assert m["steps"] > 0 and np.isfinite(m["loss"])
    table.close()
    table2.close()


# --------------------------------------------------------------------------- #
# chaos: injected failures abort back to the old shard map
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("site", ["reshard.migrate", "reshard.cutover"])
def test_fault_aborts_cleanly(world, site):
    ds = world["ds"]
    mesh2, mesh4 = make_mesh(2, device="cpu"), make_mesh(4, device="cpu")
    table = ShardedSparseTable(_tconf(), mesh2, seed=5)
    tr_old = _trainer(world, mesh2)
    _run_pass(tr_old, table, ds)
    caches = table._caches()
    before_sd = table.state_dict()
    aborts = stats.get("reshard.aborts")
    with fault_plan({site: "first:1"}):
        with pytest.raises(FaultInjected):
            table.reshard(mesh4)
    # the old shard map whole: count, mesh, caches, every row
    assert table.n_shards == 2 and table.mesh is mesh2
    assert table._caches() is caches
    assert stats.get("reshard.aborts") == aborts + 1
    after_sd = table.state_dict()
    np.testing.assert_array_equal(before_sd["keys"], after_sd["keys"])
    np.testing.assert_array_equal(before_sd["values"], after_sd["values"])
    # training goes on on the old map, and a retry commits
    m = _run_pass(tr_old, table, ds)
    assert m["steps"] > 0 and np.isfinite(m["loss"])
    assert table.reshard(mesh4) > 0
    m2 = _run_pass(_trainer(world, mesh4), table, ds)
    assert m2["steps"] > 0 and np.isfinite(m2["loss"])
    table.close()
