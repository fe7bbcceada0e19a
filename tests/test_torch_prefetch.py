"""The port's feed prefetch thread (train/trainer.py ``_FeedPrefetcher``)
against the serial feed and against the JAX package's prefetching trainer.

Ports of tests/test_prefetch.py (parity, exception propagation, close on a
full queue), tests/test_fault_tolerance.py::test_prefetch_close_timeout_counted
and tests/test_multichip.py::TestMultiChipPrefetch, plus the port's own
rule: the producer thread launches no kernel wrapper of
``ops/sparse_kernels.py``.  tests/test_torch_cuda.py holds the card's side
(pinned copies on a side stream) against the serial feed.
"""

import threading

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig, flags
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ops import sparse_kernels as sk
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train import trainer as trainer_mod
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

S, DENSE, B = 3, 2, 8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_synth_files(
        str(tmp_path_factory.mktemp("prefetch")), n_files=1, ins_per_file=96,
        n_sparse_slots=S, vocab_per_slot=60, dense_dim=DENSE, seed=2,
    )


def _load(files, batch=B):
    ds = PadBoxSlotDataset(make_synth_config(S, DENSE, batch, 16),
                           read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _run(files, prefetch: int, passes: int = 2, cache_rows: int = 1 << 16):
    """``passes`` single-chip passes (the second shuffled): (metrics of
    each pass, final state_dict)."""
    ds = _load(files)
    tconf = SparseTableConfig(embedding_dim=8, hbm_cache_rows=cache_rows)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16, 8),
                   seed=0, device="cpu")
    table = SparseTable(tconf, seed=0, device="cpu")
    trainer = Trainer(model, tconf, TrainerConfig(
        auc_buckets=1 << 10, prefetch_batches=prefetch), device="cpu")
    out = []
    for p in range(passes):
        ds.local_shuffle(seed=p)
        table.begin_pass(ds.unique_keys())
        out.append(trainer.train_from_dataset(ds, table))
        table.end_pass()
    ds.close()
    return out, table.state_dict()


def test_defaults_match_the_reference():
    assert TrainerConfig().prefetch_batches == 2
    assert ref_config.TrainerConfig().prefetch_batches == 2
    assert flags.use_native_planner and flags.use_native_parser


def test_prefetch_parity(files):
    """Prefetch 2 against the serial feed: the same steps, loss, AUC, sample
    count and table, bit for bit (only the overlap changes)."""
    serial, s0 = _run(files, prefetch=0)
    pre, s2 = _run(files, prefetch=2)
    for a, b in zip(serial, pre):
        assert a["steps"] == b["steps"] == 12
        assert a["loss"] == b["loss"] and a["auc"] == b["auc"]
        assert a["samples"] == b["samples"] == 96
    np.testing.assert_array_equal(s0["keys"], s2["keys"])
    np.testing.assert_array_equal(s0["values"], s2["values"])


def test_prefetch_zero_starts_no_thread(files, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("prefetch_batches=0 started a producer")

    monkeypatch.setattr(trainer_mod, "_FeedPrefetcher", refuse)
    (m,), _ = _run(files, prefetch=0, passes=1)
    assert m["steps"] == 12


def test_prefetch_matches_reference_prefetch(files):
    """Both packages at their defaults, prefetch 2 (the reference also with
    its native planner, HBM cache and pass-boundary overlap), from the
    reference's initial tower: per-pass loss and AUC and the table rows at
    the tolerances of test_torch_trainer.py."""
    tkw = dict(embedding_dim=4, learning_rate=0.2, initial_range=0.1)
    trkw = dict(dense_lr=1e-2, auc_buckets=1 << 10, prefetch_batches=2)
    rconf = ref_config.SparseTableConfig(**tkw)
    ref_ds = RefDataset(ref_synth_config(S, DENSE, B, 16), read_threads=1)
    ref_ds.set_filelist(files)
    ref_ds.load_into_memory()
    ref_table = RefTable(rconf, seed=3)
    ref_tr = RefTrainer(RefCtrDnn(S, rconf.row_width, dense_dim=DENSE,
                                  hidden=(16, 8)),
                        rconf, ref_config.TrainerConfig(**trkw), seed=4)
    tower = [{k: np.array(v) for k, v in layer.items()}
             for layer in ref_tr.params["tower"]]
    pconf = SparseTableConfig(**tkw)
    ds = _load(files)
    table = SparseTable(pconf, seed=3, device="cpu")
    model = CtrDnn(S, pconf.row_width, dense_dim=DENSE, hidden=(16, 8),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = Trainer(model, pconf, TrainerConfig(**trkw), device="cpu")
    for p in range(2):
        for d, t, trainer in ((ref_ds, ref_table, ref_tr), (ds, table, tr)):
            d.local_shuffle(seed=p)
            t.begin_pass(d.unique_keys())
        rm = ref_tr.train_from_dataset(ref_ds, ref_table)
        pm = tr.train_from_dataset(ds, table)
        ref_table.end_pass()
        table.end_pass()
        assert pm["steps"] == rm["steps"] == 12
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)
        assert abs(pm["auc"] - rm["auc"]) < 1e-4
    rs, ps = ref_table.state_dict(), table.state_dict()
    ref_ds.close()
    ds.close()
    np.testing.assert_array_equal(rs["keys"], ps["keys"])
    np.testing.assert_array_equal(ps["values"][:, :2], rs["values"][:, :2])
    np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5,
                               atol=1e-6)


def test_producer_exception_propagates():
    def bad_gen():
        yield 1, {}
        raise ValueError("producer exploded")

    pf = trainer_mod._FeedPrefetcher(bad_gen(), depth=2)
    assert next(pf)[0] == 1
    with pytest.raises(ValueError, match="producer exploded"):
        next(pf)
    with pytest.raises(StopIteration):  # dead producers stay dead
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_producer_exception_reaches_train_steps(files):
    """A batch stream that fails in the producer fails train_steps, and the
    producer is retired."""
    ds = _load(files)
    tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0)
    table = SparseTable(tconf, device="cpu")
    trainer = Trainer(CtrDnn(S, tconf.row_width, dense_dim=DENSE,
                             hidden=(8,), device="cpu"), tconf,
                      device="cpu")
    table.begin_pass(ds.unique_keys())

    def batches():
        it = ds.batches()
        yield next(it)
        raise OSError("read failed")

    before = threading.active_count()
    with pytest.raises(OSError, match="read failed"):
        trainer.train_steps(table, batches())
    assert trainer.global_step == 1
    assert threading.active_count() == before
    table.end_pass()
    ds.close()


def test_close_unblocks_full_queue():
    def slow_gen():
        yield from range(100)

    pf = trainer_mod._FeedPrefetcher(slow_gen(), depth=1)
    next(pf)
    pf.close()  # a producer blocked on the full queue must exit
    assert not pf._thread.is_alive()


def test_prefetch_close_timeout_counted(monkeypatch):
    monkeypatch.setattr(trainer_mod, "_PREFETCH_JOIN_S", 0.05)
    release = threading.Event()

    def stuck_gen():
        release.wait()  # planning or a copy stuck past close()
        yield 1

    before = stats.get("trainer.prefetch_close_timeout")
    pf = trainer_mod._FeedPrefetcher(stuck_gen(), depth=1)
    pf.close()
    assert stats.get("trainer.prefetch_close_timeout") == before + 1
    release.set()  # let the daemon thread exit
    pf._thread.join(5.0)
    assert not pf._thread.is_alive()


def _multichip(files, prefetch: int):
    ds = _load(files, batch=16)
    tconf = SparseTableConfig(embedding_dim=8, hbm_cache_rows=0,
                              placement_update_interval=1,
                              placement_hot_capacity=32)
    mesh = make_mesh(4, device="cpu")
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                   seed=1, device="cpu")
    tr = MultiChipTrainer(model, tconf, mesh, TrainerConfig(
        auc_buckets=1 << 10, prefetch_batches=prefetch))
    table = ShardedSparseTable(tconf, mesh, seed=2)
    out, auc = [], None
    for _ in range(3):  # the hot block realizes at the third begin_pass
        table.begin_pass(ds.unique_keys())
        out.append(tr.train_from_dataset(ds, table, auc_state=auc))
        auc = tr.last_metric_state
        table.end_pass()
    ds.close()
    return out, table.state_dict()


def test_multichip_prefetch_matches_serial(files):
    """Four positions with the realized hybrid placement: the producer's
    plan_group and stacking are a pure overlap, bit for bit, hot
    occurrences counted the same."""
    serial, s0 = _multichip(files, 0)
    pre, s2 = _multichip(files, 2)
    assert pre[-1]["hot_occurrences"] > 0
    for a, b in zip(serial, pre):
        for k in ("steps", "loss", "auc", "samples", "hot_occurrences"):
            assert a[k] == b[k], k
    np.testing.assert_array_equal(s0["keys"], s2["keys"])
    np.testing.assert_array_equal(s0["values"], s2["values"])


def test_producer_launches_no_kernel(files, monkeypatch):
    """Every kernel wrapper runs on the step's thread: the producer only
    plans and copies (scatter_rows' tag scratch orders calls per device)."""
    calls = []
    for name in sk.KERNELS:
        real = getattr(sk, name)

        def wrapper(*a, _real=real, _name=name, **kw):
            calls.append((_name, threading.current_thread()))
            return _real(*a, **kw)

        monkeypatch.setattr(sk, name, wrapper)
    _run(files, prefetch=2)  # the cached single-chip path
    _multichip(files, prefetch=2)  # the hybrid path
    names = {n for n, _ in calls}
    assert set(sk.KERNELS) <= names
    assert {t for _, t in calls} == {threading.main_thread()}
