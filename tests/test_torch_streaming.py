"""The port's online training plane (paddlebox_tpu_torch/streaming/) held to
the reference's tests/test_streaming.py, on the CPU: the sources (tailing
and socket, torn tails), the mini-pass scheduler, the watchdog's feed
stage over a wedged source, the deadline publish policy,
``StreamingConfig.from_flags``, ``StreamingTrainer.from_config``, the
launcher's environment, and the label flip that moves the served score
through Publisher -> donefile -> Syncer -> ScoringServer.

Mini-passes against one pass, windows cut by count in whole batches
(``window_seconds=0``):
  * single-chip, within the port: the state dict, the delta and the AUC
    of the stream equal one pass over the same records, bit for bit, with
    the HBM cache and the staged boundary at their defaults; a stage whose
    census misses is thrown away, and the result stays bit-equal;
  * single-chip, against the JAX StreamingTrainer on the same lines, the
    reference's tower carried across (``weights.params_from_jax``): the
    windows and their censuses bit-equal, keys and counters exact, rows
    within rtol 1e-5 / atol 1e-6, loss within rtol 1e-5, AUC within 1e-4
    (the trainer parity test's bounds: float32 sums in another order);
  * multi-chip (``make_mesh(4, device="cpu")``), within the port: the
    stream equals the port's one-pass multi-chip run bit for bit (the
    reference's own multi-chip case fails on jax 0.9, so this is that
    test's oracle).
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.streaming import IterableSource as RefIterableSource
from paddlebox_tpu.streaming import MiniPassScheduler as RefScheduler
from paddlebox_tpu.streaming import StreamingTrainer as RefStreamingTrainer
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import (
    LivenessConfig,
    SparseTableConfig,
    StreamingConfig,
    TrainerConfig,
)
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import (
    make_synth_config,
    stream_line,
    write_synth_files,
)
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.streaming import (
    DeadlinePublishPolicy,
    IterableSource,
    MiniPassScheduler,
    SocketSource,
    StreamingTrainer,
    TailingFileSource,
)
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.train.trainer import Trainer
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.faults import fault_plan
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)


def _drain(source, n, timeout=5.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        rec = source.get(timeout=0.05)
        if rec is not None:
            out.append(rec)
    return out


# --------------------------------------------------------------------------- #
# sources
# --------------------------------------------------------------------------- #
class TestTailingSource:
    def test_follows_growth_and_new_shards(self, tmp_path):
        src = TailingFileSource(str(tmp_path), poll_interval_s=0.01).start()
        try:
            p0 = tmp_path / "part-000"
            p0.write_text("a 1\nb 2\n")
            got = _drain(src, 2)
            assert [r.line for r in got] == ["a 1", "b 2"]
            with open(p0, "a") as fh:
                fh.write("c 3\n")
            (tmp_path / "part-001").write_text("d 4\ne 5\n")
            got = _drain(src, 3)
            assert sorted(r.line for r in got) == ["c 3", "d 4", "e 5"]
            assert src.watermark() is not None
            assert src._thread.daemon
        finally:
            src.close()
        assert src.drained

    def test_tmp_and_hidden_files_skipped(self, tmp_path):
        (tmp_path / "part-000.tmp").write_text("staging 1\n")
        (tmp_path / ".hidden").write_text("hidden 1\n")
        (tmp_path / "part-001").write_text("real 1\n")
        src = TailingFileSource(str(tmp_path), poll_interval_s=0.01).start()
        try:
            got = _drain(src, 1)
            assert [r.line for r in got] == ["real 1"]
            assert src.get(timeout=0.2) is None
        finally:
            src.close()

    def test_torn_tail_held_back_and_reread_whole(self, tmp_path):
        from paddlebox_tpu_torch.data.slot_parser import SlotParser

        conf = make_synth_config(n_sparse_slots=2, dense_dim=2,
                                 batch_size=8, max_feasigns_per_ins=8)
        p = tmp_path / "part-000"
        full = "1 1 2 5 9 2 105 3 2 0.1 0.2"
        with open(p, "w") as fh:
            for _ in range(3):
                fh.write(full + "\n")
            fh.write("1 0 2 7 11 2 10")  # torn mid-append: no newline
        src = TailingFileSource(str(tmp_path), poll_interval_s=0.01).start()
        try:
            got = _drain(src, 3)
            assert len(got) == 3
            assert src.get(timeout=0.3) is None
            assert src.torn_tails_held > 0
            with open(p, "a") as fh:
                fh.write("8 9 2 0.3 0.4\n")
            got2 = _drain(src, 1)
            assert [r.line for r in got2] == ["1 0 2 7 11 2 108 9 2 0.3 0.4"]
        finally:
            src.close()
        q0 = stats.get("data.quarantined_lines")
        block = SlotParser(conf).parse_lines([r.line for r in got + got2])
        assert block.n_ins == 4
        assert stats.get("data.quarantined_lines") == q0
        assert {7, 11, 108}.issubset(set(int(k) for k in block.keys))

    def test_backpressure_blocks_producer_without_loss(self, tmp_path):
        (tmp_path / "part-000").write_text(
            "".join(f"r {i}\n" for i in range(50)))
        src = TailingFileSource(str(tmp_path), poll_interval_s=0.01,
                                buffer_records=8).start()
        try:
            time.sleep(0.3)
            assert src.depth() <= 8
            got = _drain(src, 50)
            assert [r.line for r in got] == [f"r {i}" for i in range(50)]
        finally:
            src.close()

    def test_stop_drains_writes_landed_after_last_poll(self, tmp_path):
        src = TailingFileSource(str(tmp_path), poll_interval_s=30.0).start()
        try:
            time.sleep(0.2)
            (tmp_path / "part-000").write_text("a 1\nb 2\nc 3\n")
            src.stop()
            got = _drain(src, 3)
            assert [r.line for r in got] == ["a 1", "b 2", "c 3"]
            deadline = time.monotonic() + 5.0
            while not src.drained and time.monotonic() < deadline:
                time.sleep(0.01)
            assert src.drained
        finally:
            src.close()

    def test_stop_under_backpressure_loses_nothing(self, tmp_path):
        (tmp_path / "part-000").write_text(
            "".join(f"r {i}\n" for i in range(50)))
        src = TailingFileSource(str(tmp_path), poll_interval_s=0.01,
                                buffer_records=4).start()
        try:
            time.sleep(0.3)
            src.stop()
            got = _drain(src, 50)
            assert [r.line for r in got] == [f"r {i}" for i in range(50)]
            assert src.get(timeout=0.3) is None
        finally:
            src.close()

    def test_injected_tail_failure_counted_and_retried(self, tmp_path):
        (tmp_path / "part-000").write_text("a 1\n")
        with fault_plan({"stream.tail": "first:2"}):
            src = TailingFileSource(str(tmp_path),
                                    poll_interval_s=0.01).start()
            try:
                assert [r.line for r in _drain(src, 1)] == ["a 1"]
                assert src.poll_errors == 2
            finally:
                src.close()


class TestSocketSource:
    def test_lines_across_sends_and_torn_final(self):
        import socket as socketlib

        src = SocketSource().start()
        try:
            c = socketlib.create_connection(("127.0.0.1", src.port))
            c.sendall(b"one 1\ntwo")
            time.sleep(0.1)
            c.sendall(b" 2\nthree 3\n")
            c.sendall(b"torn-fragment")
            c.close()
            got = _drain(src, 3)
            assert [r.line for r in got] == ["one 1", "two 2", "three 3"]
            assert src.get(timeout=0.3) is None
        finally:
            src.close()
        assert src.drained


# --------------------------------------------------------------------------- #
# the mini-pass scheduler
# --------------------------------------------------------------------------- #
def _lines(n, label=1, seed=0, n_slots=2, dense=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = [f"1 {label}"]
        for s in range(n_slots):
            k = int(rng.integers(1, 40)) + s * 1000
            parts.append(f"2 {k} {k + 1}")
        parts.append(
            f"{dense} " + " ".join(f"{v:.3f}" for v in rng.normal(size=dense)))
        out.append(" ".join(parts))
    return out


def _all_windows(sched):
    wins = []
    while True:
        w = sched.next_window(timeout=1.0)
        if w is None and sched.done:
            return wins
        if w is not None:
            wins.append(w)


class TestMiniPassScheduler:
    CONF = make_synth_config(n_sparse_slots=2, dense_dim=2, batch_size=8,
                             max_feasigns_per_ins=8)

    def test_cut_by_count_then_drain(self):
        src = IterableSource(_lines(25)).start()
        sched = MiniPassScheduler(src, self.CONF, window_records=10,
                                  window_seconds=0.0).start()
        try:
            wins = _all_windows(sched)
            assert [w.n_records for w in wins] == [10, 10, 5]
            assert [w.cut_reason for w in wins] == ["count", "count", "drain"]
            for w in wins:
                assert np.array_equal(w.census, np.unique(w.block.keys))
                assert w.first_event_ts <= w.last_event_ts
            assert [w.index for w in wins] == [0, 1, 2]
        finally:
            sched.close()
            src.close()

    def test_windows_equal_the_references(self):
        """The same lines cut by both packages' schedulers: the same
        windows, the same censuses and blocks' keys."""
        lines = _lines(37, seed=3)
        rconf = ref_synth_config(n_sparse_slots=2, dense_dim=2, batch_size=8,
                                 max_feasigns_per_ins=8)
        out = []
        for src_cls, sched_cls, conf in (
                (IterableSource, MiniPassScheduler, self.CONF),
                (RefIterableSource, RefScheduler, rconf)):
            src = src_cls(lines).start()
            sched = sched_cls(src, conf, window_records=16,
                              window_seconds=0.0).start()
            try:
                out.append(_all_windows(sched))
            finally:
                sched.close()
                src.close()
        ours, theirs = out
        assert [w.n_records for w in ours] == [w.n_records for w in theirs]
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.census, b.census)
            np.testing.assert_array_equal(a.block.keys, b.block.keys)
            np.testing.assert_array_equal(a.block.key_offsets,
                                          b.block.key_offsets)

    def test_windows_native_and_python_parse_bit_equal(self, monkeypatch):
        """A window parses through the native parser (the port's default)
        where it builds, and through parse_lines with the flag off: the
        same blocks bit for bit."""
        from paddlebox_tpu_torch import _native

        lines = _lines(40, seed=9)
        runs = {}
        for flag in ("1", "0"):
            monkeypatch.setenv("PADDLEBOX_TORCH_USE_NATIVE_PARSER", flag)
            src = IterableSource(lines).start()
            sched = MiniPassScheduler(src, self.CONF, window_records=16,
                                      window_seconds=0.0).start()
            try:
                runs[flag] = _all_windows(sched)
            finally:
                sched.close()
                src.close()
            native = sched.parser._native is not None
            assert native == (flag == "1" and _native.get_lib() is not None)
        assert [w.n_records for w in runs["1"]] == [16, 16, 8]
        for a, b in zip(runs["1"], runs["0"]):
            for f in ("keys", "key_offsets", "dense", "labels"):
                x, y = getattr(a.block, f), getattr(b.block, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            np.testing.assert_array_equal(a.census, b.census)

    def test_cut_by_wall_clock(self):
        src = IterableSource(_lines(3)).start()
        sched = MiniPassScheduler(src, self.CONF, window_records=10_000,
                                  window_seconds=0.2).start()
        try:
            w = sched.next_window(timeout=3.0)
            assert w is not None and w.n_records == 3
            assert w.cut_reason in ("time", "drain")
        finally:
            sched.close()
            src.close()

    def test_window_dataset_batches(self):
        src = IterableSource(_lines(20)).start()
        sched = MiniPassScheduler(src, self.CONF, window_records=20).start()
        try:
            w = sched.next_window(timeout=3.0)
            ds = sched.dataset(w)
            assert ds.unique_keys() is w.census
            assert ds.get_memory_data_size() == 20
            assert [b.n_real_ins for b in ds.batches()] == [8, 8, 4]
            assert [b.n_real_ins for b in ds.batches(drop_last=True)] == [8, 8]
        finally:
            sched.close()
            src.close()

    def test_injected_cut_fault_defers_never_drops(self):
        with fault_plan({"stream.cut": "first:1"}):
            src = IterableSource(_lines(10)).start()
            sched = MiniPassScheduler(src, self.CONF,
                                      window_records=5).start()
            try:
                wins = _all_windows(sched)
                assert sched.cut_deferrals >= 1
                assert sum(w.n_records for w in wins) == 10
            finally:
                sched.close()
                src.close()

    def test_wait_census_matches_next_window(self):
        src = IterableSource(_lines(16)).start()
        sched = MiniPassScheduler(src, self.CONF, window_records=8).start()
        try:
            census = sched.wait_census(timeout=3.0)
            w = sched.next_window(timeout=3.0)
            assert np.array_equal(census, w.census)
        finally:
            sched.close()
            src.close()

    def test_wait_census_times_out_empty(self):
        src = IterableSource(_lines(4)).start()
        sched = MiniPassScheduler(src, self.CONF, window_records=100,
                                  window_seconds=0.0)
        try:  # never started: nothing is ever cut
            census = sched.wait_census(timeout=0.1)
            assert census.shape == (0,) and census.dtype == np.uint64
        finally:
            src.close()


# --------------------------------------------------------------------------- #
# the watchdog over a wedged feed
# --------------------------------------------------------------------------- #
def test_wedged_tail_source_caught_by_watchdog_feed_stage(tmp_path):
    from paddlebox_tpu_torch.parallel.watchdog import DistributedStallError

    conf = make_synth_config(n_sparse_slots=2, dense_dim=2, batch_size=8,
                             max_feasigns_per_ins=8)
    tconf = SparseTableConfig(embedding_dim=4, store_buckets=4,
                              plan_scratch_rows=32)
    model = CtrDnn(2, tconf.row_width, dense_dim=2, hidden=(4,),
                   device="cpu")
    table = SparseTable(tconf, seed=0, device="cpu")
    trainer = Trainer(
        model, tconf,
        TrainerConfig(auc_buckets=1 << 10, liveness=LivenessConfig(
            deadline_s=1.0, heartbeat_interval_s=0.2, poll_interval_s=0.05)),
        device="cpu",
    )
    with fault_plan({"stream.tail": "hang:first:1"}):
        src = TailingFileSource(str(tmp_path), poll_interval_s=0.02).start()
        sched = MiniPassScheduler(src, conf, window_records=8).start()
        runner = StreamingTrainer(trainer, table, sched)
        t0 = time.monotonic()
        with pytest.raises(DistributedStallError) as ei:
            runner.run(max_seconds=30.0)
        assert ei.value.stage == "feed"
        assert ei.value.kind == "local"
        assert time.monotonic() - t0 < 15.0
    assert stats.get("faults.hung.stream.tail") >= 1


# --------------------------------------------------------------------------- #
# mini-passes against one pass
# --------------------------------------------------------------------------- #
N_SLOTS, DENSE, B = 3, 2, 16
N_INS = 384  # 3 windows of 128 = 8 batches of 16
WINDOW = 8 * B


def _det_tconf(**kw):
    return SparseTableConfig(
        embedding_dim=4, learning_rate=0.4, initial_range=0.05,
        store_buckets=16, plan_scratch_rows=64, **kw)


@pytest.fixture(scope="module")
def det_records(tmp_path_factory):
    conf = make_synth_config(
        n_sparse_slots=N_SLOTS, dense_dim=DENSE, batch_size=B,
        max_feasigns_per_ins=16,
    )
    d = tmp_path_factory.mktemp("det")
    files = write_synth_files(
        str(d), n_files=2, ins_per_file=N_INS // 2, n_sparse_slots=N_SLOTS,
        vocab_per_slot=40, dense_dim=DENSE, seed=17,
    )
    lines = []
    for f in files:
        with open(f) as fh:
            lines += [ln for ln in fh.read().splitlines() if ln.strip()]
    assert len(lines) == N_INS
    return conf, files, lines


def _fresh_single(seed=3):
    tconf = _det_tconf()
    table = SparseTable(tconf, seed=seed, device="cpu")
    model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE, hidden=(16, 8),
                   seed=seed, device="cpu")
    trainer = Trainer(model, tconf,
                      TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 12),
                      device="cpu")
    return table, trainer


def _one_pass(conf, files, table, trainer):
    ds = PadBoxSlotDataset(conf, read_threads=2)
    ds.set_filelist(files)
    ds.load_into_memory()
    try:
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table)
        table.end_pass()
    finally:
        ds.close()
    return m


def _record_windows(runner):
    """The (census, n_records) of every window the runner trains."""
    seen = []
    train = runner._train_window

    def record(window, wd):
        seen.append((window.census.copy(), window.n_records))
        return train(window, wd)

    runner._train_window = record
    return seen


def _assert_state_equal(a, b):
    assert np.array_equal(a["keys"], b["keys"])
    # [show, clk, embed..., g2sum]: the counters, the embeddings and the
    # optimizer state bit for bit
    assert np.array_equal(a["values"], b["values"])


class TestMiniPassDeterminism:
    def test_single_chip_minipasses_match_one_pass(self, det_records):
        conf, files, lines = det_records
        table, trainer = _fresh_single()
        m_batch = _one_pass(conf, files, table, trainer)
        sd_batch, delta_batch = table.state_dict(), table.pop_delta()
        table.close()

        table2, trainer2 = _fresh_single()
        src = IterableSource(lines).start()
        sched = MiniPassScheduler(src, conf, window_records=WINDOW,
                                  window_seconds=0.0).start()
        # the staging thread waits for the next window's cut however long
        # the parse takes under load
        runner = StreamingTrainer(trainer2, table2, sched, census_wait_s=60.0)
        staged = []
        begin = table2.begin_pass

        def begin_and_note(keys):
            begin(keys)
            staged.append(table2.last_begin_breakdown["staged"])

        table2.begin_pass = begin_and_note
        summary = runner.run()
        assert summary["windows"] == 3
        assert summary["records"] == N_INS
        # the boundaries after the first are staged from the next window's
        # census; a stage whose scratch sizing moved meanwhile is thrown
        # away (resolved synchronously), which timing decides under load
        assert staged[0] is False and any(staged[1:])
        sd_stream, delta_stream = table2.state_dict(), table2.pop_delta()
        table2.close()
        _assert_state_equal(sd_batch, sd_stream)
        _assert_state_equal(delta_batch, delta_stream)
        assert summary["auc"] == m_batch["auc"]

    def test_a_stage_that_misses_its_census_is_thrown_away(self,
                                                           det_records):
        """The census wait times out (the source is slower than the
        window), so the staged census is empty: begin_pass discards it and
        resolves synchronously; the stream still equals one pass."""
        conf, files, lines = det_records
        table, trainer = _fresh_single()
        m_batch = _one_pass(conf, files, table, trainer)
        sd_batch = table.state_dict()
        table.close()

        table2, trainer2 = _fresh_single()
        src = IterableSource(lines, rate_per_s=2000.0).start()
        sched = MiniPassScheduler(src, conf, window_records=WINDOW,
                                  window_seconds=0.0).start()
        runner = StreamingTrainer(trainer2, table2, sched, census_wait_s=0.0)
        discards = stats.get("pass.stage_discards")
        summary = runner.run()
        assert summary["windows"] == 3
        assert stats.get("pass.stage_discards") > discards
        _assert_state_equal(sd_batch, table2.state_dict())
        table2.close()
        assert summary["auc"] == m_batch["auc"]

    def test_single_chip_stream_agrees_with_the_reference(self, det_records):
        conf, _, lines = det_records
        rconf = ref_synth_config(n_sparse_slots=N_SLOTS, dense_dim=DENSE,
                                 batch_size=B, max_feasigns_per_ins=16)
        rtconf = ref_config.SparseTableConfig(
            embedding_dim=4, learning_rate=0.4, initial_range=0.05,
            store_buckets=16, plan_scratch_rows=64)
        ref_table = RefTable(rtconf, seed=3)
        ref_tr = RefTrainer(
            RefCtrDnn(N_SLOTS, rtconf.row_width, dense_dim=DENSE,
                      hidden=(16, 8)),
            rtconf, ref_config.TrainerConfig(dense_lr=3e-3,
                                             auc_buckets=1 << 12), seed=3)
        tower = [{k: np.array(v) for k, v in layer.items()}
                 for layer in ref_tr.params["tower"]]
        table, trainer = _fresh_single()
        trainer.model.load_state_dict(params_from_jax(tower))

        runs = []
        for src_cls, sched_cls, runner_cls, fconf, tab, tr in (
                (RefIterableSource, RefScheduler, RefStreamingTrainer,
                 rconf, ref_table, ref_tr),
                (IterableSource, MiniPassScheduler, StreamingTrainer,
                 conf, table, trainer)):
            src = src_cls(lines).start()
            sched = sched_cls(src, fconf, window_records=WINDOW,
                              window_seconds=0.0).start()
            runner = runner_cls(tr, tab, sched)
            seen = _record_windows(runner)
            summary = runner.run()
            runs.append((seen, summary, runner.last_metrics,
                         tab.state_dict()))
        table.close()
        (rseen, rsum, rm, rs), (seen, psum, pm, ps) = runs
        assert [n for _, n in seen] == [n for _, n in rseen] == [WINDOW] * 3
        for (c, _), (rc, _) in zip(seen, rseen):
            np.testing.assert_array_equal(c, rc)
        assert psum["windows"] == rsum["windows"] == 3
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)
        assert abs(psum["auc"] - rsum["auc"]) < 1e-4
        np.testing.assert_array_equal(ps["keys"], rs["keys"])
        np.testing.assert_array_equal(ps["values"][:, :2],
                                      rs["values"][:, :2])
        np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5,
                                   atol=1e-6)

    def test_multichip_minipasses_match_one_pass(self, det_records):
        from paddlebox_tpu_torch.parallel import (
            MultiChipTrainer,
            ShardedSparseTable,
            make_mesh,
        )

        conf, files, lines = det_records

        def fresh():
            mesh = make_mesh(4, device="cpu")
            tconf = _det_tconf()
            table = ShardedSparseTable(tconf, mesh, seed=3)
            model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE,
                           hidden=(16, 8), seed=3, device="cpu")
            trainer = MultiChipTrainer(
                model, tconf, mesh,
                TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 12))
            return table, trainer

        table, trainer = fresh()
        m_batch = _one_pass(conf, files, table, trainer)
        sd_batch = table.state_dict()
        table.close()

        # a window of 2 groups of 4 positions: group composition, and so
        # the merge order across positions, is the one pass's
        table2, trainer2 = fresh()
        src = IterableSource(lines).start()
        sched = MiniPassScheduler(src, conf, window_records=WINDOW,
                                  window_seconds=0.0).start()
        summary = StreamingTrainer(trainer2, table2, sched).run()
        assert summary["windows"] == 3
        _assert_state_equal(sd_batch, table2.state_dict())
        table2.close()
        assert summary["auc"] == m_batch["auc"]


# --------------------------------------------------------------------------- #
# the deadline publish policy
# --------------------------------------------------------------------------- #
class _StubEntry:
    def __init__(self, seq):
        self.seq = seq


class _StubPublisher:
    def __init__(self, fail=0):
        self.seqs = []
        self.calls = []
        self.fail = fail

    @property
    def next_seq(self):
        return len(self.seqs)

    def publish_delta(self, tag, table, model=None, params=None,
                      metrics=None, **kw):
        self.calls.append({"tag": tag, "model": model, **kw})
        if self.fail > 0:
            self.fail -= 1
            raise RuntimeError("publish root down")
        e = _StubEntry(self.next_seq)
        self.seqs.append(tag)
        return e


class _StubWindow:
    def __init__(self, age_s, index=None):
        now = time.time()
        self.first_event_ts = now - age_s
        self.last_event_ts = now
        self.index = index


class _StubScheduler:
    def __init__(self, window_records=100):
        self.window_records = window_records


class TestDeadlinePublishPolicy:
    def test_due_on_deadline_not_cadence(self):
        pol = DeadlinePublishPolicy(_StubPublisher(), max_staleness_s=10.0,
                                    trigger_fraction=0.5)
        assert not pol.due()
        pol.observe_window(_StubWindow(age_s=1.0))
        assert not pol.due()
        pol2 = DeadlinePublishPolicy(_StubPublisher(), max_staleness_s=10.0,
                                     trigger_fraction=0.5)
        pol2.observe_window(_StubWindow(age_s=6.0))
        assert pol2.due()

    def test_publish_resets_and_counts_misses(self):
        pub = _StubPublisher()
        pol = DeadlinePublishPolicy(pub, max_staleness_s=0.5)
        misses = telemetry.counter("stream.deadline_misses").value()
        pol.observe_window(_StubWindow(age_s=2.0))
        entry = pol.maybe_publish(table=None)
        assert entry is not None and pub.seqs
        assert pol.deadline_misses == 1
        assert telemetry.counter("stream.deadline_misses").value() == \
            misses + 1
        assert not pol.due()

    def test_lineage_names_the_unpublished_windows(self):
        pub = _StubPublisher()
        pol = DeadlinePublishPolicy(pub, max_staleness_s=100.0,
                                    publish_programs=True)
        for i in (3, 4, 5):
            pol.observe_window(_StubWindow(age_s=0.1, index=i))
        assert pol.pending_lineage == "w3-5"
        pol.maybe_publish(table=None, model="m", force=True)
        assert pub.calls[-1]["lineage"] == "w3-5"
        assert pub.calls[-1]["model"] == "m"
        assert pol.pending_lineage is None

    def test_failure_widens_and_retries_at_least_once(self):
        sched = _StubScheduler(window_records=100)
        pub = _StubPublisher(fail=1)
        pol = DeadlinePublishPolicy(pub, max_staleness_s=10.0,
                                    scheduler=sched, widen_factor=2.0)
        pol.observe_window(_StubWindow(age_s=20.0))
        assert pol.maybe_publish(table=None) is None
        assert pol.publish_failures == 1
        assert sched.window_records == 200
        assert pol.due()
        assert pol.maybe_publish(table=None) is not None
        assert pol.widenings == 1

    def test_injected_publish_deadline_fault(self):
        sched = _StubScheduler()
        pub = _StubPublisher()
        pol = DeadlinePublishPolicy(pub, max_staleness_s=10.0,
                                    scheduler=sched)
        pol.observe_window(_StubWindow(age_s=20.0))
        with fault_plan({"stream.publish_deadline": "first:1"}):
            assert pol.maybe_publish(table=None) is None
            assert pub.seqs == []
            assert pol.maybe_publish(table=None) is not None
        assert stats.get("faults.injected.stream.publish_deadline") >= 1
        assert "stream.publish_deadline" in faults.KNOWN_SITES

    def test_served_confirmation_records_freshness(self):
        pub = _StubPublisher()
        pol = DeadlinePublishPolicy(pub, max_staleness_s=1.0)
        pol.track_served()
        pol.observe_window(_StubWindow(age_s=0.2))
        pol.maybe_publish(table=None, force=True)
        assert pol.outstanding == 1
        assert pol.deadline_misses == 0
        assert pol.confirm_served(0, now=time.time() + 2.0) == 1
        assert pol.outstanding == 0
        assert pol.deadline_misses == 1
        assert pol.last_freshness_s > 1.0


# --------------------------------------------------------------------------- #
# the config, from_config and the launcher
# --------------------------------------------------------------------------- #
def test_streaming_config_from_flags(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_STREAM_ROOT", "/tmp/sroot")
    monkeypatch.setenv("PADDLEBOX_TORCH_MAX_STALENESS_S", "3.5")
    monkeypatch.setenv("PADDLEBOX_TORCH_STREAM_WINDOW_RECORDS", "256")
    sc = StreamingConfig.from_flags()
    assert sc.stream_root == "/tmp/sroot"
    assert sc.max_staleness_s == 3.5
    assert sc.window_records == 256


def test_streaming_config_fields_are_the_references():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(StreamingConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(ref_config.StreamingConfig)}
    assert ours == theirs


@pytest.mark.parametrize("kw", [
    dict(max_staleness_s=0.0), dict(window_records=0),
    dict(window_seconds=-1.0), dict(trigger_fraction=0.0),
    dict(widen_factor=0.5), dict(window_records=8, max_window_records=4),
    dict(max_pending_windows=0),
])
def test_streaming_config_refuses_bad_values(kw):
    with pytest.raises(ValueError):
        StreamingConfig(**kw)


def test_from_config_builds_and_trains(tmp_path, monkeypatch):
    stream = tmp_path / "stream"
    stream.mkdir()
    monkeypatch.setenv("PADDLEBOX_TORCH_STREAM_ROOT", str(stream))
    monkeypatch.setenv("PADDLEBOX_TORCH_MAX_STALENESS_S", "5.0")
    monkeypatch.setenv("PADDLEBOX_TORCH_STREAM_WINDOW_RECORDS", "16")

    conf = make_synth_config(n_sparse_slots=2, dense_dim=2, batch_size=8,
                             max_feasigns_per_ins=8)
    tconf = SparseTableConfig(embedding_dim=4, store_buckets=4,
                              plan_scratch_rows=32)
    model = CtrDnn(2, tconf.row_width, dense_dim=2, hidden=(4,),
                   device="cpu")
    table = SparseTable(tconf, seed=0, device="cpu")
    trainer = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 10),
                      device="cpu")
    runner = StreamingTrainer.from_config(trainer, table, conf)
    assert runner.scheduler.window_records == 16
    assert runner.policy is None
    (stream / "part-000").write_text("\n".join(_lines(32)) + "\n")

    def write_then_stop():
        time.sleep(0.6)
        runner.stop()

    threading.Thread(target=write_then_stop, daemon=True).start()
    summary = runner.run(max_seconds=20.0)
    assert summary["windows"] == 2
    assert summary["records"] == 32
    assert table.n_features > 0


def test_from_config_requires_a_root():
    conf = make_synth_config(n_sparse_slots=2, dense_dim=2, batch_size=8)
    with pytest.raises(ValueError, match="stream_root is empty"):
        StreamingTrainer.from_config(
            trainer=None, table=None, feed_conf=conf,
            stream_conf=StreamingConfig(stream_root=""),
        )


def test_launch_env_carries_stream_flags():
    from paddlebox_tpu_torch.launch import main, rank_env

    env = rank_env(0, 1, "127.0.0.1:1234", stream_root="/data/stream",
                   max_staleness_s=2.0, publish_root="/data/pub",
                   base_env={})
    assert env["PADDLEBOX_TORCH_STREAM_ROOT"] == "/data/stream"
    assert env["PADDLEBOX_TORCH_MAX_STALENESS_S"] == "2.0"
    assert env["PADDLEBOX_TORCH_PUBLISH_ROOT"] == "/data/pub"
    assert not any(k.startswith("PBOX_") for k in env)
    bare = rank_env(0, 1, "127.0.0.1:1234", base_env={})
    assert "PADDLEBOX_TORCH_STREAM_ROOT" not in bare
    with pytest.raises(SystemExit):
        main(["--nproc", "1", "--serve-replicas", "2", "prog.py"])


def test_launched_rank_reads_the_stream_flags(tmp_path):
    """A rank the launcher starts builds its StreamingConfig and publish
    root from the flags the launcher set."""
    from paddlebox_tpu_torch.launch import launch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = tmp_path / "rank.py"
    out = tmp_path / "out.json"
    prog.write_text(
        "import json, sys\n"
        f"sys.path.insert(0, {repo!r})\n"
        "from paddlebox_tpu_torch.config import StreamingConfig, flags\n"
        "sc = StreamingConfig.from_flags()\n"
        "json.dump([sc.stream_root, sc.max_staleness_s, "
        f"flags.publish_root], open({str(out)!r}, 'w'))\n")
    rc = launch([str(prog)], nproc=1, device="cpu",
                stream_root="/s", max_staleness_s=4.5, publish_root="/p",
                job_timeout_s=120)
    assert rc == 0
    assert json.load(open(out)) == ["/s", 4.5, "/p"]


# --------------------------------------------------------------------------- #
# the label flip moves the served score
# --------------------------------------------------------------------------- #
def _fresh_count(name="stream.freshness_seconds"):
    from paddlebox_tpu_torch.telemetry.metrics import Histogram

    m = telemetry.registry.get(name)
    return m.summary()["count"] if isinstance(m, Histogram) else 0


def test_e2e_label_flip_moves_served_score(tmp_path):
    """A label flip appended to the live stream moves the served score
    through Publisher -> donefile -> Syncer -> ScoringServer within a
    bounded time on the CPU, and ``stream.freshness_seconds`` records the
    event-to-served latency."""
    from paddlebox_tpu_torch.data.feed import BatchBuilder
    from paddlebox_tpu_torch.data.slot_parser import SlotParser
    from paddlebox_tpu_torch.inference import ScoringServer
    from paddlebox_tpu_torch.serving_sync import Publisher, Syncer
    from paddlebox_tpu_torch.streaming.minipass import (
        MiniPassWindow,
        WindowDataset,
    )

    S, D, Bsz = 2, 2, 16
    conf = make_synth_config(n_sparse_slots=S, dense_dim=D, batch_size=Bsz,
                             max_feasigns_per_ins=8)
    tconf = SparseTableConfig(embedding_dim=4, learning_rate=0.3,
                              store_buckets=8, plan_scratch_rows=64)
    model = CtrDnn(S, tconf.row_width, dense_dim=D, hidden=(8,),
                   device="cpu")
    table = SparseTable(tconf, seed=0, device="cpu")
    trainer = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 12),
                      device="cpu")
    rng = np.random.default_rng(0)

    def line(label):
        return stream_line(rng, label, n_sparse_slots=S, dense_dim=D,
                           hot_keys=(5, 1005))

    # a warm pass anchors the delta chain
    warm = [line(1) for _ in range(4 * Bsz)]
    block = SlotParser(conf).parse_lines(warm)
    w0 = MiniPassWindow(0, block, np.unique(block.keys), len(warm),
                        time.time(), time.time(), "warm", time.time())
    table.begin_pass(w0.census)
    trainer.train_from_dataset(WindowDataset(w0, BatchBuilder(conf)), table)
    table.end_pass()

    root = str(tmp_path / "publish")
    stream = str(tmp_path / "stream")
    os.makedirs(stream)
    pub = Publisher(root, staging_dir=str(tmp_path / "staging"))
    pub.publish_base("base", model, None, table, batch_size=Bsz,
                     key_capacity=Bsz * conf.max_feasigns_per_ins,
                     dense_dim=D, feed_conf=conf)

    server = ScoringServer(device="cpu")
    syncer = Syncer(root, server, "live", cache_dir=str(tmp_path / "cache"),
                    poll_interval_s=0.05)
    syncer.poll_once()
    syncer.start()
    port = server.start(port=0)
    probe = b"1 0 2 5 30 2 1005 1030 2 0.0 0.0\n"

    def score():
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/score/live", data=probe, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())["scores"][0]

    source = TailingFileSource(stream, poll_interval_s=0.02)
    sched = MiniPassScheduler(source, conf, window_records=2 * Bsz,
                              window_seconds=0.2)
    policy = DeadlinePublishPolicy(pub, max_staleness_s=1.0,
                                   scheduler=sched)
    runner = StreamingTrainer(
        trainer, table, sched, policy=policy, model=model,
        served_seq_fn=lambda: syncer.applied_seq,
    )
    source.start()
    sched.start()
    fresh0 = _fresh_count()
    run_err = []

    def run():
        try:
            runner.run()
        except BaseException as e:  # surfaced after the join
            run_err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    feed = open(os.path.join(stream, "part-000"), "w", buffering=1)
    try:
        high = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            for _ in range(2 * Bsz):
                feed.write(line(1))
            time.sleep(0.4)
            s = score()
            if s > 0.55:
                high = s
                break
        assert high is not None, "served score never learned label=1"

        flip_ts = time.monotonic()
        moved = None
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            for _ in range(2 * Bsz):
                feed.write(line(0))
            time.sleep(0.4)
            s = score()
            if s < high - 0.2:
                moved = time.monotonic() - flip_ts
                break
        assert moved is not None, "served score never moved after the flip"
        assert moved < 45.0
    finally:
        feed.close()
        runner.stop()
        t.join(timeout=60.0)
        syncer.stop()
        server.stop()
    assert not run_err, f"streaming loop died: {run_err!r}"
    summary = runner.summary()
    assert summary["publishes"] >= 2
    assert syncer.applied_seq >= 1
    assert _fresh_count() > fresh0
    assert policy.last_freshness_s is not None
    assert server.model_version("live")["lineage"].startswith("w")
