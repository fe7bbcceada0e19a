"""The port's data half against the JAX package, bit for bit on the host:
the slot parser with the ins_id, logkey and task-label columns (native and
Python; plain, .gz and pipe_command), the synthetic files, the binary
archives, the shuffle routing and the in-process shuffle group, the slot
shuffle, the Criteo writer and converter, the retry helper at the
``data.read`` site, and the config's dict form.
"""

import gzip
import io
import os
import threading
import zipfile

import numpy as np
import pytest
import torch

import paddlebox_tpu.data.shuffle as ref_shuffle
from paddlebox_tpu.data import archive as ref_archive
from paddlebox_tpu.data import criteo as ref_criteo
from paddlebox_tpu.data.data_generator import format_instance as ref_format
from paddlebox_tpu.data.dataset import _shuffle_slots as ref_shuffle_slots
from paddlebox_tpu.data.slot_parser import SlotParser as RefParser
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.data.synth import write_synth_files as ref_write_synth
from paddlebox_tpu_torch.data import archive, criteo, shuffle
from paddlebox_tpu_torch.data.data_generator import format_instance
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset, _shuffle_slots
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.data.slot_parser import SlotParser
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.fs import FsError
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.utils.retry import RetryPolicy, retry_call

torch.set_num_threads(1)

S, DENSE, TASKS = 4, 3, 2
FIELDS = ("n_ins", "n_sparse_slots", "keys", "key_offsets", "dense", "labels",
          "ins_ids", "search_ids", "ranks", "cmatches", "task_labels")


def assert_blocks_equal(a, b):
    """Every column of two RecordBlocks (either package's) bit for bit,
    dtypes included."""
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        elif isinstance(x, list):
            assert x == y, f
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def _with_ins_ids(paths):
    """Prefix every line with an ins_id (``<file>-<line>``), in place."""
    for p in paths:
        with open(p) as f:
            lines = f.read().splitlines()
        name = os.path.basename(p)
        with open(p, "w") as f:
            f.writelines(f"{name}-{i} {line}\n" for i, line in enumerate(lines))
    return paths


@pytest.fixture(scope="module")
def logkey_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("logkey")
    return _with_ins_ids(write_synth_files(
        str(d), n_files=2, ins_per_file=96, n_sparse_slots=S, dense_dim=DENSE,
        seed=5, with_logkey=True, cmatch_values=(222, 223, 1),
        n_task_labels=TASKS))


def _confs(**kw):
    kw = dict(parse_ins_id=True, parse_logkey=True, n_task_labels=TASKS, **kw)
    return (make_synth_config(S, DENSE, 32, 16, **kw),
            ref_synth_config(S, DENSE, 32, 16, **kw))


def _native_env(monkeypatch, on: bool):
    v = "1" if on else "0"
    monkeypatch.setenv("PBOX_USE_NATIVE_PARSER", v)
    monkeypatch.setenv("PADDLEBOX_TORCH_USE_NATIVE_PARSER", v)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("source", ["plain", "gz", "pipe"])
def test_parsed_blocks_match_reference(logkey_files, tmp_path, monkeypatch,
                                       native, source):
    """ins_id, logkey and task-label columns parse bit-exact against the
    reference's parser of the same kind, and the port's native block equals
    its Python block."""
    _native_env(monkeypatch, native)
    path = logkey_files[0]
    kw = {}
    if source == "gz":
        path = str(tmp_path / "part.gz")
        with open(logkey_files[0], "rb") as src, gzip.open(path, "wb") as dst:
            dst.write(src.read())
    elif source == "pipe":
        path = str(tmp_path / "part.gz")
        with open(logkey_files[0], "rb") as src, gzip.open(path, "wb") as dst:
            dst.write(src.read())
        # the pipe gets the .gz bytes through a name without the suffix
        os.rename(path, str(tmp_path / "part-z"))
        path = str(tmp_path / "part-z")
        kw = dict(pipe_command="gzip -d")
    conf, ref_conf = _confs(**kw)
    parser = SlotParser(conf)
    got = parser.parse_file(path)
    want = RefParser(ref_conf).parse_file(path)
    assert (parser._native is not None) == native
    assert got.n_ins == 96 and len(set(got.ins_ids)) == 96
    assert set(np.unique(got.cmatches)) == {1, 222, 223}
    assert got.task_labels.shape == (96, TASKS)
    assert_blocks_equal(got, want)
    if native:
        _native_env(monkeypatch, False)
        python = SlotParser(conf).parse_file(path)
        assert_blocks_equal(got, python)


def test_native_parity_on_reference_lines(monkeypatch):
    """tests/test_native_parser.py::test_parity_ins_id_logkey's lines: the
    port's native block equals its Python block and the reference's."""
    _native_env(monkeypatch, True)
    conf, ref_conf = _confs()
    lines = [f"id-{i} {1000 + i}:{i % 3}:{222 + (i % 2)} 1 {i % 2} "
             f"1 {i % 2} 1 1 2 11 12 1 21 0 3 31 32 33 3 0.1 0.2 0.{i}"
             for i in range(9)]
    text = "\n".join(lines) + "\n"
    native = SlotParser(conf)._native_parser()
    assert native is not None
    got = native.parse_bytes(text.encode())
    assert_blocks_equal(got, SlotParser(conf).parse_lines(lines))
    assert_blocks_equal(got, RefParser(ref_conf).parse_lines(lines))


def test_pipe_command_failure_is_retryable_fs_error(logkey_files, monkeypatch):
    """A non-zero pipe exit raises FsError; the dataset retries it at the
    data.read site and gives up after the policy's attempts."""
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.0")
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS", "2")
    conf, _ = _confs(pipe_command="exit 3")
    with pytest.raises(FsError, match="exited 3"):
        SlotParser(conf).parse_file(logkey_files[0])
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(logkey_files[:1])
    before = stats.get("retry.data.read.attempts")
    with pytest.raises(FsError):
        ds.load_into_memory()
    assert stats.get("retry.data.read.attempts") - before == 2
    ds.close()


def test_data_read_fault_is_retried(logkey_files, monkeypatch):
    """An injected data.read fault is transient: the load retries it and
    gets the same block as an undisturbed load."""
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.0")
    conf, _ = _confs()
    want = SlotParser(conf).parse_file(logkey_files[0])
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(logkey_files[:1])
    before = stats.get("retry.data.read.retries")
    with faults.fault_plan({"data.read": "first:1"}):
        ds.load_into_memory()
    assert stats.get("retry.data.read.retries") - before == 1
    assert_blocks_equal(ds._block, want)
    ds.close()


def test_retry_call_policy():
    """Transient errors retry with the jittered backoff, a ValueError never
    does, and exhaustion re-raises the last error."""
    sleeps, calls = [], []

    def flaky(fail_with, n):
        calls.append(1)
        if len(calls) <= n:
            raise fail_with("boom")
        return "ok"

    policy = RetryPolicy(max_attempts=3, base_delay_s=0.5, max_delay_s=0.8,
                         jitter=0.0)
    assert retry_call(flaky, FsError, 2, site="t.ok", policy=policy,
                      sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 0.8]
    calls.clear()
    with pytest.raises(ValueError):
        retry_call(flaky, ValueError, 1, site="t.value", policy=policy,
                   sleep=sleeps.append)
    assert len(calls) == 1
    calls.clear()
    with pytest.raises(faults.FaultInjected):
        retry_call(flaky, faults.FaultInjected, 5, site="t.out",
                   policy=policy, sleep=lambda s: None)
    assert len(calls) == 3
    assert stats.get("retry.t.out.exhausted") >= 1


@pytest.mark.parametrize("kw", [
    dict(),
    dict(with_logkey=True, max_ads_per_pv=4, cmatch_values=(222, 223, 1),
         n_task_labels=1),
    dict(zipf_a=1.3, n_task_labels=2),
], ids=["plain", "logkey_tasks", "zipf"])
def test_synth_files_byte_identical(tmp_path, kw):
    got = write_synth_files(str(tmp_path / "port"), n_files=2,
                            ins_per_file=77, seed=9, **kw)
    want = ref_write_synth(str(tmp_path / "ref"), n_files=2, ins_per_file=77,
                           seed=9, **kw)
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _members(data: bytes) -> dict:
    """An npz's members by name: their bytes, without the zip's
    timestamps."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_archives_cross_read(logkey_files, tmp_path):
    """An archive written by either package reads in the other, and the
    two packages serialize a block to the same npz members, byte for byte
    (the zip's timestamps aside)."""
    conf, ref_conf = _confs()
    block = SlotParser(conf).parse_file(logkey_files[0])
    ref_block = RefParser(ref_conf).parse_file(logkey_files[0])
    assert _members(archive.block_to_bytes(block)) == _members(
        ref_archive.block_to_bytes(ref_block))
    mine, theirs = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    halves = [block.select(np.arange(0, 40)), block.select(np.arange(40, 96))]
    assert archive.write_archive(mine, halves) == 2
    ref_archive.write_archive(theirs, [ref_block.select(np.arange(0, 40)),
                                       ref_block.select(np.arange(40, 96))])
    for got, want in zip(ref_archive.read_archive(mine), halves):
        assert_blocks_equal(got, want)
    back = RecordBlock.concat(list(archive.read_archive(theirs)))
    assert_blocks_equal(back, block)
    for codec in ("varint", "raw", "legacy"):
        payload, raw_kb, _ = archive.block_to_wire(block, codec)
        assert raw_kb == block.keys.nbytes
        assert_blocks_equal(ref_archive.block_from_wire(payload), block)
        ref_payload = ref_archive.block_to_wire(ref_block, codec)[0]
        assert_blocks_equal(archive.block_from_wire(ref_payload), block)
    with pytest.raises(archive.WireCodecError):
        archive.block_from_wire(b"junk")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_hash_and_route_ids_match_reference(logkey_files, monkeypatch, native):
    conf, _ = _confs()
    block = SlotParser(conf).parse_file(logkey_files[0])
    ids = block.ins_ids + ["", "x", "é-unicode", "a" * 300]
    if not native:
        monkeypatch.setattr(shuffle, "hash_ids_native", lambda ids: None)
    np.testing.assert_array_equal(shuffle._hash_ins_ids(ids),
                                  ref_shuffle._hash_ins_ids(ids))
    for mode in ("search_id", "ins_id", "random"):
        for n in (1, 3, 4):
            np.testing.assert_array_equal(
                shuffle.route_ids(block, n, mode, seed=2),
                ref_shuffle.route_ids(block, n, mode, seed=2))
    with pytest.raises(ValueError):
        shuffle.route_ids(block, 0)
    with pytest.raises(ValueError):
        shuffle.route_ids(block, 2, mode="bogus")


def test_in_process_group_places_like_reference(logkey_files):
    """Four workers exchange their loads: every record lands where
    route_ids says, the union is the input, and each worker's set equals
    the reference group's."""
    conf, ref_conf = _confs()
    parts = [SlotParser(conf).parse_file(p) for p in logkey_files]
    quarters = [b.select(np.arange(lo, lo + 48)) for b in parts
                for lo in (0, 48)]
    ref_parts = [RefParser(ref_conf).parse_file(p) for p in logkey_files]
    ref_quarters = [b.select(np.arange(lo, lo + 48)) for b in ref_parts
                    for lo in (0, 48)]

    def exchange(group, blocks):
        out = [None] * 4
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(
                i, group.shuffler(i).exchange(blocks[i])))
            for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        return out

    for mode in ("search_id", "ins_id"):
        got = exchange(shuffle.InProcessShuffleGroup(4, mode), quarters)
        want = exchange(ref_shuffle.InProcessShuffleGroup(4, mode),
                        ref_quarters)
        everything = RecordBlock.concat(quarters)
        dest = dict(zip(everything.ins_ids,
                        shuffle.route_ids(everything, 4, mode)))
        for w, (g, r) in enumerate(zip(got, want)):
            assert all(dest[i] == w for i in g.ins_ids)
            assert sorted(g.ins_ids) == sorted(r.ins_ids)
        assert sorted(i for g in got for i in g.ins_ids) == sorted(
            everything.ins_ids)
    # a second round reuses the group; sender order makes it repeatable
    group = shuffle.InProcessShuffleGroup(4, "ins_id")
    first = exchange(group, quarters)
    second = exchange(group, quarters)
    for a, b in zip(first, second):
        assert_blocks_equal(a, b)


@pytest.mark.parametrize("kind", ["shuffle", "census"])
def test_group_barrier_times_out_instead_of_hanging(logkey_files, kind,
                                                    monkeypatch):
    """A worker whose peers never arrive raises instead of waiting
    forever: the shuffle group's and the census group's barriers."""
    from paddlebox_tpu_torch.parallel import census

    monkeypatch.setattr(shuffle, "BARRIER_TIMEOUT_S", 0.5)
    monkeypatch.setattr(census, "BARRIER_TIMEOUT_S", 0.5)
    if kind == "shuffle":
        conf, _ = _confs()
        block = SlotParser(conf).parse_file(logkey_files[0])
        group = shuffle.InProcessShuffleGroup(2, "ins_id")
        with pytest.raises(threading.BrokenBarrierError):
            group.shuffler(0).exchange(block)
    else:
        group = census.InProcessCensusGroup(2)
        with pytest.raises(threading.BrokenBarrierError):
            group.transport(0).gather(b"payload")


def test_shuffle_slots_matches_reference(logkey_files):
    conf, ref_conf = _confs()
    block = SlotParser(conf).parse_file(logkey_files[1])
    ref_block = RefParser(ref_conf).parse_file(logkey_files[1])
    got = _shuffle_slots(block, [1, 3], np.random.default_rng(4))
    want = ref_shuffle_slots(ref_block, [1, 3], np.random.default_rng(4))
    assert_blocks_equal(got, want)
    # the other slots and every other column stay
    lens = np.diff(block.key_offsets).reshape(block.n_ins, S)
    new_lens = np.diff(got.key_offsets).reshape(block.n_ins, S)
    np.testing.assert_array_equal(lens[:, [0, 2]], new_lens[:, [0, 2]])
    assert got.ins_ids == block.ins_ids


def test_criteo_writer_and_converter_match_reference(tmp_path):
    tsv = str(tmp_path / "day_0.tsv")
    ref_tsv = str(tmp_path / "ref_day_0.tsv")
    criteo.write_criteo_format_sample(tsv, n_lines=300, seed=3)
    ref_criteo.write_criteo_format_sample(ref_tsv, n_lines=300, seed=3)
    with open(tsv, "rb") as a, open(ref_tsv, "rb") as b:
        assert a.read() == b.read()
    got = criteo.convert_criteo_files([tsv], str(tmp_path / "port"),
                                      lines_per_shard=128)
    want = ref_criteo.convert_criteo_files([tsv], str(tmp_path / "ref"),
                                           lines_per_shard=128)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    conf = criteo.criteo_feed_config(batch_size=64)
    block = SlotParser(conf).parse_file(got[0])
    ref_block = RefParser(ref_criteo.criteo_feed_config(batch_size=64)
                          ).parse_file(want[0])
    assert_blocks_equal(block, ref_block)
    assert criteo.criteo_key(3, "abc") == ref_criteo.criteo_key(3, "abc")


def test_format_instance_matches_reference():
    conf, ref_conf = _confs()
    ins = [("click", [1]), ("task0", [0]), ("task1", [1]),
           ("slot0", [5, 6]), ("slot2", [7]), ("dense0", [0.5, 0.25, 1.0])]
    line = format_instance(conf, ins, ins_id="u-1", logkey=(9, 2, 222))
    assert line == ref_format(ref_conf, ins, ins_id="u-1", logkey=(9, 2, 222))
    block = SlotParser(conf).parse_lines([line])
    assert block.ins_ids == ["u-1"] and int(block.ranks[0]) == 2


def test_config_dict_round_trip_matches_reference():
    conf, ref_conf = _confs(enable_pv_merge=True, rank_offset="rank_offset",
                            pv_batch_size=8, rank_cmatch_filter=(222,),
                            sequence_slot="slot1", max_seq_len=4,
                            pipe_command="cat")
    d = conf.to_dict()
    assert d == ref_conf.to_dict()
    back = type(conf).from_dict(d)
    assert back.rank_cmatch_filter == (222,) and back.max_rank == 3
    assert back.to_dict() == d
    with pytest.warns(RuntimeWarning):
        type(conf).from_dict({**d, "from_the_future": 1})
