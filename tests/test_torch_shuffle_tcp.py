"""The port's TCP global shuffler (data/shuffle.py TcpShuffler) against the
JAX package's, on loopback threads (port of tests/test_shuffle.py's TCP
cases).

  * two port shufflers and two reference shufflers exchange the same blocks
    under each routing mode: the routed blocks are equal, field by field;
  * the payloads that cross the wire are byte-equal to the reference's
    under each codec, and ``shuffle.exchange_bytes`` records the same raw
    and encoded totals;
  * a dataset with a TcpShuffler attached loads the same records as one
    with an InProcessShuffleGroup shuffler of the same mode and seed;
  * the reference's robustness cases: a wait that times out names the
    missing workers, a refused connection names the peer, the
    ``shuffle.exchange`` fault site, the ``shuffle.connect`` retry, an
    idempotent ``close``, the collective digest, the timeout's resolution
    (argument, active watchdog, flag) and a corrupt payload counted in
    ``shuffle.wire_errors``.

Keys, routes, bytes and counters are compared exactly.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu.data import shuffle as ref_shuffle
from paddlebox_tpu.data.record import RecordBlock as RefBlock
from paddlebox_tpu.utils import faults as ref_faults
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import LivenessConfig
from paddlebox_tpu_torch.data import shuffle
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.parallel.watchdog import Watchdog
from paddlebox_tpu_torch.telemetry import flight
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

FIELDS = ("keys", "key_offsets", "dense", "labels", "search_ids", "ranks",
          "cmatches")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def _block(n_ins=20, s=2, seed=0, cls=RecordBlock):
    """The reference test's block: ins_ids, search_ids and the logkey
    fields set, key counts 1..3 a slot."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 4, size=n_ins * s)
    offs = np.zeros(n_ins * s + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return cls(
        n_ins=n_ins, n_sparse_slots=s,
        keys=rng.integers(1, 1000, size=int(offs[-1])).astype(np.uint64),
        key_offsets=offs,
        dense=rng.normal(size=(n_ins, 3)).astype(np.float32),
        labels=rng.integers(0, 2, size=n_ins).astype(np.float32),
        ins_ids=[f"ins-{seed}-{i}" for i in range(n_ins)],
        search_ids=rng.integers(0, 1 << 40, size=n_ins).astype(np.uint64),
        ranks=np.zeros(n_ins, dtype=np.int32),
        cmatches=np.zeros(n_ins, dtype=np.int32),
    )


def _run_workers(n, fn):
    out, errs = [None] * n, []

    def run(i):
        try:
            out[i] = fn(i)
        except BaseException as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    if errs:
        raise errs[0]
    return out


def _wired(cls, n, **kw):
    """n started shufflers of ``cls`` on OS-assigned loopback ports, each
    told every peer's real endpoint."""
    shs = [cls([("127.0.0.1", 0)] * n, i, **kw) for i in range(n)]
    for s in shs:
        s.start()
    endpoints = [("127.0.0.1", s.bound_port()) for s in shs]
    for s in shs:
        s.endpoints = endpoints
    return shs


def _exchange(cls, blocks, record=None, **kw):
    """Every worker exchanges its block; ``record`` collects the payloads
    each sender put on the wire, by (sender, peer)."""
    shs = _wired(cls, len(blocks), **kw)
    if record is not None:
        for s in shs:
            send = s._send_to_peer

            def spy(peer, rnd, payload, s=s, send=send):
                record[(s.worker_id, peer)] = payload
                return send(peer, rnd, payload)

            s._send_to_peer = spy
    try:
        return _run_workers(len(blocks), lambda i: shs[i].exchange(blocks[i]))
    finally:
        for s in shs:
            s.close()


def _assert_blocks_equal(a, b):
    assert (a.n_ins, a.n_sparse_slots) == (b.n_ins, b.n_sparse_slots)
    assert a.ins_ids == b.ins_ids
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("mode", ["search_id", "ins_id", "random"])
def test_routed_blocks_equal_the_reference(mode):
    n = 3
    port = _exchange(shuffle.TcpShuffler,
                     [_block(30, seed=10 + i) for i in range(n)],
                     mode=mode, seed=7)
    ref = _exchange(ref_shuffle.TcpShuffler,
                    [_block(30, seed=10 + i, cls=RefBlock) for i in range(n)],
                    mode=mode, seed=7)
    assert sum(b.n_ins for b in port) == 3 * 30
    for p, r in zip(port, ref):
        _assert_blocks_equal(p, r)
    if mode == "search_id":
        for wid, b in enumerate(port):
            np.testing.assert_array_equal(
                (b.search_ids % n).astype(np.int32), np.full(b.n_ins, wid))


@pytest.mark.parametrize("codec", ["varint", "raw", "legacy"])
def test_wire_bytes_equal_the_reference(codec):
    blocks = [_block(120, seed=20 + i) for i in range(2)]
    ref_blocks = [_block(120, seed=20 + i, cls=RefBlock) for i in range(2)]
    telemetry.registry.reset()
    got, want = {}, {}
    port = _exchange(shuffle.TcpShuffler, blocks, got, codec=codec)
    ref = _exchange(ref_shuffle.TcpShuffler, ref_blocks, want, codec=codec)
    assert set(got) == set(want) == {(0, 1), (1, 0)}
    for k in got:
        assert got[k] == want[k], k
    for p, r in zip(port, ref):
        _assert_blocks_equal(p, r)
    h = telemetry.registry.get("shuffle.exchange_bytes")
    series = h.series()
    raw = sum(s.sum for k, s in series.items() if ("kind", "raw") in k)
    enc = sum(s.sum for k, s in series.items() if ("kind", "encoded") in k)
    from paddlebox_tpu.data.archive import block_to_wire as ref_to_wire

    parts = [ref_shuffle.split_by_route(
        b, ref_shuffle.route_ids(b, 2), 2)[1 - i]
        for i, b in enumerate(ref_blocks)]
    sizes = [ref_to_wire(p, codec)[1:] for p in parts]
    assert raw == sum(s[0] for s in sizes) > 0
    assert enc == sum(s[1] for s in sizes)
    assert (enc < raw) == (codec == "varint")


def test_dataset_load_equals_the_in_process_group(tmp_path):
    """Two datasets loading through TcpShufflers hold exactly what two
    datasets of an InProcessShuffleGroup of the same mode and seed hold,
    record for record (the TCP block puts the worker's own part first,
    then its peers' in worker order; compared in ins_id order)."""
    files = write_synth_files(str(tmp_path), n_files=2, ins_per_file=40,
                              n_sparse_slots=3, vocab_per_slot=50,
                              dense_dim=2, seed=3)
    for i, f in enumerate(files):  # an ins_id in front of every line
        lines = open(f).read().splitlines()
        open(f, "w").write("".join(f"f{i}-{j} {ln}\n"
                                   for j, ln in enumerate(lines)))
    conf = make_synth_config(3, 2, 8, 16, parse_ins_id=True)

    def load(shufflers):
        dss = []
        for w in range(2):
            d = PadBoxSlotDataset(conf, read_threads=1)
            d.set_filelist([files[w]])
            d.shuffler = shufflers[w]
            d.preload_into_memory()
            dss.append(d)
        for d in dss:
            d.wait_preload_done()
        return [d._block for d in dss]

    tcp = _wired(shuffle.TcpShuffler, 2, mode="ins_id", seed=1)
    try:
        got = load(tcp)
    finally:
        for s in tcp:
            s.close()
    group = shuffle.InProcessShuffleGroup(2, mode="ins_id", seed=1)
    want = load([group.shuffler(w) for w in range(2)])
    assert sum(b.n_ins for b in got) == 80
    for g, w in zip(got, want):
        og, ow = np.argsort(g.ins_ids), np.argsort(w.ins_ids)
        _assert_blocks_equal(g.select(og), w.select(ow))


def test_exchange_records_the_collective_digest():
    rec = flight.reset_for_tests()
    s = shuffle.TcpShuffler([("127.0.0.1", 0)], 0, timeout=1.0)
    try:
        for _ in range(2):
            s.exchange(_block(seed=3))
    finally:
        s.close()
        digests = [r for r in rec.snapshot()
                   if r["kind"] == "collective" and r.get("channel") == "shuffle"]
        flight.reset_for_tests()
    assert [(d["seq"], d["op"], d["rank"]) for d in digests] == [
        (0, "exchange", 0), (1, "exchange", 0)]


def test_close_is_idempotent():
    s = shuffle.TcpShuffler([("127.0.0.1", 0)], 0)
    s.start()
    s.close()
    s.close()
    shuffle.TcpShuffler([("127.0.0.1", 0)], 0).close()


def _dead_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_connection_refused_names_the_peer(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.01")
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_DELAY_S", "0.02")
    dead = _dead_port()
    s = shuffle.TcpShuffler([("127.0.0.1", 0), ("127.0.0.1", dead)], 0,
                            mode="random", timeout=1.0)
    s.start()
    try:
        with pytest.raises(shuffle.ShufflePeerError) as ei:
            s.exchange(_block(n_ins=30, seed=5))
        assert "worker 1" in str(ei.value)
        assert f"127.0.0.1:{dead}" in str(ei.value)
        assert ei.value.worker_id == 1
        assert ei.value.endpoint == ("127.0.0.1", dead)
    finally:
        s.close()


def test_timeout_names_the_missing_workers():
    shs = _wired(shuffle.TcpShuffler, 2, timeout=0.6)
    try:
        with pytest.raises(TimeoutError) as ei:
            shs[0].exchange(_block(seed=3))
        msg = str(ei.value)
        assert "worker 1" in msg and str(shs[0].endpoints[1][1]) in msg
        assert "round 0" in msg
    finally:
        for s in shs:
            s.close()


def test_exchange_fault_site():
    s = shuffle.TcpShuffler([("127.0.0.1", 0)], 0)
    s.start()
    try:
        with faults.fault_plan({"shuffle.exchange": "first:1"}):
            with pytest.raises(faults.FaultInjected):
                s.exchange(_block(seed=1))
        assert s.exchange(_block(seed=1, n_ins=4)).n_ins == 4
    finally:
        s.close()
    assert {"shuffle.exchange", "shuffle.connect"} <= faults.known_sites()


def test_connect_retry_absorbs_a_late_listener(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS", "5")
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.05")
    monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_DELAY_S", "0.1")
    a = shuffle.TcpShuffler([("127.0.0.1", 0)] * 2, 0, mode="random",
                            timeout=5.0)
    a.start()
    endpoints = [("127.0.0.1", a.bound_port()), ("127.0.0.1", _dead_port())]
    a.endpoints = endpoints
    b = shuffle.TcpShuffler(endpoints, 1, mode="random", timeout=5.0)
    base = stats.get("retry.shuffle.connect.retries")

    def late(i):
        if i == 0:
            return a.exchange(_block(seed=20, n_ins=16))
        time.sleep(0.3)  # a's first connects hit a dead port
        b.start()
        return b.exchange(_block(seed=21, n_ins=16))

    try:
        res = _run_workers(2, late)
    finally:
        a.close()
        b.close()
    assert sum(r.n_ins for r in res) == 32
    assert stats.get("retry.shuffle.connect.retries") > base


def test_timeout_resolution(monkeypatch):
    """The explicit argument, else the active watchdog's LivenessConfig,
    else the flag."""
    monkeypatch.setenv("PADDLEBOX_TORCH_SHUFFLE_TIMEOUT_S", "7.5")
    eps = [("127.0.0.1", 0)]
    assert shuffle.TcpShuffler(eps, 0).timeout == 7.5
    assert shuffle.TcpShuffler(eps, 0, timeout=2.0).timeout == 2.0
    wd = Watchdog(LivenessConfig(shuffle_timeout_s=3.25), rank=0,
                  world=1).start()
    try:
        assert shuffle.TcpShuffler(eps, 0).timeout == 3.25
    finally:
        wd.close()
    with pytest.raises(ValueError, match="codec"):
        shuffle.TcpShuffler(eps, 0, codec="zip")


def test_corrupt_payload_is_counted_and_times_out_naming_the_sender():
    shs = _wired(shuffle.TcpShuffler, 2, timeout=0.6)
    errors = telemetry.counter("shuffle.wire_errors")
    base = errors.value()
    send = shs[1]._send_to_peer
    shs[1]._send_to_peer = lambda peer, rnd, payload: send(
        peer, rnd, b"not-a-frame")
    try:
        with pytest.raises(TimeoutError, match="worker 1"):
            _run_workers(2, lambda i: shs[i].exchange(_block(seed=4 + i)))
    finally:
        for s in shs:
            s.close()
    assert errors.value() == base + 1
