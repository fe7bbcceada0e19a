"""The port's distributed liveness and host plane against the reference
(tests/test_watchdog.py, case by case): the staleness math, the local and
peer stall detection, the poison-key convergence, retired peers, the
heartbeat fault site, hang interruption, the prefetcher's bounded get, the
current-watchdog registry, and the KvChannel's deadline-bounded waits over
simulated ranks.  The detector runs on an injected clock throughout (the
monitor threads poll it; no test waits on a real deadline), so nothing
here depends on the host's load.

Beyond the reference's cases: the KvChannel frames are byte-equal to the
reference's ``_encode_array`` for every codec, ``DistributedStallError``
payloads round-trip between the packages, the StoreKv over a real TCPStore
keeps the KV contract, and one real 2-process job (tests/
_torch_stall_child.py) in which rank 1 freezes its first step aborts on
both ranks with the error naming rank 1 and its stage, within twice the
5 s deadline.
"""

import base64
import json
import os
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu.parallel import host_plane as ref_host_plane
from paddlebox_tpu.parallel.watchdog import (
    DistributedStallError as RefStallError,
)
from paddlebox_tpu_torch.config import LivenessConfig, flags
from paddlebox_tpu_torch.parallel import host_plane
from paddlebox_tpu_torch.parallel import watchdog as wmod
from paddlebox_tpu_torch.parallel.watchdog import (
    DistributedStallError,
    InMemoryKv,
    PeerTracker,
    Watchdog,
    beat,
    current,
)
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.faults import FaultSpec
from paddlebox_tpu_torch.utils.monitor import stats
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))

FAST = LivenessConfig(
    deadline_s=0.5, heartbeat_interval_s=0.1, poll_interval_s=0.05
)
# real-time bound of a wait for a monitor thread to act on the fake clock
WAIT_S = 30.0


class FakeClock:
    def __init__(self, t0=100.0):
        self.t = t0

    def __call__(self):
        return self.t


def _sim_fleet(n, kv, conf=FAST, t0=100.0):
    """n simulated workers' watchdogs over one shared KV store, driven
    synchronously (install_current=False keeps them out of the process-wide
    registry)."""
    wds = [Watchdog(conf, rank=r, world=n, kv=kv, namespace="sim",
                    install_current=False) for r in range(n)]
    for wd in wds:  # pin the staleness origin to the fake clock
        wd._tracker = PeerTracker()
        wd._tracker.observe(wd.rank, 0, "start", t0)
    return wds


def _until(cond, what):
    end = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > end:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.01)


# --------------------------------------------------------------------------- #
# staleness math
# --------------------------------------------------------------------------- #
def test_peer_tracker_staleness_math():
    tr = PeerTracker()
    tr.observe(1, 0, "feed", 10.0)
    assert tr.age(1, 12.0) == pytest.approx(2.0)
    tr.observe(1, 5, "step", 12.0)  # progress resets the clock
    assert tr.age(1, 12.5) == pytest.approx(0.5)
    # frozen progress does NOT reset it, even when heartbeats keep arriving
    tr.observe(1, 5, "step", 14.0)
    tr.observe(1, 5, "shuffle", 15.0)
    assert tr.age(1, 15.0) == pytest.approx(3.0)
    assert tr.last(1) == (5, "shuffle")  # the stage label stays fresh
    assert tr.age(2, 15.0) is None  # never observed
    assert tr.stale(15.5, deadline_s=3.0) == [(1, pytest.approx(3.5), 5,
                                                "shuffle")]
    assert tr.stale(15.5, deadline_s=10.0) == []


def test_staleness_is_observer_clocked_not_heartbeat_clocked():
    tr = PeerTracker()
    for t in (0.0, 1.0, 2.0, 3.0):
        tr.observe(7, 42, "step", t)
    assert tr.age(7, 3.0) == pytest.approx(3.0)


def test_local_stall_detection_and_error_fields():
    wd = Watchdog(FAST, rank=3, world=1, install_current=False)
    wd._tracker = PeerTracker()
    wd._tracker.observe(3, 0, "start", 0.0)
    wd.report("feed")
    assert not wd.tick(now=0.2)
    assert wd.tick(now=1.0)  # frozen past the deadline
    err = wd.error
    assert isinstance(err, DistributedStallError)
    assert (err.culprit, err.stage, err.kind, err.detected_by) == (
        3, "feed", "local", 3)
    assert err.age_s > FAST.deadline_s
    assert "process 3" in str(err) and "'feed'" in str(err)
    with pytest.raises(DistributedStallError):
        wd.check()


def test_progress_keeps_watchdog_quiet():
    wd = Watchdog(FAST, rank=0, world=1, install_current=False)
    wd._tracker = PeerTracker()
    wd._tracker.observe(0, 0, "start", 0.0)
    for i in range(40):  # 4 simulated seconds, reporting every 0.1
        wd.report("step")
        assert not wd.tick(now=i * 0.1)
    assert not wd.aborted


# --------------------------------------------------------------------------- #
# poison-key convergence
# --------------------------------------------------------------------------- #
def test_poison_key_convergence_names_the_frozen_worker():
    kv = InMemoryKv()
    wds = _sim_fleet(3, kv)
    t0 = 100.0
    for step in range(4):  # everyone progresses except rank 1
        t = t0 + step * 0.1
        for wd in wds:
            if wd.rank != 1:
                wd.report("step")
            assert not wd.tick(now=t)
    t = t0 + 0.65
    for wd in wds:
        if wd.rank != 1:
            wd.report("step")
        wd.tick(now=t)
    for wd in wds:
        assert wd.aborted and wd.error.culprit == 1
        assert wd.error.kind in ("peer", "poison")
    assert kv.get(wds[0].poison_key) is not None
    assert len({wd.error.stage for wd in wds}) == 1


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_poison_payload_roundtrip_and_corruption(reader):
    """The port's payload, read by either package, and the reference's,
    read by the port, rebuild the same error; a corrupt payload still
    converges (culprit unknown)."""
    kw = dict(culprit=2, stage="hostplane:plan-4", kind="peer", age_s=12.5,
              progress=77, detected_by=0)
    for make in (DistributedStallError, RefStallError):
        payload = make(**kw).to_payload()
        read = (DistributedStallError if reader == "port"
                else RefStallError).from_payload
        back = read(payload, reader_rank=1)
        assert (back.culprit, back.stage, back.kind, back.progress,
                back.age_s, back.detected_by) == (2, "hostplane:plan-4",
                                                  "poison", 77, 12.5, 0)
    assert DistributedStallError(**kw).to_payload() == \
        RefStallError(**kw).to_payload()
    bad = DistributedStallError.from_payload("not json{", reader_rank=1)
    assert bad.kind == "poison" and bad.culprit == -1


# --------------------------------------------------------------------------- #
# deliberate membership shrink
# --------------------------------------------------------------------------- #
def test_retired_rank_never_named_stall_culprit():
    kv = InMemoryKv()
    wds = _sim_fleet(3, kv)
    t0 = 100.0
    for step in range(4):
        for wd in wds:
            wd.report("step")
            assert not wd.tick(now=t0 + step * 0.1)
    for wd in wds:
        if wd.rank != 1:
            wd.retire_peer(1)
    assert kv.get(wds[0]._hb_key(1)) is None  # heartbeat key pruned
    for step in range(30):  # rank 1 frozen, far past the deadline
        for wd in wds:
            if wd.rank != 1:
                wd.report("step")
                assert not wd.tick(now=t0 + 0.4 + step * 0.1)
    assert not any(wd.aborted for wd in wds if wd.rank != 1)
    assert kv.get(wds[0].poison_key) is None


def test_poison_naming_retired_rank_is_ignored_and_cleared():
    kv = InMemoryKv()
    wds = _sim_fleet(3, kv)
    wds[0].retire_peer(1)
    kv.set(wds[0].poison_key, DistributedStallError(
        culprit=1, stage="step", kind="peer", age_s=9.9, progress=3,
        detected_by=2).to_payload())
    base = stats.get("watchdog.poison_retired_ignored")
    wds[0].report("step")
    assert not wds[0].tick(now=100.1)
    assert not wds[0].aborted
    assert kv.get(wds[0].poison_key) is None
    assert stats.get("watchdog.poison_retired_ignored") == base + 1
    kv.set(wds[0].poison_key, DistributedStallError(
        culprit=2, stage="step", kind="peer", age_s=9.9, progress=3,
        detected_by=0).to_payload())
    assert wds[0].tick(now=100.2)
    assert wds[0].aborted and wds[0].error.culprit == 2


def test_retire_peer_is_idempotent_and_guards_own_rank():
    kv = InMemoryKv()
    wds = _sim_fleet(2, kv)
    tr = PeerTracker()
    tr.observe(1, 0, "step", 0.0)
    tr.deregister(1)
    assert tr.age(1, 5.0) is None
    tr.deregister(1)
    wds[0].retire_peer(1)
    wds[0].retire_peer(1)
    assert wds[0]._is_retired(1)
    with pytest.raises(ValueError):
        wds[0].retire_peer(0)


def test_threaded_fleet_aborts_within_deadline():
    """The monitor threads on a shared fake clock: rank 1 never reports;
    once the clock passes the deadline both abort naming it (the fake
    clock's bound is exact: neither aborts before)."""
    kv = InMemoryKv()
    clock = FakeClock()
    conf = LivenessConfig(deadline_s=5.0, heartbeat_interval_s=1.0,
                          poll_interval_s=0.01)
    wds = [Watchdog(conf, rank=r, world=2, kv=kv, namespace="thr",
                    clock=clock, install_current=False).start()
           for r in range(2)]
    try:
        for _ in range(4):  # 4 fake seconds: rank 0 progresses
            wds[0].report("step")
            clock.t += 1.0
            time.sleep(0.05)
        assert not any(wd.aborted for wd in wds)
        clock.t += 2.0  # rank 1 frozen 6 fake seconds > the 5 s deadline
        wds[0].report("step")
        _until(lambda: all(wd.aborted for wd in wds), "both aborts")
        assert [wd.error.culprit for wd in wds] == [1, 1]
    finally:
        for wd in wds:
            wd.close()


def test_heartbeat_fault_site():
    kv = InMemoryKv()
    wd = Watchdog(FAST, rank=0, world=2, kv=kv, namespace="hb",
                  install_current=False)
    wd._tracker = PeerTracker()
    wd._tracker.observe(0, 0, "start", 0.0)
    base = stats.get("watchdog.heartbeat_faults")
    with faults.fault_plan({"watchdog.heartbeat": "first:1"}):
        wd.tick(now=0.0)  # the first publish fails by injection
        assert kv.get(wd._hb_key(0)) is None
        assert stats.get("watchdog.heartbeat_faults") == base + 1
        wd.tick(now=0.2)  # past the interval: publishes
        hb = json.loads(kv.get(wd._hb_key(0)))
        assert hb == {"rank": 0, "stage": "start", "progress": 0}


# --------------------------------------------------------------------------- #
# hang injection
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("text,hang,first,at", [
    ("hang:first:2", True, 2, ()), ("hang:at:3,5", True, 0, (3, 5)),
    ("first:1", False, 1, ())])
def test_hang_spec_parse(text, hang, first, at):
    spec = FaultSpec.parse(text)
    assert (spec.hang, spec.fail_first, spec.at) == (hang, first, at)


def test_hang_spec_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultSpec.parse("freeze:1")


def test_hang_interrupted_by_watchdog():
    """A hung site on another thread ends with the structured error once
    the watchdog (fake clock) trips."""
    clock = FakeClock()
    conf = LivenessConfig(deadline_s=5.0, heartbeat_interval_s=1.0,
                          poll_interval_s=0.01)
    wd = Watchdog(conf, rank=0, world=1, clock=clock).start()
    got = {}

    def run():
        try:
            faults.inject("train.step")
        except DistributedStallError as e:
            got["err"] = e

    try:
        with faults.fault_plan({"train.step": "hang:first:1"}):
            t = threading.Thread(target=run, daemon=True)
            t.start()
            _until(lambda: stats.get("faults.hung.train.step") >= 1, "hang")
            assert t.is_alive()
            clock.t += 6.0
            t.join(WAIT_S)
            assert not t.is_alive()
            assert got["err"].culprit == 0 and got["err"].kind == "local"
    finally:
        wd.close()
        faults.clear()


def test_hang_released_without_watchdog():
    with faults.fault_plan({"x.y": "hang:first:1"}):
        done = threading.Event()

        def run():
            faults.inject("x.y")  # hangs until released
            done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert not done.wait(0.2)
        faults.release_hangs()
        assert done.wait(WAIT_S)


def test_prefetcher_get_interrupted_by_abort():
    """A consumer blocked on a stalled producer's queue unblocks with the
    structured error within one poll slice."""
    from paddlebox_tpu_torch.train.trainer import _FeedPrefetcher

    hold = threading.Event()

    def gen():
        hold.wait(WAIT_S)  # the stalled producer
        yield "never"

    wd = Watchdog(FAST, rank=0, world=1).start()
    pf = _FeedPrefetcher(gen(), depth=1)
    try:
        wd.abort(DistributedStallError(
            culprit=0, stage="feed", kind="local", age_s=9.9, progress=0,
            detected_by=0))
        with pytest.raises(DistributedStallError):
            next(pf)
    finally:
        hold.set()
        wd.close()
        pf.close()


def test_current_registry_and_beat():
    assert current() is None
    beat("feed")  # a no-op without a watchdog
    wd = Watchdog(FAST, rank=0, world=1).start()
    try:
        assert current() is wd
        _, p0 = wd.state()
        beat("shuffle")
        stage, p1 = wd.state()
        assert stage == "shuffle" and p1 == p0 + 1
    finally:
        wd.close()
    assert current() is None


# --------------------------------------------------------------------------- #
# KvChannel over simulated ranks
# --------------------------------------------------------------------------- #
@pytest.fixture
def kv():
    return InMemoryKv()


def _channel(kv, name, **kw):
    """Rank 0's view of a 3-process channel."""
    ch = host_plane.KvChannel(name, kv=kv, rank=0, world=3, **kw)
    ch.POLL_S = 0.05
    return ch


def _peer_payload(x: np.ndarray, codec: str = "varint") -> str:
    return base64.b64encode(
        host_plane._encode_array(np.ascontiguousarray(x), codec)
    ).decode("ascii")


def test_kvchannel_timeout_names_missing_keys(kv):
    ch = _channel(kv, "plan-7", timeout_s=0.4)
    kv.set("pbox_hp/plan-7/0/1", _peer_payload(np.asarray([6], np.int64)))
    with pytest.raises(host_plane.HostPlaneTimeout) as ei:
        ch.allgather(np.asarray([5], dtype=np.int64))
    err = ei.value
    assert err.channel == "plan-7" and err.seq == 0
    assert [r for r, _ in err.missing] == [2]
    assert "pbox_hp/plan-7/0/2" in str(err)
    assert "process(es) [2]" in str(err)


def test_kvchannel_completes_when_peers_answer(kv):
    ch = _channel(kv, "plan-8", timeout_s=5.0)
    for r in (1, 2):
        kv.set(f"pbox_hp/plan-8/0/{r}", _peer_payload(np.asarray([r],
                                                                 np.int64)))
    out = ch.allgather(np.asarray([0], dtype=np.int64))
    np.testing.assert_array_equal(out, [[0], [1], [2]])
    ch.close()
    assert kv.get("pbox_hp/plan-8/0/0") is None  # close deletes its keys


def test_kvchannel_close_can_keep_the_last_key(kv):
    """close(keep_last=True) deletes all but the last sequence's key (a
    peer may still be reading it); close() then deletes that one too."""
    ch = _channel(kv, "plan-k", timeout_s=5.0)
    for s in range(3):
        for r in (1, 2):
            kv.set(f"pbox_hp/plan-k/{s}/{r}",
                   _peer_payload(np.asarray([r], np.int64)))
        ch.allgather(np.asarray([0], dtype=np.int64))
    assert kv.get("pbox_hp/plan-k/0/0") is None  # the gathers' GC window
    ch.close(keep_last=True)
    assert kv.get("pbox_hp/plan-k/1/0") is None
    assert kv.get("pbox_hp/plan-k/2/0") is not None
    ch.close()
    assert kv.get("pbox_hp/plan-k/2/0") is None


def test_kvchannel_gather_bytes_varlen(kv):
    ch = _channel(kv, "plan-b", timeout_s=5.0)
    kv.set("pbox_hp/plan-b/0/1",
           base64.b64encode(b"peer-one-longer-payload").decode())
    kv.set("pbox_hp/plan-b/0/2", base64.b64encode(b"p2").decode())
    assert ch.gather_bytes(b"mine") == [b"mine", b"peer-one-longer-payload",
                                        b"p2"]
    ch.close()


def test_kvchannel_codec_mismatch_fails_loudly(kv):
    """A legacy peer on a framed channel, and the mirror case, raise the
    codec error naming the peer."""
    bare = base64.b64encode(np.asarray([6], np.int64).tobytes()).decode()
    ch = _channel(kv, "plan-m", timeout_s=5.0, codec="varint")
    kv.set("pbox_hp/plan-m/0/1", bare)
    kv.set("pbox_hp/plan-m/0/2", _peer_payload(np.asarray([7], np.int64)))
    with pytest.raises(host_plane.HostPlaneCodecError) as ei:
        ch.allgather(np.asarray([0], dtype=np.int64))
    assert ei.value.rank == 1 and ei.value.channel == "plan-m"
    ch2 = _channel(kv, "plan-m2", timeout_s=5.0, codec="legacy")
    kv.set("pbox_hp/plan-m2/0/1", _peer_payload(np.asarray([6], np.int64)))
    kv.set("pbox_hp/plan-m2/0/2", bare)
    with pytest.raises(host_plane.HostPlaneCodecError):
        ch2.allgather(np.asarray([0], dtype=np.int64))


CODEC_ARRAYS = [
    np.asarray([[5, -3, 4095, 4095]], dtype=np.int32),
    np.asarray([1.5, -2.25], dtype=np.float32),
    np.asarray([0, (1 << 63)], dtype=np.uint64),
    np.asarray([200, 3, 3], dtype=np.uint8),
    np.zeros((0,), dtype=np.int64),
]


@pytest.mark.parametrize("codec", ["varint", "raw", "legacy"])
@pytest.mark.parametrize("i", range(len(CODEC_ARRAYS)))
def test_kvchannel_frames_equal_the_reference(codec, i):
    """Every codec frames every dtype byte for byte as the reference, and
    each package decodes the other's frame."""
    x = CODEC_ARRAYS[i]
    frame = host_plane._encode_array(x, codec)
    assert frame == ref_host_plane._encode_array(x, codec)
    for dec in (host_plane._decode_array, ref_host_plane._decode_array):
        back = dec(frame, x, codec, "c", 0, 1)
        assert back.dtype == x.dtype
        np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("codec", ["varint", "raw", "legacy"])
def test_kvchannel_codec_roundtrip_all_modes(kv, codec):
    for x in CODEC_ARRAYS[:3]:
        name = f"plan-c-{codec}-{x.dtype}"
        ch = _channel(kv, name, timeout_s=5.0, codec=codec)
        for r in (1, 2):
            kv.set(f"pbox_hp/{name}/0/{r}",
                   _peer_payload(x + x.dtype.type(r), codec))
        out = ch.allgather(x)
        assert out.dtype == x.dtype
        np.testing.assert_array_equal(out[0], x)
        np.testing.assert_array_equal(out[2], x + x.dtype.type(2))
        ch.close()


def test_kvchannel_records_collective_digest(kv):
    from paddlebox_tpu_torch.telemetry import flight

    rec = flight.reset_for_tests()
    ch = _channel(kv, "plan-w", timeout_s=5.0)
    for s in range(2):
        for r in (1, 2):
            kv.set(f"pbox_hp/plan-w/{s}/{r}",
                   _peer_payload(np.asarray([r], np.int64)))
        ch.allgather(np.asarray([0], dtype=np.int64))
    digests = [r for r in rec.snapshot()
               if r["kind"] == "collective" and r.get("channel") == "plan-w"]
    assert [(d["seq"], d["op"], d["rank"]) for d in digests] == [
        (0, "allgather", 0), (1, "allgather", 0)]
    ch.close()
    flight.reset_for_tests()


def test_kvchannel_two_deep_delete_window(kv):
    ch = _channel(kv, "plan-g", timeout_s=5.0)
    for s in range(4):
        for r in (1, 2):
            kv.set(f"pbox_hp/plan-g/{s}/{r}",
                   _peer_payload(np.asarray([r], np.int64)))
        ch.allgather(np.asarray([0], dtype=np.int64))
    # posting s deleted s - 2: only the last two sequences remain
    assert [kv.get(f"pbox_hp/plan-g/{s}/0") is not None
            for s in range(4)] == [False, False, True, True]
    ch.close()
    assert kv.get("pbox_hp/plan-g/3/0") is None


def test_kvchannel_threads_as_ranks(kv):
    """Three channels on threads, one a rank: every rank gets every
    payload in rank order, over several sequences."""
    outs = {}

    def rank(r):
        ch = host_plane.KvChannel("plan-t", kv=kv, rank=r, world=3,
                                  timeout_s=WAIT_S)
        outs[r] = [ch.allgather(np.asarray([r * 10 + s], np.int64))
                   for s in range(3)]

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
    for r in range(3):
        for s in range(3):
            np.testing.assert_array_equal(outs[r][s][:, 0],
                                          [s, 10 + s, 20 + s])


def test_kvchannel_wait_interrupted_by_watchdog_abort(kv):
    wd = Watchdog(FAST, rank=0, world=1).start()
    ch = _channel(kv, "plan-9", timeout_s=30.0)
    try:
        wd.abort(DistributedStallError(
            culprit=2, stage="step", kind="peer", age_s=9.0, progress=4,
            detected_by=0))
        t0 = time.monotonic()
        with pytest.raises(DistributedStallError):
            ch.allgather(np.asarray([1], dtype=np.int64))
        assert time.monotonic() - t0 < 5.0  # nowhere near the 30 s timeout
    finally:
        wd.close()


def test_kvchannel_default_timeout_resolution(kv, monkeypatch):
    assert _channel(kv, "a").timeout_s == flags.hostplane_timeout_s
    monkeypatch.setenv("PADDLEBOX_TORCH_HOSTPLANE_TIMEOUT_S", "123.0")
    assert _channel(kv, "b").timeout_s == 123.0
    conf = LivenessConfig(deadline_s=5.0, heartbeat_interval_s=1.0,
                          poll_interval_s=0.5, hostplane_timeout_s=42.0)
    wd = Watchdog(conf, rank=0, world=1).start()
    try:  # the active watchdog's LivenessConfig outranks the flag
        assert _channel(kv, "c").timeout_s == 42.0
    finally:
        wd.close()


def test_kvchannel_allgather_fault_site(kv):
    with faults.fault_plan({"hostplane.allgather": "first:1"}):
        ch = _channel(kv, "plan-f", timeout_s=1.0)
        with pytest.raises(faults.FaultInjected):
            ch.allgather(np.asarray([1], dtype=np.int64))


def test_kvchannel_outside_a_job_raises():
    with pytest.raises(RuntimeError, match="multi-process job"):
        host_plane.KvChannel("orphan")


def test_store_kv_over_a_tcpstore():
    """StoreKv keeps the KV contract on a real TCPStore (127.0.0.1): a
    missing key reads None at once, set overwrites, delete is
    idempotent."""
    import datetime

    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=30),
                          wait_for_workers=False)
    skv = host_plane.StoreKv(store)
    t0 = time.monotonic()
    assert skv.get("absent") is None
    assert time.monotonic() - t0 < 5.0
    skv.set("k", "one")
    skv.set("k", "two")
    assert skv.get("k") == "two"
    skv.delete("k")
    skv.delete("k")
    assert skv.get("k") is None
    ch = host_plane.KvChannel("solo", kv=skv, rank=0, world=1, timeout_s=5.0)
    np.testing.assert_array_equal(ch.allgather(np.arange(3)), [[0, 1, 2]])


# --------------------------------------------------------------------------- #
# LivenessConfig and for_trainer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(deadline_s=0.0), dict(deadline_s=10.0, heartbeat_interval_s=10.0),
    dict(poll_interval_s=0.0)])
def test_liveness_config_validation(kw):
    with pytest.raises(ValueError):
        LivenessConfig(**kw)


def test_liveness_config_from_flags(monkeypatch):
    monkeypatch.setenv("PADDLEBOX_TORCH_LIVENESS_DEADLINE_S", "77.0")
    monkeypatch.setenv("PADDLEBOX_TORCH_LIVENESS_HEARTBEAT_S", "7.0")
    conf = LivenessConfig.from_flags()
    assert conf.deadline_s == 77.0 and conf.heartbeat_interval_s == 7.0


def test_for_trainer_disabled_and_single_process():
    assert wmod.for_trainer(None, "x") is None
    assert wmod.for_trainer(LivenessConfig(
        deadline_s=5.0, heartbeat_interval_s=1.0, poll_interval_s=0.5,
        enabled=False), "x") is None
    wd = wmod.for_trainer(FAST, "x")
    assert wd is not None and wd.kv is None and wd.world == 1
    # single-process watchdogs never arm the hard-exit reaper
    assert wd._hard_exit_grace_s is None


# --------------------------------------------------------------------------- #
# the single-chip trainer under liveness
# --------------------------------------------------------------------------- #
def _small_world(tmp_path, liveness):
    import torch

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import (
        make_synth_config,
        write_synth_files,
    )
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    files = write_synth_files(str(tmp_path / "data"), n_files=2,
                              ins_per_file=64, n_sparse_slots=3,
                              vocab_per_slot=60, dense_dim=2, seed=9)
    ds = PadBoxSlotDataset(make_synth_config(3, 2, 16, 8), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(16, 8),
                   device="cpu")
    table = SparseTable(tconf, seed=0, device="cpu")
    # the serial feed: no producer thread reports "feed" past the hang
    trainer = Trainer(model, tconf, TrainerConfig(
        auc_buckets=1 << 10, liveness=liveness, prefetch_batches=0),
        device="cpu")
    return ds, table, trainer


@pytest.mark.parametrize("rollback", [False, True])
def test_single_chip_step_hang_aborts(tmp_path, monkeypatch, rollback):
    """A hung step of the single-chip trainer ends with a local stall
    naming the process and the step stage; with rollback_on_abort and a
    checkpointer, the pass rolls back first.  The watchdog's clock is the
    real one until the hang begins, then jumps past the 5 s deadline (a
    hang interrupt hook moves it), so no test time waits on a deadline."""
    from paddlebox_tpu_torch.train import AutoCheckpointer
    from paddlebox_tpu_torch.train.trainer import PassRolledBack

    real = wmod.for_trainer
    offset = [0.0]

    def jumping_clock(conf, namespace):
        wd = real(conf, namespace)
        wd._clock = lambda: time.monotonic() + offset[0]
        return wd

    def jump():  # polled by the hung site
        offset[0] = 1000.0

    conf = LivenessConfig(deadline_s=5.0, heartbeat_interval_s=1.0,
                          poll_interval_s=0.01, rollback_on_abort=rollback)
    ds, table, trainer = _small_world(tmp_path, conf)
    unhook = faults.register_hang_interrupt(jump)
    try:
        if rollback:
            trainer.checkpointer = AutoCheckpointer(str(tmp_path / "ckpt"),
                                                    job_id="stall")
            table.begin_pass(ds.unique_keys())
            trainer.train_from_dataset(ds, table)
            table.end_pass()
            trainer.checkpointer.after_pass(0, table, trainer)
        monkeypatch.setattr(wmod, "for_trainer", jumping_clock)
        base = stats.get("train.stall_aborts")
        faults.install(faults.FaultPlan({"train.step": "hang:at:1"}))
        table.begin_pass(ds.unique_keys())
        want = PassRolledBack if rollback else DistributedStallError
        with pytest.raises(want) as ei:
            trainer.train_from_dataset(ds, table)
        assert stats.get("train.stall_aborts") == base + 1
        if rollback:
            assert not table._in_pass  # aborted and restored
        else:
            err = ei.value
            assert (err.culprit, err.kind, err.stage) == (0, "local", "step")
    finally:
        unhook()
        faults.clear()
        ds.close()
        if table._in_pass:
            table.abort_pass()
        table.close()


# --------------------------------------------------------------------------- #
# one real job: a frozen rank names itself everywhere
# --------------------------------------------------------------------------- #
def test_frozen_rank_aborts_both_ranks_naming_it(tmp_path):
    from paddlebox_tpu_torch.data.synth import write_synth_files
    from paddlebox_tpu_torch.launch import launch

    deadline = 5.0
    files = write_synth_files(str(tmp_path / "data"), n_files=1,
                              ins_per_file=64, n_sparse_slots=3,
                              vocab_per_slot=30, dense_dim=2, seed=4)
    spec = tmp_path / "files.json"
    spec.write_text(json.dumps(files))
    logs = tmp_path / "logs"
    rc = launch([os.path.join(HERE, "_torch_stall_child.py"), str(tmp_path),
                 str(deadline), "1", str(spec)], nproc=2,
                positions_per_proc=1, device="cpu", backend="gloo",
                log_dir=str(logs), job_timeout_s=120.0)
    text = "\n".join((logs / f"rank{r}.log").read_text()[-3000:]
                     for r in range(2))
    assert rc == 7, text
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["culprit"] == 1 and got["stage"] == "step", (r, got)
        assert got["t_abort"] - got["t_start"] < 2 * deadline, (r, got)
        assert "STALL-ABORT" in (logs / f"rank{r}.log").read_text()
