"""The port's fleet view against the reference (telemetry/fleet.py;
reference cases: tests/test_telemetry.py's fleet gathers): merged
snapshots and the rank-0 line equal the reference's on the same
snapshots, from either package's registries; the gather over an
``InMemoryKv`` with threads as ranks converges on one view and names a
missing rank on timeout.
"""

import threading

import pytest

from paddlebox_tpu.telemetry import fleet as ref_fleet
from paddlebox_tpu.telemetry.metrics import MetricRegistry as RefRegistry
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.parallel.watchdog import InMemoryKv
from paddlebox_tpu_torch.telemetry import fleet
from paddlebox_tpu_torch.telemetry.metrics import MetricRegistry
from paddlebox_tpu_torch.utils.profiler import STAGE_BUCKETS
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401


def _fill(reg, rank, slow=1):
    """One rank's metrics: stage timings (rank ``slow`` the slow one), a
    counter, a labeled gauge, a histogram only some ranks have."""
    h = reg.histogram("trainer.stage_seconds", buckets=STAGE_BUCKETS)
    for i in range(10):
        h.observe((0.2 if rank == slow else 0.001) * (1 + i / 10),
                  stage="step")
        h.observe(0.003 * (rank + 1), stage="plan")
    reg.counter("train.steps").inc(10 + rank)
    reg.counter("faults.injected.x").inc(0)
    reg.gauge("watchdog.staleness_s").set(0.5 * (rank + 1), rank=str(rank))
    if rank == 0:
        reg.histogram("hostplane.gather_seconds").observe(0.02,
                                                          channel="plan")
    snap = reg.snapshot()
    snap["rank"] = rank
    return snap


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("registry", ["port", "reference"])
def test_merge_and_format_equal_the_reference(world, registry):
    make = MetricRegistry if registry == "port" else RefRegistry
    snaps = [_fill(make(), r) for r in range(world)]
    merged = fleet.merge_snapshots(snaps)
    assert merged == ref_fleet.merge_snapshots(snaps)
    assert fleet.format_fleet_view(merged, prefix="fleet pass step=4") == \
        ref_fleet.format_fleet_view(merged, prefix="fleet pass step=4")
    assert merged["world"] == world
    assert merged["counters"]["train.steps"]["per_rank"] == [
        float(10 + r) for r in range(world)]


def test_port_and_reference_snapshots_have_one_shape():
    """The same metrics recorded by both packages' registries merge to the
    same view (the snapshot format is shared)."""
    port = fleet.merge_snapshots([_fill(MetricRegistry(), r)
                                  for r in range(2)])
    ref = ref_fleet.merge_snapshots([_fill(RefRegistry(), r)
                                     for r in range(2)])
    assert port == ref


def test_gather_fleet_snapshot_two_ranks_merge():
    kv = InMemoryKv()
    regs = [MetricRegistry() for _ in range(2)]
    for rank, reg in enumerate(regs):
        h = reg.histogram("trainer.stage_seconds", buckets=STAGE_BUCKETS)
        for _ in range(10):
            h.observe(0.001 if rank == 0 else 0.2, stage="step")
        reg.counter("train.steps").inc(10)
        reg.gauge("watchdog.staleness_s").set(0.5 * (rank + 1),
                                              rank=str(rank))
    merged = [None, None]

    def gather(seq):
        def run(rank):
            merged[rank] = telemetry.gather_fleet_snapshot(
                kv, rank=rank, world=2, seq=seq, registry=regs[rank],
                timeout_s=30.0)

        ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)

    gather(7)
    assert merged[0] == merged[1]  # both ranks converge on one view
    m = merged[0]
    assert m["world"] == 2
    assert m["counters"]["train.steps"]["sum"] == 20
    assert m["counters"]["train.steps"]["per_rank"] == [10.0, 10.0]
    h = m["histograms"]["trainer.stage_seconds{stage=step}"]
    assert h["count"] == 20 and h["p99"] > 0.05
    assert h["per_rank_p99"][1] > h["per_rank_p99"][0]  # names the slow one
    line = telemetry.format_fleet_view(m)
    for part in ("world=2", "trainer.stage_seconds{stage=step}",
                 "per_rank_p99_ms=", "train.steps=20"):
        assert part in line
    # the next sequence converges again, and each rank deleted its key of
    # the previous one
    gather(8)
    assert merged[0] == merged[1] == m
    assert all(kv.get(fleet._key("fleet", 7, r)) is None for r in range(2))


def test_gather_fleet_snapshot_timeout_names_missing_rank():
    kv = InMemoryKv()
    with pytest.raises(telemetry.FleetGatherTimeout) as ei:
        telemetry.gather_fleet_snapshot(
            kv, rank=0, world=2, seq=0, registry=MetricRegistry(),
            timeout_s=0.2, poll_s=0.01)
    assert ei.value.missing == [1]
    assert "rank(s) [1]" in str(ei.value)


def test_log_fleet_view_returns_the_line(caplog):
    merged = fleet.merge_snapshots([_fill(MetricRegistry(), r)
                                    for r in range(2)])
    with caplog.at_level("INFO"):
        line = telemetry.log_fleet_view(merged, prefix="p")
    assert line.startswith("[p] world=2") and line in caplog.text
