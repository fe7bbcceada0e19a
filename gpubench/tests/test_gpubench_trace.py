"""The trace reduction and the readers that take it, on hand-made
Chrome-trace events (microseconds)."""

import pytest

from harness.trace import reduce_trace
from harness import spec


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _x("user_annotation", "gpubench.trace_stretch", 0, 1000),
    _x("user_annotation", "gpubench.begin_pass", 0, 200),
    _x("user_annotation", "gpubench.train_steps", 200, 700),
    _x("user_annotation", "gpubench.end_pass", 900, 100),
    _x("kernel", "pull_rows_kernel(float2 const*)", 250, 50),
    _x("kernel", "gemm", 280, 40),            # overlaps the pull
    _x("gpu_memcpy", "Memcpy HtoD", 100, 20),
    _x("kernel", "scatter_add_rows_kernel(float2*)", 600, 100),
    _x("kernel", "late", 990, 50),            # cut at the stretch's end
    _x("gpu_user_annotation", "gpubench.pull_rows", 250, 50),
    _x("gpu_user_annotation", "gpubench.scatter_add_rows", 600, 100),
]


def test_reduce_trace_by_hand():
    r = reduce_trace(EVENTS)
    assert r["window_s"] == pytest.approx(1e-3)
    # union: [100,120] [250,320] [600,700] [990,1000] = 20 + 70 + 100 + 10
    assert r["busy_s"] == pytest.approx(200e-6)
    assert r["ranges"] == {"gpubench.pull_rows": pytest.approx(50e-6),
                           "gpubench.scatter_add_rows": pytest.approx(100e-6)}
    idle = dict(r["idle_gaps"])
    # gaps by their midpoint: [0,100] and [120,250] in begin_pass,
    # [320,600] and [700,990] in train_steps
    assert idle["begin_pass"] == pytest.approx(230e-6)
    assert idle["train_steps"] == pytest.approx(570e-6)
    assert r["device_ops"][0][0].startswith("scatter_add_rows_kernel")


def test_device_readers():
    r = reduce_trace(EVENTS)
    idle = spec.metric_reader("device.idle_pct").read({"trace": r})
    assert idle == pytest.approx(80.0)
    assert spec.metric_reader("device.idle_pct").read({"trace": None}) is None
    assert spec.metric_reader("kernels.step_roofline").read(
        {"trace": None}) is None
