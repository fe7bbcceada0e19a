"""A whole run of each cell on the CPU at a small size: the result line
has the contract's keys, the reference agrees with the port, a run whose
timed path is broken comes out not correct, and nothing loads JAX."""

import json
import os
import subprocess
import sys

import pytest

import readings
import run
from conftest import BENCH_DIR, CELLS, CHUNKED, ROOT, SMALL
from harness import spec

TOP = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


def _cpu_run(cell, trace=False, faults=(), chunked=False):
    over = dict(SMALL, **CHUNKED) if chunked else SMALL
    return run.run_cell(cell, 2**31 + 101, 0.5, trace, device="cpu",
                        faults=faults, overrides=over)


@pytest.mark.parametrize("cell,chunked", [(CELLS[0], False),
                                          (CELLS[1], False),
                                          (CELLS[0], True)])
def test_sound_run_is_correct_with_the_contract_keys(cell, chunked):
    out = _cpu_run(cell, chunked=chunked)
    assert set(out) == TOP | {"pass_seconds"}
    assert list(out)[-2] == "checks"
    assert set(out["device"]) == DEVICE
    want = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell,
                                               False)}
    assert set(out["metrics"]) == want == {"train_samples_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_run_keys():
    out = _cpu_run(CELLS[0], trace=True, chunked=True)
    assert set(out) == TOP | {"breakdown", "pass_seconds"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    declared = {m["name"] for m in spec.benchmark()["per_layer"]}
    # the CPU has no device trace: the device readers find nothing and the
    # line leaves them out
    assert set(out["metrics"]) <= declared
    assert "kernels.step_roofline" not in out["metrics"]
    assert out["correct"]


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch", "cold_hits"])
@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_broken_timed_path_is_not_correct(cell, fault):
    """A step that returns its state unchanged, and half of every batch
    left out with the mean over the rest, each fail the check."""
    out = _cpu_run(cell, faults=(fault,))
    assert not out["correct"], out["checks"]


def test_reference_agrees_with_the_port_on_cpu():
    r = readings.reading(CELLS[1], 5, device="cpu", overrides=SMALL)
    for k in ("loss1_gap", "grad1_gap", "change3_gap", "rows6_gap"):
        assert r[k] < 1e-6, (k, r[k])
    assert r["counters_gap"] == 0.0
    for k in ("change6_worst", "moment6_worst"):
        assert r["extra"][k] < 1e-6, (k, r["extra"][k])
    assert r["extra"]["warm_hits"] > 0 and r["extra"]["warm_steps"] == 3


def test_control_reads_apart_on_cpu():
    """The port's bfloat16 tower against the float32 reference."""
    r = readings.reading(CELLS[0], 5, "bf16", device="cpu", overrides=SMALL)
    assert r["loss1_gap"] > 1e-5 and r["grad1_gap"] > 1e-4


def test_cli_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_harness_loads_no_jax():
    """A process that imports the harness and drives a small run loads no
    module whose top-level name is jax, jaxlib, flax or paddlebox_tpu."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{BENCH_DIR!r}, {ROOT!r}]\n"
        "import run, readings\n"
        "from harness import check, spec, trace, traffic, world\n"
        "bench = spec.benchmark()\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        f"run.run_cell({CELLS[0]!r}, 3, 0.2, False, device='cpu', "
        f"overrides={SMALL!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "paddlebox_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "paddlebox_tpu"}
