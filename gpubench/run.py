"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the
``paddlebox_tpu_torch`` package.  The cell (a ``workloads`` entry) names a
configuration (``configs/``) and a traffic mix (``traffic/``).  Set-up makes
the data and the initial state from the seed, loads them into the program,
trains the check's two passes (a cold one and a warm one, three steps
each) and one warm-up pass; the window then runs whole pass cycles for
``--seconds``.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones, read with a
profiler over whole passes of the window.  After the window the plain
reference replays the check's six steps, and the comparison decides
``correct``.  The last line of standard output is the result as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

It needs as many CUDA devices as the cell asks for, and exits non-zero
with no result without them, or if the run loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# build and kernel caches at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, ".gpubench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                 "torch_extensions")
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "paddlebox_tpu")
# whole pass cycles the trace covers: at least two, and every chunk once
MIN_TRACED_PASSES = 2


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", faults=(), overrides=None,
             bench: dict = None) -> dict:
    """One run of a cell; returns the result line's object.  ``faults``
    break the timed path (tests and the control's readings);
    ``overrides`` replace configuration or mix keys (the tests' small
    sizes).  Neither is reachable from the command line."""
    import torch

    from harness import check, spec, traffic, world
    from harness.trace import Tracer

    bench = bench or spec.benchmark()
    cell = spec.cell(bench, name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    for key, value in (overrides or {}).items():
        (mix if key in mix else cfg)[key] = value
    limits = spec.limits(name)
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    try:
        data = traffic.generate(cfg, mix, seed, os.path.join(tmp, "data"))
        w = world.World(cfg, data, seed, device, faults)
        prog = w.check_steps()
        check_s = prog.pop("read_s")
        w.warm_up()
        setup_s = time.perf_counter() - T_START - check_s
        tracer = None
        if trace:
            tracer = Tracer(1, max(MIN_TRACED_PASSES, len(data.chunks)), tmp,
                            device)
        win = w.window(seconds, tracer,
                       min_passes=1 + tracer.count if tracer else 1)
        cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if tracer is not None:
            tracer.finish()
        ctx = {
            "config": cfg, "cell": cell, "window": win, "setup_s": setup_s,
            "data": data, "trace": tracer.result if tracer else None,
            "flops_per_sample": spec.model_counts(cfg["model"])
            .flops_per_sample(cfg),
            "compute_dtype": str(w.model.compute_dtype or torch.float32)
            .replace("torch.", ""),
            "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        }
        metrics = {}
        for m in spec.metrics_of(bench, name, trace):
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        w.close()
        del w.table, w.trainer, w.model, w.datasets
        if cuda:
            torch.cuda.empty_cache()
        ref = check.run_reference(w, prog)
        correct, checks = check.judge(check.numbers(w, prog, ref)[0], limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win["steps"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.result["busy_s"]
        dev["window_s"] = tracer.result["window_s"]
        out["breakdown"] = {"device_ops": tracer.result["device_ops"],
                            "idle_gaps": tracer.result["idle_gaps"]}
    out["checks"] = checks
    out["pass_seconds"] = win["pass_seconds"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    chips = int(spec.cell(spec.benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: the cell needs {chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    passes = out.pop("pass_seconds")
    print("pass seconds: " + " ".join(f"{s:.4f}" for s in passes),
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    odd = [k for k, m in out["metrics"].items()
           if not math.isfinite(m["value"])]
    if odd:
        print(f"gpubench: metrics not finite: {', '.join(odd)}",
              file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
