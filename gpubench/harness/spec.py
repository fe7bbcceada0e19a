"""Everything a cell is made of, found by name under the benchmark's own
directory:

  * ``BENCHMARK.json`` at the checkout's root: the cell (a ``workloads``
    entry) and the metrics it reports;
  * ``configs/<config>.json``: the model, table and trainer settings;
  * ``traffic/<traffic>.json``: the generator's parameters;
  * ``metrics/<metric>.py``: one reader a metric, ``read(ctx)``;
  * ``reference/<model>.py`` and ``counts/<model>.py``: the plain model
    and its operation count;
  * ``checks/<cell>.json``: the limits of the correctness comparison.

A new configuration, mix, metric or cell is a new file and a new entry;
no file here changes for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "checks", f"{cell_name}.json"))


def reference_model(model: str):
    """``reference/<model>.py``: ``param_shapes(config)`` and ``logits``."""
    return importlib.import_module(f"reference.{model}")


def model_counts(model: str):
    """``counts/<model>.py``: ``flops_per_sample(config)``."""
    return importlib.import_module(f"counts.{model}")


def metric_reader(name: str):
    """``metrics/<name>.py`` (a name may hold dots, so it loads by path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_gpubench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The cell's metric entries: its per-layer ones in a traced run, its
    end-to-end ones otherwise.  An entry without ``workloads`` belongs to
    every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
