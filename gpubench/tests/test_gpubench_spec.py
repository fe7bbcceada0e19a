"""Every piece is found by name, and a new configuration, mix, metric and
cell dropped in as files and entries are found without an edit."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, CELLS, ROOT, SMALL
from harness import spec


def test_every_named_piece_is_found():
    bench = spec.benchmark()
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert os.path.normpath(os.path.join(ROOT, c["file"])) == \
            os.path.join(BENCH_DIR, "configs", f"{c['name']}.json")
        assert c["reduced"] == cfg["reduced"] and c["source"] == cfg["source"]
        spec.reference_model(cfg["model"]).param_shapes(cfg)
        assert spec.model_counts(cfg["model"]).flops_per_sample(cfg) > 0
    for w in bench["workloads"]:
        spec.traffic(w["traffic"])
        spec.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    assert [w["name"] for w in bench["workloads"]] == [
        "ctr_dnn-criteo.zipf-pass128", "deepfm-criteo.zipf-pass128"]


def test_a_new_piece_is_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    g = root / "gpubench"
    cfg = json.load(open(g / "configs" / "ctr_dnn-criteo.json"))
    cfg["table"]["hbm_cache_rows"] = 1 << 22
    json.dump(cfg, open(g / "configs" / "ctr_dnn-big.json", "w"))
    mix = json.load(open(g / "traffic" / "zipf-pass128.json"))
    mix["zipf_alpha"] = 1.1
    json.dump(mix, open(g / "traffic" / "zipf11.json", "w"))
    (g / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    shutil.copy(g / "checks" / f"{CELLS[0]}.json",
                g / "checks" / "ctr_dnn-big.zipf11.json")
    bench["workloads"].append({"name": "ctr_dnn-big.zipf11",
                               "config": "ctr_dnn-big", "traffic": "zipf11",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new.metric", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "Device",
                               "moves": "train_samples_per_s"})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(g)!r})\n"
        "from harness import spec\n"
        "b = spec.benchmark()\n"
        "c = spec.cell(b, 'ctr_dnn-big.zipf11')\n"
        "assert spec.config(c['config'])['table']['hbm_cache_rows'] == 1 << 22\n"
        "assert spec.traffic(c['traffic'])['zipf_alpha'] == 1.1\n"
        "assert spec.limits(c['name'])['counters_gap'] == 0.0\n"
        "names = [m['name'] for m in spec.metrics_of(b, c['name'], True)]\n"
        "assert 'new.metric' in names\n"
        "assert spec.metric_reader('new.metric').read({}) == 42.0\n"
        "print('found')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and "found" in p.stdout, p.stderr


def test_benchmark_json_keys():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "gpubench/run.py"]
    assert bench["paths"] == ["gpubench"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"train_samples_per_s", "setup_s"}
    for m in bench["per_layer"]:
        assert m["moves"] == "train_samples_per_s" and "workloads" not in m
    assert all(w["chips"] == 1 for w in bench["workloads"])


MMOE_REFERENCE = '''
import torch

from reference.common import cvm_features, mlp


def param_shapes(config):
    a = config["model_args"]
    d = (int(config["n_sparse_slots"]) * (2 + int(config["embedding_dim"]))
         + int(config["dense_dim"]))
    out = {}

    def chain(prefix, dims):
        for i in range(len(dims) - 1):
            out[f"{prefix}.{i}.weight"] = (dims[i + 1], dims[i])
            out[f"{prefix}.{i}.bias"] = (dims[i + 1],)

    for e in range(a["n_experts"]):
        chain(f"experts.{e}", [d, *a["expert_hidden"], a["expert_dim"]])
    for t in range(a["n_tasks"]):
        out[f"gates.{t}.weight"] = (a["n_experts"], d)
        out[f"gates.{t}.bias"] = (a["n_experts"],)
    for t in range(a["n_tasks"]):
        chain(f"towers.{t}", [a["expert_dim"], *a["tower_hidden"], 1])
    return out


def logits(params, pooled, dense, config, dtype=torch.float32):
    a = config["model_args"]
    b = pooled.shape[0]
    x = torch.cat([cvm_features(pooled, int(config["cvm_offset"]))
                   .reshape(b, -1), dense], dim=1)
    experts = torch.stack([
        mlp(params, f"experts.{e}", len(a["expert_hidden"]) + 1, x, dtype)
        for e in range(a["n_experts"])], dim=1)
    out = []
    for t in range(a["n_tasks"]):
        g = torch.softmax(x @ params[f"gates.{t}.weight"].t()
                          + params[f"gates.{t}.bias"], dim=-1)
        mixed = (g[:, :, None] * experts).sum(1)
        out.append(mlp(params, f"towers.{t}", len(a["tower_hidden"]) + 1,
                       mixed, dtype)[:, 0])
    return torch.stack(out, dim=1)
'''


def test_a_new_model_is_only_new_files(tmp_path):
    """A multi-task configuration (MMoE: experts, gates, a tower and a
    label a task) runs and is judged from its own files alone: the
    configuration, its plain reference, its count, its limits and the
    cell's entry."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    g = root / "gpubench"
    cfg = json.load(open(g / "configs" / "ctr_dnn-criteo.json"))
    cfg.update(model="mmoe", program_model="MMoE",
               label_slots=["click", "conv"],
               model_args={"n_tasks": 2, "n_experts": 3,
                           "expert_hidden": [16], "expert_dim": 8,
                           "tower_hidden": [8]})
    json.dump(cfg, open(g / "configs" / "mmoe-small.json", "w"))
    (g / "reference" / "mmoe.py").write_text(MMOE_REFERENCE)
    (g / "counts" / "mmoe.py").write_text(
        "def flops_per_sample(config):\n    return 1\n")
    shutil.copy(g / "checks" / f"{CELLS[0]}.json",
                g / "checks" / "mmoe-small.zipf-pass128.json")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "mmoe-small.zipf-pass128",
                               "config": "mmoe-small",
                               "traffic": "zipf-pass128", "chips": 1,
                               "why": "test"})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    small = dict(SMALL)
    small.pop("model_args")
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(g)!r}, {str(root)!r}, {ROOT!r}]\n"
        "import run\n"
        "kw = dict(device='cpu', overrides=" + repr(small) + ")\n"
        "out = run.run_cell('mmoe-small.zipf-pass128', 11, 0.2, False, **kw)\n"
        "assert out['correct'], out['checks']\n"
        "bad = run.run_cell('mmoe-small.zipf-pass128', 11, 0.2, False,\n"
        "                   faults=('half_batch',), **kw)\n"
        "assert not bad['correct'], bad['checks']\n"
        "print('judged')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0 and "judged" in p.stdout, p.stderr[-3000:]
