"""Every port example (``examples/*_torch.py``) run as a user runs it, on the
CPU (``--cpu``) at its smallest flags, with torch on one thread: each must
exit 0 and print finite losses and AUCs (``bench_store_torch.py``: its
table of seconds).  The multi-chip CTR-DNN example also runs as a job of
two ranks under the port's launcher.  On the card: tests/test_torch_cuda.py
and the H100 runs that PERF.md records.
"""

import ast
import glob
import math
import os
import re
import subprocess
import sys

import pytest

from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples")
LAUNCH = [sys.executable, "-m", "paddlebox_tpu_torch.launch", "--nproc", "2",
          "--device", "cpu", "--backend", "gloo"]

NUM = r"([^\s,;|]+)"
LOSS_AUC = (rf"\bloss={NUM}", rf"\bauc={NUM}")
# (argv after the interpreter, the patterns whose every capture must be a
# finite number; each pattern must match at least once)
CASES = {
    "train_criteo": ([f"{EX}/train_criteo_torch.py", "--lines", "2048",
                      "--passes", "2", "--batch-size", "512"],
                     LOSS_AUC + (rf"samples/s={NUM}", rf"features: {NUM}")),
    "train_ctr_dnn": ([f"{EX}/train_ctr_dnn_torch.py", "--days", "2",
                       "--passes", "2", "--ins-per-pass", "1024"],
                      LOSS_AUC + (rf"shrink evicted {NUM}",)),
    "train_ctr_dnn_multichip": ([f"{EX}/train_ctr_dnn_torch.py",
                                 "--multichip", "--days", "1", "--passes",
                                 "2", "--ins-per-pass", "1024"], LOSS_AUC),
    "train_ctr_dnn_job": ([*LAUNCH[1:], f"{EX}/train_ctr_dnn_torch.py",
                           "--multichip", "--days", "1", "--passes", "2",
                           "--ins-per-pass", "1024"], LOSS_AUC),
    "train_longseq": ([f"{EX}/train_longseq_torch.py", "--passes", "1",
                       "--max-seq-len", "32", "--seq-mesh", "2"], LOSS_AUC),
    "bench_store": ([f"{EX}/bench_store_torch.py", "--max-exp", "6",
                     "--pass-keys", "100000", "--table-pass"],
                    (r"1,000,000 \| +([\d.]+)s \| +([\d.]+)s \| +([\d.]+)s "
                     r"\| +([\d.]+)",
                     rf"begin_pass\([\d,]+\)=([\d.]+)s end_pass=([\d.]+)s "
                     rf"flush=([\d.]+)s")),
    "serve_ctr": ([f"{EX}/serve_ctr_torch.py"],
                  LOSS_AUC + (r"scores: \[([^,\]]+)",)),
    "online_delivery": ([f"{EX}/online_delivery_torch.py", "--passes", "1"],
                        LOSS_AUC + (rf"score = {NUM}",)),
    "streaming_online": ([f"{EX}/streaming_online_torch.py", "--seconds",
                          "3"], LOSS_AUC + (rf"final served score: {NUM}",)),
    "day_loop": ([f"{EX}/day_loop_torch.py", "--days", "1", "--passes", "1"],
                 LOSS_AUC),
    "multi_scenario": ([f"{EX}/multi_scenario_torch.py", "--passes", "1",
                        "--stream-seconds", "2"], LOSS_AUC),
}


def _imported(path):
    """Every module a file imports, at any depth of its functions."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_examples_import_no_jax_and_nothing_of_the_reference():
    paths = sorted(glob.glob(os.path.join(EX, "*_torch.py")))
    assert len(paths) == 9
    for path in paths:
        for mod in _imported(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "paddlebox_tpu"), (
                path, mod)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(tmp_path, name):
    argv, patterns = CASES[name]
    # a job under the launcher passes --cpu on to every rank's program
    cmd = [sys.executable, *argv, "--cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               TMPDIR=str(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=150)
    out = proc.stdout
    assert proc.returncode == 0, (
        f"{name} rc={proc.returncode}\n{out[-3000:]}\n{proc.stderr[-3000:]}")
    for pat in patterns:
        found = re.findall(pat, out)
        assert found, f"{name}: nothing matched {pat!r} in\n{out[-3000:]}"
        for match in found:
            for text in (match if isinstance(match, tuple) else (match,)):
                value = float(text.replace(",", ""))
                assert math.isfinite(value), (name, pat, text)
