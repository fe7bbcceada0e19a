"""The benchmark's own tests: CPU tests of the harness at small sizes, and
card tests (marker ``cuda``) that skip without a CUDA device.

    python -m pytest -p no:cacheprovider gpubench/tests
"""

import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# a cell at a size a test run holds: the configuration's schema, a small
# pass, a narrow tower, the columns' vocabularies capped
with open(os.path.join(BENCH_DIR, "traffic", "zipf-pass128.json")) as _f:
    _VOCAB = json.load(_f)["vocab_per_column"]
SMALL = {"pass_instances": 4096, "batch_size": 256,
         "batch_key_capacity": 256 * 26, "model_args": {"hidden": [32, 16]},
         "vocab_per_column": [min(v, 3000) for v in _VOCAB]}
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = tuple(w["name"] for w in json.load(_f)["workloads"])
# the mix's lines in four chunks, one pass a chunk: the multi-chunk path
CHUNKED = {"chunks": 4, "files_per_chunk": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
