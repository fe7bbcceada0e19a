"""The yardstick's arithmetic against hand-worked values."""

import numpy as np
import pytest
import torch

from conftest import CHUNKED, SMALL
from counts import ctr_dnn, deepfm, peaks, sparse_kernels
from harness import spec, traffic, world


def test_flops_by_hand():
    # CTR-DNN: 26 * 11 + 13 = 299 inputs, 512-256-128-32-1; 3 x 2 x MACs
    macs = 299 * 512 + 512 * 256 + 256 * 128 + 128 * 32 + 32 * 1
    assert ctr_dnn.flops_per_sample(spec.config("ctr_dnn-criteo")) == 6 * macs
    assert 6 * macs == 1_926_336
    # DeepFM: 26 * 12 + 13 = 325 inputs, 400-400-400-1, the FM's first
    # order 325 -> 1, its second order 4 * 26 * 10 forward
    deep = 6 * (325 * 400 + 400 * 400 + 400 * 400 + 400)
    assert deepfm.flops_per_sample(spec.config("deepfm-criteo")) == (
        deep + 6 * 325 + 3 * 4 * 26 * 10) == 2_707_470


def test_peaks():
    assert peaks.matmul_peak("float32", False) == 67e12
    assert peaks.matmul_peak("", True) == 495e12
    assert peaks.matmul_peak("bfloat16", False) == 989e12
    with pytest.raises(ValueError):
        peaks.matmul_peak("int8", False)


def test_kernel_bytes_by_hand():
    # 53 248 indices of 10-float rows, 30 000 distinct rows
    assert sparse_kernels.pull_bytes(53_248, 10, 30_000) == (
        53_248 * 4 + 30_000 * 40 + 53_248 * 40)
    assert sparse_kernels.scatter_add_bytes(53_248, 10, 53_248) == (
        53_248 * 4 + 53_248 * 40 + 2 * 53_248 * 40)


@pytest.mark.parametrize("extra", [{}, CHUNKED])
def test_step_bytes_match_the_plans(tmp_path, extra):
    """The distinct rows the bytes count assumes are the ones the program's
    plans name, batch by batch of a pass."""
    c = spec.cell(spec.benchmark(), "ctr_dnn-criteo.zipf-pass128")
    cfg, mix = spec.config(c["config"]), spec.traffic(c["traffic"])
    for k, v in dict(SMALL, **extra).items():
        (mix if k in mix else cfg)[k] = v
    data = traffic.generate(cfg, mix, 17, str(tmp_path))
    w = world.World(cfg, data, 17, "cpu")
    try:
        table = w.table
        table.begin_pass(w.censuses[0])
        rows, n_live = table.values.shape[0], w.censuses[0].shape[0]
        b, cap = int(cfg["batch_size"]), int(cfg["batch_key_capacity"])
        width = table.values.shape[1]
        for i, batch in enumerate(w.datasets[0].batches()):
            plan = table.plan_batch(batch)
            keys = data.chunks[0].batch_keys(i * b, (i + 1) * b)
            pull, push = sparse_kernels.step_bytes(keys, cap, width, n_live,
                                                   rows)
            d_pull = torch.unique(torch.from_numpy(plan.idx)).shape[0]
            d_push = torch.unique(torch.from_numpy(plan.uniq_idx)).shape[0]
            assert pull == sparse_kernels.pull_bytes(cap, width, d_pull)
            assert push == sparse_kernels.scatter_add_bytes(cap, width, d_push)
        table.end_pass()
    finally:
        w.close()
