"""The generator: the same seed gives the same bytes, the text parses back
to the keys it was made from, and the census matches its reckoning."""

import json
import os

import numpy as np
import pytest

from harness import spec, traffic


# the flat mix: uniform in each column, four chunks a pass each
FLAT = {"dist": "uniform", "chunks": 4, "files_per_chunk": 4}


def _gen(tmp_path, mix_name, seed, **over):
    cfg = spec.config("ctr_dnn-criteo")
    mix = spec.traffic("zipf-pass128")
    if mix_name == "flat":
        mix.update(FLAT)
    for k, v in over.items():
        (mix if k in mix else cfg)[k] = v
    return cfg, mix, traffic.generate(cfg, mix, seed,
                                      str(tmp_path / f"{mix_name}-{seed}"))


def _bytes(data):
    return b"".join(open(f, "rb").read() for c in data.chunks for f in c.files)


@pytest.mark.parametrize("mix_name", ["zipf-pass128", "flat"])
def test_same_seed_same_bytes(tmp_path, mix_name):
    _, _, a = _gen(tmp_path / "a", mix_name, 2**31 + 11, pass_instances=2048)
    _, _, b = _gen(tmp_path / "b", mix_name, 2**31 + 11, pass_instances=2048)
    _, _, c = _gen(tmp_path / "c", mix_name, 2**31 + 12, pass_instances=2048)
    assert _bytes(a) == _bytes(b)
    assert _bytes(a) != _bytes(c)


def test_text_parses_back(tmp_path):
    """Lines parse back to the keys, dense counts and labels they were
    made from, with each column's empty fields as the mix gives them."""
    cfg, mix, data = _gen(tmp_path, "zipf-pass128", -5, pass_instances=4096)
    ck = data.chunks[0]
    keys, segs, dense, labels = traffic.parse_lines(ck.files[0], 100, 200,
                                                    26, 1)
    assert np.array_equal(keys, ck.batch_keys(100, 300))
    rows = ck.keys[100:300]
    assert np.array_equal(segs, np.nonzero(rows.reshape(-1))[0])
    assert np.array_equal(labels[:, 0], data.labels[100:300, 0])
    assert dense.shape == (200, 13) and (dense >= 0).all()
    assert np.all(ck.census != 0)
    empty = (ck.keys == 0).mean(0)
    want = np.asarray(mix["empty_rate_per_column"])
    assert np.all(np.abs(empty - want) < 0.03), (empty, want)
    assert np.all(empty[want == 0] == 0)


def test_tasks_get_labels_of_their_own(tmp_path):
    cfg, mix, data = _gen(tmp_path, "flat", 9, pass_instances=4096,
                          label_slots=["click", "conv"])
    assert data.labels.shape == (4096, 2)
    assert not np.array_equal(data.labels[:, 0], data.labels[:, 1])
    _, _, _, labels = traffic.parse_lines(data.chunks[0].files[0], 0, 50,
                                          26, 2)
    assert np.array_equal(labels, data.labels[:50])


def test_digits():
    v = np.array([0, 7, 12345678901234567890, (1 << 64) - 1], dtype=np.uint64)
    got = [bytes(r).decode() for r in traffic.digits(v, 20)]
    assert got == [f"{int(x):020d}" for x in v]


@pytest.mark.parametrize("mix_name,want", [("zipf-pass128", 267_393),
                                           ("flat", 497_897)])
def test_census_matches_reckoning(tmp_path, mix_name, want):
    """At the cell's size: a chunk's distinct keys against the expected
    count (over the columns and their ranks, 1 - (1 - (1 - e) p)^n with
    e the column's empty share), within half a percent."""
    cfg, mix, data = _gen(tmp_path, mix_name, 2**31 + 3)
    lines = int(cfg["pass_instances"]) // int(mix["chunks"])
    expect = traffic.expected_census(mix, lines, 26)
    assert abs(expect - want) < 1.0
    for c in data.chunks:
        assert abs(c.census.shape[0] - expect) / expect < 5e-3
    assert abs(data.labels.mean() - mix["positive_rate"]) < 0.01
