"""Public members of the JAX package that the port had only in private form
or not at all, against the reference on the same config, block and
censuses: ``DataFeedConfig.used_slots``, ``SlotParser.dense_width``,
``RecordBlock.slot_slice`` and ``PlacementPlanner.tracked``; and
``make_mesh()`` with no count, the reference's "every device of the job":
one position alone, one a rank in a job of two (or ``--positions-per-proc``
a rank).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from paddlebox_tpu.data import criteo as ref_criteo
from paddlebox_tpu.data.slot_parser import SlotParser as RefParser
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.sparse.placement import PlacementPlanner as RefPlanner
from paddlebox_tpu_torch.data import criteo
from paddlebox_tpu_torch.data.slot_parser import SlotParser
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.launch import launch
from paddlebox_tpu_torch.parallel import make_mesh
from paddlebox_tpu_torch.sparse.placement import PlacementPlanner
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_mp_child.py")


def _with_unused(conf, names=("slot1", "dense0")):
    """conf with the named slots marked unused (skipped by the parser)."""
    slots = [dataclasses.replace(s, is_used=s.name not in names)
             for s in conf.slots]
    return dataclasses.replace(conf, slots=slots)


def _configs():
    """(port, reference) config pairs: the synth layout with task labels,
    with two slots unused, and the Criteo layout."""
    kw = dict(n_sparse_slots=4, dense_dim=3, batch_size=16,
              max_feasigns_per_ins=16)
    return [
        (make_synth_config(**kw, n_task_labels=1),
         ref_synth_config(**kw, n_task_labels=1)),
        (_with_unused(make_synth_config(**kw)),
         _with_unused(ref_synth_config(**kw))),
        (criteo.criteo_feed_config(64), ref_criteo.criteo_feed_config(64)),
    ]


@pytest.mark.parametrize("case", range(3))
def test_used_slots_and_dense_width_match_reference(case):
    conf, ref_conf = _configs()[case]
    got = [(s.name, s.type, tuple(s.shape)) for s in conf.used_slots()]
    want = [(s.name, s.type, tuple(s.shape)) for s in ref_conf.used_slots()]
    assert got == want
    assert len(got) == len(conf.slots) - 2 * (case == 1)
    assert SlotParser(conf).dense_width == RefParser(ref_conf).dense_width


@pytest.mark.parametrize("case", range(2))
def test_slot_slice_matches_reference(tmp_path, case):
    """Every (instance, slot) slice of one file parsed by both packages'
    parsers (the second config skips an unused slot)."""
    conf, ref_conf = _configs()[case]
    path = write_synth_files(str(tmp_path), n_files=1, ins_per_file=40,
                             n_sparse_slots=4, vocab_per_slot=30, dense_dim=3,
                             seed=9, n_task_labels=1 if case == 0 else 0)[0]
    block = SlotParser(conf).parse_file(path)
    ref_block = RefParser(ref_conf).parse_file(path)
    assert (block.n_ins, block.n_sparse_slots) == (ref_block.n_ins,
                                                    ref_block.n_sparse_slots)
    sizes = set()
    for i in range(block.n_ins):
        for s in range(block.n_sparse_slots):
            got = block.slot_slice(i, s)
            np.testing.assert_array_equal(got, ref_block.slot_slice(i, s))
            assert got.dtype == np.uint64
            sizes.add(got.shape[0])
    assert len(sizes) > 1  # slices of more than one length were compared


def test_planner_tracked_matches_reference():
    """The tracker's size over censuses that overlap, repeat and stop, so
    keys enter, age and are pruned (aging 0.5)."""
    rng = np.random.default_rng(4)
    kw = dict(hot_capacity=8, aging=0.5, update_interval=1)
    planner, ref = PlacementPlanner(**kw), RefPlanner(**kw)
    assert planner.tracked == ref.tracked == 0
    seen = []
    for p in range(8):
        hi = 400 if p < 5 else 60  # later passes draw from a narrow range
        census = np.unique(rng.integers(1, hi, 120).astype(np.uint64))
        planner.observe(census)
        ref.observe(census)
        planner.update_plan()
        ref.update_plan()
        assert planner.tracked == ref.tracked
        seen.append(planner.tracked)
    assert max(seen) > seen[-1]  # the prune ran


def test_make_mesh_without_a_count_is_one_position_alone():
    mesh = make_mesh(device="cpu")
    assert (mesh.n, mesh.distributed, mesh.n_local) == (1, False, 1)
    assert mesh.axis_names == ("data",)
    seq = make_mesh(device="cpu", axis_name="seq")
    assert (seq.n, seq.shape) == (1, {"seq": 1})


@pytest.mark.parametrize("per_proc", [None, 2])
def test_make_mesh_without_a_count_spans_a_job(tmp_path, per_proc):
    """Two ranks on the CPU: one data position a rank (two in all), or
    ``--positions-per-proc`` a rank; a model axis keeps a rank's own."""
    out = tmp_path / "out"
    out.mkdir()
    logs = str(tmp_path / "logs")
    rc = launch([CHILD, "mesh", str(out)], nproc=2,
                positions_per_proc=per_proc, device="cpu", backend="gloo",
                log_dir=logs, job_timeout_s=120.0)
    if rc != 0:
        pytest.fail(f"launch rc={rc}\n" + "\n".join(
            open(os.path.join(logs, f)).read()[-3000:]
            for f in sorted(os.listdir(logs))))
    k = per_proc or 1
    for r in range(2):
        got = json.loads((out / f"rank{r}.json").read_text())
        assert got["data"] == {"n": 2 * k, "distributed": True, "n_proc": 2,
                               "local": list(range(r * k, (r + 1) * k))}
        assert got["seq"] == {"n": k, "distributed": False, "n_proc": 1,
                              "local": list(range(k))}
