"""The port's MultiScenarioTrainer (scenarios/multi.py) against the JAX
package's, on the CPU (reference: tests/test_scenarios.py).

Three scenarios over ONE table: a CtrDnn ranker, a CtrDnn over slots 0 and
1 with its own create threshold, and a TwoTower retrieval tower; each
port tower starts from the reference trainer's seeded parameters.  Over
two interleaved passes:

  * the union census is bit-exact with the reference's;
  * each scenario's steps and counts are equal, its loss within rtol
    1e-5 and its AUC within two bucket crossings (tests/
    test_torch_retrieval.py's bounds), and the shared table's keys and
    counters equal and its rows within rtol 2e-5 / atol 1e-5 (the in-batch
    softmax's bounds, test_torch_retrieval.py, here at temperature 1);
  * at the retrieval tower's default temperature 0.1 the same, with the
    rows within atol 1e-3 (see ROWS_ATOL_T01);
  * the table sees the reference's push order: the same batches planned
    in the same sequence, bit for bit;
  * the steps interleave one batch a scenario in spec order, and a rerun
    is bit-equal;
  * the per-scenario create threshold resolves on its trainer only, the
    slot mask rides its scenario, a missing dataset is refused before
    begin_pass, a mid-pass failure aborts the pass, and every scenario is
    separately attributable in telemetry.
"""

import jax
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.scenarios import MultiScenarioTrainer as RefMulti
from paddlebox_tpu.scenarios import ScenarioSpec as RefSpec
from paddlebox_tpu.sparse.table import SparseTable as RefTable
import paddlebox_tpu_torch.models as models
from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.scenarios import (
    MultiScenarioTrainer,
    RetrievalTrainer,
    ScenarioSpec,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, B, VOCAB = 3, 2, 16, 40
TKW = dict(embedding_dim=4, learning_rate=0.2, initial_range=0.1,
           create_threshold=1.0)
TRKW = dict(dense_lr=3e-3, auc_buckets=1 << 10)
NAMES = ("feed", "cvr", "retr")
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


# At temperature 0.1 the softmax scales the row gradients (and their
# float32 rounding) by 10, and the rounding compounds over the passes:
# the reference against ITSELF, with its towers' initial parameters moved
# by one ulp, differs by up to 3.7e-4 in the rows of this data (2.2e-4 with
# all three scenarios, 3.7e-4 with the retrieval scenario alone), and the
# port against the reference by 6.2e-4 (4.6e-4 alone); at temperature 1
# all four read 1.4e-6 to 3.9e-6.  The bound is about 2.7 times the
# reference's own one-ulp spread.
ROWS_ATOL_T01 = 1e-3


def _spec_args(width, temperature=1.0):
    """(name, model kwargs, spec kwargs) of the three scenarios."""
    return [
        ("feed", "CtrDnn", dict(dense_dim=DENSE, hidden=(16,)), {}),
        ("cvr", "CtrDnn", dict(dense_dim=DENSE, hidden=(8,)),
         dict(slot_mask=(0, 1), create_threshold=0.0)),
        # temperature 1: three towers share each row, and the softmax's
        # 1 / temperature scale of the row gradients (and of their float32
        # rounding) compounds over the scenarios' pushes
        ("retr", "TwoTower", dict(item_slots=(2,), dense_dim=DENSE,
                                  hidden=(16,), temperature=temperature),
         dict(kind="retrieval")),
    ]


def _ref_world(temperature=1.0):
    conf = ref_config.SparseTableConfig(hbm_cache_rows=0,
                                        overlap_pass_boundary=False, **TKW)
    specs = [RefSpec(name, getattr(ref_models, cls)(S, conf.row_width, **mk),
                     trainer_conf=ref_config.TrainerConfig(**TRKW),
                     seed=i + 1, **sk)
             for i, (name, cls, mk, sk) in enumerate(_spec_args(
                 conf.row_width, temperature))]
    return RefTable(conf, seed=0), RefMulti(conf, specs)


def _port_world(params, temperature=1.0):
    conf = SparseTableConfig(**TKW)
    specs = []
    for name, cls, mk, sk in _spec_args(conf.row_width, temperature):
        model = getattr(models, cls)(S, conf.row_width, device="cpu", **mk)
        model.load_state_dict(params_from_jax_tree(params[name]))
        specs.append(ScenarioSpec(name, model,
                                  trainer_conf=TrainerConfig(**TRKW), **sk))
    return (SparseTable(conf, seed=0, device="cpu"),
            MultiScenarioTrainer(conf, specs, device="cpu"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each scenario its own file set (so the union census is a real
    union), loaded in both packages; the reference's seeded towers."""
    root = tmp_path_factory.mktemp("scen")
    files = {n: write_synth_files(str(root / n), n_files=1, ins_per_file=48 + 16 * i,
                                  n_sparse_slots=S, vocab_per_slot=VOCAB,
                                  dense_dim=DENSE, seed=11 + i)
             for i, n in enumerate(NAMES)}
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        port, ref = {}, {}
        for n in NAMES:
            port[n] = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 8),
                                        read_threads=1)
            ref[n] = RefDataset(ref_synth_config(S, DENSE, B, 8),
                                read_threads=1)
            for ds in (port[n], ref[n]):
                ds.set_filelist(files[n])
                ds.load_into_memory()
        _, rmst = _ref_world()
        params = {n: jax.tree.map(np.array, rmst.trainers[n].params)
                  for n in NAMES}
        yield {"port": port, "ref": ref, "params": params}
    for d in (*port.values(), *ref.values()):
        d.close()


def _two_passes(world, temperature, rows_atol, planned=None):
    """Two passes of the port and of the reference side by side, held as
    the module docstring says; ``planned`` collects each side's planned
    batch keys in order."""
    table, mst = _port_world(world["params"], temperature)
    rtable, rmst = _ref_world(temperature)
    if planned is not None:
        for side, t in (("port", table), ("ref", rtable)):
            real = t.plan_batch

            def spy(batch, *a, side=side, real=real, **kw):
                planned[side].append(np.array(batch.keys[:batch.n_keys]))
                return real(batch, *a, **kw)

            t.plan_batch = spy
    np.testing.assert_array_equal(mst.union_census(world["port"]),
                                  rmst.union_census(world["ref"]))
    try:
        for _ in range(2):
            got = mst.train_pass(world["port"], table)
            want = rmst.train_pass(world["ref"], rtable)
            assert set(got) == set(want) == set(NAMES)
            for n in NAMES:
                m, rm = got[n], want[n]
                assert m["steps"] == rm["steps"] > 0, n
                assert m["count"] == rm["count"] and m["samples"] == \
                    rm["samples"], n
                np.testing.assert_allclose(m["loss"], rm["loss"], rtol=1e-5,
                                           err_msg=n)
                pos = round(rm["actual_ctr"] * rm["count"])
                assert abs(m["auc"] - rm["auc"]) <= 2.0 / max(
                    pos * (rm["count"] - pos), 1), n
            st, rst = table.state_dict(), rtable.state_dict()
            np.testing.assert_array_equal(st["keys"], rst["keys"])
            np.testing.assert_array_equal(st["values"][:, :2],
                                          rst["values"][:, :2])
            np.testing.assert_allclose(st["values"], rst["values"],
                                       rtol=2e-5, atol=rows_atol)
        assert table.missing_key_count == 0
        assert isinstance(mst.trainers["retr"], RetrievalTrainer)
    finally:
        table.close()
        rtable.close()


def test_two_passes_match_the_reference(world):
    _two_passes(world, 1.0, 1e-5)


def test_two_passes_at_the_default_temperature(world):
    _two_passes(world, 0.1, ROWS_ATOL_T01)


def test_push_order_matches_the_reference(world):
    """The table takes the scenarios' batches in the reference's order:
    the same keys planned in the same sequence, bit for bit, over two
    passes (the rows' tolerance cannot hide a reordered push)."""
    planned = {"port": [], "ref": []}
    _two_passes(world, 1.0, 1e-5, planned)
    assert len(planned["port"]) == len(planned["ref"]) > len(NAMES)
    for a, b in zip(planned["port"], planned["ref"]):
        np.testing.assert_array_equal(a, b)


def test_interleave_order_and_bit_equal_rerun(world):
    order = []
    runs = []
    for _ in range(2):
        table, mst = _port_world(world["params"])
        for name, tr in mst.trainers.items():
            real = tr._run_group

            def spy(*a, name=name, real=real, **kw):
                order.append(name)
                return real(*a, **kw)

            tr._run_group = spy
        del order[:]
        results = mst.train_pass(world["port"], table)
        runs.append((results, table.state_dict(), list(order)))
        table.close()
    (r1, s1, o1), (r2, s2, o2) = runs
    n = {k: sum(1 for _ in world["port"][k].batches()) for k in NAMES}
    want, left = [], dict(n)
    while any(left.values()):
        for k in NAMES:  # one batch a scenario, spec order, until drained
            if left[k]:
                want.append(k)
                left[k] -= 1
    assert o1 == o2 == want
    assert len(set(n.values())) > 1  # the datasets drain at different steps
    np.testing.assert_array_equal(s1["values"], s2["values"])
    for k in NAMES:
        assert (r1[k]["loss"], r1[k]["auc"]) == (r2[k]["loss"], r2[k]["auc"])


def test_create_threshold_and_slot_mask_resolve_per_scenario(world):
    _, mst = _port_world(world["params"])
    assert mst.trainers["cvr"].table_conf.create_threshold == 0.0
    assert mst.trainers["feed"].table_conf.create_threshold == 1.0
    assert (mst.trainers["cvr"].table_conf.row_width
            == mst.trainers["feed"].table_conf.row_width)
    assert mst.trainers["cvr"].slot_mask == (0, 1)
    assert mst.trainers["feed"].slot_mask is None
    assert mst.scenario_names() == NAMES


def test_spec_validation():
    conf = SparseTableConfig(embedding_dim=4)
    model = models.CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,),
                          device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        MultiScenarioTrainer(conf, [], device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        MultiScenarioTrainer(conf, [ScenarioSpec("a", model),
                                    ScenarioSpec("a", model)], device="cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        MultiScenarioTrainer(conf, [ScenarioSpec("a", model, kind="nope")],
                             device="cpu")
    with pytest.raises(ValueError, match="apply_towers"):
        MultiScenarioTrainer(conf, [ScenarioSpec("a", model,
                                                 kind="retrieval")],
                             device="cpu")


def test_missing_dataset_and_mid_pass_failure(world):
    table, mst = _port_world(world["params"])
    try:
        partial = {k: v for k, v in world["port"].items() if k != "cvr"}
        with pytest.raises(ValueError, match="cvr"):
            mst.train_pass(partial, table)
        assert not table._in_pass  # refused before begin_pass
        real = world["port"]["feed"]

        class _Exploder:
            def batches(self, drop_last=False):
                raise RuntimeError("boom")

            def unique_keys(self):
                return real.unique_keys()

        with pytest.raises(RuntimeError, match="boom"):
            mst.train_pass(dict(world["port"], feed=_Exploder()), table)
        assert not table._in_pass  # aborted
        table.begin_pass(np.array([1], np.uint64))
        table.abort_pass()
    finally:
        table.close()


def test_scenarios_are_separately_attributable(world):
    table, mst = _port_world(world["params"])
    before = telemetry.registry.snapshot()
    try:
        mst.train_pass(world["port"], table)
    finally:
        table.close()
    snap = telemetry.registry.snapshot()
    for n in NAMES:
        key = f"scenario.steps{{scenario={n}}}"
        assert snap["counters"][key] - before["counters"].get(key, 0) > 0
        key = f"scenario.samples{{scenario={n}}}"
        assert snap["counters"][key] - before["counters"].get(key, 0) > 0
        assert f"scenario.auc{{scenario={n}}}" in snap["gauges"]
        assert f"scenario.loss{{scenario={n}}}" in snap["gauges"]
