"""The port's step grouping (``TrainerConfig.scan_steps``) on the CPU: the
one group body that the card captures as a CUDA graph, run eagerly here.

Ports of tests/test_prefetch.py::test_scan_steps_parity (12 batches in
groups of 5: two groups and a ragged tail of two single steps) and
tests/test_e2e_train.py::test_scan_nan_short_circuits_remaining_ticks.
Against the reference's ``lax.scan``: the steps and counts exactly, the
loss to rtol 1e-6, rows to rtol 1e-6 / atol 1e-7 and the AUC to 1e-3, the
reference's own scan tolerances.  Within the port the grouped run is held
bit for bit against the one-step run.  tests/test_torch_cuda.py holds the
captured graph against eager steps on the card.
"""

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train import trainer as trainer_mod
from paddlebox_tpu_torch.train.trainer import NonFiniteBatchError
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

# test_prefetch.py's world: 96 instances in batches of 8 = 12 batches
S, DENSE, B = 3, 2, 8
NATIVE_FLAGS = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER",
                "PADDLEBOX_TORCH_USE_NATIVE_PLANNER",
                "PADDLEBOX_TORCH_USE_NATIVE_PARSER")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    files = write_synth_files(
        str(tmp_path_factory.mktemp("scan")), n_files=1, ins_per_file=96,
        n_sparse_slots=S, vocab_per_slot=60, dense_dim=DENSE, seed=2,
    )
    with pytest.MonkeyPatch.context() as mp:
        for k in NATIVE_FLAGS:
            mp.setenv(k, "0")
        port = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 16),
                                 read_threads=1)
        ref = RefDataset(ref_synth_config(S, DENSE, B, 16), read_threads=1)
        for ds in (port, ref):
            ds.set_filelist(files)
            ds.load_into_memory()
        yield {"port": port, "ref": ref, "mp": mp}
    port.close()
    ref.close()


def _ref_run(world, scan_steps):
    tconf = ref_config.SparseTableConfig(embedding_dim=8, hbm_cache_rows=0,
                                         overlap_pass_boundary=False)
    trconf = ref_config.TrainerConfig(auc_buckets=1 << 10, prefetch_batches=2,
                                      scan_steps=scan_steps)
    model = RefCtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16, 8))
    table = RefTable(tconf, seed=0)
    tr = RefTrainer(model, tconf, trconf, seed=0)
    tower = [{k: np.asarray(v) for k, v in layer.items()}
             for layer in tr.params["tower"]]
    table.begin_pass(world["ref"].unique_keys())
    m = tr.train_from_dataset(world["ref"], table)
    table.end_pass()
    return m, table.state_dict()["values"].copy(), tower


def _port_world(tower, scan_steps, prefetch=2, **trkw):
    tconf = SparseTableConfig(embedding_dim=8)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16, 8),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = Trainer(model, tconf, TrainerConfig(
        auc_buckets=1 << 10, prefetch_batches=prefetch,
        scan_steps=scan_steps, **trkw), device="cpu")
    return SparseTable(tconf, seed=0, device="cpu"), tr


def _port_run(world, tower, scan_steps, prefetch=2):
    table, tr = _port_world(tower, scan_steps, prefetch)
    table.begin_pass(world["port"].unique_keys())
    m = tr.train_from_dataset(world["port"], table)
    table.end_pass()
    state = table.state_dict()
    table.close()
    return m, state["values"].copy(), tr


@pytest.fixture(scope="module")
def ref_runs(world):
    return {k: _ref_run(world, k) for k in (1, 5)}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_grouped_steps_match_reference_scan(world, ref_runs, prefetch):
    """12 batches in groups of 5 (two groups, then two single steps),
    serial and prefetched, against the reference's scan_steps=5 run at its
    scan tolerances."""
    rm, rv, tower = ref_runs[5]
    m, v, tr = _port_run(world, tower, 5, prefetch)
    assert m["steps"] == rm["steps"] == 12 and tr.global_step == 12
    assert np.isclose(m["loss"], rm["loss"], rtol=1e-6)
    assert np.isclose(m["auc"], rm["auc"], atol=1e-3)
    np.testing.assert_allclose(v, rv, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m["grad_norm"], rm["grad_norm"], rtol=1e-5)
    # the CPU never captures: the group body ran eagerly
    assert tr.graph_captures == tr.graph_replays == 0


def test_grouped_steps_equal_single_steps_bit_for_bit(world, ref_runs):
    """Within the port the group body runs the same operations as single
    steps: loss, AUC, grad_norm and every row are equal."""
    tower = ref_runs[1][2]
    m1, v1, _ = _port_run(world, tower, 1)
    m5, v5, _ = _port_run(world, tower, 5)
    for key in ("loss", "auc", "steps", "count", "grad_norm", "weight_norm"):
        assert m1[key] == m5[key], key
    np.testing.assert_array_equal(v1, v5)
    # and the one-step port run agrees with the reference's one-step run
    rm, rv, _ = ref_runs[1]
    assert np.isclose(m1["loss"], rm["loss"], rtol=1e-6)
    np.testing.assert_allclose(v1, rv, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scan_steps,prefetch,depth", [
    (5, 2, 1), (2, 4, 2), (1, 2, 2), (5, 0, 0)])
def test_queue_depth_counts_groups(world, ref_runs, monkeypatch, scan_steps,
                                   prefetch, depth):
    """The producer's queue holds groups: max(1, prefetch_batches // k)
    of them (0 = the serial feed), as in the reference; every item is a
    group of k feeds, the ragged tail single ones."""
    seen = {}
    real = trainer_mod.prefetched

    def spy(feeds, d):
        seen["depth"] = d
        sizes = []

        def counted():
            for group in feeds:
                sizes.append(len(group))
                yield group
        seen["sizes"] = sizes
        return real(counted(), d)

    monkeypatch.setattr(trainer_mod, "prefetched", spy)
    _port_run(world, ref_runs[1][2], scan_steps, prefetch)
    assert seen["depth"] == depth
    full, tail = divmod(12, scan_steps)
    assert seen["sizes"] == [scan_steps] * full + [1] * tail


def test_raise_short_circuits_within_a_group(world, ref_runs):
    """check_nan_inf with groups of 3: the second batch poisoned raises a
    NonFiniteBatchError naming the group's steps, and every update of the
    group after its first step is left out: the table and the tower equal
    a run of the first batch alone (the port applies not even the poisoned
    step, where the reference applies it and skips the rest)."""
    tower = ref_runs[1][2]
    ds = world["port"]
    batches = list(ds.batches())
    table, tr = _port_world(tower, 3, check_nan_inf=True)
    table.begin_pass(ds.unique_keys())
    with faults.fault_plan({"train.nan": "at:1"}):
        with pytest.raises(NonFiniteBatchError, match=r"steps 0\.\.2"):
            tr.train_steps(table, batches)
    got = table.pass_state_dict()
    table.end_pass()
    table1, tr1 = _port_world(tower, 1)
    table1.begin_pass(ds.unique_keys())
    tr1.train_steps(table1, batches[:1])
    want = table1.pass_state_dict()
    table1.end_pass()
    np.testing.assert_array_equal(got["values"], want["values"])
    for (k, a), (_, b) in zip(tr.model.state_dict().items(),
                              tr1.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert tr.global_step == 0


def test_group_flags_and_losses(world, ref_runs):
    """The group body fills one loss and one flag per step without a host
    sync: under "raise" the flags after a failing step read False, under
    "skip_batch" only the failing step's."""
    tower = ref_runs[1][2]
    ds = world["port"]
    batches = list(ds.batches())[:3]
    for policy, want in (("raise", [True, False, False]),
                         ("skip_batch", [True, False, True])):
        table, tr = _port_world(tower, 3, check_nan_inf=True,
                                nan_policy=policy)
        table.begin_pass(ds.unique_keys())
        feeds = []
        for i, b in enumerate(batches):
            host = trainer_mod.host_feed(b, table.plan_batch(b))
            if i == 1:
                host["labels"] = np.full_like(host["labels"], np.nan)
            feeds.append(tr._to_device(host))
        auc, gn = tr.init_auc(), torch.zeros(2)
        losses, flags = torch.zeros(3), torch.ones(3, dtype=torch.bool)
        tr._group_body(table.values, table.g2sum, feeds, auc, gn, losses,
                       flags)
        table.end_pass()
        assert flags.tolist() == want, policy
        assert np.isnan(losses[1].item())
        assert gn[1].item() == want.count(True)
        assert int(auc.count) == B * want.count(True)
