"""Field and parameter dumps (train/dump.py) against the JAX package: the
dump lines of a single-chip pass and of a 4-position pass equal the
reference's but for the prediction column, compared as floats within
2e-6; ``dump_params`` writes the reference's npz keys.  Within the port: a
dumped pass runs one step at a time whatever ``scan_steps`` says, padding
batches dump nothing, and a write error latches.
"""

import os

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.parallel import MultiChipTrainer as RefMultiChipTrainer
from paddlebox_tpu.parallel import ShardedSparseTable as RefShardedTable
from paddlebox_tpu.parallel import make_mesh as ref_make_mesh
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.parallel import (
    MultiChipTrainer,
    ShardedSparseTable,
    make_mesh,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train.dump import FieldDumper
from paddlebox_tpu_torch.weights import params_from_jax
from test_torch_data import _with_ins_ids

torch.set_num_threads(1)

S, DENSE, B = 3, 2, 16
FIELDS = ("cmatch", "rank", "task_labels", "dense")
# the prediction column: float32 towers whose sums run in another order on
# the two CPU backends drift ~1e-7 a step; 2e-6 bounds a pass of them
PRED_TOL = 2e-6
NATIVE = ("PBOX_USE_NATIVE_PLANNER", "PBOX_USE_NATIVE_PARSER")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dump")
    return _with_ins_ids(write_synth_files(
        str(d), n_files=2, ins_per_file=72, n_sparse_slots=S, dense_dim=DENSE,
        vocab_per_slot=40, seed=21, with_logkey=True,
        cmatch_values=(222, 223, 1), n_task_labels=1))


def _dataset(files, ref=False):
    kw = dict(n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
              max_feasigns_per_ins=16, parse_ins_id=True, parse_logkey=True,
              n_task_labels=1)
    conf = (ref_synth_config if ref else make_synth_config)(**kw)
    ds = (RefDataset if ref else PadBoxSlotDataset)(conf, read_threads=2)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def _trainer_kw(path, **extra):
    return dict(auc_buckets=1 << 10, need_dump_field=True,
                dump_fields_path=str(path), dump_fields=FIELDS, **extra)


def _read(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def assert_dumps_match(got_path, want_path, n_lines):
    got, want = _read(got_path), _read(want_path)
    assert len(got) == len(want) == n_lines
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3:] == w[3:], (g, w)
        assert abs(float(g[2]) - float(w[2])) <= PRED_TOL, (g[2], w[2])


def test_single_chip_dump_matches_reference(files, tmp_path, monkeypatch):
    for k in NATIVE:
        monkeypatch.setenv(k, "0")
    rconf = ref_config.SparseTableConfig(embedding_dim=4, hbm_cache_rows=0,
                                         overlap_pass_boundary=False)
    ref_tr = RefTrainer(
        RefCtrDnn(S, rconf.row_width, dense_dim=DENSE, hidden=(16,)), rconf,
        ref_config.TrainerConfig(**_trainer_kw(tmp_path / "ref",
                                               need_dump_param=True)),
        seed=2)
    tower = [{k: np.array(v) for k, v in layer.items()}
             for layer in ref_tr.params["tower"]]
    tconf = SparseTableConfig(embedding_dim=4)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = Trainer(model, tconf,
                 TrainerConfig(**_trainer_kw(tmp_path / "port",
                                             need_dump_param=True)),
                 device="cpu")
    ref_table = RefTable(rconf, seed=0)
    table = SparseTable(tconf, seed=0, device="cpu")
    ds, ref = _dataset(files), _dataset(files, ref=True)
    for d, t in ((ref, ref_table), (ds, table)):
        d.local_shuffle(seed=4)
        t.begin_pass(d.unique_keys())
    ref_tr.train_from_dataset(ref, ref_table)
    m = tr.train_from_dataset(ds, table)
    assert m["steps"] == 9
    assert_dumps_match(tmp_path / "port" / "dump-0.txt",
                       tmp_path / "ref" / "dump-0.txt", 144)
    # the post-pass parameter dump, mid-pass: the reference's keys
    for kind, names in (("dense", ["['tower'][0]['b']", "['tower'][0]['w']",
                                   "['tower'][1]['b']", "['tower'][1]['w']"]),
                        ("sparse", ["keys", "values"])):
        got = np.load(tmp_path / "port" / f"param-9.{kind}.npz")
        want = np.load(tmp_path / "ref" / f"param-9.{kind}.npz")
        assert sorted(got.files) == sorted(want.files) == names
        for k in want.files:
            # the table's and the tower's float32 drift of one pass
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    ref_table.end_pass()
    table.end_pass()
    table.close()
    ds.close()
    ref.close()


def test_dump_param_select_filters_by_path(files, tmp_path):
    from paddlebox_tpu_torch.train.dump import dump_params

    model = CtrDnn(S, 6, dense_dim=DENSE, hidden=(8, 4), device="cpu")
    dump_params(str(tmp_path / "p"), model.state_dict(),
                select=("['tower'][1]",))
    got = np.load(tmp_path / "p.dense.npz")
    assert sorted(got.files) == ["['tower'][1]['b']", "['tower'][1]['w']"]
    np.testing.assert_array_equal(got["['tower'][1]['w']"],
                                  model.tower[1].weight.detach().numpy().T)
    assert not os.path.exists(tmp_path / "p.sparse.npz")


def test_dumped_pass_runs_single_steps(files, tmp_path):
    """scan_steps 8 with a dump: the pass runs one step at a time, and its
    dump and metrics equal those of scan_steps 1."""
    out = []
    for scan in (1, 8):
        tconf = SparseTableConfig(embedding_dim=4)
        table = SparseTable(tconf, seed=1, device="cpu")
        path = tmp_path / f"scan{scan}"
        tr = Trainer(CtrDnn(S, tconf.row_width, dense_dim=DENSE,
                            hidden=(16,), seed=3, device="cpu"), tconf,
                     TrainerConfig(**_trainer_kw(path, scan_steps=scan)),
                     device="cpu")
        ds = _dataset(files)
        table.begin_pass(ds.unique_keys())
        m = tr.train_from_dataset(ds, table)
        table.end_pass()
        with open(path / "dump-0.txt") as f:
            out.append((m, f.read()))
        table.close()
        ds.close()
    (m1, d1), (m8, d8) = out
    assert d1 == d8 and d1.count("\n") == 144
    assert m1["loss"] == m8["loss"] and m8["steps"] == 9


def test_multichip_dump_matches_reference(files, tmp_path, monkeypatch):
    """Four positions, 9 batches: the third group carries three padding
    batches, which dump nothing; the lines equal the reference's, position
    by position."""
    for k in NATIVE + ("PADDLEBOX_TORCH_USE_NATIVE_PLANNER",):
        monkeypatch.setenv(k, "0")
    kw = dict(embedding_dim=4, hbm_cache_rows=0, placement="hash")
    rconf = ref_config.SparseTableConfig(**kw)
    ref_tr = RefMultiChipTrainer(
        RefCtrDnn(S, rconf.row_width, dense_dim=DENSE, hidden=(8,)), rconf,
        ref_make_mesh(4),
        ref_config.TrainerConfig(**_trainer_kw(tmp_path / "ref")), seed=3)
    tower = [{k: np.asarray(v) for k, v in layer.items()}
             for layer in ref_tr.dense_state()[0]["tower"]]
    ref_table = RefShardedTable(rconf, ref_tr.mesh, seed=5, bucket_slack=8.0)
    conf = SparseTableConfig(**kw)
    mesh = make_mesh(4, device="cpu")
    model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = MultiChipTrainer(model, conf, mesh,
                          TrainerConfig(**_trainer_kw(tmp_path / "port")))
    table = ShardedSparseTable(conf, mesh, seed=5, bucket_slack=8.0)
    ds, ref = _dataset(files), _dataset(files, ref=True)
    ref_table.begin_pass(ref.unique_keys())
    table.begin_pass(ds.unique_keys())
    ref_tr.train_from_dataset(ref, ref_table)
    m = tr.train_from_dataset(ds, table)
    ref_table.end_pass()
    table.end_pass()
    assert m["steps"] == 3 and m["samples"] == 144
    assert_dumps_match(tmp_path / "port" / "dump-0.txt",
                       tmp_path / "ref" / "dump-0.txt", 144)
    table.close()
    ref_table.close()
    ds.close()
    ref.close()


def test_field_dumper_latches_a_write_error(files, tmp_path):
    ds = _dataset(files)
    batch = next(iter(ds.batches()))
    d = FieldDumper(str(tmp_path / "d" / "x.txt"), FIELDS)
    assert d._thread.daemon
    d._fh.close()  # every later write fails
    d.dump_batch(batch, np.zeros(B, np.float32))
    with pytest.raises(RuntimeError, match="failed"):
        for _ in range(100):  # the writer latches the error meanwhile
            d.dump_batch(batch, np.zeros(B, np.float32))
    with pytest.raises(RuntimeError, match="failed"):
        d.close()
    assert not d._thread.is_alive()
    # a dumper collected unclosed stops its writer
    d2 = FieldDumper(str(tmp_path / "d" / "y.txt"))
    thread = d2._thread
    del d2
    import gc

    gc.collect()
    thread.join(5)
    assert not thread.is_alive()
    ds.close()
