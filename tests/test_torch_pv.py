"""PV merge against the JAX package: ``build_rank_offset`` bit for bit (and
against the reference's loop oracle), the PV batches of a shuffled PV-mode
dataset and their ``pv_state`` round trip, ``seq_pos`` and task labels,
the reference's errors, and one pass of PV batches through both trainers
at the trainer parity tolerance.
"""

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.feed import BatchBuilder as RefBuilder
from paddlebox_tpu.data.feed import build_rank_offset as ref_build_rank_offset
from paddlebox_tpu.data.record import RecordBlock as RefBlock
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.feed import BatchBuilder, build_rank_offset
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train.trainer import host_feed
from paddlebox_tpu_torch.weights import params_from_jax
from test_host_vectorized import _random_block, _rank_offset_oracle

torch.set_num_threads(1)

S, DENSE, BATCH = 4, 3, 16
BATCH_FIELDS = ("keys", "key_segments", "n_keys", "dense", "labels",
                "ins_mask", "batch_size", "n_sparse_slots", "rank_offset",
                "seq_pos", "task_labels", "cmatches", "ranks", "ins_ids")


def assert_batches_equal(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def _port_block(ref_block):
    return RecordBlock(**ref_block.__dict__)


@pytest.mark.parametrize("seed", [1, 7])
def test_build_rank_offset_matches_reference_and_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 64
    ref_block = _random_block(rng, n, 2)
    block = _port_block(ref_block)
    ids = rng.permutation(n)
    cuts = np.sort(rng.choice(np.arange(1, n), size=12, replace=False))
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    for filt in (None, (222, 223), (111,)):
        for max_rank in (1, 3, 4):
            got = build_rank_offset(block, ids, bounds, 80, max_rank, filt)
            np.testing.assert_array_equal(
                got, ref_build_rank_offset(ref_block, ids, bounds, 80,
                                           max_rank, filt))
            np.testing.assert_array_equal(
                got, _rank_offset_oracle(ref_block, ids, bounds, 80,
                                         max_rank, filt))


def test_build_rank_offset_without_ranks_or_ranked_members():
    rng = np.random.default_rng(2)
    block = _port_block(_random_block(rng, 8, 2, with_logkey=False))
    ids, bounds = np.arange(8), np.asarray([0, 4, 8], dtype=np.int64)
    assert (build_rank_offset(block, ids, bounds, 8, 3) == -1).all()
    block.ranks = np.zeros(8, dtype=np.int32)
    got = build_rank_offset(block, ids, bounds, 8, 3)
    assert (got[:, 1:] == -1).all() and (got[:, 0] == -1).all()


@pytest.fixture(scope="module")
def pv_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pv")
    return write_synth_files(
        str(d), n_files=2, ins_per_file=80, n_sparse_slots=S, dense_dim=DENSE,
        vocab_per_slot=30, seed=13, with_logkey=True, max_ads_per_pv=4,
        cmatch_values=(222, 223, 1), n_task_labels=1)


def _pv_datasets(files, batch_size=BATCH):
    kw = dict(parse_logkey=True, enable_pv_merge=True, pv_batch_size=4,
              rank_offset="rank_offset", n_task_labels=1)
    out = []
    for ds in (PadBoxSlotDataset(make_synth_config(S, DENSE, batch_size, 16,
                                                   **kw), read_threads=2),
               RefDataset(ref_synth_config(S, DENSE, batch_size, 16, **kw),
                          read_threads=2)):
        ds.set_filelist(files)
        ds.load_into_memory()
        out.append(ds)
    return out


def test_pv_batches_and_state_match_reference(pv_files):
    ds, ref = _pv_datasets(pv_files)
    try:
        for d in (ds, ref):
            d.preprocess_instance()
            d.local_shuffle(seed=3)  # whole page-views move
        assert ds.pv_mode and ds.get_pv_data_size() == ref.get_pv_data_size()
        got, want = list(ds.batches()), list(ref.batches())
        assert len(got) == len(want) > 10
        for a, b in zip(got, want):
            assert_batches_equal(a, b)
            assert a.rank_offset.shape == (BATCH, 7)
            # at most pv_batch_size PVs a batch
            assert np.unique(a.rank_offset[:, 0][a.ins_mask > 0]).size >= 1
        # instance mode and back: the shuffled PV order survives
        state = ds.pv_state()
        ds.postprocess_instance()
        assert not ds.pv_mode and all(b.rank_offset is None
                                      for b in ds.batches())
        ds.restore_pv_state(state)
        for a, b in zip(ds.batches(), want):
            assert_batches_equal(a, b)
        # drop_last drops a short tail batch, as the reference does
        assert len(list(ds.batches(drop_last=True))) == len(
            list(ref.batches(drop_last=True)))
    finally:
        ds.close()
        ref.close()


def test_seq_pos_and_task_labels_match_reference(pv_files):
    kw = dict(parse_logkey=True, n_task_labels=1, sequence_slot="slot2",
              max_seq_len=2, parse_ins_id=False)
    conf = make_synth_config(S, DENSE, BATCH, 16, **kw)
    ref_conf = ref_synth_config(S, DENSE, BATCH, 16, **kw)
    ds = PadBoxSlotDataset(conf, read_threads=1)
    ds.set_filelist(pv_files[:1])
    ds.load_into_memory()
    ref_block = RefBlock(**ds._block.__dict__)
    builder, ref_builder = BatchBuilder(conf), RefBuilder(ref_conf)
    ids = np.random.default_rng(0).permutation(ds._block.n_ins)[:BATCH - 3]
    got = builder.build(ds._block, ids)
    assert_batches_equal(got, ref_builder.build(ref_block, ids))
    K = got.keys.shape[0]
    assert got.seq_pos.shape == (BATCH, 2) and (got.seq_pos[-3:] == K).all()
    assert got.task_labels.shape == (BATCH, 2)
    np.testing.assert_array_equal(got.task_labels[:, 0], got.labels)
    ds.close()


def test_reference_errors(pv_files, tmp_path):
    # a bad sequence_slot
    with pytest.raises(ValueError, match="sequence_slot"):
        BatchBuilder(make_synth_config(S, DENSE, BATCH, 16,
                                       sequence_slot="dense0"))
    # a PV larger than the batch
    ds, ref = _pv_datasets(pv_files, batch_size=3)
    try:
        for d in (ds, ref):
            d.preprocess_instance()
            with pytest.raises(ValueError, match="exceeds batch_size"):
                list(d.batches())
    finally:
        ds.close()
        ref.close()
    # PV mode on a spilled dataset
    ds, ref = _pv_datasets(pv_files)
    try:
        for i, d in enumerate((ds, ref)):
            d.preprocess_instance()
            d.preload_into_disk(str(tmp_path / f"spill{i}"))
            d.wait_preload_done()
            with pytest.raises(RuntimeError, match="in-memory"):
                next(iter(d.batches()))
            d.release_memory()
            with pytest.raises(RuntimeError):
                d.preprocess_instance()
    finally:
        ds.close()
        ref.close()
    # PV merge without logkey data, or with the config's switch off
    plain = PadBoxSlotDataset(make_synth_config(S, DENSE, BATCH, 16,
                                                enable_pv_merge=True),
                              read_threads=1)
    plain.set_filelist([write_synth_files(str(tmp_path / "plain"), n_files=1,
                                          ins_per_file=8, n_sparse_slots=S,
                                          dense_dim=DENSE)[0]])
    plain.load_into_memory()
    with pytest.raises(RuntimeError, match="parse_logkey"):
        plain.preprocess_instance()
    plain.close()
    off = PadBoxSlotDataset(make_synth_config(S, DENSE, BATCH, 16,
                                              parse_logkey=True,
                                              n_task_labels=1),
                            read_threads=1)
    off.set_filelist(pv_files[:1])
    off.load_into_memory()
    with pytest.raises(RuntimeError, match="enable_pv_merge"):
        off.preprocess_instance()
    off.close()


def test_pv_pass_matches_reference_trainer(pv_files, monkeypatch):
    """One pass of PV batches through both single-chip trainers from the
    reference's tower: the feed carries rank_offset (CtrDnn reads none of
    it), and the loss and AUC agree at test_torch_trainer.py's
    tolerances (float32 sums in another order: rtol 1e-5 on the loss,
    1e-4 on the AUC)."""
    monkeypatch.setenv("PBOX_USE_NATIVE_PLANNER", "0")
    monkeypatch.setenv("PADDLEBOX_TORCH_USE_NATIVE_PLANNER", "0")
    ds, ref = _pv_datasets(pv_files)
    try:
        for d in (ds, ref):
            d.preprocess_instance()
            d.local_shuffle(seed=1)
        tkw = dict(embedding_dim=4, learning_rate=0.2, initial_range=0.1)
        rconf = ref_config.SparseTableConfig(
            hbm_cache_rows=0, overlap_pass_boundary=False, **tkw)
        ref_tr = RefTrainer(RefCtrDnn(S, rconf.row_width, dense_dim=DENSE,
                                      hidden=(16,)),
                            rconf, ref_config.TrainerConfig(
                                dense_lr=1e-2, auc_buckets=1 << 10), seed=4)
        tower = [{k: np.array(v) for k, v in layer.items()}
                 for layer in ref_tr.params["tower"]]
        conf = SparseTableConfig(**tkw)
        model = CtrDnn(S, conf.row_width, dense_dim=DENSE, hidden=(16,),
                       device="cpu")
        model.load_state_dict(params_from_jax(tower))
        tr = Trainer(model, conf, TrainerConfig(dense_lr=1e-2,
                                                auc_buckets=1 << 10),
                     device="cpu")
        ref_table, table = RefTable(rconf, seed=3), SparseTable(
            conf, seed=3, device="cpu")
        ref_table.begin_pass(ref.unique_keys())
        table.begin_pass(ds.unique_keys())
        batch = next(iter(ds.batches()))
        feed = host_feed(batch, table.plan_batch(batch))
        np.testing.assert_array_equal(feed["rank_offset"], batch.rank_offset)
        rm = ref_tr.train_from_dataset(ref, ref_table)
        pm = tr.train_from_dataset(ds, table)
        ref_table.end_pass()
        table.end_pass()
        assert pm["steps"] == rm["steps"] and pm["count"] == rm["count"] == 160
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)
        assert abs(pm["auc"] - rm["auc"]) < 1e-4
        table.close()
    finally:
        ds.close()
        ref.close()



@pytest.mark.parametrize("needs", ["uses_rank_offset", "uses_seq_pos"])
def test_a_model_that_reads_the_pv_inputs_needs_them(pv_files, needs):
    """The reference's RuntimeError, from both trainers, for a model that
    reads rank_offset or seq_pos on batches without it; with them the
    pass trains."""
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )

    class Reader(CtrDnn):
        """A CtrDnn that declares it reads ``needs``' input: the trainers
        pass it by keyword, and it must arrive."""

        def forward(self, rows, key_segments, dense, batch_size, **extra):
            assert set(extra) == {needs[len("uses_"):]}, extra
            return super().forward(rows, key_segments, dense, batch_size)

    setattr(Reader, needs, True)
    tconf = SparseTableConfig(embedding_dim=4)
    model = Reader(S, tconf.row_width, dense_dim=DENSE, hidden=(8,),
                   device="cpu")
    plain = _pv_datasets(pv_files)[0]
    table = SparseTable(tconf, device="cpu")
    table.begin_pass(plain.unique_keys())
    tr = Trainer(model, tconf, device="cpu")
    with pytest.raises(RuntimeError, match="rank_offset|seq_pos"):
        tr.train_from_dataset(plain, table)
    with pytest.raises(RuntimeError, match="rank_offset|seq_pos"):
        tr.evaluate(plain, table)
    table.end_pass()
    table.close()
    mesh = make_mesh(2, device="cpu")
    sharded = ShardedSparseTable(tconf, mesh)
    sharded.begin_pass(plain.unique_keys())
    with pytest.raises(RuntimeError, match="rank_offset|seq_pos"):
        MultiChipTrainer(model, tconf, mesh).train_from_dataset(plain,
                                                                sharded)
    sharded.end_pass()
    sharded.close()
    plain.close()
    # with the input in the batches, the same model trains
    kw = (dict(enable_pv_merge=True, parse_logkey=True, n_task_labels=1)
          if needs == "uses_rank_offset" else
          dict(sequence_slot="slot0", parse_logkey=True, n_task_labels=1))
    ds = PadBoxSlotDataset(make_synth_config(S, DENSE, BATCH, 16, **kw),
                           read_threads=1)
    ds.set_filelist(pv_files)
    ds.load_into_memory()
    if needs == "uses_rank_offset":
        ds.preprocess_instance()
    table = SparseTable(tconf, device="cpu")
    table.begin_pass(ds.unique_keys())
    m = tr.train_from_dataset(ds, table)
    assert m["count"] == 160 and np.isfinite(m["loss"])
    table.end_pass()
    table.close()
    ds.close()
