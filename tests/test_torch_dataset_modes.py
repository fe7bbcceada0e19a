"""The dataset's load modes against the JAX package and against each other:
preload into memory, the disk spill (its batches bit-equal to the
in-memory ones and to the reference's, its files removed on release), the
global shuffle through an in-process group of four datasets, the slot
shuffle, the reference's misuse errors, training and evaluating on a
spilled or PV-merged dataset, and the reader threads' lifetime.
"""

import gc
import os
import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.shuffle import InProcessShuffleGroup as RefGroup
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.data.shuffle import InProcessShuffleGroup, route_ids
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.train import Trainer
from test_torch_data import _with_ins_ids, assert_blocks_equal
from test_torch_pv import assert_batches_equal

torch.set_num_threads(1)

S, DENSE, BATCH = 4, 3, 24
KW = dict(parse_ins_id=True, parse_logkey=True, n_task_labels=1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes")
    return _with_ins_ids(write_synth_files(
        str(d), n_files=8, ins_per_file=50, n_sparse_slots=S, dense_dim=DENSE,
        vocab_per_slot=40, seed=17, with_logkey=True,
        cmatch_values=(222, 223, 1), n_task_labels=1))


def _ds(files, ref=False, read_threads=3, **kw):
    kw = {**KW, **kw}
    ds = (RefDataset(ref_synth_config(S, DENSE, BATCH, 16, **kw),
                     read_threads=read_threads) if ref else
          PadBoxSlotDataset(make_synth_config(S, DENSE, BATCH, 16, **kw),
                            read_threads=read_threads))
    ds.set_filelist(files)
    return ds


def test_preload_into_memory_equals_load(files):
    ds, loaded = _ds(files), _ds(files)
    ds.preload_into_memory()
    with pytest.raises(RuntimeError, match="in flight"):
        ds.preload_into_memory()
    ds.wait_preload_done()
    with pytest.raises(RuntimeError, match="no preload"):
        ds.wait_preload_done()
    loaded.load_into_memory()
    assert ds.parser._native is not None  # the native parser ran
    assert_blocks_equal(ds._block, loaded._block)
    assert ds.get_memory_data_size() == 400
    for a, b in zip(ds.batches(), loaded.batches()):
        assert_batches_equal(a, b)
    ds.close()
    loaded.close()


@pytest.mark.parametrize("read_threads", [1, 3])
def test_disk_spill_matches_memory_and_reference(files, tmp_path,
                                                 read_threads):
    """Spilled batches equal the in-memory ones and the reference's spilled
    ones bit for bit; the census is the same; at most read_threads parsed
    blocks are in flight; release_memory removes the files."""
    mem = _ds(files)
    mem.load_into_memory()
    ds = _ds(files, read_threads=read_threads)
    ref = _ds(files, ref=True, read_threads=read_threads)
    spill, ref_spill = str(tmp_path / "port"), str(tmp_path / "ref")
    ds.preload_into_disk(spill)
    ref.preload_into_disk(ref_spill)
    ds.wait_preload_done()
    ref.wait_preload_done()
    assert ds._block is None and len(os.listdir(spill)) == 8
    assert 1 <= ds.spill_peak_inflight <= read_threads
    assert ds.get_memory_data_size() == 400
    np.testing.assert_array_equal(ds.unique_keys(), mem.unique_keys())
    got = list(ds.batches())
    assert len(got) == 17  # 400 = 16 * 24 + 16: the tail batch is partial
    for a, b, c in zip(got, mem.batches(), ref.batches()):
        assert_batches_equal(a, b)
        assert_batches_equal(a, c)
    assert len(list(ds.batches(drop_last=True))) == 16
    ds.release_memory()
    ref.release_memory()
    assert os.listdir(spill) == []
    with pytest.raises(RuntimeError):
        next(iter(ds.batches()))
    for d in (mem, ds, ref):
        d.close()


def _load_group(group, files, spill_dir=None):
    """Four datasets of two files each, loading on their own preload
    threads, exchanged through ``group``."""
    dss = []
    for w in range(4):
        d = _ds(files[2 * w:2 * w + 2])
        d.shuffler = group.shuffler(w)
        if spill_dir is None:
            d.preload_into_memory()
        else:
            d.preload_into_disk(os.path.join(spill_dir, str(w)))
        dss.append(d)
    for d in dss:
        d.wait_preload_done()
    return dss


def test_global_shuffle_in_process_group(files, tmp_path):
    """Each record lands where route_ids says, the union is the input, the
    placement equals the reference group's, and a spilled load exchanges
    the same records."""
    whole = _ds(files)
    whole.load_into_memory()
    dest = dict(zip(whole._block.ins_ids, route_ids(whole._block, 4)))
    dss = _load_group(InProcessShuffleGroup(4), files)
    ref_group = RefGroup(4)
    refs = []
    for w in range(4):
        r = _ds(files[2 * w:2 * w + 2], ref=True)
        r.shuffler = ref_group.shuffler(w)
        r.preload_into_memory()
        refs.append(r)
    for r in refs:
        r.wait_preload_done()
    seen = []
    for w, (d, r) in enumerate(zip(dss, refs)):
        ids = d._block.ins_ids
        assert all(dest[i] == w for i in ids)
        assert sorted(ids) == sorted(r._block.ins_ids)
        seen += ids
        d.global_shuffle(seed=w)
        assert sum(b.n_real_ins for b in d.batches()) == len(ids)
    assert sorted(seen) == sorted(whole._block.ins_ids)
    spilled = _load_group(InProcessShuffleGroup(4), files, str(tmp_path))
    for d, s in zip(_load_group(InProcessShuffleGroup(4), files), spilled):
        for a, b in zip(d.batches(), s.batches()):
            assert_batches_equal(a, b)
    for d in [whole] + dss + refs + spilled:
        d.close()


def test_slots_shuffle_matches_reference(files):
    ds, ref = _ds(files[:2]), _ds(files[:2], ref=True)
    for d in (ds, ref):
        d.load_into_memory()
        d.slots_shuffle(["slot1", "slot3"], seed=5)
    assert_blocks_equal(ds._block, ref._block)
    ds.close()
    ref.close()


def _train(ds, passes=2):
    tconf = SparseTableConfig(embedding_dim=4, learning_rate=0.2)
    table = SparseTable(tconf, seed=1, device="cpu")
    tr = Trainer(CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                        seed=2, device="cpu"), tconf,
                 TrainerConfig(auc_buckets=1 << 10), device="cpu")
    out = []
    for _ in range(passes):
        table.begin_pass(ds.unique_keys())
        out.append(tr.train_from_dataset(ds, table))
        ev = tr.evaluate(ds, table)
        table.end_pass()
        out.append(ev)
    state = table.state_dict()
    table.close()
    return out, state


def test_spilled_pass_trains_bit_equal_to_memory(files, tmp_path):
    mem = _ds(files[:4])
    mem.load_into_memory()
    disk = _ds(files[:4])
    disk.preload_into_disk(str(tmp_path / "spill"))
    disk.wait_preload_done()
    (m_mem, s_mem), (m_disk, s_disk) = _train(mem), _train(disk)
    for a, b in zip(m_mem, m_disk):
        assert a["auc"] == b["auc"] and a["count"] == b["count"]
        assert a.get("loss") == b.get("loss")
    np.testing.assert_array_equal(s_mem["values"], s_disk["values"])
    mem.close()
    disk.close()


def test_evaluate_on_pv_merged_dataset(files):
    """evaluate takes PV batches: the same instances in another order give
    the same AUC histogram, so the same AUC and count."""
    flat = _ds(files[:4])
    pv = _ds(files[:4], enable_pv_merge=True, pv_batch_size=6)
    for d in (flat, pv):
        d.load_into_memory()
    pv.preprocess_instance()
    tconf = SparseTableConfig(embedding_dim=4)
    table = SparseTable(tconf, seed=1, device="cpu")
    tr = Trainer(CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16,),
                        seed=2, device="cpu"), tconf,
                 TrainerConfig(auc_buckets=1 << 10), device="cpu")
    table.begin_pass(flat.unique_keys())
    a, b = tr.evaluate(flat, table), tr.evaluate(pv, table)
    table.end_pass()
    assert a["auc"] == b["auc"] and a["count"] == b["count"] == 200
    table.close()
    flat.close()
    pv.close()


def _dataset_threads() -> set:
    return {t for t in threading.enumerate()
            if t.name.startswith(("dataset-read", "dataset-preload"))}


def _retired(threads, timeout_s=5.0) -> bool:
    for t in threads:
        t.join(timeout_s)
    return not any(t.is_alive() for t in threads)


def test_reader_threads_are_daemons_that_retire(files):
    """The readers and the preload run on daemon threads; close() retires
    them, a later load starts new ones, and a dataset collected unclosed
    leaves none behind."""
    before = _dataset_threads()
    ds = _ds(files[:2])
    ds.preload_into_memory()
    ds.wait_preload_done()
    mine = _dataset_threads() - before
    assert len(mine) == 3 + 1 and all(t.daemon for t in mine)
    ds.close()
    assert _retired(mine)
    before = _dataset_threads()
    ds.load_into_memory()  # usable after close
    assert ds.get_memory_data_size() == 100
    again = _dataset_threads() - before
    assert len(again) == 3
    del ds
    gc.collect()
    assert _retired(again)


def test_concat_and_select_carry_the_metadata(files):
    ds = _ds(files[:2])
    ds.load_into_memory()
    block = ds._block
    halves = [block.select(np.arange(50)), block.select(np.arange(50, 100))]
    assert_blocks_equal(RecordBlock.concat(halves), block)
    picked = block.select(np.array([7, 3]))
    assert picked.ins_ids == [block.ins_ids[7], block.ins_ids[3]]
    np.testing.assert_array_equal(picked.search_ids, block.search_ids[[7, 3]])
    np.testing.assert_array_equal(picked.task_labels,
                                  block.task_labels[[7, 3]])
    # a block without a column drops it from the merge
    bare = RecordBlock(**{**halves[1].__dict__, "ins_ids": None})
    assert RecordBlock.concat([halves[0], bare]).ins_ids is None
    ds.close()
