"""The Criteo CTR-DNN recipe end to end, the port against the JAX package
(reference: examples/train_criteo.py).

One synthetic Criteo TSV from a seed, converted by both packages'
``convert_criteo_files`` (the shards must be byte-equal), loaded with
``criteo_feed_config``, and trained for two passes by each package's
``Trainer`` at the recipe's layout (26 hashed slots, 13 ``log1p`` counts,
``embedding_dim`` 8) at a small size: batch 128, 1 024 lines, tower 32-16,
the default HBM cache and pass boundary.  The port starts from the
reference's tower (``weights.params_from_jax``).
"""

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.data import criteo as ref_criteo
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.models import CtrDnn as RefCtrDnn
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.data import criteo
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.weights import params_from_jax
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

LINES, BATCH, EMB, HIDDEN, PASSES = 1024, 128, 8, (32, 16), 2
# the writer's default vocabulary (1 000 tokens a column): keys recur across
# the 1 024 lines, so the second pass hits the HBM cache
VOCAB = 1000


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo")
    tsv = criteo.write_criteo_format_sample(str(d / "sample.tsv"),
                                            n_lines=LINES, seed=5,
                                            vocab_per_cat=VOCAB)
    got = criteo.convert_criteo_files([tsv], str(d / "port"),
                                      batch_size=BATCH)
    want = ref_criteo.convert_criteo_files([tsv], str(d / "ref"),
                                           batch_size=BATCH)
    return got, want


def _passes(ds, table, trainer, census):
    """Per pass the metrics and the HBM cache's hits at begin_pass."""
    out = []
    for _ in range(PASSES):
        table.begin_pass(census)
        hits = table.last_cache_hits
        m = trainer.train_from_dataset(ds, table,
                                       auc_state=trainer.last_metric_state)
        table.end_pass()
        out.append(dict(m, cache_hits=hits))
    return out


def test_criteo_passes_match_reference(shards):
    """Per pass the loss, the cumulative AUC and the counts; the census,
    the feature count and every table row after the last pass."""
    got_shards, want_shards = shards
    assert len(got_shards) == len(want_shards) == 1
    with open(got_shards[0], "rb") as a, open(want_shards[0], "rb") as b:
        assert a.read() == b.read()

    rconf = ref_config.SparseTableConfig(embedding_dim=EMB)
    ref_ds = RefDataset(ref_criteo.criteo_feed_config(BATCH), read_threads=1)
    ref_ds.set_filelist(want_shards)
    ref_ds.load_into_memory()
    ref_table = RefTable(rconf, seed=0)
    ref_tr = RefTrainer(
        RefCtrDnn(ref_criteo.CRITEO_N_CAT, rconf.row_width,
                  dense_dim=ref_criteo.CRITEO_N_DENSE, hidden=HIDDEN),
        rconf, ref_config.TrainerConfig(auc_buckets=1 << 16), seed=0)
    tower = [{k: np.array(v) for k, v in layer.items()}
             for layer in ref_tr.params["tower"]]

    tconf = SparseTableConfig(embedding_dim=EMB)
    assert tconf.hbm_cache_rows == rconf.hbm_cache_rows > 0
    ds = PadBoxSlotDataset(criteo.criteo_feed_config(BATCH), read_threads=1)
    ds.set_filelist(got_shards)
    ds.load_into_memory()
    table = SparseTable(tconf, seed=0, device="cpu")
    model = CtrDnn(criteo.CRITEO_N_CAT, tconf.row_width,
                   dense_dim=criteo.CRITEO_N_DENSE, hidden=HIDDEN,
                   device="cpu")
    model.load_state_dict(params_from_jax(tower))
    tr = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 16),
                 device="cpu")
    try:
        census = ds.unique_keys()
        ref_census = ref_ds.unique_keys()
        np.testing.assert_array_equal(census, ref_census)
        want = _passes(ref_ds, ref_table, ref_tr, ref_census)
        got = _passes(ds, table, tr, census)
        rs, ps = ref_table.state_dict(), table.state_dict()
        assert table.n_features == ref_table.n_features == census.shape[0]
    finally:
        ref_ds.close()
        ds.close()
        table.close()
    assert got[1]["cache_hits"] > 0, "the second pass never hit the cache"
    for p, (g, w) in enumerate(zip(got, want)):
        assert g["cache_hits"] == w["cache_hits"]
        # the AUC state continues across passes: counts are cumulative
        assert g["count"] == w["count"] == LINES * (p + 1)
        assert g["steps"] == w["steps"] == LINES // BATCH
        # the slice trainer's bounds (tests/test_torch_trainer.py): float32
        # sums and matmuls in another order on the two CPU backends drift
        # ~1e-7 an op, well under 1e-5 over 16 steps; a prediction moved
        # by that can cross one of the AUC's bucket edges, ~1e-5 of AUC
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert abs(g["auc"] - w["auc"]) < 1e-4, (g["auc"], w["auc"])
    np.testing.assert_array_equal(ps["keys"], rs["keys"])
    # rows at tests/test_torch_trainer.py's bound: show and click counters
    # exact, embeddings and g2sum within rtol 1e-5, atol 1e-6
    np.testing.assert_array_equal(ps["values"][:, :2], rs["values"][:, :2])
    np.testing.assert_allclose(ps["values"], rs["values"], rtol=1e-5,
                               atol=1e-6)
