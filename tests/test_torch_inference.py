"""The port's serving export and Predictor against the JAX package's, on
the CPU (reference oracle: tests/test_inference.py and
tests/test_quantized_artifacts.py).

Each model trains one pass in the JAX package (3 slots, 2 dense, batch 8,
tower 16-8 as the reference's tests); the port's model and table take its
trained parameters and table state (``weights.params_from_jax_tree``, the
store's ``state_dict``).  Both packages export and predict the same
batches:

  * predictions agree at rtol 1e-5 / atol 1e-6 for CtrDnn, RankCtrDnn
    (PV-merged, rank_offset), LongSeqCtrDnn (seq_pos) and MMoE
    ([b, n_tasks]), over every batch, with a second shape bucket;
  * the sparse files and meta.json are byte-equal to the reference's, but
    for the program file names and ``program_format``; int8 and fp8
    ``quantize_rows`` codes are byte-equal;
  * create_threshold and pull_embedx_scale, unseen keys, every schema and
    bucket error the reference raises, ``with_delta`` (fp32 and quantized)
    and the refusal of a JAX artifact.
"""

import dataclasses
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
import paddlebox_tpu.models as ref_models
from paddlebox_tpu.data.dataset import PadBoxSlotDataset as RefDataset
from paddlebox_tpu.data.synth import make_synth_config as ref_synth_config
from paddlebox_tpu.inference import Predictor as RefPredictor
from paddlebox_tpu.inference import export_model as ref_export_model
from paddlebox_tpu.inference import quant as ref_quant
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu.train.trainer import Trainer as RefTrainer
import paddlebox_tpu_torch.models as models
from paddlebox_tpu_torch.config import SparseTableConfig
from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
from paddlebox_tpu_torch.inference import (
    EmbeddingDtypeMismatch,
    Predictor,
    export_model,
)
from paddlebox_tpu_torch.inference import quant
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.weights import params_from_jax_tree
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

S, DENSE, B, EMB = 3, 2, 8, 8
FEASIGNS = 16
KCAP = B * FEASIGNS
SEQ_T = 6
# scores: float32 towers summed in another order by the two CPU backends
TOL = dict(rtol=1e-5, atol=1e-6)

# kind -> (model class, model kwargs, data kwargs, write kwargs)
KINDS = {
    "ctr": ("CtrDnn", dict(hidden=(16, 8)), {}, {}),
    "rank": ("RankCtrDnn", dict(hidden=(16, 8), max_rank=3),
             dict(parse_logkey=True, enable_pv_merge=True, pv_batch_size=4,
                  rank_offset="rank_offset", n_task_labels=1),
             dict(with_logkey=True, max_ads_per_pv=3,
                  cmatch_values=(222, 223, 1), n_task_labels=1)),
    "longseq": ("LongSeqCtrDnn", dict(hidden=(16, 8), max_seq_len=SEQ_T,
                                      n_heads=2, head_dim=4),
                dict(sequence_slot="slot0", max_seq_len=SEQ_T),
                dict(max_keys_per_slot=6)),
    "mmoe": ("MMoE", dict(n_tasks=2, n_experts=2, expert_hidden=(16,),
                          expert_dim=8, tower_hidden=(8,)),
             dict(n_task_labels=1), dict(n_task_labels=1)),
}


@dataclasses.dataclass
class World:
    kind: str
    ref_model: object
    ref_params: object
    ref_table: object
    ref_conf: object
    model: object
    table: object
    conf: object
    ds: object
    ref_ds: object
    files: list


_WORLDS: dict = {}


def _datasets(files, kind, batch=B):
    dkw = KINDS[kind][2]
    out = []
    for mk, cls in ((make_synth_config, PadBoxSlotDataset),
                    (ref_synth_config, RefDataset)):
        ds = cls(mk(S, DENSE, batch, FEASIGNS, **dkw), read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        if dkw.get("enable_pv_merge"):
            ds.preprocess_instance()
        out.append(ds)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """kind -> World, each trained once in the JAX package."""
    root = tmp_path_factory.mktemp("inference")

    def get(kind):
        if kind in _WORLDS:
            return _WORLDS[kind]
        cls, mkw, _, wkw = KINDS[kind]
        files = write_synth_files(
            str(root / kind), n_files=1, ins_per_file=48, n_sparse_slots=S,
            vocab_per_slot=50, dense_dim=DENSE, seed=11, **wkw)
        ds, ref_ds = _datasets(files, kind)
        rconf = ref_config.SparseTableConfig(embedding_dim=EMB)
        ref_model = getattr(ref_models, cls)(S, rconf.row_width,
                                             dense_dim=DENSE, **mkw)
        ref_tr = RefTrainer(ref_model, rconf,
                            ref_config.TrainerConfig(auc_buckets=1 << 10),
                            seed=0)
        ref_table = RefTable(rconf, seed=0)
        ref_table.begin_pass(ref_ds.unique_keys())
        ref_tr.train_from_dataset(ref_ds, ref_table)
        ref_table.end_pass()
        ref_params = jax.tree.map(np.array, ref_tr.params)
        conf = SparseTableConfig(embedding_dim=EMB)
        model = getattr(models, cls)(S, conf.row_width, dense_dim=DENSE,
                                     device="cpu", **mkw)
        model.load_state_dict(params_from_jax_tree(ref_params))
        table = SparseTable(conf, device="cpu")
        table.load_state_dict(ref_table.state_dict())
        w = World(kind, ref_model, ref_params, ref_table, rconf, model, table,
                  conf, ds, ref_ds, files)
        _WORLDS[kind] = w
        return w

    yield get
    for w in _WORLDS.values():
        w.ds.close()
        w.ref_ds.close()
        w.table.close()
    _WORLDS.clear()


def _export_pair(w, root, tag, *, ref_table=None, table=None, **kw):
    """Export the world with both packages; returns the two artifact dirs."""
    kw.setdefault("batch_size", B)
    kw.setdefault("key_capacity", KCAP)
    kw.setdefault("dense_dim", DENSE)
    if getattr(w.model, "uses_rank_offset", False):
        kw.setdefault("rank_offset_cols", w.ds.conf.rank_offset_cols)
    ref_dir, dir_ = str(root / f"{tag}-ref"), str(root / f"{tag}-port")
    ref_export_model(w.ref_model, w.ref_params, ref_table or w.ref_table,
                     ref_dir, **kw)
    export_model(w.model, table or w.table, dir_, **kw)
    return ref_dir, dir_


def _scores_agree(ref_pred, pred, w, limit=None, sets=None) -> int:
    ds, ref_ds = sets or (w.ds, w.ref_ds)
    n = 0
    for i, (rb, b) in enumerate(zip(ref_ds.batches(drop_last=False),
                                    ds.batches(drop_last=False))):
        if limit is not None and i >= limit:
            break
        want = np.asarray(ref_pred.predict(rb))
        got = pred.predict(b)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
        n += got.shape[0]
    return n


@pytest.mark.parametrize("kind", list(KINDS))
def test_export_predict_parity(worlds, tmp_path, kind):
    """Every batch of the set, scored by both packages' Predictors; for
    CtrDnn also half batches through a second, smaller bucket."""
    w = worlds(kind)
    buckets = [(B // 2, KCAP // 2)] if kind == "ctr" else None
    ref_dir, dir_ = _export_pair(w, tmp_path, kind, batch_buckets=buckets)
    pred = Predictor.load(dir_, device="cpu")
    assert os.path.exists(os.path.join(dir_, "serving.pt2"))
    ref_pred = RefPredictor.load(ref_dir)
    n = _scores_agree(ref_pred, pred, w)
    assert n == w.ds.get_memory_data_size()
    if kind == "mmoe":
        assert pred.predict(next(w.ds.batches())).shape == (B, 2)
    if kind != "ctr":
        return
    assert sorted(pred.bucket_shapes) == [(B // 2, KCAP // 2), (B, KCAP)]
    half = _datasets(w.files, kind, batch=B // 2)
    try:
        assert _scores_agree(ref_pred, pred, w, limit=3, sets=half) > 0
        assert pred._pick_bucket(B // 2, 1)[:2] == (B // 2, KCAP // 2)
    finally:
        for d in half:
            d.close()


def _files(d):
    out = {}
    for sub, _, fs in os.walk(d):
        for f in fs:
            out[os.path.relpath(os.path.join(sub, f), d)] = os.path.join(sub,
                                                                         f)
    return out


@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp8", "legacy"])
def test_artifact_files_equal_the_reference(worlds, tmp_path, dtype):
    """Sparse files byte-equal, meta.json equal but for the program files
    and program_format, feed.json equal; the quantized predictions agree."""
    w = worlds("ctr")
    kw = dict(quantize=True) if dtype == "legacy" else dict(
        embedding_dtype=dtype)
    ref_dir, dir_ = _export_pair(w, tmp_path, dtype,
                                 batch_buckets=[(B // 2, KCAP // 2)],
                                 feed_conf=w.ds.conf, **kw)
    rf, pf = _files(ref_dir), _files(dir_)
    sparse = sorted(k for k in rf if k.startswith("sparse"))
    assert sparse == sorted(k for k in pf if k.startswith("sparse"))
    assert len(sparse) == (2 if dtype == "fp32" else 4)
    for k in sparse:
        assert filecmp.cmp(rf[k], pf[k], shallow=False), k
    with open(rf["meta.json"]) as f:
        rmeta = json.load(f)
    with open(pf["meta.json"]) as f:
        meta = json.load(f)
    assert meta.pop("program_format") == "torch.export"
    assert [b["file"] for b in rmeta.pop("buckets")] == [
        "serving.stablehlo", f"serving-b{B // 2}-k{KCAP // 2}.stablehlo"]
    assert [b["file"] for b in meta.pop("buckets")] == [
        "serving.pt2", f"serving-b{B // 2}-k{KCAP // 2}.pt2"]
    assert meta == rmeta
    with open(rf["feed.json"]) as f, open(pf["feed.json"]) as g:
        assert json.load(f) == json.load(g)
    pred = Predictor.load(dir_, device="cpu")
    assert pred.embedding_dtype == ("fp32" if dtype == "legacy" else dtype)
    ref_pred = RefPredictor.load(ref_dir)
    assert pred.artifact_bytes == ref_pred.artifact_bytes
    _scores_agree(ref_pred, pred, w, limit=2)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_rows_bytes_equal_the_reference(dtype):
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(257, 10)).astype(np.float32) * 3
    rows[5, 3:] = 0.0  # an all-zero embedx row: scale 1
    rows[7, 3] = 1e-30  # a denormal-scale row
    rows[9, 3:] = rng.normal(size=7) * 1e4
    head, q, sc = quant.quantize_rows(rows, 2, dtype)
    rhead, rq, rsc = ref_quant.quantize_rows(rows, 2, dtype)
    np.testing.assert_array_equal(head, rhead)
    np.testing.assert_array_equal(sc, rsc)
    assert q.tobytes() == ref_quant.store_q(rq).tobytes()
    assert q.dtype == ref_quant.store_q(rq).dtype
    np.testing.assert_array_equal(
        quant.dequantize_rows(head, q, sc),
        ref_quant.dequantize_rows(rhead, rq, rsc))
    # the encoder alone, past the format's range and at its edges
    x = np.concatenate([rng.uniform(-500, 500, 4096),
                        [448, 464, 464.01, -465, 0.0, -0.0, np.nan,
                         2.0 ** -10, 2.0 ** -12]]).astype(np.float32)
    if dtype == "fp8":
        assert quant.fp8_encode(x).tobytes() == x.astype(
            ref_quant.fp8_numpy_dtype()).view(np.uint8).tobytes()


@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp8"])
def test_create_threshold_and_embedx_scale(worlds, tmp_path, dtype):
    """A table config with create_threshold (half the trained keys below
    it) and pull_embedx_scale: both packages hide and descale the same
    rows."""
    w = worlds("ctr")
    state = w.ref_table.state_dict()
    thr = float(np.median(state["values"][:, 0]))
    rconf = dataclasses.replace(w.ref_conf, create_threshold=thr,
                                pull_embedx_scale=0.5)
    conf = dataclasses.replace(w.conf, create_threshold=thr,
                               pull_embedx_scale=0.5)
    rt, pt = RefTable(rconf, seed=0), SparseTable(conf, device="cpu")
    rt.load_state_dict(state)
    pt.load_state_dict(state)
    try:
        ref_dir, dir_ = _export_pair(w, tmp_path, dtype, ref_table=rt,
                                     table=pt, embedding_dtype=dtype)
        pred = Predictor.load(dir_, device="cpu")
        assert pred.meta["create_threshold"] == thr
        _scores_agree(RefPredictor.load(ref_dir), pred, w, limit=3)
    finally:
        pt.close()


def test_unseen_keys_and_bucket_guard(worlds, tmp_path):
    w = worlds("ctr")
    ref_dir, dir_ = _export_pair(w, tmp_path, "unseen")
    pred = Predictor.load(dir_, device="cpu")
    ref_pred = RefPredictor.load(ref_dir)
    batch = next(w.ds.batches(drop_last=False))
    rbatch = next(w.ref_ds.batches(drop_last=False))
    # half the keys unseen: they resolve to zero rows
    for bt in (batch, rbatch):
        bt.keys = bt.keys.copy()
        bt.keys[::2] += np.uint64(10_000_000)
    got = pred.predict(batch)
    np.testing.assert_allclose(got, np.asarray(ref_pred.predict(rbatch)),
                               **TOL)
    # keys at and above 2^63, the all-ones key among them, all unseen
    batch.keys[: batch.n_keys] = np.uint64(1 << 63) + np.arange(
        batch.n_keys, dtype=np.uint64)
    batch.keys[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    rbatch.keys = batch.keys.copy()
    np.testing.assert_allclose(pred.predict(batch),
                               np.asarray(ref_pred.predict(rbatch)), **TOL)
    for p in (pred, ref_pred):
        with pytest.raises(ValueError, match="bucket"):
            p._pick_bucket(B + 1, 0)
        with pytest.raises(ValueError, match="bucket"):
            p._pick_bucket(1, KCAP + 1)
    assert sum(p.shape[0] for p in pred.predict_dataset(w.ds)) == 48


def test_resolve_is_the_reference_resolve(worlds, tmp_path):
    """The device resolve (sorted_search + gather_slots twins on the CPU)
    gives the reference's host rows; -0.0 against +0.0 compares equal."""
    w = worlds("ctr")
    ref_dir, dir_ = _export_pair(w, tmp_path, "resolve")
    pred, ref_pred = Predictor.load(dir_, device="cpu"), RefPredictor.load(
        ref_dir)
    batch = next(w.ds.batches(drop_last=False))
    keys = batch.keys.copy()
    keys[1::3] += np.uint64(7_777_777)
    q = pred.upload_keys(keys, batch.n_keys)
    got = pred.resolve(q, KCAP)[0].numpy()
    want = ref_pred._resolve_rows(keys, batch.n_keys, KCAP)
    assert (got == want).all()


def test_schema_and_extra_errors(worlds, tmp_path):
    """Every schema error the reference raises, raised by the port with the
    same message keyword."""
    w = worlds("ctr")
    _, dir_ = _export_pair(w, tmp_path, "schema")
    pred = Predictor.load(dir_, device="cpu")
    batch = next(w.ds.batches(drop_last=False))
    with pytest.raises(ValueError, match="sparse slots"):
        pred.predict(dataclasses.replace(batch, n_sparse_slots=S + 1))
    with pytest.raises(ValueError, match="dense width"):
        pred.predict(dataclasses.replace(
            batch, dense=np.zeros((B, DENSE + 1), np.float32)))
    mask = batch.ins_mask.copy()
    mask[0] = 0.0
    with pytest.raises(ValueError, match="front-packed"):
        pred.predict(dataclasses.replace(batch, ins_mask=mask))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Predictor.load(dir_)  # the card is the default

    r = worlds("rank")
    _, rdir = _export_pair(r, tmp_path, "rank")
    rpred = Predictor.load(rdir, device="cpu")
    rb = next(r.ds.batches(drop_last=False))
    with pytest.raises(ValueError, match="rank_offset"):
        rpred.predict(dataclasses.replace(rb, rank_offset=None))
    with pytest.raises(ValueError, match="rank_offset has"):
        rpred.predict(dataclasses.replace(rb,
                                          rank_offset=rb.rank_offset[:, :3]))
    with pytest.raises(ValueError, match="rank_offset_cols"):
        export_model(r.model, r.table, str(tmp_path / "norank"),
                     batch_size=B, key_capacity=KCAP, dense_dim=DENSE)

    s = worlds("longseq")
    _, sdir = _export_pair(s, tmp_path, "seq")
    spred = Predictor.load(sdir, device="cpu")
    sb = next(s.ds.batches(drop_last=False))
    with pytest.raises(ValueError, match="seq_pos"):
        spred.predict(dataclasses.replace(sb, seq_pos=None))
    wide = np.full((B, 2 * SEQ_T), KCAP, np.int32)
    with pytest.raises(ValueError, match="seq_len"):
        spred.predict(dataclasses.replace(sb, seq_pos=wide))
    # a narrower feed pads with the marker and scores as the full one
    narrow = sb.seq_pos[:, :SEQ_T - 2]
    full = sb.seq_pos.copy()
    full[:, SEQ_T - 2:] = KCAP
    np.testing.assert_array_equal(
        spred.predict(dataclasses.replace(sb, seq_pos=narrow)),
        spred.predict(dataclasses.replace(sb, seq_pos=full)))
    # a feed whose batch fits no exported bucket is refused up front
    with pytest.raises(ValueError, match="fits no"):
        export_model(w.model, w.table, str(tmp_path / "nofit"),
                     batch_size=B // 2, key_capacity=KCAP, dense_dim=DENSE,
                     feed_conf=w.ds.conf)


def test_jax_artifact_refused(worlds, tmp_path):
    w = worlds("ctr")
    ref_dir, _ = _export_pair(w, tmp_path, "jaxart")
    with pytest.raises(ValueError, match="serving.stablehlo"):
        Predictor.load(ref_dir, device="cpu")


def _delta(state, rng, n_new, width):
    """A delta: a third of the keys rewritten, n_new new keys, and a
    duplicate whose last occurrence must win."""
    keys = state["keys"]
    pick = keys[rng.choice(keys.shape[0], keys.shape[0] // 3, replace=False)]
    new = np.uint64(90_000_000) + np.arange(n_new, dtype=np.uint64)
    dk = np.concatenate([pick, new, pick[:1]])
    dv = rng.normal(size=(dk.shape[0], width)).astype(np.float32)
    dv[:, :2] = np.abs(dv[:, :2]) * 5
    return dk, dv


@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp8"])
def test_with_delta_equals_the_reference(worlds, tmp_path, dtype):
    w = worlds("ctr")
    ref_dir, dir_ = _export_pair(w, tmp_path, f"delta-{dtype}",
                                 embedding_dtype=dtype)
    pred = Predictor.load(dir_, device="cpu")
    ref_pred = RefPredictor.load(ref_dir)
    rng = np.random.default_rng(5)
    dk, dv = _delta(w.ref_table.state_dict(), rng, 7, w.conf.row_width)
    if dtype == "fp32":
        got = pred.with_delta(dk, dv)
        want = ref_pred.with_delta(dk, dv)
        np.testing.assert_array_equal(got._values, want._values)
    else:
        h, q, sc = quant.quantize_rows(dv, 2, dtype)
        rh, rq, rsc = ref_quant.quantize_rows(dv, 2, dtype)
        got = pred.with_delta(dk, head=h, embedx_q=q, scales=sc,
                              embedding_dtype=dtype)
        want = ref_pred.with_delta(dk, head=rh, embedx_q=rq, scales=rsc,
                                   embedding_dtype=dtype)
        np.testing.assert_array_equal(got._head, want._head)
        assert got._q.tobytes() == want._q.view(np.uint8).tobytes()
        np.testing.assert_array_equal(got._scales, want._scales)
        with pytest.raises(EmbeddingDtypeMismatch):
            pred.with_delta(dk, dv)
        other = "fp8" if dtype == "int8" else "int8"
        oh, oq, osc = quant.quantize_rows(dv, 2, other)
        with pytest.raises(EmbeddingDtypeMismatch):
            pred.with_delta(dk, head=oh, embedx_q=oq, scales=osc,
                            embedding_dtype=dtype)
    np.testing.assert_array_equal(got._keys, want._keys)
    assert got.n_features == pred.n_features + 7
    assert got._programs is pred._programs  # loaded programs shared
    _scores_agree(want, got, w, limit=2)
    # the old snapshot is untouched
    _scores_agree(ref_pred, pred, w, limit=1)
    with pytest.raises(ValueError):
        pred.with_delta(dk[:-1], **(
            dict(values=dv) if dtype == "fp32" else
            dict(head=h, embedx_q=q, scales=sc, embedding_dtype=dtype)))


def test_export_params_and_serial_models_only(worlds, tmp_path):
    """``params`` (a multi-chip trainer's ``dense_state()[0]``) loads into
    a copy of the model before export, leaving the model as it was; a
    model on a parallel axis is refused."""
    from paddlebox_tpu_torch.parallel import make_mesh

    w = worlds("ctr")
    kw = dict(batch_size=B, key_capacity=KCAP, dense_dim=DENSE)
    other = models.CtrDnn(S, w.conf.row_width, dense_dim=DENSE,
                          hidden=(16, 8), seed=9, device="cpu")
    before = {k: v.clone() for k, v in other.state_dict().items()}
    export_model(other, w.table, str(tmp_path / "p"),
                 params=w.model.state_dict(), **kw)
    export_model(w.model, w.table, str(tmp_path / "m"), **kw)
    assert all(torch.equal(v, before[k])
               for k, v in other.state_dict().items())
    batch = next(w.ds.batches())
    np.testing.assert_array_equal(
        Predictor.load(str(tmp_path / "p"), device="cpu").predict(batch),
        Predictor.load(str(tmp_path / "m"), device="cpu").predict(batch))
    sharded = models.LongSeqCtrDnn(
        S, w.conf.row_width, dense_dim=DENSE, max_seq_len=8, n_heads=2,
        head_dim=4, seq_mesh=make_mesh(2, device="cpu", axis_name="seq"),
        device="cpu")
    with pytest.raises(ValueError, match="seq_mesh"):
        export_model(sharded, w.table, str(tmp_path / "s"), **kw)
