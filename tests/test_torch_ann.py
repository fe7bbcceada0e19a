"""The port's ANN index (inference/ann.py) and POST /retrieve against the
JAX package's, on the CPU (reference oracle: tests/test_ann.py).

  * exact top-k keys equal the JAX ``AnnIndex``'s, scores within 1e-6,
    equal scores in index order;
  * the int8 coarse tier's recall@10 against exact >= 0.95 (the pin of
    tests/test_ann.py), its codes and the fp8 tier's byte-equal;
  * save and load in the reference's files (each package loads the
    other's), ``with_delta`` equal to the reference's, fp32 and quantized;
  * ``export_ann_index`` from a table equal to the reference's, and
    ``/retrieve`` answering ``search``.
"""

import filecmp
import http.client
import json

import numpy as np
import pytest
import torch

import paddlebox_tpu.config as ref_config
from paddlebox_tpu.inference import quant as ref_quant
from paddlebox_tpu.inference.ann import AnnIndex as RefIndex
from paddlebox_tpu.inference.ann import export_ann_index as ref_export
from paddlebox_tpu.sparse.table import SparseTable as RefTable
from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.config import SparseTableConfig
from paddlebox_tpu_torch.inference import ScoringServer, quant
from paddlebox_tpu_torch.inference.ann import (
    AnnIndex,
    export_ann_index,
    rows_to_item_embeddings,
)
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401

torch.set_num_threads(1)

SCORE_TOL = 1e-6  # float32 dot products of unit vectors, two backends


def _unit_rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _meta(n, d, **over):
    return {"embed_dim": d, "row_width": d + 2, "cvm_offset": 2,
            "item_key_lo": 1, "item_key_hi": n, "create_threshold": 0.0,
            **over}


def _pair(n=300, d=16, seed=2, **over):
    keys = np.arange(1, n + 1, dtype=np.uint64)
    emb = _unit_rows(n, d, seed)
    return (AnnIndex(keys, emb, _meta(n, d, **over), device="cpu"),
            RefIndex(keys, emb, _meta(n, d, **over)))


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_search_equals_the_reference(tier):
    idx, ref = _pair()
    q = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
    keys, scores = idx.search(q, k=10, tier=tier)
    rkeys, rscores = ref.search(q, k=10, tier=tier)
    np.testing.assert_array_equal(keys, rkeys)
    np.testing.assert_allclose(scores, rscores, rtol=0, atol=SCORE_TOL)
    assert keys.dtype == np.uint64 and scores.dtype == np.float32
    # k clamps to the index size
    k_all, _ = idx.search(q[:2], k=1000, tier=tier)
    assert k_all.shape == (2, 300)


def test_ties_keep_index_order():
    """Duplicate rows score equal: they come back in index order.  (The
    reference's stable argsort keeps the order its argpartition left,
    which is not the index order, so only the sets of tied keys and the
    scores are compared with it here.)"""
    n, d = 12, 4
    emb = np.repeat(_unit_rows(3, d, seed=9), 4, axis=0)
    keys = np.arange(10, 10 + n, dtype=np.uint64)
    idx = AnnIndex(keys, emb, _meta(n, d), device="cpu")
    ref = RefIndex(keys, emb, _meta(n, d))
    q = emb[[0, 4, 8]] * 3.0
    got, scores = idx.search(q, k=n)
    rgot, rscores = ref.search(q, k=n)
    np.testing.assert_allclose(scores, rscores, rtol=0, atol=SCORE_TOL)
    for row, rrow in zip(got, rgot):
        for grp in range(3):
            block = row[grp * 4:(grp + 1) * 4]
            np.testing.assert_array_equal(block, np.sort(block))
            assert set(block) == set(rrow[grp * 4:(grp + 1) * 4])


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_coarse_tier_recall_and_bytes(dtype):
    idx, ref = _pair(coarse_dtype=dtype)
    head, q, sc = idx._coarse_tier()
    rhead, rq, rsc = ref._coarse_tier()
    np.testing.assert_array_equal(head, rhead)
    np.testing.assert_array_equal(sc, rsc)
    assert q.tobytes() == ref_quant.store_q(rq).tobytes()
    np.testing.assert_array_equal(idx.coarse_matrix(), ref.coarse_matrix())
    assert idx.artifact_bytes == ref.artifact_bytes
    qs = _unit_rows(64, 16, seed=3)
    ek, _ = idx.search(qs, k=10, tier="exact")
    qk, _ = idx.search(qs, k=10, tier="int8")
    recall = np.mean([len(set(ek[i]) & set(qk[i])) / 10.0
                      for i in range(len(qs))])
    assert recall >= 0.95, f"{dtype} recall@10 {recall:.3f} < 0.95"


def test_search_validation():
    idx, _ = _pair(n=20, d=8)
    q = _unit_rows(2, 8)
    with pytest.raises(ValueError, match="tier"):
        idx.search(q, k=3, tier="fp64")
    with pytest.raises(ValueError, match="k"):
        idx.search(q, k=0)
    with pytest.raises(ValueError, match="dim"):
        idx.search(_unit_rows(2, 5), k=3)
    with pytest.raises(ValueError, match="sorted"):
        AnnIndex(np.array([2, 1], np.uint64), _unit_rows(2, 8), _meta(2, 8),
                 device="cpu")
    with pytest.raises(ValueError, match="retrieve"):
        idx.predict({})
    empty = AnnIndex(np.zeros(0, np.uint64), np.zeros((0, 8), np.float32),
                     _meta(0, 8), device="cpu")
    keys, scores = empty.search(q, k=5)
    assert keys.shape == (2, 0) and scores.shape == (2, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            AnnIndex(idx.keys, idx.emb, idx.meta)  # the card is the default


def test_save_load_the_reference_files(tmp_path):
    idx, ref = _pair(n=40, d=8, coarse_dtype="fp8")
    idx.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    for name in ("ann_keys.npy", "ann_emb.npy"):
        assert filecmp.cmp(str(tmp_path / "port" / name),
                           str(tmp_path / "ref" / name), shallow=False)
    with np.load(str(tmp_path / "port" / "ann_coarse.npz")) as a, \
            np.load(str(tmp_path / "ref" / "ann_coarse.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    with open(tmp_path / "port" / "meta.json") as f, \
            open(tmp_path / "ref" / "meta.json") as g:
        assert json.load(f) == json.load(g)
    # each package loads the other's artifact
    back = AnnIndex.load(str(tmp_path / "ref"), device="cpu")
    rback = RefIndex.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.keys, ref.keys)
    np.testing.assert_array_equal(back.coarse_matrix(), rback.coarse_matrix())
    q = _unit_rows(5, 8, seed=4)
    np.testing.assert_array_equal(back.search(q, 7, "int8")[0],
                                  rback.search(q, 7, "int8")[0])
    with open(tmp_path / "ref" / "meta.json", "w") as f:
        json.dump({"artifact_kind": "ranking"}, f)
    with pytest.raises(ValueError, match="not an ANN artifact"):
        AnnIndex.load(str(tmp_path / "ref"), device="cpu")


@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp8"])
def test_with_delta_equals_the_reference(dtype):
    idx, ref = _pair(n=10, d=8, item_key_hi=20, create_threshold=5.0)
    w = idx.meta["row_width"]
    rng = np.random.default_rng(4)
    # key 3 replaced, 25 outside [1, 20] dropped, 15 twice (last wins),
    # 16 below the create_threshold dropped
    keys = np.array([3, 25, 15, 16, 15], np.uint64)
    vals = rng.normal(size=(5, w)).astype(np.float32)
    vals[:, 0] = [10.0, 10.0, 10.0, 2.0, 10.0]
    if dtype == "fp32":
        new, rnew = idx.with_delta(keys, vals), ref.with_delta(keys, vals)
    else:
        h, q, sc = quant.quantize_rows(vals, 2, dtype)
        rh, rq, rsc = ref_quant.quantize_rows(vals, 2, dtype)
        new = idx.with_delta(keys, head=h, embedx_q=q, scales=sc,
                             embedding_dtype=dtype)
        rnew = ref.with_delta(keys, head=rh, embedx_q=rq, scales=rsc,
                              embedding_dtype=dtype)
    np.testing.assert_array_equal(new.keys, rnew.keys)
    np.testing.assert_array_equal(new.emb, rnew.emb)
    assert new.n_items == rnew.meta["n_items"] == 11
    assert idx.n_items == 10  # the source is untouched
    assert idx.with_delta(np.array([99], np.uint64),
                          vals[:1]) is idx  # nothing in range
    q = _unit_rows(3, 8, seed=6)
    np.testing.assert_array_equal(new.search(q, 4)[0], rnew.search(q, 4)[0])


def test_rows_to_item_embeddings_and_export(tmp_path):
    """export_ann_index over the same table state in both packages: the
    item range, the threshold filter and the matrix agree."""
    values = np.random.default_rng(0).normal(size=(5, 11)).astype(np.float32)
    emb = rows_to_item_embeddings(values, cvm_offset=2, row_width=10)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    rng = np.random.default_rng(1)
    keys = np.sort(rng.choice(np.arange(1, 400, dtype=np.uint64), 200,
                              replace=False))
    vals = rng.normal(size=(200, 11)).astype(np.float32)
    vals[:, 0] = rng.integers(0, 10, 200)
    state = {"keys": keys, "values": vals}
    conf = SparseTableConfig(embedding_dim=8, create_threshold=3.0)
    rconf = ref_config.SparseTableConfig(embedding_dim=8, create_threshold=3.0)
    table, rtable = SparseTable(conf, device="cpu"), RefTable(rconf)
    table.load_state_dict(state)
    rtable.load_state_dict(state)
    try:
        idx = export_ann_index(str(tmp_path / "p"), table, item_key_lo=100,
                               item_key_hi=300, device="cpu")
        ridx = ref_export(str(tmp_path / "r"), rtable, item_key_lo=100,
                          item_key_hi=300)
    finally:
        table.close()
    np.testing.assert_array_equal(idx.keys, ridx.keys)
    np.testing.assert_array_equal(idx.emb, ridx.emb)
    assert idx.meta == ridx.meta
    assert idx.keys.min() >= 100 and idx.keys.max() <= 300
    with pytest.raises(ValueError, match="quantized tier"):
        export_ann_index(str(tmp_path / "x"), table, item_key_lo=1,
                         item_key_hi=2, coarse_dtype="fp32", device="cpu")


def _post(port, body, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_retrieve_endpoint():
    idx, _ = _pair(n=120, d=8)
    srv = ScoringServer(device="cpu")
    srv.register_predictor("ann", idx, None)
    conf = DataFeedConfig(
        slots=(SlotConfig("click", type="float", is_dense=True),
               SlotConfig("s0")),
        batch_size=8,
    )

    class _Stub:
        meta = {"n_tasks": 1, "row_width": 4}
        bucket_shapes = [(8, 64)]
        n_features = 1

    srv.register_predictor("ctr", _Stub(), conf)
    with pytest.raises(ValueError, match="feed schema"):
        srv.register_predictor("bad", _Stub(), None)
    port = srv.start(port=0)
    try:
        q = _unit_rows(4, 8, seed=8).tolist()
        for tier in ("exact", "int8"):
            st, out = _post(port, json.dumps(
                {"queries": q, "k": 5, "tier": tier}).encode(), "/retrieve")
            assert st == 200 and out["tier"] == tier
            assert out["n_items"] == 120
            want_k, want_s = idx.search(np.asarray(q, np.float32), 5, tier)
            assert [r["keys"] for r in out["results"]] == want_k.tolist()
            np.testing.assert_allclose(
                [r["scores"] for r in out["results"]], want_s, rtol=1e-6)
        st, out = _post(port, json.dumps({"queries": q[0]}).encode(),
                        "/retrieve/ann")
        assert st == 200 and len(out["results"]) == 1
        for body, path, code in (
            (b"{not json", "/retrieve", 400),
            (json.dumps({"k": 3}).encode(), "/retrieve", 400),
            (json.dumps({"queries": q, "tier": "fp64"}).encode(),
             "/retrieve", 400),
            (json.dumps({"queries": q}).encode(), "/retrieve/ctr", 400),
            (json.dumps({"queries": q}).encode(), "/retrieve/nope", 404),
            (b"1 0 1 5\n", "/score/ann", 400),
        ):
            assert _post(port, body, path)[0] == code, (path, body)
    finally:
        srv.stop()
