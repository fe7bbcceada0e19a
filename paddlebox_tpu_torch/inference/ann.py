"""ANN-servable item index exported from the shared SparseTable (reference:
paddlebox_tpu/inference/ann.py).

The serving artifact of the two-tower retrieval scenario
(models/two_tower.py): the item tower is the identity over the pooled
item-slot embedding, so the servable index is the table's item rows,
``row[cvm_offset:]`` L2-normalized.

Two scoring tiers over one matrix, both on the index's device:

  * ``exact`` — f32 ``queries @ emb.T`` (``torch.matmul``) and a top-k;
  * ``int8`` — the same matrix through the row codec of quant.py
    (``quantize_rows`` with ``cvm_offset=0``: the first column f32, the
    rest int8, or fp8 with ``coarse_dtype="fp8"``, one f32 scale a row),
    dequantized once and cached.

The top-k is ordered by descending score with ties in index order (the
reference's argpartition leaves tied items in an order of its own before
its stable sort).  :class:`AnnIndex` duck-types the
Predictor surface the delivery plane touches (``meta`` / ``n_features`` /
``bucket_shapes`` / ``embedding_dtype`` / ``artifact_bytes`` / ``load`` /
``with_delta``); ``meta["artifact_kind"] == "ann"`` is the dispatch key.
Files and their format are the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from paddlebox_tpu_torch.inference import quant
from paddlebox_tpu_torch.utils.device import resolve_device

META_NAME = "meta.json"
KEYS_NAME = "ann_keys.npy"
EMB_NAME = "ann_emb.npy"
COARSE_NAME = "ann_coarse.npz"

ARTIFACT_KIND = "ann"


def _l2_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    x = np.asarray(x, np.float32)
    norm = np.sqrt(np.maximum((x * x).sum(axis=1, keepdims=True), eps))
    return (x / norm).astype(np.float32)


def rows_to_item_embeddings(values: np.ndarray, cvm_offset: int,
                            row_width: int) -> np.ndarray:
    """Table rows -> normalized item vectors: the ``use_cvm=False`` pooled
    view of a single-key instance (``row[cvm_offset:row_width]``),
    L2-normalized."""
    vals = np.asarray(values, np.float32)[:, cvm_offset:row_width]
    return _l2_normalize(vals)


class AnnIndex:
    """Normalized item-embedding matrix + exact/int8 top-k scorers."""

    def __init__(self, keys: np.ndarray, emb: np.ndarray, meta: dict,
                 device="cuda"):
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.emb = np.ascontiguousarray(emb, dtype=np.float32)
        if self.keys.shape[0] != self.emb.shape[0]:
            raise ValueError(
                f"keys/emb row mismatch: {self.keys.shape[0]} vs "
                f"{self.emb.shape[0]}"
            )
        if self.keys.shape[0] > 1 and not bool(
            np.all(self.keys[1:] > self.keys[:-1])
        ):
            raise ValueError("AnnIndex keys must be strictly sorted")
        self.meta = dict(meta)
        self.meta.setdefault("artifact_kind", ARTIFACT_KIND)
        self.meta.setdefault("n_tasks", 1)
        self.device = resolve_device(device)
        self._emb_dev = torch.from_numpy(self.emb).to(self.device)
        self._coarse = None  # (head, q, scales), built lazily
        self._coarse_dev = None  # its dequantized matrix on the device

    # -- Predictor duck-type surface (delivery plane) ----------------------- #
    @property
    def n_features(self) -> int:
        return int(self.keys.shape[0])

    @property
    def n_items(self) -> int:
        return self.n_features

    @property
    def bucket_shapes(self) -> list:
        return []  # no program ladder

    @property
    def embedding_dtype(self) -> str:
        # the index is f32; the coarse tier is a per-request choice
        return self.meta.get("embedding_dtype", "fp32")

    @property
    def artifact_bytes(self) -> int:
        head, q, scales = self._coarse_tier()
        return int(self.keys.nbytes + self.emb.nbytes + head.nbytes
                   + q.nbytes + scales.nbytes)

    def predict(self, batch):
        raise ValueError(
            "this model is a retrieval index: POST /retrieve (it has no "
            "slot-text scoring program)"
        )

    # -- persistence -------------------------------------------------------- #
    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, KEYS_NAME), self.keys)
        np.save(os.path.join(out_dir, EMB_NAME), self.emb)
        head, q, scales = self._coarse_tier()
        np.savez(os.path.join(out_dir, COARSE_NAME),
                 head=head, q=q, scales=scales)
        with open(os.path.join(out_dir, META_NAME), "w") as fh:
            json.dump(self.meta, fh, indent=1)

    @classmethod
    def load(cls, artifact_dir: str, device="cuda") -> "AnnIndex":
        with open(os.path.join(artifact_dir, META_NAME)) as fh:
            meta = json.load(fh)
        if meta.get("artifact_kind") != ARTIFACT_KIND:
            raise ValueError(
                f"{artifact_dir} is not an ANN artifact "
                f"(artifact_kind={meta.get('artifact_kind')!r})"
            )
        keys = np.load(os.path.join(artifact_dir, KEYS_NAME))
        emb = np.load(os.path.join(artifact_dir, EMB_NAME))
        idx = cls(keys, emb, meta, device=device)
        coarse_path = os.path.join(artifact_dir, COARSE_NAME)
        if os.path.exists(coarse_path):
            with np.load(coarse_path) as c:
                idx._coarse = (
                    np.asarray(c["head"], np.float32),
                    quant.load_q(c["q"], meta.get("coarse_dtype", "int8")),
                    np.asarray(c["scales"], np.float32),
                )
        return idx

    # -- delta merge (hot-apply path) --------------------------------------- #
    def with_delta(
        self,
        keys: np.ndarray,
        values: Optional[np.ndarray] = None,
        program_dir: Optional[str] = None,
        bucket_meta=None,
        *,
        head: Optional[np.ndarray] = None,
        embedx_q: Optional[np.ndarray] = None,
        scales: Optional[np.ndarray] = None,
        embedding_dtype: str = "fp32",
    ) -> "AnnIndex":
        """Build-aside merge of a sparse delta: the rows are full table
        rows, so only keys inside this index's item range update it.
        Quantized deltas dequantize through quant.py first (the index stays
        f32).  program_dir / bucket_meta do not apply and are ignored."""
        del program_dir, bucket_meta
        keys = np.asarray(keys, dtype=np.uint64)
        if values is None:
            if head is None or embedx_q is None or scales is None:
                raise ValueError(
                    "with_delta needs values=... or head/embedx_q/scales"
                )
            quant.validate_dtype(embedding_dtype)
            values = quant.dequantize_rows(head, embedx_q, scales)
        values = np.asarray(values, dtype=np.float32)
        w = int(self.meta["row_width"])
        co = int(self.meta["cvm_offset"])
        if values.shape[0] and values.shape[1] < w:
            raise ValueError(
                f"delta rows of width {values.shape[1]} < artifact "
                f"row_width {w}"
            )
        lo = np.uint64(self.meta["item_key_lo"])
        hi = np.uint64(self.meta["item_key_hi"])
        in_range = (keys >= lo) & (keys <= hi)
        keys, values = keys[in_range], values[in_range]
        thr = float(self.meta.get("create_threshold", 0.0))
        if thr > 0 and keys.shape[0]:
            # rows below create_threshold serve a zero embedding in
            # training, so they are no candidates yet
            admitted = values[:, 0] >= thr
            keys, values = keys[admitted], values[admitted]
        if not keys.shape[0]:
            return self
        # dedup, LAST write wins
        order = np.argsort(keys, kind="stable")
        keys, values = keys[order], values[order]
        last = np.ones(keys.shape[0], bool)
        last[:-1] = keys[1:] != keys[:-1]
        keys, values = keys[last], values[last]
        new_emb = rows_to_item_embeddings(values, co, w)
        pos = np.searchsorted(self.keys, keys)
        pos_c = np.minimum(pos, max(self.n_features - 1, 0))
        exists = (self.n_features > 0) & (self.keys[pos_c] == keys)
        merged_keys = self.keys.copy()
        merged_emb = self.emb.copy()
        if exists.any():
            merged_emb[pos_c[exists]] = new_emb[exists]
        ins = ~exists
        if ins.any():
            merged_keys = np.insert(merged_keys, pos[ins], keys[ins])
            merged_emb = np.insert(merged_emb, pos[ins], new_emb[ins],
                                   axis=0)
        meta = dict(self.meta)
        meta["n_items"] = int(merged_keys.shape[0])
        return AnnIndex(merged_keys, merged_emb, meta, device=self.device)

    # -- scoring ------------------------------------------------------------ #
    def _coarse_tier(self):
        if self._coarse is None:
            dtype = self.meta.get("coarse_dtype", "int8")
            if self.emb.shape[0] == 0:
                d = self.emb.shape[1] if self.emb.ndim == 2 else 1
                self._coarse = (
                    np.zeros((0, 1), np.float32),
                    np.zeros((0, max(d - 1, 0)), quant.code_dtype(dtype)),
                    np.zeros((0,), np.float32),
                )
            else:
                self._coarse = quant.quantize_rows(self.emb, 0, dtype)
        return self._coarse

    def coarse_matrix(self) -> np.ndarray:
        """The coarse tier's dequantized matrix (what ``tier="int8"``
        scores against), on the host."""
        head, q, scales = self._coarse_tier()
        if self.emb.shape[0] == 0:
            return self.emb
        return quant.dequantize_rows(head, q, scales)

    def _matrix(self, tier: str) -> torch.Tensor:
        if tier == "exact":
            return self._emb_dev
        if self._coarse_dev is None:
            self._coarse_dev = torch.from_numpy(
                np.ascontiguousarray(self.coarse_matrix())).to(self.device)
        return self._coarse_dev

    def search(self, queries: np.ndarray, k: int = 10,
               tier: str = "exact"):
        """Top-k by inner product over normalized vectors.  Returns
        ``(keys [Q, k] uint64, scores [Q, k] f32)``; k clamps to the index
        size.  Queries are L2-normalized here (callers send raw user-tower
        outputs)."""
        if tier not in ("exact", "int8"):
            raise ValueError(f"unknown tier {tier!r} (want exact | int8)")
        q = np.atleast_2d(np.asarray(queries, np.float32))
        d = self.emb.shape[1]
        if q.shape[1] != d:
            raise ValueError(
                f"query dim {q.shape[1]} != index embed_dim {d}"
            )
        n = self.n_features
        k = int(k)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        k = min(k, n)
        if k == 0:
            return (np.zeros((q.shape[0], 0), np.uint64),
                    np.zeros((q.shape[0], 0), np.float32))
        qd = torch.from_numpy(_l2_normalize(q)).to(self.device)
        scores = torch.matmul(qd, self._matrix(tier).t())  # [Q, n]
        vals, idx = torch.topk(scores, k, dim=1)
        # equal scores in index order: order the k by index, then sort by
        # score with a stable sort
        idx, perm = torch.sort(idx, dim=1)
        vals, perm = torch.sort(vals.gather(1, perm), dim=1,
                                descending=True, stable=True)
        top = idx.gather(1, perm).cpu().numpy()
        return self.keys[top], vals.cpu().numpy()


def export_ann_index(
    out_dir: str,
    table,
    *,
    item_key_lo: int,
    item_key_hi: int,
    coarse_dtype: str = "int8",
    feed_conf=None,
    meta: Optional[dict] = None,
    device="cuda",
) -> AnnIndex:
    """Build and save the ANN artifact from the table's item-key range
    ``[item_key_lo, item_key_hi]`` (an item slot is a key range in the
    synthetic data); writes meta.json, the keys, the matrix and the coarse
    tier (and feed.json when given).  Returns the index on ``device``."""
    quant.validate_dtype(coarse_dtype)
    if coarse_dtype == "fp32":
        raise ValueError("coarse_dtype must be a quantized tier (int8/fp8)")
    state = table.state_dict()
    keys = np.asarray(state["keys"], dtype=np.uint64)
    values = np.asarray(state["values"], dtype=np.float32)
    w = int(table.conf.row_width)
    co = int(table.conf.cvm_offset)
    lo, hi = np.uint64(item_key_lo), np.uint64(item_key_hi)
    in_range = (keys >= lo) & (keys <= hi)
    keys, values = keys[in_range], values[in_range]
    thr = float(table.conf.create_threshold)
    if thr > 0 and keys.shape[0]:
        admitted = values[:, 0] >= thr
        keys, values = keys[admitted], values[admitted]
    emb = rows_to_item_embeddings(values, co, w)
    full_meta = {
        "artifact_kind": ARTIFACT_KIND,
        "model_class": "TwoTower",
        "row_width": w,
        "cvm_offset": co,
        "embed_dim": int(w - co),
        "n_tasks": 1,
        "embedding_dtype": "fp32",
        "coarse_dtype": coarse_dtype,
        "item_key_lo": int(item_key_lo),
        "item_key_hi": int(item_key_hi),
        "n_items": int(keys.shape[0]),
        "create_threshold": thr,
    }
    full_meta.update(meta or {})
    idx = AnnIndex(keys, emb, full_meta, device=device)
    idx.save(out_dir)
    if feed_conf is not None:
        with open(os.path.join(out_dir, "feed.json"), "w") as fh:
            json.dump(feed_conf.to_dict(), fh)
    return idx
