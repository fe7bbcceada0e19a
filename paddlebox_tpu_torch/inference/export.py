"""Model export: a self-contained serving artifact (reference:
paddlebox_tpu/inference/export.py).

An artifact directory holds:

  * ``serving.pt2`` (and ``serving-b{B}-k{K}.pt2`` for each extra shape
    bucket): the forward function as a ``torch.export`` program, saved with
    ``torch.export.save``.  The dense parameters are frozen in, so serving
    needs no Python model code.  A program is exported on the model's
    device and moved at load (``torch.export.passes.move_to_device_pass``),
    so one file serves on the CPU or the card;
  * ``sparse/keys-00000.npy`` with ``values-`` (fp32), or ``head-``,
    ``embedx_q-`` and ``scales-`` (int8/fp8 per-row scales), or the legacy
    global-scale ``head-``, ``embedx_q-`` and ``scale-``: the table
    snapshot, counters kept so feature admission (``create_threshold``)
    behaves as in training;
  * ``meta.json``: the reference's keys plus ``"program_format":
    "torch.export"``; ``feed.json`` when a feed schema is given.

The sparse files and ``meta.json`` are the reference's format, so the two
packages write the same bytes for the same table; the program files
differ (the reference's are ``jax.export`` StableHLO).
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.inference import quant

FORMAT_VERSION = 1
PROGRAM_FORMAT = "torch.export"
PROGRAM_SUFFIX = ".pt2"


def resolve_embedding_dtype(embedding_dtype, row_width: int,
                            cvm_offset: int) -> str:
    """Normalize the artifact dtype choice: None reads the flag shim
    (PADDLEBOX_TORCH_EMBEDDING_DTYPE), and a row with no embedx columns
    has nothing to quantize."""
    dtype = quant.validate_dtype(
        flags.embedding_dtype if embedding_dtype is None else embedding_dtype
    )
    if dtype != "fp32" and row_width - int(cvm_offset) - 1 <= 0:
        dtype = "fp32"
    return dtype


def program_file(batch_size: int, key_capacity: int, primary: bool) -> str:
    """The primary bucket keeps the plain name, as in the reference."""
    if primary:
        return "serving" + PROGRAM_SUFFIX
    return f"serving-b{batch_size}-k{key_capacity}{PROGRAM_SUFFIX}"


class _ServingProgram(nn.Module):
    """``sigmoid(model(rows, key_segments, dense, B, **extras))`` with the
    extras in the reference's fixed order (rank_offset, then seq_pos).
    With ``codes`` ("int8" or "fp8") the rows arrive as (head, embedx
    codes, scales) and the dequant, ``pull_embedx_scale`` and the
    ``create_threshold`` mask run first, in the reference's order of
    operations (export.py serve_quant)."""

    def __init__(self, model: nn.Module, batch_size: int, extras: tuple,
                 codes=None, cvm_offset: int = 2,
                 create_threshold: float = 0.0,
                 pull_embedx_scale: float = 1.0):
        super().__init__()
        self.model = model
        self.batch_size = int(batch_size)
        self.extras = tuple(extras)
        self.codes = codes
        self.cvm_offset = int(cvm_offset)
        self.create_threshold = float(create_threshold)
        self.pull_embedx_scale = float(pull_embedx_scale)

    def _rows(self, head, embedx_q, scales):
        if self.codes == "int8":
            emb = embedx_q.to(torch.float32)
        else:
            emb = embedx_q.view(torch.float8_e4m3fn).to(torch.float32)
        emb = emb * (scales * self.pull_embedx_scale)[:, None]
        if self.create_threshold > 0.0:
            co = self.cvm_offset
            visible = (head[:, 0] >= self.create_threshold).to(
                torch.float32)[:, None]
            emb = emb * visible
            head = torch.cat([head[:, :co], head[:, co:] * visible], dim=1)
        return torch.cat([head, emb], dim=1)

    def forward(self, *args):
        if self.codes is None:
            rows, args = args[0], args[1:]
        else:
            rows, args = self._rows(*args[:3]), args[3:]
        key_segments, dense = args[0], args[1]
        kw = dict(zip(self.extras, args[2:]))
        logits = self.model(rows, key_segments, dense, self.batch_size, **kw)
        return torch.sigmoid(logits)


def _serial_model(model: nn.Module, params) -> nn.Module:
    """The model as exported: ``params`` (a state_dict, e.g. the multi-chip
    trainer's ``dense_state()[0]``) loaded into a copy when given.  A model
    on a parallel axis is refused: export its serial twin."""
    for attr in ("seq_mesh", "expert_mesh", "mesh"):
        if getattr(model, attr, None) is not None:
            raise ValueError(
                f"{type(model).__name__}.{attr} is set: export the serial "
                f"model ({attr}=None) with the trained parameters "
                "(params=trainer.dense_state()[0])"
            )
    if params is not None:
        model = copy.deepcopy(model)
        model.load_state_dict(params)
    return model


def _model_device(model: nn.Module) -> torch.device:
    for p in model.parameters():
        return p.device
    return torch.device(getattr(model, "device", "cpu"))


def export_serving_programs(
    model,
    out_dir: str,
    *,
    batch_size: int,
    key_capacity: int,
    dense_dim: int,
    row_width: int,
    rank_offset_cols: int = 0,
    batch_buckets=None,
    feed_conf=None,
    embedding_dtype=None,
    cvm_offset: int = 2,
    create_threshold: float = 0.0,
    pull_embedx_scale: float = 1.0,
    params=None,
) -> list:
    """Export and save the serving program ladder of ``model`` (its own
    trained parameters, or ``params`` loaded into a copy) into
    ``out_dir``.  Returns the bucket metadata list
    (``[{"batch_size", "key_capacity", "file"}, ...]``).

    embedding_dtype ("fp32" | "int8" | "fp8"; None reads
    PADDLEBOX_TORCH_EMBEDDING_DTYPE): with a quantized dtype the program
    takes ``(head f32, embedx codes, scales f32)`` instead of f32 rows (the
    codes int8, or fp8 as uint8 bytes) and dequantizes on its device, with
    create_threshold and pull_embedx_scale folded in."""
    uses_rank = getattr(model, "uses_rank_offset", False)
    uses_seq = getattr(model, "uses_seq_pos", False)
    seq_len = int(getattr(model, "max_seq_len", 0)) if uses_seq else 0
    if uses_rank and rank_offset_cols <= 0:
        raise ValueError(
            "model consumes rank_offset: pass rank_offset_cols "
            "(DataFeedConfig.rank_offset_cols) so the serving program can "
            "take the PV-merged rank matrix as input"
        )
    edtype = resolve_embedding_dtype(embedding_dtype, row_width, cvm_offset)
    co = int(cvm_offset)
    n_embedx = row_width - co - 1
    os.makedirs(out_dir, exist_ok=True)
    buckets = [(int(batch_size), int(key_capacity))]
    for bb, bk in batch_buckets or ():
        if (int(bb), int(bk)) not in buckets:
            buckets.append((int(bb), int(bk)))
    if feed_conf is not None and not any(
        feed_conf.batch_size <= bb for bb, _ in buckets
    ):
        # fail before any export: the server chunks requests by
        # feed_conf.batch_size, so some bucket must fit a full chunk
        raise ValueError(
            f"feed_conf.batch_size={feed_conf.batch_size} fits no "
            f"exported bucket (batch sizes {[b for b, _ in buckets]}): "
            "add a bucket via batch_buckets or lower the feed batch"
        )
    model = _serial_model(model, params)
    dev = _model_device(model)
    extras = (("rank_offset",) if uses_rank else ()) + (
        ("seq_pos",) if uses_seq else ())
    codes = None if edtype == "fp32" else edtype
    bucket_meta = []
    for B, K in buckets:
        program = _ServingProgram(
            model, B, extras, codes=codes, cvm_offset=co,
            create_threshold=create_threshold,
            pull_embedx_scale=pull_embedx_scale,
        )
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        if codes is None:
            args = [torch.zeros((K, row_width), **f32)]
        else:
            args = [torch.zeros((K, co + 1), **f32),
                    torch.zeros((K, n_embedx), device=dev,
                                dtype=torch.int8 if codes == "int8"
                                else torch.uint8),
                    torch.zeros((K,), **f32)]
        args += [torch.full((K,), B * int(getattr(model, "n_sparse_slots",
                                                  1)), **i32),
                 torch.zeros((B, dense_dim), **f32)]
        if uses_rank:
            args.append(torch.full((B, rank_offset_cols), -1, **i32))
        if uses_seq:
            args.append(torch.full((B, seq_len), K, **i32))
        with torch.no_grad():
            exported = torch.export.export(program, tuple(args), strict=False)
        fname = program_file(B, K, (B, K) == buckets[0])
        torch.export.save(exported, os.path.join(out_dir, fname))
        bucket_meta.append(
            {"batch_size": B, "key_capacity": K, "file": fname}
        )
    return bucket_meta


def export_model(
    model,
    table,
    out_dir: str,
    *,
    batch_size: int,
    key_capacity: int,
    dense_dim: int,
    quantize: bool = False,
    embedding_dtype=None,
    rank_offset_cols: int = 0,
    batch_buckets=None,
    feed_conf=None,
    params=None,
) -> None:
    """Write a serving artifact for ``model`` + ``table`` to ``out_dir``.

    model: the trained model (an nn.Module holding its parameters); for a
    MultiChipTrainer pass the serial model and
    ``params=trainer.dense_state()[0]``.
    table: a SparseTable or ShardedSparseTable outside a pass (end_pass
    first); its host store is snapshotted.
    quantize: the LEGACY int8 snapshot with one global scale a shard file,
    dequantized host-side at load; superseded by embedding_dtype, which
    wins when both are set.
    embedding_dtype ("fp32" | "int8" | "fp8"; None reads
    PADDLEBOX_TORCH_EMBEDDING_DTYPE): per-row-scale quantized rows that
    stay quantized on disk and on the serving device, dequantized inside
    the serving program.
    rank_offset_cols: for rank_offset models (RankCtrDnn), the feed's
    rank-offset width (DataFeedConfig.rank_offset_cols).
    batch_buckets: extra (batch_size, key_capacity) shape buckets; the
    Predictor pads each request to the cheapest bucket that fits.
    feed_conf: the training DataFeedConfig, written as feed.json so a
    serving host parses request lines from the artifact alone.
    """
    uses_rank = getattr(model, "uses_rank_offset", False)
    uses_seq = getattr(model, "uses_seq_pos", False)
    seq_len = int(getattr(model, "max_seq_len", 0)) if uses_seq else 0
    if uses_rank and rank_offset_cols <= 0:
        raise ValueError(
            "model consumes rank_offset: pass rank_offset_cols "
            "(DataFeedConfig.rank_offset_cols) so the serving program can "
            "take the PV-merged rank matrix as input"
        )
    conf = table.conf
    os.makedirs(os.path.join(out_dir, "sparse"), exist_ok=True)

    # sparse snapshot: sorted keys + value rows, g2sum dropped (the
    # optimizer state has no serving meaning)
    state = table.state_dict()
    w = conf.row_width
    pid = int(flags.process_id)
    sp = os.path.join(out_dir, "sparse")
    np.save(os.path.join(sp, f"keys-{pid:05d}.npy"),
            np.asarray(state["keys"], dtype=np.uint64))
    vals = np.asarray(state["values"], dtype=np.float32)[:, :w]
    co = conf.cvm_offset
    # decided off the config, never this rank's row count: every rank
    # writes the same shard layout
    edtype = resolve_embedding_dtype(embedding_dtype, w, co)
    quantize = quantize and edtype == "fp32" and (w - co - 1) > 0
    if edtype != "fp32":
        head, q, scales = quant.quantize_rows(vals, co, edtype)
        np.save(os.path.join(sp, f"head-{pid:05d}.npy"), head)
        np.save(os.path.join(sp, f"embedx_q-{pid:05d}.npy"), q)
        np.save(os.path.join(sp, f"scales-{pid:05d}.npy"), scales)
    elif quantize:
        # embedx -> int8 with one scale per shard file; counters and
        # embed_w stay f32 (the reference's legacy layout)
        embedx = vals[:, co + 1:]
        amax = float(np.abs(embedx).max()) if embedx.size else 0.0
        scale = (amax / 127.0) if amax > 0 else 1.0
        q = np.clip(np.round(embedx / scale), -127, 127).astype(np.int8)
        np.save(os.path.join(sp, f"embedx_q-{pid:05d}.npy"), q)
        np.save(os.path.join(sp, f"head-{pid:05d}.npy"),
                np.ascontiguousarray(vals[:, : co + 1]))
        np.save(os.path.join(sp, f"scale-{pid:05d}.npy"), np.float32(scale))
    else:
        np.save(os.path.join(sp, f"values-{pid:05d}.npy"), vals)

    if pid != 0:
        return  # the programs and meta are rank 0's to write

    bucket_meta = export_serving_programs(
        model, out_dir,
        batch_size=batch_size, key_capacity=key_capacity,
        dense_dim=dense_dim, row_width=w,
        rank_offset_cols=rank_offset_cols, batch_buckets=batch_buckets,
        feed_conf=feed_conf,
        embedding_dtype=edtype, cvm_offset=co,
        create_threshold=conf.create_threshold,
        pull_embedx_scale=conf.pull_embedx_scale,
        params=params,
    )

    meta = {
        "format_version": FORMAT_VERSION,
        "model_class": type(model).__name__,
        "batch_size": bucket_meta[0]["batch_size"],
        "key_capacity": bucket_meta[0]["key_capacity"],
        "buckets": bucket_meta,
        "dense_dim": dense_dim,
        "n_sparse_slots": int(getattr(model, "n_sparse_slots", 0)),
        "n_tasks": int(getattr(model, "n_tasks", 1)),
        "row_width": w,
        "cvm_offset": conf.cvm_offset,
        "create_threshold": conf.create_threshold,
        "pull_embedx_scale": conf.pull_embedx_scale,
        "quantized": bool(quantize),
        "embedding_dtype": edtype,
        "rank_offset_cols": rank_offset_cols if uses_rank else 0,
        "seq_len": seq_len,
        "program_format": PROGRAM_FORMAT,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)

    if feed_conf is not None:
        with open(os.path.join(out_dir, "feed.json"), "w") as f:
            json.dump(feed_conf.to_dict(), f, indent=1)
