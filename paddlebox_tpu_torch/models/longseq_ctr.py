"""Long-sequence CTR model: an attention tower over one ordered behaviour
slot beside the CTR net (reference: paddlebox_tpu/models/longseq_ctr.py).

The behaviour slot (DataFeedConfig.sequence_slot, file order = behaviour
order) is embedded as an ordered sequence through the feed's ``seq_pos``
[B, T] (key-buffer positions, padding = the key capacity K), run through
multi-head self-attention, and mean-pooled over its real positions into
one feature vector next to the pooled-CVM slot features; the slot still
contributes its pooled feature too.

``seq_mesh`` shards the sequence over a ``seq`` axis (parallel/sequence.py)
with ring attention or Ulysses all-to-all attention; ``"inherit"`` takes
the axis from an enclosing composed mesh (parallel/mesh.py).  At one
position both reduce to plain attention.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import make_mlp, mlp, resolve_compute_dtype
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.parallel.mesh import axis_positions, inner_mesh
from paddlebox_tpu_torch.parallel.sequence import (
    SEQ_AXIS,
    full_attention,
    merge_positions,
    ring_attention,
    split_positions,
    ulysses_attention,
)
from paddlebox_tpu_torch.utils.device import resolve_device


class LongSeqCtrDnn(nn.Module):
    """CtrDnn + an attention tower over one ordered behaviour slot; its
    forward takes the feed's ``seq_pos`` by keyword (``uses_seq_pos``)."""

    uses_seq_pos = True

    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,  # pulled row width (cvm_offset + embedding_dim)
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
        use_cvm: bool = True,
        cvm_offset: int = 2,
        max_seq_len: int = 64,
        n_heads: int = 2,
        head_dim: int = 16,
        seq_mesh=None,  # Mesh with a "seq" axis | "inherit" | None
        seq_impl: str = "ring",  # "ring" | "ulysses" (with seq_mesh)
        compute_dtype: str = "",
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        if seq_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq_impl {seq_impl!r}")
        if seq_mesh is not None and seq_mesh != "inherit":
            self._check_axis(axis_positions(seq_mesh, SEQ_AXIS), max_seq_len,
                             n_heads, seq_impl)
        self.device = resolve_device(device)
        self.n_sparse_slots = n_sparse_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.max_seq_len = max_seq_len
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.seq_mesh = seq_mesh
        self.seq_impl = seq_impl
        self.emb_dim = emb_width - cvm_offset
        if self.emb_dim <= 0:
            raise ValueError("emb_width leaves no embedding columns")
        self.seq_feat_dim = n_heads * head_dim
        self.input_dim = (n_sparse_slots * pooled_width(emb_width, cvm_offset,
                                                        use_cvm)
                          + self.seq_feat_dim + dense_dim)
        gen = torch.Generator().manual_seed(seed)
        # the reference's init: normal / sqrt(emb_dim), drawn on the CPU
        qkv = torch.randn((self.emb_dim, 3 * self.seq_feat_dim),
                          generator=gen) / math.sqrt(self.emb_dim)
        self.qkv = nn.Parameter(qkv.to(self.device))  # [emb_dim, 3*H*D]
        self.tower = make_mlp(self.input_dim, self.hidden, 1, gen, self.device)

    def bind_composed_mesh(self, mesh) -> None:
        """Bind an ``"inherit"`` seq_mesh to the composed ``mesh``'s seq
        axis (MultiChipTrainer calls it once, when it is built)."""
        if self.seq_mesh == "inherit":
            self.seq_mesh = inner_mesh(mesh, SEQ_AXIS)
            self._check_axis(self.seq_mesh.n, self.max_seq_len, self.n_heads,
                             self.seq_impl)

    @staticmethod
    def _check_axis(p: int, max_seq_len: int, n_heads: int, impl: str) -> None:
        if max_seq_len % p:
            raise ValueError(
                f"max_seq_len {max_seq_len} not divisible by the "
                f"{SEQ_AXIS!r} axis size {p}"
            )
        if impl == "ulysses" and n_heads % p:
            raise ValueError(
                f"ulysses needs n_heads ({n_heads}) divisible by the seq "
                f"axis size ({p})"
            )

    def _attend(self, q, k, v, valid):
        """[B, T, H, D] attention, sequence-sharded when a mesh is given."""
        if self.seq_mesh is None:
            return full_attention(q, k, v, key_valid=valid)
        p = axis_positions(self.seq_mesh, SEQ_AXIS)
        impl = ring_attention if self.seq_impl == "ring" else ulysses_attention
        out = impl(*(split_positions(x, p) for x in (q, k, v)),
                   key_valid=split_positions(valid, p))
        return merge_positions(out)

    def forward(
        self,
        rows: torch.Tensor,  # [K, emb_width]
        key_segments: torch.Tensor,  # [K]
        dense: torch.Tensor,  # [B, dense_dim]
        batch_size: int,
        seq_pos: torch.Tensor,  # int [B, T] into the key buffer (pad = K)
    ) -> torch.Tensor:
        """Returns logits [B]."""
        B, T = batch_size, self.max_seq_len
        K = rows.shape[0]
        if seq_pos.shape[-1] != T:
            raise ValueError(
                f"seq_pos width {seq_pos.shape[-1]} != model max_seq_len "
                f"{T}: set DataFeedConfig.max_seq_len and "
                "LongSeqCtrDnn(max_seq_len=...) to the same value"
            )
        pooled = fused_seqpool_cvm(
            rows, key_segments, B, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        # ordered behaviour embeddings: padding positions (== K) read the
        # appended zero row; their gradient lands on it and is dropped
        rows_pad = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        seq = rows_pad.index_select(0, seq_pos.reshape(-1)).reshape(
            B, T, -1)[..., self.cvm_offset:]
        valid = seq_pos < K  # [B, T]
        cdt = self.compute_dtype
        qkv_w = self.qkv
        if cdt is not None:
            seq, qkv_w = seq.to(cdt), qkv_w.to(cdt)
        qkv = (seq @ qkv_w).reshape(B, T, 3, self.n_heads, self.head_dim)
        q, k, v = qkv.unbind(2)  # [B, T, H, D]
        out = self._attend(q, k, v, valid).reshape(B, T, self.seq_feat_dim)
        out = out * valid[..., None].to(out.dtype)
        denom = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        seq_feat = (out.sum(dim=1) / denom).float()  # [B, H*D]
        parts = [pooled, seq_feat] + ([dense] if self.dense_dim else [])
        return mlp(self.tower, torch.cat(parts, dim=1), cdt)[:, 0]
