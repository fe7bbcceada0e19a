"""DeepFM (reference: paddlebox_tpu/models/deepfm.py): a factorization
machine and a deep tower over pooled slot embeddings (BASELINE.json
configs[1]).

The FM second-order term over the per-slot pooled embeddings v_s,
``0.5 * sum_d [(sum_s v_sd)^2 - sum_s v_sd^2]``, comes from the raw pooled
[B, S, D] tensor in two reductions; the first-order weights and the tower
act on the CVM features (raw pooled show/clk counters are unbounded).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import (
    linear,
    make_linear,
    make_mlp,
    mlp,
    resolve_compute_dtype,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import _cvm_transform, pooled_width, seqpool
from paddlebox_tpu_torch.utils.device import resolve_device


class DeepFM(nn.Module):
    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,  # pulled row width (cvm_offset + embedding_dim)
        dense_dim: int = 0,
        hidden: Sequence[int] = (400, 400, 400),
        use_cvm: bool = True,
        cvm_offset: int = 2,
        compute_dtype: str = "",
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.n_sparse_slots = n_sparse_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.emb_dim = emb_width - cvm_offset  # FM acts on the embedding part
        self.deep_in = (n_sparse_slots * pooled_width(emb_width, cvm_offset,
                                                      use_cvm) + dense_dim)
        gen = torch.Generator().manual_seed(seed)
        self.tower = make_mlp(self.deep_in, self.hidden, 1, gen, self.device)
        self.fm1 = make_linear(self.deep_in, 1, gen, self.device)

    def forward(self, rows, key_segments, dense, batch_size):
        """Returns logits [B]."""
        pooled = seqpool(rows, key_segments, batch_size, self.n_sparse_slots)
        v = pooled[..., self.cvm_offset:]  # [B, S, D] embeddings
        sum_v = v.sum(1)
        fm2 = 0.5 * (sum_v * sum_v - (v * v).sum(1)).sum(1)  # [B]
        feats = (_cvm_transform(pooled, self.cvm_offset) if self.use_cvm
                 else v).reshape(batch_size, -1)
        if self.dense_dim:
            feats = torch.cat([feats, dense], dim=1)
        dt = self.compute_dtype
        fm1 = linear(self.fm1, feats, dt)[:, 0]
        deep = mlp(self.tower, feats, dt)[:, 0]
        return fm1 + fm2 + deep
