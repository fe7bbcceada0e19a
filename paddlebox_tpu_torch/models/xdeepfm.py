"""xDeepFM (reference: paddlebox_tpu/models/xdeepfm.py): a compressed
interaction network (CIN), a deep tower and a linear path
(BASELINE.json configs[3]).

CIN layer k over the field matrix X0 [B, m, D]:

    X_k[b, h, d] = sum_{i,j} W_k[h, i, j] * X_{k-1}[b, i, d] * X0[b, j, d]

one einsum a layer, in the compute dtype; the pooled maps come back as
float32.  The field matrix is the per-slot pooled embeddings without the
CVM counter columns (fields share one width D); the counters still feed
the deep tower and the linear path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import (
    init_param,
    linear,
    make_linear,
    make_mlp,
    mlp,
    resolve_compute_dtype,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.utils.device import resolve_device


class XDeepFM(nn.Module):
    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,
        dense_dim: int = 0,
        hidden: Sequence[int] = (256, 128),
        cin_layers: Sequence[int] = (32, 32),
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
        self.cin_layers = tuple(cin_layers)
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        embed_w = emb_width - cvm_offset
        self.pooled_w = pooled_width(emb_width, cvm_offset, use_cvm)
        self.n_counter_cols = self.pooled_w - embed_w
        self.field_w = embed_w
        if self.field_w <= 0:
            raise ValueError("emb_width too small for a CIN field matrix")
        self.input_dim = n_sparse_slots * self.pooled_w + dense_dim
        m = n_sparse_slots
        gen = torch.Generator().manual_seed(seed)
        cin, prev = [], m
        for h in self.cin_layers:
            cin.append(init_param((h, prev, m), 1.0 / math.sqrt(prev * m),
                                  gen, self.device))
            prev = h
        self.cin = nn.ParameterList(cin)
        self.deep = make_mlp(self.input_dim, self.hidden, self.hidden[-1], gen,
                             self.device)
        self.linear = make_linear(self.input_dim, 1, gen, self.device)
        self.head = make_linear(sum(self.cin_layers) + self.hidden[-1] + 1, 1,
                                gen, self.device)

    def forward(self, rows, key_segments, dense, batch_size):
        """Returns logits [B]."""
        feats = fused_seqpool_cvm(
            rows, key_segments, batch_size, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        if self.dense_dim:
            feats = torch.cat([feats, dense], dim=1)
        # field matrix [B, m, D]: the CVM counter columns of each slot dropped
        m, pw = self.n_sparse_slots, self.pooled_w
        fields = feats[:, : m * pw].reshape(-1, m, pw)[:, :, self.n_counter_cols:]
        dt = self.compute_dtype
        x0 = fields if dt is None else fields.to(dt)
        xk = x0
        pooled_maps = []
        for w in self.cin:
            xk = torch.einsum("hij,bid,bjd->bhd", w if dt is None else w.to(dt),
                              xk, x0)
            pooled_maps.append(xk.sum(2))  # [B, h]
        cin_out = torch.cat(pooled_maps, dim=1).float()
        deep = mlp(self.deep, feats, dt)
        lin = linear(self.linear, feats, dt)
        return linear(self.head, torch.cat([cin_out, deep, lin], dim=1),
                      dt)[:, 0]
