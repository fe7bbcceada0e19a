"""Wide&Deep (reference: paddlebox_tpu/models/wide_deep.py): a linear
"wide" path and a deep tower over the fused seqpool-CVM features
(BASELINE.json configs[2])."""

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
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.utils.device import resolve_device


class WideDeep(nn.Module):
    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
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
        self.input_dim = (n_sparse_slots * pooled_width(emb_width, cvm_offset,
                                                        use_cvm) + dense_dim)
        gen = torch.Generator().manual_seed(seed)
        self.tower = make_mlp(self.input_dim, self.hidden, 1, gen, self.device)
        self.wide = make_linear(self.input_dim, 1, gen, self.device)

    def forward(self, rows, key_segments, dense, batch_size):
        """Returns logits [B]."""
        feats = fused_seqpool_cvm(
            rows, key_segments, batch_size, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        if self.dense_dim:
            feats = torch.cat([feats, dense], dim=1)
        dt = self.compute_dtype
        return (linear(self.wide, feats, dt)[:, 0]
                + mlp(self.tower, feats, dt)[:, 0])
