"""PV-aware CTR model (reference: paddlebox_tpu/models/rank_ctr.py):
pooled slot features and rank_attention over the page-view's peers.

The attention input X is the per-instance feature vector (pooled CVM
features and the dense ones); its PV peers' rows are contracted against
the (own rank, peer rank)-selected parameter block, and the result is
concatenated into the tower's input.  rank_attention stays float32; the
tower runs in the compute dtype.  The trainers pass the batch's
``rank_offset`` (``uses_rank_offset``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import (
    init_param,
    make_mlp,
    mlp,
    resolve_compute_dtype,
)
from paddlebox_tpu_torch.ops.rank_attention import rank_attention
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.utils.device import resolve_device


class RankCtrDnn(nn.Module):
    uses_rank_offset = True

    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
        max_rank: int = 3,
        att_out_dim: int = 64,
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
        self.max_rank = max_rank
        self.att_out_dim = att_out_dim
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.feat_dim = (n_sparse_slots * pooled_width(emb_width, cvm_offset,
                                                       use_cvm) + dense_dim)
        self.input_dim = self.feat_dim + att_out_dim
        gen = torch.Generator().manual_seed(seed)
        self.tower = make_mlp(self.input_dim, self.hidden, 1, gen, self.device)
        k = max_rank
        self.rank_param = init_param(
            (k * k * self.feat_dim, att_out_dim),
            math.sqrt(6.0 / (self.feat_dim + att_out_dim)), gen, self.device)

    def forward(self, rows, key_segments, dense, batch_size,
                rank_offset: torch.Tensor):
        """rank_offset: int32 [B, 2*max_rank+1].  Returns logits [B]."""
        pooled = fused_seqpool_cvm(
            rows, key_segments, batch_size, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        x = torch.cat([pooled, dense], dim=1) if self.dense_dim else pooled
        att = rank_attention(x, rank_offset, self.rank_param, self.max_rank)
        return mlp(self.tower, torch.cat([x, att], dim=1),
                   self.compute_dtype)[:, 0]
