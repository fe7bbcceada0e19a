"""CTR-DNN, the canonical BoxPS benchmark model (reference:
paddlebox_tpu/models/ctr_dnn.py): sparse slots pooled through
fused_seqpool_cvm, concatenated with the dense features, into a ReLU tower.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.config import not_ported
from paddlebox_tpu_torch.models.layers import make_mlp, mlp, resolve_compute_dtype
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.utils.device import resolve_device


class CtrDnn(nn.Module):
    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,  # pulled row width (cvm_offset + embedding_dim)
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
        use_cvm: bool = True,
        cvm_offset: int = 2,
        expand_dim: int = 0,
        compute_dtype: str = "",
        layout: str = "default",
        slot_embed_dims=None,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        if layout != "default":
            raise not_ported(f"layout={layout!r}", "model zoo, item 5")
        if expand_dim:
            raise not_ported("expand_dim", "model zoo, item 5")
        if slot_embed_dims:
            raise not_ported("slot_embed_dims", "model zoo, item 5")
        resolve_compute_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.n_sparse_slots = n_sparse_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.input_dim = (
            n_sparse_slots * pooled_width(emb_width, cvm_offset, use_cvm)
            + dense_dim
        )
        gen = torch.Generator().manual_seed(seed)
        self.tower = make_mlp(self.input_dim, self.hidden, 1, gen, self.device)

    def forward(
        self,
        rows: torch.Tensor,  # [K, emb_width] pulled rows
        key_segments: torch.Tensor,  # [K]
        dense: torch.Tensor,  # [B, dense_dim]
        batch_size: int,
    ) -> torch.Tensor:
        """Returns logits [B]."""
        pooled = fused_seqpool_cvm(
            rows, key_segments, batch_size, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        x = torch.cat([pooled, dense], dim=1) if self.dense_dim else pooled
        return mlp(self.tower, x)[:, 0]
