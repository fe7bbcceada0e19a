"""CTR-DNN, the canonical BoxPS benchmark model (reference:
paddlebox_tpu/models/ctr_dnn.py): sparse slots pooled through the
seqpool-CVM family, concatenated with the dense features, into a ReLU tower.

Options, as in the reference: ``layout="conv"`` (rows [show, clk, conv,
embed...], ``show_filter`` drops the show column), ``expand_dim`` (rows
carry an extended embedding tail, pooled as a separate block) and
``slot_embed_dims`` (per-slot embedx widths as a column mask over the
shared row).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import make_mlp, mlp, resolve_compute_dtype
from paddlebox_tpu_torch.ops.seqpool_cvm import (
    fused_seqpool_cvm,
    fused_seqpool_cvm_extended,
    fused_seqpool_cvm_with_conv,
    pooled_width,
)
from paddlebox_tpu_torch.utils.device import resolve_device


class CtrDnn(nn.Module):
    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,  # pulled row width (cvm_offset + embedding_dim [+ expand])
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
        use_cvm: bool = True,
        cvm_offset: int = 2,
        expand_dim: int = 0,  # extended embedding tail width
        compute_dtype: str = "",
        layout: str = "default",  # "default" | "conv"
        show_filter: bool = False,  # conv layout: drop the show column
        slot_embed_dims=None,  # ((slot, dim), ...): per-slot embedx width
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        if layout not in ("default", "conv"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "conv" and expand_dim:
            raise ValueError("conv layout does not support expand_dim")
        if layout == "conv" and cvm_offset < 3:
            raise ValueError(
                "conv layout needs cvm_offset >= 3 ([show, clk, conv, ...]); "
                f"got {cvm_offset}"
            )
        # None (float32), torch.bfloat16 or torch.float16; the trainers set
        # it from TrainerConfig.compute_dtype when that names one
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.layout = layout
        self.show_filter = show_filter
        self.n_sparse_slots = n_sparse_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.expand_dim = expand_dim
        base_w = emb_width - expand_dim
        pooled_w = pooled_width(base_w, cvm_offset, use_cvm, layout=layout,
                                show_filter=show_filter)
        self.input_dim = n_sparse_slots * (pooled_w + expand_dim) + dense_dim
        # per-slot embedding dims as a column mask over the shared row: slot
        # s keeps its first dim_s embedx columns; the rest read zero and,
        # since the mask applies inside forward (inside the loss), receive
        # zero gradient.  Not persistent: it is configuration, not state
        self.register_buffer("_dim_mask", None, persistent=False)
        if slot_embed_dims:
            emb_cols = base_w - cvm_offset
            mask = np.ones((n_sparse_slots, emb_width), np.float32)
            for slot, dim in slot_embed_dims:
                if not 0 <= slot < n_sparse_slots:
                    raise ValueError(f"slot_embed_dims slot {slot} out of range")
                if not 0 < dim <= emb_cols:
                    raise ValueError(
                        f"slot {slot} dim {dim} not in (0, {emb_cols}]"
                    )
                mask[slot, cvm_offset + dim: base_w] = 0.0
            self._dim_mask = torch.from_numpy(mask).to(self.device)
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
        if self._dim_mask is not None:
            # padding occurrences index slot 0 harmlessly: their rows are
            # the dead row's zeros
            rows = rows * self._dim_mask[key_segments % self.n_sparse_slots]
        if self.expand_dim:
            base, expand = fused_seqpool_cvm_extended(
                rows, key_segments, batch_size, self.n_sparse_slots,
                self.expand_dim, use_cvm=self.use_cvm,
                cvm_offset=self.cvm_offset,
            )
            pooled = torch.cat([base, expand], dim=1)
        elif self.layout == "conv":
            pooled = fused_seqpool_cvm_with_conv(
                rows, key_segments, batch_size, self.n_sparse_slots,
                use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
                show_filter=self.show_filter,
            )
        else:
            pooled = fused_seqpool_cvm(
                rows, key_segments, batch_size, self.n_sparse_slots,
                use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
            )
        x = torch.cat([pooled, dense], dim=1) if self.dense_dim else pooled
        return mlp(self.tower, x, self.compute_dtype)[:, 0]
