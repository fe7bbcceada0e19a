"""DCN, deep & cross network (reference: paddlebox_tpu/models/dcn.py) over
the fused seqpool-CVM features (BASELINE.json configs[3]).

Cross layer l: ``x_{l+1} = x0 * (x_l @ w_l) + b_l + x_l`` (w_l a vector, so
each layer is one matvec).  The cross vectors start at zero (each layer
starts as the identity) and the cross stack stays float32 whatever the
compute dtype; the deep tower and the head run in the compute dtype.
"""

from __future__ import annotations

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


class CrossLayer(nn.Module):
    """One cross layer's vectors ``w`` and ``b`` [d] (the reference's
    ``{"w", "b"}`` entry of ``params["cross"]``)."""

    def __init__(self, d: int, device):
        super().__init__()
        self.w = init_param((d,), 0.0, None, device)
        self.b = init_param((d,), 0.0, None, device)


class DCN(nn.Module):
    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,
        dense_dim: int = 0,
        hidden: Sequence[int] = (256, 128),
        n_cross: int = 3,
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
        self.n_cross = n_cross
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        d = self.input_dim = (n_sparse_slots * pooled_width(
            emb_width, cvm_offset, use_cvm) + dense_dim)
        gen = torch.Generator().manual_seed(seed)
        self.cross = nn.ModuleList(CrossLayer(d, self.device)
                                   for _ in range(n_cross))
        self.deep = make_mlp(d, self.hidden, self.hidden[-1], gen, self.device)
        self.head = make_linear(d + self.hidden[-1], 1, gen, self.device)

    def forward(self, rows, key_segments, dense, batch_size):
        """Returns logits [B]."""
        feats = fused_seqpool_cvm(
            rows, key_segments, batch_size, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        if self.dense_dim:
            feats = torch.cat([feats, dense], dim=1)
        x0 = x = feats
        for layer in self.cross:
            x = x0 * (x @ layer.w)[:, None] + layer.b + x
        deep = mlp(self.deep, feats, self.compute_dtype)
        return linear(self.head, torch.cat([x, deep], dim=1),
                      self.compute_dtype)[:, 0]
