"""MMoE, the multi-gate mixture-of-experts multi-task model (reference:
paddlebox_tpu/models/mmoe.py; BASELINE.json configs[4]).

All tasks share the sparse table and the pooled features; E expert MLPs
feed T softmax gates and T task towers.  Task 0's label is the primary
label; tasks 1.. read the batch's task-label columns
(DataFeedConfig.task_label_slots).  The serial expert bank only: the
reference's expert-parallel bank (``expert_mesh``) is a later slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.config import not_ported
from paddlebox_tpu_torch.models.layers import (
    linear,
    make_linear,
    make_mlp,
    mlp,
    resolve_compute_dtype,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.utils.device import resolve_device


class MMoE(nn.Module):
    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,
        dense_dim: int = 0,
        n_tasks: int = 2,
        n_experts: int = 4,
        expert_hidden: Sequence[int] = (128,),
        expert_dim: int = 64,
        tower_hidden: Sequence[int] = (32,),
        use_cvm: bool = True,
        cvm_offset: int = 2,
        compute_dtype: str = "",
        expert_mesh=None,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        if expert_mesh is not None:
            raise not_ported("expert_mesh", "parallel axes, item 5")
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.n_sparse_slots = n_sparse_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.n_tasks = n_tasks
        self.n_experts = n_experts
        self.expert_hidden = tuple(expert_hidden)
        self.expert_dim = expert_dim
        self.tower_hidden = tuple(tower_hidden)
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        d = self.input_dim = (n_sparse_slots * pooled_width(
            emb_width, cvm_offset, use_cvm) + dense_dim)
        gen = torch.Generator().manual_seed(seed)
        self.experts = nn.ModuleList(
            make_mlp(d, self.expert_hidden, expert_dim, gen, self.device)
            for _ in range(n_experts))
        self.gates = nn.ModuleList(make_linear(d, n_experts, gen, self.device)
                                   for _ in range(n_tasks))
        self.towers = nn.ModuleList(
            make_mlp(expert_dim, self.tower_hidden, 1, gen, self.device)
            for _ in range(n_tasks))

    def forward(self, rows, key_segments, dense, batch_size):
        """Returns logits [B, n_tasks]."""
        feats = fused_seqpool_cvm(
            rows, key_segments, batch_size, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        if self.dense_dim:
            feats = torch.cat([feats, dense], dim=1)
        dt = self.compute_dtype
        gates = torch.stack([torch.softmax(linear(g, feats, dt), dim=-1)
                             for g in self.gates])  # [T, B, E]
        expert_out = torch.stack([mlp(e, feats, dt) for e in self.experts],
                                 dim=1)  # [B, E, expert_dim]
        mixed = torch.einsum("tbe,bed->tbd", gates, expert_out)
        return torch.stack([mlp(tower, mixed[t], dt)[:, 0]
                            for t, tower in enumerate(self.towers)], dim=1)
