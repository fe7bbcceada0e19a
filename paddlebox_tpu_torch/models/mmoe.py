"""MMoE, the multi-gate mixture-of-experts multi-task model (reference:
paddlebox_tpu/models/mmoe.py; BASELINE.json configs[4]).

All tasks share the sparse table and the pooled features; E expert MLPs
feed T softmax gates and T task towers.  Task 0's label is the primary
label; tasks 1.. read the batch's task-label columns
(DataFeedConfig.task_label_slots).

Expert parallelism: with ``expert_mesh`` (a mesh with an ``expert`` axis,
or ``"inherit"`` inside a composed mesh, parallel/mesh.py) the bank runs
over the axis's positions (parallel/expert.py): each position runs its E/P
experts on the replicated batch and mixes them by its own gate columns, and
one psum reduces the mix.  The parameters stay the serial bank's
``ModuleList``; the forward stacks them ``[E, d_in, d_out]``.
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
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.parallel.expert import EXPERT_AXIS, expert_parallel_mlp_mix
from paddlebox_tpu_torch.parallel.mesh import axis_positions, inner_mesh
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
        expert_mesh=None,  # Mesh with an "expert" axis | "inherit" | None
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        if expert_mesh is not None and expert_mesh != "inherit":
            self._check_axis(axis_positions(expert_mesh, EXPERT_AXIS),
                             n_experts)
        self.expert_mesh = expert_mesh
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
        if self.expert_mesh is None:
            expert_out = torch.stack([mlp(e, feats, dt) for e in self.experts],
                                     dim=1)  # [B, E, expert_dim]
            mixed = torch.einsum("tbe,bed->tbd", gates, expert_out)
        else:
            mixed = self._ep_mixed(feats, gates)
        return torch.stack([mlp(tower, mixed[t], dt)[:, 0]
                            for t, tower in enumerate(self.towers)], dim=1)

    def bind_composed_mesh(self, mesh) -> None:
        """Bind an ``"inherit"`` expert_mesh to the composed ``mesh``'s
        expert axis (MultiChipTrainer calls it once, when it is built)."""
        if self.expert_mesh == "inherit":
            self.expert_mesh = inner_mesh(mesh, EXPERT_AXIS)
            self._check_axis(self.expert_mesh.n, self.n_experts)

    @staticmethod
    def _check_axis(p: int, n_experts: int) -> None:
        if n_experts % p:
            raise ValueError(
                f"n_experts {n_experts} not divisible by the "
                f"{EXPERT_AXIS!r} axis size {p}"
            )

    def _ep_mixed(self, feats: torch.Tensor, gates: torch.Tensor
                  ) -> torch.Tensor:
        """[T, B, expert_dim] gate-mixed expert outputs with the bank over
        the ``expert`` axis's P positions: the stacked bank [E, d_in, d_out]
        split [P, E/P, ...], the gates' expert columns [P, T, B, E/P] the
        same way; mlp()'s cast policy, so serial == sharded under any
        compute dtype."""
        p = axis_positions(self.expert_mesh, EXPERT_AXIS)
        dt = self.compute_dtype
        e_local = self.n_experts // p
        stacked = []
        for li in range(len(self.experts[0])):
            w = torch.stack([e[li].weight.t() for e in self.experts])
            b = torch.stack([e[li].bias for e in self.experts])
            if dt is not None:
                w, b = w.to(dt), b.to(dt)
            stacked.append({"w": w.reshape(p, e_local, *w.shape[1:]),
                            "b": b.reshape(p, e_local, -1)})
        if dt is not None:
            feats = feats.to(dt)
        T, B, _ = gates.shape
        gates_local = gates.reshape(T, B, p, e_local).permute(2, 0, 1, 3)
        return expert_parallel_mlp_mix(stacked, feats, gates_local)[0]
