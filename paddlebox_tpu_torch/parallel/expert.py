"""Expert parallelism: MMoE expert banks over an ``expert`` axis
(reference: paddlebox_tpu/parallel/expert.py).

MMoE gates densely (every instance weighs every expert), so there is no
token dispatch: each of the P positions (parallel/mesh.py) owns E/P
experts, the batch is replicated over the axis, every position runs its
experts on the full batch, weighs their outputs by its own gate columns,
and one psum over the axis reduces the mix.  Sharded arguments are stacked
``[P, ...]`` in position order, replicated ones are passed once.  At P = 1
this is the serial computation.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.parallel import collectives

EXPERT_AXIS = "expert"


def mix_local_experts(h: torch.Tensor, gates_local: torch.Tensor
                      ) -> torch.Tensor:
    """Weigh each position's expert outputs h [P, E_local, B, D] by its gate
    columns, [P, B, E_local] or [P, T, B, E_local] (stacked per-task
    gates), and psum over the positions.  Returns [P, B, D] or
    [P, T, B, D], every position holding the same sum."""
    if gates_local.dim() == 3:
        local = torch.einsum("pebo,pbe->pbo", h, gates_local)
    else:
        local = torch.einsum("pebo,ptbe->ptbo", h, gates_local)
    return collectives.psum(local)


def expert_parallel_forward(expert_w: torch.Tensor, expert_b: torch.Tensor,
                            x: torch.Tensor, gates_local: torch.Tensor
                            ) -> torch.Tensor:
    """Gate-weighted sum of single-layer ReLU experts.  expert_w
    [P, E_local, D_in, D_hid], expert_b [P, E_local, D_hid], x [B, D_in]
    (replicated), gates_local [P, B, E_local].  Returns [P, B, D_hid]."""
    h = torch.relu(torch.einsum("bi,peio->pebo", x, expert_w)
                   + expert_b[:, :, None, :])
    return mix_local_experts(h, gates_local)


def expert_parallel_mlp_mix(stacked_layers: list, x: torch.Tensor,
                            gates_local: torch.Tensor) -> torch.Tensor:
    """A multi-layer expert bank with mlp()'s semantics (ReLU between
    layers, the last linear) and its cast policy: the expert outputs are
    upcast to float32 before the gate mix, so a compute-dtype bank mixes as
    the serial path does.  stacked_layers: [{"w": [P, E_local, d_i, d_o],
    "b": [P, E_local, d_o]}, ...]; x [B, D_in] (replicated); gates_local
    [P, T, B, E_local].  Returns [P, T, B, D_out] float32."""
    n, e_local = stacked_layers[0]["w"].shape[:2]
    h = x.expand(n, e_local, *x.shape)  # [P, E_local, B, D_in]
    for li, layer in enumerate(stacked_layers):
        h = (torch.einsum("pebi,peio->pebo", h, layer["w"])
             + layer["b"][:, :, None, :])
        if li < len(stacked_layers) - 1:
            h = torch.relu(h)
    return mix_local_experts(h.float(), gates_local.float())


def serial_expert_forward(expert_w: torch.Tensor, expert_b: torch.Tensor,
                          x: torch.Tensor, gates: torch.Tensor
                          ) -> torch.Tensor:
    """The single-position semantics of ``expert_parallel_forward``:
    expert_w [E, D_in, D_hid], expert_b [E, D_hid], gates [B, E]."""
    h = torch.relu(torch.einsum("bi,eio->ebo", x, expert_w)
                   + expert_b[:, None, :])
    return torch.einsum("ebo,be->bo", h, gates)
