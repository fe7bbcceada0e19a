"""The four collectives of the multi-chip step over stacked ``[n, ...]``
tensors, one leading entry per shard position (reference: the ``jax.lax``
collectives over the mesh's data axis in paddlebox_tpu/parallel/trainer.py).

All positions live in one process (parallel/mesh.py), so each collective is
a tensor operation on the stacked values; every sum runs in a fixed order,
so results do not depend on scheduling.
"""

from __future__ import annotations

import torch


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)``: position s sends
    its block d to position d, which stacks what it receives in source
    order.  x: [n, n, ...] with ``x[s, d]`` the block s sends to d; returns
    ``got`` with ``got[d, s] = x[s, d]``."""
    if x.dim() < 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"all_to_all needs [n, n, ...], got {tuple(x.shape)}")
    return x.transpose(0, 1).contiguous()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather``: every position receives every position's block.
    x: [n, ...] -> [n, n, ...] (a view: all positions share one copy)."""
    return x.unsqueeze(0).expand(x.shape[0], *x.shape)


def _fold(x: torch.Tensor, op) -> torch.Tensor:
    acc = x[0]
    for i in range(1, x.shape[0]):  # unrolled: fixed ascending order
        acc = op(acc, x[i])
    return acc.unsqueeze(0).expand_as(x)


def psum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` as an unrolled fold in ascending position order,
    ``((x[0] + x[1]) + x[2]) + ...``; every position holds the sum.
    x: [n, ...] -> [n, ...] (a view of one copy)."""
    return _fold(x, torch.add)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over positions."""
    return _fold(x, torch.maximum)
