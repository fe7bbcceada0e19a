"""The collectives of the parallel axes over stacked ``[n, ...]`` tensors,
one leading entry per position (reference: the ``jax.lax`` collectives in
paddlebox_tpu/parallel/): the four of the multi-chip step's data axis
(trainer.py), then the ring shift of the sequence and pipeline axes and the
tiled all_to_all and all_gather of Ulysses attention (sequence.py,
pipeline.py).

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


def ppermute(x: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute(x, axis_name, perm)``: for each pair ``(s, d)`` of
    ``perm`` position d receives x[s]; a position that no pair targets
    receives zeros.  x: [n, ...] -> [n, ...].  The GPipe chain
    ``[(i, i + 1)]`` (parallel/pipeline.py) relies on the zeros, the ring
    ``[(i, (i + 1) % n)]`` (parallel/sequence.py) on the wrap."""
    n = x.shape[0]
    src = {}
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"ppermute pair {(s, d)} out of range for {n} "
                             "positions")
        if d in src:
            raise ValueError(f"ppermute targets position {d} twice")
        src[d] = s
    zero = x.new_zeros(x.shape[1:])
    return torch.stack([x[src[d]] if d in src else zero for d in range(n)])


def all_to_all_tiled(x: torch.Tensor, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis_name, split_axis, concat_axis, tiled=True)``:
    position s splits its block along ``split_axis`` into n chunks and sends
    chunk d to position d, which concatenates what it receives along
    ``concat_axis`` in source order.  x: [n, ...] with both axes counted in
    a position's block (0 is the block's first axis)."""
    n = x.shape[0]
    if x.shape[1 + split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[1 + split_axis]} does not split over {n} "
                         "positions")
    chunks = x.chunk(n, dim=1 + split_axis)  # chunks[d][s]: s's chunk for d
    return torch.stack([torch.cat(list(chunks[d].unbind(0)), dim=concat_axis)
                        for d in range(n)])


def all_gather_tiled(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=axis, tiled=True)``: every
    position receives the positions' blocks concatenated along ``axis`` (of
    a block) in position order.  x: [n, ...] -> [n, ...] (a view: all
    positions share one copy)."""
    full = torch.cat(list(x.unbind(0)), dim=axis)
    return full.unsqueeze(0).expand(x.shape[0], *full.shape)
