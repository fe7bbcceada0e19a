"""Shard positions of the multi-chip path (reference:
paddlebox_tpu/parallel/mesh.py:make_mesh).

The reference's one-axis ``jax.sharding.Mesh`` carries data parallelism and
the key-sharded table over its "data" axis.  This slice runs all n shard
positions in one process, with the stacked state ``[n, ...]`` on one
explicit device, as the reference's tests run n forced CPU devices of one
host.  The collectives (parallel/collectives.py) are then exact and move
no bytes between cards; NCCL across processes is a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from paddlebox_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n shard positions whose stacked state lives on ``device``."""

    n: int
    device: torch.device


def make_mesh(n: int, device="cuda") -> Mesh:
    """n shard positions on one device (``device="cpu"`` for the CPU)."""
    if n < 1:
        raise ValueError(f"need at least one shard position, got {n}")
    return Mesh(int(n), resolve_device(device))
