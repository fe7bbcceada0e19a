"""rank_attention: PV-rank-conditioned parameter selection (reference:
paddlebox_tpu/ops/rank_attention.py).

For each ad instance i of a page-view (PV), the features of its PV peers
are combined with a parameter block selected by the (own rank, peer rank)
pair:

    out[i, c] = sum_k sum_f  X[peer(i, k), f] * P[rank(i), rank(peer k), f, c]

``rank_offset`` (the PV feed's, data/feed.py:build_rank_offset) holds per
instance row: col 0 its own rank (-1 or 0: unranked), col 2k+1 the rank of
its peer k and col 2k+2 that peer's row in the batch.  Missing peers and
unranked instances contribute exact zeros.

The reference gathers one parameter block per (instance, peer), a
[N, K, F, C] tensor (272 MB in float32 at the benchmark's width, as much
again for its gradient).  Here the inner sum over f is done first for
every block at once, ``Y[a, b] = X @ P[a, b]`` ([R, R, N, C] for
R = max_rank), and each (instance, peer) then selects its row
``Y[own, peer_rank, peer]``, the same double sum in another order.
Autograd gives both gradients: the select's transpose is a scatter-add
into Y, and Y's is one matmul each for X and P.
"""

from __future__ import annotations

import torch


def rank_attention(
    x: torch.Tensor,  # [N, F] per-instance features
    rank_offset: torch.Tensor,  # int32 [N, 2*max_rank + 1]
    rank_param: torch.Tensor,  # [max_rank * max_rank * F, C] (reference layout)
    max_rank: int,
) -> torch.Tensor:
    """Returns [N, C].  Differentiable in x and rank_param."""
    n, f = x.shape
    c = rank_param.shape[-1]
    r = max_rank
    p = rank_param.reshape(r, r, f, c)
    own = rank_offset[:, 0].long() - 1  # [N]; < 0: unranked
    peer_rank = rank_offset[:, 1::2].long() - 1  # [N, K]
    peer_idx = rank_offset[:, 2::2].long()  # [N, K]
    valid = (own[:, None] >= 0) & (peer_rank >= 0) & (peer_idx >= 0)
    # every block's product at once: y[a, b] = x @ P[a, b]
    y = torch.matmul(x, p).reshape(r * r * n, c)  # [R*R*N, C]
    sel = ((own.clamp(0, r - 1)[:, None] * r + peer_rank.clamp(0, r - 1)) * n
           + peer_idx.clamp(0, n - 1))  # [N, K]
    picked = y.index_select(0, sel.reshape(-1)).view(*sel.shape, c)
    picked = torch.where(valid[..., None], picked, 0.0)
    return picked.sum(1)


def ins_rank(rank_offset: torch.Tensor) -> torch.Tensor:
    """[N, 1] own-rank column (the reference's InsRank output)."""
    return rank_offset[:, 0:1].float()


# The reference ships two ops with the same math (a batched GEMM over
# scratch tensors, and a direct double sum with atomics in the backward);
# one function covers both, and the alias keeps the API.
rank_attention2 = rank_attention
