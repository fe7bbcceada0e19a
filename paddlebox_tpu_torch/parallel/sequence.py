"""Sequence parallelism over a ``seq`` axis: ring attention and all-to-all
(Ulysses) attention (reference: paddlebox_tpu/parallel/sequence.py).

The P positions of the axis hold contiguous chunks of the sequence, stacked
``[P, B, T_local, H, D]`` in position order (parallel/mesh.py):

  * ``ring_attention`` — each position's K/V block rides the ring
    (``collectives.ppermute``) while every position folds one block per
    tick into a float32 online-softmax accumulator (running max ``m``,
    normalizer ``l``, weighted sum ``acc``).  Causal masking reads the
    global positions that ride the ring with their block.  A block that
    lies wholly in the causal future folds to an exact no-op (every score
    is -inf: ``alpha`` is 1, or 0 on a still-empty accumulator, and every
    weight 0), so it is folded rather than branched on: no host sync, and
    the fold stays capturable in a CUDA graph.
  * ``ulysses_attention`` — a tiled all_to_all trades the sequence axis for
    the head axis, each position attends over the full sequence for H/P
    heads (``full_attention``), and a second all_to_all trades back.

Both reduce to ``full_attention`` at P = 1.  The attention is the
reference's einsum chain in plain torch ops, as the reference computes it
in jnp: ``scaled_dot_product_attention`` would return NaN for a query whose
keys are all masked, where the reference returns a zero vector.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddlebox_tpu_torch.parallel import collectives

SEQ_AXIS = "seq"

_NEG_INF = float("-inf")


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention (the single-position semantics).

    q/k/v: [B, T, H, D]; returns [B, T, H, D].  key_valid: optional bool
    [B, Tk], padded keys read zero weight; a query whose keys are all
    masked reads a zero vector, not NaN (the masked-stable softmax)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(float(d))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(tq, device=s.device)[:, None]
                >= torch.arange(tk, device=s.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    w = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m))
    p = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   key_valid: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ring attention over P stacked sequence chunks.

    q/k/v: [P, B, T_local, H, D], position p holding chunk p; returns the
    same shape, in q's dtype.  key_valid: optional bool [P, B, T_local],
    each chunk's key validity, which rides the ring with its block.
    positions: optional int [P, T_local], each chunk's global sequence
    positions (default ``p * T_local + arange(T_local)``), read only by
    causal masking."""
    n, b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(float(d))
    if causal and positions is None:
        positions = (torch.arange(n, device=q.device)[:, None] * t
                     + torch.arange(t, device=q.device)[None, :])
    q_pos = positions
    valid_blk = (torch.ones((n, b, t), dtype=torch.bool, device=q.device)
                 if key_valid is None else key_valid)
    # float32 scores and accumulators whatever the input dtype (the
    # reference's preferred_element_type): bf16 products are exact in f32
    qf = q.float()
    k_blk, v_blk, pos_blk = k, v, positions
    acc = q.new_zeros((n, b, h, t, d), dtype=torch.float32)
    m = torch.full((n, b, h, t), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = q.new_zeros((n, b, h, t), dtype=torch.float32)
    ring = [(i, (i + 1) % n) for i in range(n)]
    for j in range(n):
        s = torch.einsum("pbqhd,pbkhd->pbhqk", qf, k_blk.float()) * scale
        if causal:
            mask = q_pos[:, :, None] >= pos_blk[:, None, :]  # [P, Tq, Tk]
            s = torch.where(mask[:, None, None], s, _NEG_INF)
        s = torch.where(valid_blk[:, :, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        w = torch.exp(s - m_safe[..., None])  # exp(-inf) = 0: masked
        l = l * alpha + w.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "pbhqk,pbkhd->pbhqd", w, v_blk.float())
        m = m_new
        if j < n - 1:  # the last tick's rotation would be discarded
            k_blk = collectives.ppermute(k_blk, ring)
            v_blk = collectives.ppermute(v_blk, ring)
            valid_blk = collectives.ppermute(valid_blk, ring)
            if causal:
                pos_blk = collectives.ppermute(pos_blk, ring)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [P, B, H, T, D]
    return out.permute(0, 1, 3, 2, 4).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False,
                      key_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """All-to-all sequence parallelism: trade T-sharding for H-sharding,
    run full attention, trade back.  q/k/v: [P, B, T_local, H, D] with H
    divisible by P; returns the same shape.  key_valid: optional bool
    [P, B, T_local], all-gathered to the full sequence for the
    head-sharded attention."""
    n, b, t, h, d = q.shape
    if h % n != 0:
        raise ValueError(f"heads {h} not divisible by seq axis size {n}")
    # [P, B, T_local, H, D] -> [P, B, P*T_local, H/P, D]: every position
    # holds the full sequence for its H/P heads
    full = [collectives.all_to_all_tiled(x, split_axis=2, concat_axis=1)
            for x in (q, k, v)]
    valid = None
    if key_valid is not None:
        valid = collectives.all_gather_tiled(key_valid, axis=1)
        valid = valid.reshape(n * b, n * t)
    # the positions' attentions are independent: one call over [P*B, ...]
    out = full_attention(*(x.reshape(n * b, n * t, h // n, d) for x in full),
                         causal=causal, key_valid=valid)
    out = out.reshape(n, b, n * t, h // n, d)
    return collectives.all_to_all_tiled(out, split_axis=1, concat_axis=2)


def split_positions(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, ...] -> [n, B, T/n, ...]: position p takes the p-th
    contiguous chunk of the sequence axis."""
    b, t = x.shape[:2]
    return x.reshape(b, n, t // n, *x.shape[2:]).transpose(0, 1)


def merge_positions(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``split_positions``: [n, B, T/n, ...] -> [B, T, ...]."""
    n, b, t = x.shape[:3]
    return x.transpose(0, 1).reshape(b, n * t, *x.shape[3:])
