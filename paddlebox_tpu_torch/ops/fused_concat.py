"""Column-select concat over paired feature blocks (reference:
paddlebox_tpu/ops/fused_concat.py): for every slot, ``len(output_cols)``
output columns, each drawn from one of two per-slot inputs (x1 the base
embedding, x2 the expand embedding, as production pairs them) by a
(which input, which column) spec.  A column gather and a stack per slot;
autograd gives the split backward the reference writes by hand.

``fusion_seqpool_cvm_concat`` needs no op of its own: ``fused_seqpool_cvm``
pools every slot in one segment sum and already returns the concatenated
[B, S * W] layout.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def fused_concat(
    x1: Sequence[torch.Tensor],
    x2: Sequence[torch.Tensor],
    output_cols: Sequence[Tuple[int, int]],
) -> list:
    """x1, x2: parallel lists of per-slot blocks, [B, D1] and [B, D2];
    output_cols: ``(which, col)`` for each output column (0 = x1, 1 = x2).
    Returns one [B, len(output_cols)] tensor per slot."""
    if len(x1) != len(x2):
        raise ValueError(f"slot count mismatch: {len(x1)} vs {len(x2)}")
    for which, _col in output_cols:
        if which not in (0, 1):
            raise ValueError(
                f"output_cols 'which' must be 0 (x1) or 1 (x2), got {which}"
            )
    outs = []
    for a, b in zip(x1, x2):
        cols = [(a if which == 0 else b)[:, col] for which, col in output_cols]
        outs.append(torch.stack(cols, dim=1))
    return outs
