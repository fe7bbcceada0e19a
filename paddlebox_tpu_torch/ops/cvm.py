"""Standalone CVM op (reference: paddlebox_tpu/ops/cvm.py).

Input [..., W] whose first two columns are (show, click); with use_cvm they
become (log(show+1), log(click+1)-log(show+1)), without they are removed.
Counters carry no gradient.
"""

from __future__ import annotations

import torch


def cvm(x: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    if not use_cvm:
        return x[..., 2:]
    show = x[..., 0:1].detach()
    click = x[..., 1:2].detach()
    log_show = torch.log(show + 1.0)
    return torch.cat(
        [log_show, torch.log(click + 1.0) - log_show, x[..., 2:]], dim=-1
    )


def cvm_decayed_show(x: torch.Tensor, decay: float) -> torch.Tensor:
    """The CVM with show and click scaled by ``decay`` before the log (the
    per-day decay of an AUC-runner style evaluation)."""
    show = x[..., 0:1].detach() * decay
    click = x[..., 1:2].detach() * decay
    log_show = torch.log(show + 1.0)
    return torch.cat(
        [log_show, torch.log(click + 1.0) - log_show, x[..., 2:]], dim=-1
    )
