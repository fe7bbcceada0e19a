"""Dense layer helpers (reference: paddlebox_tpu/models/layers.py).

Layers are ``torch.nn.Linear``, whose weight is ``[out, in]`` and computes
``x @ weight.T + bias``; the reference keeps ``w`` as ``[in, out]`` and
computes ``x @ w + b``.  ``weights.params_from_jax`` transposes on the way
in.  Initialization follows the reference's distribution (xavier-uniform
weights, zero biases) drawn from an explicit ``torch.Generator``; the draws
differ from JAX's, so tests copy the reference's parameters across.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.config import flags, not_ported


def resolve_compute_dtype(name: Optional[str] = None):
    """The tower compute dtype; this slice runs float32 only (None)."""
    if not name:
        name = flags.compute_dtype
    if name in ("float32", "f32", "fp32"):
        return None
    if name in ("bfloat16", "bf16", "float16", "fp16", "f16"):
        raise not_ported(f"compute_dtype={name!r}", "trainer cut-outs, item 3")
    raise ValueError(f"unknown compute_dtype {name!r}")


def init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (layer.in_features + layer.out_features))
    with torch.no_grad():
        # draw on the CPU so one seed gives the same weights on any device
        w = torch.empty(layer.weight.shape).uniform_(-bound, bound,
                                                     generator=generator)
        layer.weight.copy_(w)
        layer.bias.zero_()


def make_mlp(in_dim: int, hidden: Sequence[int], out_dim: int,
             generator: torch.Generator, device) -> nn.ModuleList:
    dims = [in_dim, *hidden, out_dim]
    layers = nn.ModuleList(
        nn.Linear(dims[i], dims[i + 1], device=device)
        for i in range(len(dims) - 1)
    )
    for layer in layers:
        init_linear(layer, generator)
    return layers


def mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP; the final layer is linear."""
    for layer in layers[:-1]:
        x = torch.relu(layer(x))
    return layers[-1](x)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (per element)."""
    return (
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
