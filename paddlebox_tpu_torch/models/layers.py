"""Dense layer helpers (reference: paddlebox_tpu/models/layers.py).

Layers are ``torch.nn.Linear``, whose weight is ``[out, in]`` and computes
``x @ weight.T + bias``; the reference keeps ``w`` as ``[in, out]`` and
computes ``x @ w + b``.  ``weights.params_from_jax`` transposes on the way
in.  Initialization follows the reference's distribution (xavier-uniform
weights, zero biases) drawn from an explicit ``torch.Generator``; the draws
differ from JAX's, so tests copy the reference's parameters across.

A compute dtype (bfloat16 or float16) is a cast policy, as in the
reference: the parameters and the optimizer state stay float32, the tower's
input and a copy of each parameter are cast once on the way in, the matmul
chain runs in the compute dtype, and the output is cast back to float32
before the loss.  The casts are explicit (no ``torch.autocast``), so the
chain rounds where the reference's does; autograd carries each parameter's
gradient back through its cast as float32.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.config import flags

_COMPUTE_DTYPES = {
    "float32": None, "f32": None, "fp32": None,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16, "f16": torch.float16,
}


def resolve_compute_dtype(name: Optional[str] = None):
    """The tower compute dtype of a config string: None for float32,
    ``torch.bfloat16`` or ``torch.float16``.  "" reads
    ``flags.compute_dtype`` (PADDLEBOX_TORCH_COMPUTE_DTYPE)."""
    if not name:
        name = flags.compute_dtype
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return _COMPUTE_DTYPES[name]


def apply_compute_dtype_override(model, dtype_name: str) -> None:
    """A trainer config's compute_dtype, set on the model (the trainer owns
    the training-time policy; "" leaves the model's own).  Warns when the
    model has no compute_dtype attribute, so the setting is never ignored
    silently."""
    if not dtype_name:
        return
    if not hasattr(model, "compute_dtype"):
        warnings.warn(
            f"TrainerConfig.compute_dtype={dtype_name!r} ignored: "
            f"{type(model).__name__} has no compute_dtype attribute",
            RuntimeWarning, stacklevel=2,
        )
        return
    model.compute_dtype = resolve_compute_dtype(dtype_name)


def init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (layer.in_features + layer.out_features))
    with torch.no_grad():
        # draw on the CPU so one seed gives the same weights on any device
        w = torch.empty(layer.weight.shape).uniform_(-bound, bound,
                                                     generator=generator)
        layer.weight.copy_(w)
        layer.bias.zero_()


def make_linear(in_dim: int, out_dim: int, generator: torch.Generator,
                device) -> nn.Linear:
    """One xavier-initialized linear layer (the reference's init_linear)."""
    layer = nn.Linear(in_dim, out_dim)
    init_linear(layer, generator)
    return layer.to(device)


def init_param(shape, bound: float, generator: torch.Generator,
               device) -> nn.Parameter:
    """A bare parameter array drawn uniform in [-bound, bound] on the CPU
    from ``generator`` (the CIN kernels, rank_param); ``bound`` 0 gives
    zeros (DCN's cross vectors)."""
    w = torch.zeros(shape)
    if bound:
        w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w.to(device))


def make_mlp(in_dim: int, hidden: Sequence[int], out_dim: int,
             generator: torch.Generator, device) -> nn.ModuleList:
    # built on the CPU, then moved: nn.Linear's own init would draw from the
    # device's default generator, which init_linear overwrites anyway
    dims = [in_dim, *hidden, out_dim]
    layers = nn.ModuleList(
        nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1)
    )
    for layer in layers:
        init_linear(layer, generator)
    return layers.to(device)


def linear(layer: nn.Linear, x: torch.Tensor,
           compute_dtype=None) -> torch.Tensor:
    """One layer, ``x @ w + b``; with a compute dtype it runs in it and the
    output comes back as float32, as the reference's linear()."""
    if compute_dtype is None:
        return layer(x)
    out = x.to(compute_dtype) @ layer.weight.to(compute_dtype).t()
    return (out + layer.bias.to(compute_dtype)).float()


def mlp(layers: nn.ModuleList, x: torch.Tensor,
        compute_dtype=None) -> torch.Tensor:
    """ReLU MLP; the final layer is linear.  With a compute dtype the whole
    chain runs in it, x @ w + b as in the reference, and the output comes
    back as float32."""
    if compute_dtype is None:
        for layer in layers[:-1]:
            x = torch.relu(layer(x))
        return layers[-1](x)
    x = x.to(compute_dtype)
    params = [(layer.weight.to(compute_dtype), layer.bias.to(compute_dtype))
              for layer in layers]
    for w, b in params[:-1]:
        x = torch.relu(x @ w.t() + b)
    w, b = params[-1]
    return (x @ w.t() + b).float()


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (per element).  At a logit
    of exactly 0 (a tower whose last hidden layer is all dead ReLUs, and a
    zero output bias) the gradient is the reference's, -label: relu's
    derivative there is 0 (clamp's would be 1) and abs's is 0, where the
    reference's maximum gives 1/2 and its abs 1."""
    return (
        torch.relu(logits)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
