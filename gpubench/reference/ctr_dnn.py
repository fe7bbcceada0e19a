"""CTR-DNN (the PaddleBox benchmark model): every slot's CVM features and
the dense counts, concatenated, through a ReLU tower to one logit."""

from __future__ import annotations

import torch

from reference.common import cvm_features, mlp


def param_shapes(config: dict) -> dict:
    """Leaf name -> shape, the tower's ``[out, in]`` weights and biases."""
    s, d = int(config["n_sparse_slots"]), int(config["dense_dim"])
    dims = [s * (2 + int(config["embedding_dim"])) + d,
            *config["model_args"]["hidden"], 1]
    out = {}
    for i in range(len(dims) - 1):
        out[f"tower.{i}.weight"] = (dims[i + 1], dims[i])
        out[f"tower.{i}.bias"] = (dims[i + 1],)
    return out


def logits(params: dict, pooled: torch.Tensor, dense: torch.Tensor,
           config: dict, dtype=torch.float32) -> torch.Tensor:
    b = pooled.shape[0]
    x = torch.cat([cvm_features(pooled, int(config["cvm_offset"])).reshape(b, -1),
                   dense], dim=1)
    return mlp(params, "tower", len(config["model_args"]["hidden"]) + 1, x,
               dtype)[:, 0]
