"""DeepFM (Guo et al. 2017): a factorization machine and a deep ReLU tower
over the same slot features.  The FM's second-order term is
``0.5 * sum_d [(sum_s v_sd)^2 - sum_s v_sd^2]`` over the pooled slot
embeddings ``v``; its first-order term and the tower act on the CVM
features and the dense counts."""

from __future__ import annotations

import torch

from reference.common import cvm_features, mlp


def param_shapes(config: dict) -> dict:
    s, d = int(config["n_sparse_slots"]), int(config["dense_dim"])
    deep_in = s * (2 + int(config["embedding_dim"])) + d
    dims = [deep_in, *config["model_args"]["hidden"], 1]
    out = {}
    for i in range(len(dims) - 1):
        out[f"tower.{i}.weight"] = (dims[i + 1], dims[i])
        out[f"tower.{i}.bias"] = (dims[i + 1],)
    out["fm1.weight"] = (1, deep_in)
    out["fm1.bias"] = (1,)
    return out


def logits(params: dict, pooled: torch.Tensor, dense: torch.Tensor,
           config: dict, dtype=torch.float32) -> torch.Tensor:
    b = pooled.shape[0]
    co = int(config["cvm_offset"])
    v = pooled[..., co:]
    sum_v = v.sum(1)
    fm2 = 0.5 * (sum_v * sum_v - (v * v).sum(1)).sum(1)
    x = torch.cat([cvm_features(pooled, co).reshape(b, -1), dense], dim=1)
    fm1 = (x.to(dtype) @ params["fm1.weight"].to(dtype).t()
           + params["fm1.bias"].to(dtype)).float()[:, 0]
    deep = mlp(params, "tower", len(config["model_args"]["hidden"]) + 1, x,
               dtype)[:, 0]
    return fm1 + fm2 + deep
