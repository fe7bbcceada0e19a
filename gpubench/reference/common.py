"""The plain training step of a CTR model over a sparse table, float32
with TF32 off, from the published recipe and written apart from the
program under test:

  * rows ``[show, clk, embed...]`` of the batch's distinct keys; each
    categorical slot of an instance sums the rows of its keys, however
    many (none gives a zero row), and the CVM features are
    ``[log(show + 1), log(clk + 1) - log(show + 1), embed...]`` with the
    counters out of the gradient;
  * the model's logits (``reference/<model>.py``), [B] or [B, tasks], and
    its ``loss`` where it has one, else the mean sigmoid cross-entropy
    over the batch and its label columns (column 0 the click label);
  * Adam (lr, betas 0.9 / 0.999, eps 1e-8, bias-corrected) on the dense
    parameters;
  * sparse Adagrad on each distinct key's summed gradient ``g``:
    ``g <- clip(g, grad_clip)``, ``g2sum += mean(g^2)``,
    ``w -= lr * sqrt(g0 / (g0 + g2sum)) * g``; then ``show`` += the key's
    occurrences and ``clk`` += their instances' click labels.
"""

from __future__ import annotations

import numpy as np
import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def xavier_bound(shape) -> float:
    """Glorot's uniform bound of a ``[out, in]`` weight."""
    return float(np.sqrt(6.0 / (shape[0] + shape[1])))


def cvm_features(pooled: torch.Tensor, cvm_offset: int) -> torch.Tensor:
    """[B, S, W] pooled rows -> [B, S, 2 + embed] CVM features."""
    show = pooled[..., 0:1].detach()
    clk = pooled[..., 1:2].detach()
    log_show = torch.log(show + 1.0)
    return torch.cat([log_show, torch.log(clk + 1.0) - log_show,
                      pooled[..., cvm_offset:]], dim=-1)


def mlp(params: dict, prefix: str, n_layers: int, x: torch.Tensor,
        dtype=torch.float32) -> torch.Tensor:
    """ReLU tower ``prefix.0 .. prefix.{n-1}``, the last layer linear, run
    in ``dtype`` and returned as float32."""
    x = x.to(dtype)
    for i in range(n_layers):
        w = params[f"{prefix}.{i}.weight"].to(dtype)
        b = params[f"{prefix}.{i}.bias"].to(dtype)
        x = x @ w.t() + b
        if i + 1 < n_layers:
            x = torch.relu(x)
    return x.float()


def bce_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy, in its stable form."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits)))).mean()


def pool(table: torch.Tensor, inv: torch.Tensor, seg: torch.Tensor,
         batch: int, slots: int) -> torch.Tensor:
    """[B, S, W]: each (instance, slot) segment's sum of its keys' rows."""
    out = torch.zeros((batch * slots, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return out.index_add(0, seg, table[inv]).reshape(batch, slots, -1)


def train(model, config: dict, params: dict, rows: torch.Tensor,
          g2sum: torch.Tensor, batches: list, dtype=torch.float32,
          keep_params=()) -> dict:
    """Steps over ``batches``, each ``(inv [K] long: the row of every key
    occurrence, seg [K] long: its instance * S + slot, dense [B, D],
    labels [B, tasks])``; ``rows`` [U, W] and ``g2sum`` [U] are the
    distinct keys' initial state.  ``dtype`` is the tower's matmul type
    (float32 is the reference; a lower one is the control).

    Returns the losses of the steps, the dense parameters after each step
    named in ``keep_params`` (``params_at``), each dense leaf's first gradient
    (``grad1``), the clipped sparse gradient of the first step
    (``sparse_grad1`` [U, embed]), Adam's first moment after the last step
    (``moment``), the dense parameters and the rows and g2sum after the
    last step."""
    tcfg = config["table"]
    co, s = int(config["cvm_offset"]), int(config["n_sparse_slots"])
    lr_d, lr_s = float(config["trainer"]["dense_lr"]), float(tcfg["learning_rate"])
    g0, clip = float(tcfg["initial_g2sum"]), float(tcfg["grad_clip"])
    loss_fn = getattr(model, "loss", None) or bce_mean
    p = {k: v.detach().clone().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    rows, g2sum = rows.detach().clone().float(), g2sum.detach().clone().float()
    out = {"losses": [], "params_at": {}}
    for t, (inv, seg, dense, labels) in enumerate(batches, start=1):
        leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        emb = rows[:, co:].clone().requires_grad_(True)
        table = torch.cat([rows[:, :co], emb], dim=1)
        pooled = pool(table, inv, seg, labels.shape[0], s)
        logits = model.logits(leaves, pooled, dense, config, dtype)
        loss = loss_fn(logits, labels.reshape(logits.shape))
        loss.backward()
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                out["grad1"] = {k: x.grad.clone() for k, x in leaves.items()}
            for k, x in leaves.items():
                g = x.grad
                m[k] = BETA1 * m[k] + (1 - BETA1) * g
                v2[k] = BETA2 * v2[k] + (1 - BETA2) * g * g
                mh = m[k] / (1 - BETA1 ** t)
                vh = v2[k] / (1 - BETA2 ** t)
                p[k] = p[k] - lr_d * mh / (torch.sqrt(vh) + EPS)
            if t in keep_params:
                out["params_at"][t] = {k: x.clone() for k, x in p.items()}
            g = torch.clamp(emb.grad, -clip, clip)
            if t == 1:
                out["sparse_grad1"] = g.clone()
            add = (g * g).mean(dim=1)
            scale = lr_s * torch.sqrt(g0 / (g0 + g2sum + add))
            rows[:, co:] -= scale[:, None] * g
            g2sum += add
            rows[:, 0].index_add_(0, inv,
                                  torch.ones_like(inv, dtype=rows.dtype))
            rows[:, 1].index_add_(0, inv, labels[seg // s, 0])
    out.update(params=p, rows=rows, g2sum=g2sum, moment=m)
    return out
