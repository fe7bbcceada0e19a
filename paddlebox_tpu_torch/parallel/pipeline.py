"""Pipeline parallelism: a microbatched stage pipeline over a ``pipe`` axis
(reference: paddlebox_tpu/parallel/pipeline.py; the PipelineTrainer /
SectionWorker analog).

Each of the P positions (parallel/mesh.py) owns one stage, its parameters
stacked on a leading ``[P, ...]`` axis.  ``gpipe_run`` is the loop-skew
schedule: M + P - 1 ticks, in each of which every stage computes its
in-flight microbatch and ``collectives.ppermute`` shifts the activations one
stage down the chain; stage 0 injects microbatch t at tick t (clipped to
M - 1) and the last stage completes microbatch t - (P - 1).  The ticks are
host integers, so the schedule stays capturable in a CUDA graph.  Backward
is autograd through the schedule (the shift's transpose is the reverse
shift).

The demo network is a uniform-width MLP tower: stage 0 projects d_in ->
width, every stage applies ``depth_per_stage`` width -> width ReLU layers,
the last stage adds the scalar head; every stage carries a proj and a head
block, so the stage program is uniform (only stage 0's proj and the last
stage's head are live).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.nn.functional import binary_cross_entropy_with_logits

from paddlebox_tpu_torch.parallel import collectives
from paddlebox_tpu_torch.parallel.mesh import Mesh, axis_positions
from paddlebox_tpu_torch.utils.device import resolve_device

PIPE_AXIS = "pipe"

_PARAM_NAMES = ("proj_w", "proj_b", "blocks_w", "blocks_b", "head_w",
                "head_b")


def init_pipeline_params(d_in: int, width: int, depth_per_stage: int,
                         n_stages: int, seed: int = 0,
                         device="cuda") -> dict:
    """Per-stage parameters stacked on a leading [n_stages, ...] axis, the
    reference's distributions (uniform weights in +-1/sqrt(fan_in), zero
    biases) drawn on the CPU from a ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    s_in, s_w = 1.0 / np.sqrt(d_in), 1.0 / np.sqrt(width)

    def uniform(shape, bound):
        return torch.empty(shape).uniform_(-bound, bound, generator=gen)

    stages = [{
        "proj_w": uniform((d_in, width), s_in),
        "proj_b": torch.zeros(width),
        "blocks_w": uniform((depth_per_stage, width, width), s_w),
        "blocks_b": torch.zeros(depth_per_stage, width),
        "head_w": uniform((width, 1), s_w),
        "head_b": torch.zeros(1),
    } for _ in range(n_stages)]
    dev = resolve_device(device)
    return {k: torch.stack([s[k] for s in stages]).to(dev)
            for k in _PARAM_NAMES}


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element sigmoid cross-entropy (optax's
    sigmoid_binary_cross_entropy)."""
    return binary_cross_entropy_with_logits(logits, labels, reduction="none")


def _stage_apply(p: dict, x_inject: torch.Tensor, carry: torch.Tensor,
                 is_first: torch.Tensor) -> tuple:
    """Every stage's compute at once: stage 0 takes the injected input
    x_inject [mb, d_in], the others their carried activation [P, mb,
    width]; all run their blocks and the head (live on the last stage
    only).  Returns (activations [P, mb, width], logits [P, mb])."""
    h0 = torch.matmul(x_inject, p["proj_w"]) + p["proj_b"][:, None, :]
    h = torch.where(is_first[:, None, None], h0, carry)
    for d in range(p["blocks_w"].shape[1]):
        h = torch.relu(torch.matmul(h, p["blocks_w"][:, d])
                       + p["blocks_b"][:, d, None, :])
    logits = (torch.matmul(h, p["head_w"]) + p["head_b"][:, None, :])[..., 0]
    return h, logits


def _stack(items: list):
    """[T] emissions (tensors or tuples of them, each [P, ...]) stacked
    along a new axis 1: [P, T, ...]."""
    if isinstance(items[0], tuple):
        return tuple(torch.stack(xs, dim=1) for xs in zip(*items))
    return torch.stack(items, dim=1)


def gpipe_run(stage_fn: Callable, emit_fn: Callable, n_microbatches: int,
              act0: torch.Tensor):
    """The GPipe loop-skew schedule over P stacked stages (act0 [P, ...],
    the initial carried activations), shared by ``pipeline_forward_loss``
    and models/pipelined_ctr.py.

      stage_fn(m_in, act, is_first) -> (act_out, aux): every stage on its
          tick input (m_in: the clipped microbatch stage 0 injects; act
          [P, ...] the carried activations; is_first bool [P]).
      emit_fn(aux, m_out, valid) -> a tensor or a tuple of tensors, each
          [P, ...] (m_out: the microbatch the last stage completes this
          tick, clipped; valid bool [P]: the last stage, in range).

    Returns the emissions stacked [P, T, ...], T = M + P - 1."""
    n = act0.shape[0]
    M = n_microbatches
    idx = torch.arange(n, device=act0.device)
    is_first, is_last = idx == 0, idx == n - 1
    chain = [(i, i + 1) for i in range(n - 1)]
    act, emits = act0, []
    for t in range(M + n - 1):
        act_out, aux = stage_fn(min(t, M - 1), act, is_first)
        m_out = t - (n - 1)
        valid = is_last if m_out >= 0 else torch.zeros_like(is_last)
        emits.append(emit_fn(aux, min(max(m_out, 0), M - 1), valid))
        # the last stage's output falls off the chain: the emit consumed it
        act = collectives.ppermute(act_out, chain)
    return _stack(emits)


def pipeline_forward_loss(stage_params: dict, x: torch.Tensor,
                          y: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    """Mean sigmoid-BCE over the real instances of x [M, mb, d_in] (labels
    y and mask [M, mb]) through the stacked stages.  Returns [P], the
    psummed loss every position holds."""
    M, mb, _ = x.shape
    n, width = stage_params["proj_b"].shape

    def stage_fn(m_in, act, is_first):
        return _stage_apply(stage_params, x[m_in], act, is_first)

    def emit_fn(logits, m_out, valid):
        msk = mask[m_out][None, :] * valid[:, None].to(mask.dtype)
        per = _bce(logits, y[m_out][None, :].expand_as(logits)) * msk
        return per.sum(dim=1), msk.sum(dim=1)

    losses, cnts = gpipe_run(stage_fn, emit_fn, M,
                             x.new_zeros((n, mb, width)))
    # only the last stage accumulated: share with every position
    loss_sum = collectives.psum(losses.sum(dim=1))
    cnt_sum = collectives.psum(cnts.sum(dim=1))
    return loss_sum / torch.clamp(cnt_sum, min=1.0)


class PipelineTrainer:
    """Drives the pipelined tower over a pipe mesh: one step is forward and
    backward through the schedule and the optimizer on the stacked stage
    parameters (default Adam, which is elementwise, so it equals per-stage
    Adam)."""

    def __init__(self, mesh: Mesh, d_in: int, width: int = 64,
                 depth_per_stage: int = 2, lr: float = 1e-3, seed: int = 0,
                 params: Optional[dict] = None, optimizer=None):
        """params: stacked stage parameters (tensors or numpy arrays, e.g.
        ``weights.params_from_jax_tree`` of the reference's); optimizer: a
        callable that builds a ``torch.optim.Optimizer`` from the parameter
        list (default ``torch.optim.Adam(params, lr)``, optax.adam's
        defaults)."""
        self.mesh = mesh
        self.n_stages = axis_positions(mesh, PIPE_AXIS)
        self.device = mesh.device
        self.d_in, self.width = d_in, width
        if params is None:
            params = init_pipeline_params(d_in, width, depth_per_stage,
                                          self.n_stages, seed, self.device)
        got = int(np.shape(params["proj_b"])[0])
        if got != self.n_stages:
            raise ValueError(
                f"params carry {got} stages but the pipe mesh has "
                f"{self.n_stages} positions — a divisible mismatch would "
                "silently drop stages"
            )
        self.params = {
            k: torch.nn.Parameter(
                (params[k] if torch.is_tensor(params[k])
                 else torch.from_numpy(np.array(params[k], np.float32)))
                .float().to(self.device).clone())
            for k in _PARAM_NAMES
        }
        make = optimizer or (lambda ps: torch.optim.Adam(ps, lr=lr))
        self.optimizer = make(list(self.params.values()))

    def train_step(self, x_mb, y_mb, mask_mb=None) -> float:
        """x_mb: [M, mb, d_in] microbatches; returns the step loss."""
        dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(self.device)
        x, y = dev(x_mb), dev(y_mb)
        mask = torch.ones_like(y) if mask_mb is None else dev(mask_mb)
        # the true gradient of the loss: autograd through the one psummed
        # copy a position reads.  The reference differentiates inside its
        # shard_map body and divides by P, assuming psum's transpose seeds
        # P cotangents; on jax 0.9 it seeds one, so its step applies 1/P
        # of this gradient (tests hold the port against the sequential
        # oracle, reference_forward_loss)
        loss = pipeline_forward_loss(self.params, x, y, mask)[0]
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach())


def reference_forward_loss(stage_params: dict, x: torch.Tensor,
                           y: torch.Tensor, mask: torch.Tensor
                           ) -> torch.Tensor:
    """The same stacked parameters without the pipeline (the test oracle):
    every stage in turn on the full batch."""
    n = stage_params["proj_b"].shape[0]
    M, mb, _ = x.shape
    h = x.reshape(M * mb, -1) @ stage_params["proj_w"][0] \
        + stage_params["proj_b"][0]
    for s in range(n):
        for d in range(stage_params["blocks_w"].shape[1]):
            h = torch.relu(h @ stage_params["blocks_w"][s, d]
                           + stage_params["blocks_b"][s, d])
    logits = (h @ stage_params["head_w"][n - 1]
              + stage_params["head_b"][n - 1])[:, 0]
    per = _bce(logits, y.reshape(-1)) * mask.reshape(-1)
    return per.sum() / torch.clamp(mask.sum(), min=1.0)
