"""Pipeline-parallel CTR model: CtrDnn's tower as GPipe stages over a
``pipe`` axis (reference: paddlebox_tpu/models/pipelined_ctr.py).

It keeps CtrDnn's forward contract (rows in, logits out), so the
single-chip Trainer drives it unchanged; the pooling runs once, replicated,
and only the tower pipelines (parallel/pipeline.py's ``gpipe_run``).

The stages run one program on same-shaped tensors, but the tower narrows
(173 -> 512 -> 256 -> 128 -> 1), so every layer is zero-padded to [A, A]
(A = the widest activation) and the activations ride the chain at width A.
The padding is exact: padded input columns are zero, so padded weights see
zero inputs and zero gradients and stay zero under any gradient optimizer,
and the logits are the unpadded tower's.  Per (stage, layer slot) flags
say which slots hold a layer (``live``) and which is the head (``head``,
no ReLU); the head's logit rides column 0.  ``microbatches`` (default 2P)
must divide the batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import make_mlp, resolve_compute_dtype
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, pooled_width
from paddlebox_tpu_torch.parallel import collectives
from paddlebox_tpu_torch.parallel.mesh import Mesh, axis_positions
from paddlebox_tpu_torch.parallel.pipeline import PIPE_AXIS, gpipe_run
from paddlebox_tpu_torch.utils.device import resolve_device


def _split_stages(n_layers: int, n_stages: int) -> list:
    """Contiguous layer ranges per stage (early stages take the
    remainder)."""
    if n_layers < n_stages:
        raise ValueError(
            f"tower has {n_layers} layers but the pipe mesh has {n_stages} "
            "stages: every stage needs at least one layer"
        )
    base, rem = divmod(n_layers, n_stages)
    out, i = [], 0
    for s in range(n_stages):
        take = base + (1 if s < rem else 0)
        out.append(list(range(i, i + take)))
        i += take
    return out


class PipelinedCtrDnn(nn.Module):
    """CtrDnn with its ReLU tower run as a GPipe pipeline (the default
    layout: no expand_dim, no conv).  Parameters: ``stages.w`` [P, dmax, A,
    A] (``x @ w``, the reference's orientation) and ``stages.b`` [P, dmax,
    A]."""

    def __init__(
        self,
        mesh: Mesh,
        n_sparse_slots: int,
        emb_width: int,
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
        use_cvm: bool = True,
        cvm_offset: int = 2,
        microbatches: Optional[int] = None,
        compute_dtype: str = "",
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.n_stages = axis_positions(mesh, PIPE_AXIS)
        # CtrDnn's cast policy: f32 parameters and pooling, the tower in
        # the compute dtype, f32 logits
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_sparse_slots = n_sparse_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.input_dim = (n_sparse_slots * pooled_width(emb_width, cvm_offset,
                                                        use_cvm) + dense_dim)
        self.microbatches = microbatches or 2 * self.n_stages
        # layer l maps dims[l] -> dims[l + 1]; the last layer is the head
        self.dims = [self.input_dim, *self.hidden, 1]
        self.A = max(self.dims)
        self.stage_layers = _split_stages(len(self.dims) - 1, self.n_stages)
        self.depth_max = max(len(ls) for ls in self.stage_layers)
        live = np.zeros((self.n_stages, self.depth_max), np.bool_)
        head = np.zeros((self.n_stages, self.depth_max), np.bool_)
        for s, ls in enumerate(self.stage_layers):
            for j, l in enumerate(ls):
                live[s, j] = True
                head[s, j] = l == len(self.dims) - 2
        # structure, not state
        self.register_buffer("_live", torch.from_numpy(live).to(self.device),
                             persistent=False)
        self.register_buffer("_head", torch.from_numpy(head).to(self.device),
                             persistent=False)
        # CtrDnn's tower init from the same seed, packed: a PipelinedCtrDnn
        # and a CtrDnn seeded alike start from the same function
        gen = torch.Generator().manual_seed(seed)
        packed = self.pack_tower(make_mlp(self.input_dim, self.hidden, 1, gen,
                                          "cpu"))
        self.stages = nn.Module()
        self.stages.w = nn.Parameter(packed["w"].to(self.device))
        self.stages.b = nn.Parameter(packed["b"].to(self.device))

    def pack_tower(self, layers) -> dict:
        """A CtrDnn tower (its ``nn.Linear`` layers) -> the zero-padded
        stacked stage parameters {"w": [P, dmax, A, A], "b": [P, dmax, A]}
        as float32 CPU tensors."""
        A, dmax = self.A, self.depth_max
        w = torch.zeros((self.n_stages, dmax, A, A))
        b = torch.zeros((self.n_stages, dmax, A))
        for s, ls in enumerate(self.stage_layers):
            for j, l in enumerate(ls):
                lw = layers[l].weight.detach().float().cpu().t()  # [in, out]
                lb = layers[l].bias.detach().float().cpu()
                w[s, j, : lw.shape[0], : lw.shape[1]] = lw
                b[s, j, : lb.shape[0]] = lb
        return {"w": w, "b": b}

    def unpack_tower(self) -> nn.ModuleList:
        """The inverse of ``pack_tower``: the tower as ``nn.Linear`` layers
        on the model's device, a CtrDnn ``tower``'s state (checkpoint
        interchange with CtrDnn)."""
        out = nn.ModuleList()
        for s, ls in enumerate(self.stage_layers):
            for j, l in enumerate(ls):
                din, dout = self.dims[l], self.dims[l + 1]
                layer = nn.Linear(din, dout, device=self.device)
                with torch.no_grad():
                    layer.weight.copy_(self.stages.w[s, j, :din, :dout].t())
                    layer.bias.copy_(self.stages.b[s, j, :dout])
                out.append(layer)
        return out

    def _pipeline_logits(self, x_pad: torch.Tensor) -> torch.Tensor:
        """x_pad [M, mb, A] padded microbatches -> logits [M * mb]."""
        sw, sb = self.stages.w, self.stages.b
        if self.compute_dtype is not None:
            sw, sb = sw.to(self.compute_dtype), sb.to(self.compute_dtype)
        live, head = self._live, self._head
        M, mb, A = x_pad.shape
        n = self.n_stages

        def stage_fn(m_in, act, is_first):
            h = torch.where(is_first[:, None, None], x_pad[m_in], act)
            for j in range(self.depth_max):
                out = torch.matmul(h, sw[:, j]) + sb[:, j, None, :]
                out = torch.where(head[:, j, None, None], out, torch.relu(out))
                # a dead slot (a stage shorter than dmax) passes through
                h = torch.where(live[:, j, None, None], out, h)
            return h, h[..., 0]

        def emit_fn(logit_col, m_out, valid):
            return torch.where(valid[:, None], logit_col, 0.0)

        emits = gpipe_run(stage_fn, emit_fn, M,
                          x_pad.new_zeros((n, mb, A)))  # [P, T, mb]
        # ticks P-1 .. T-1 carry microbatches 0 .. M-1 (last stage only)
        logits = emits[:, n - 1:].reshape(n, M * mb).float()
        return collectives.psum(logits)[0]  # zeros on the other stages

    def forward(
        self,
        rows: torch.Tensor,  # [K, emb_width]
        key_segments: torch.Tensor,  # [K]
        dense: torch.Tensor,  # [B, dense_dim]
        batch_size: int,
    ) -> torch.Tensor:
        """Returns logits [B]."""
        pooled = fused_seqpool_cvm(
            rows, key_segments, batch_size, self.n_sparse_slots,
            use_cvm=self.use_cvm, cvm_offset=self.cvm_offset,
        )
        x = torch.cat([pooled, dense], dim=1) if self.dense_dim else pooled
        B, M = batch_size, self.microbatches
        if B % M:
            raise ValueError(
                f"batch size {B} not divisible by microbatches {M}"
            )
        x_pad = nn.functional.pad(x, (0, self.A - self.input_dim))
        if self.compute_dtype is not None:
            x_pad = x_pad.to(self.compute_dtype)
        return self._pipeline_logits(x_pad.reshape(M, B // M, self.A))
