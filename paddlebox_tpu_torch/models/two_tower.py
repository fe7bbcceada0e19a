"""Two-tower retrieval model over the shared sparse table (reference:
paddlebox_tpu/models/two_tower.py).

The user tower is a dense MLP over the pooled user-slot embeddings and the
dense features; the item tower is the identity over the pooled item-slot
embeddings (``row[cvm_offset:]``, the ``use_cvm=False`` pooled view), so a
served index is exactly the table's item rows, L2-normalized.  Trained with
in-batch sampled-softmax negatives by scenarios/retrieval.py.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import make_mlp, mlp, resolve_compute_dtype
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.utils.device import resolve_device


class TwoTower(nn.Module):
    """``apply_towers`` returns the normalized (user, item) embedding pair;
    ``forward`` their pointwise logits [B] (user . item / temperature), the
    view ranking-style AUC reads."""

    retrieval = True  # the scenario plumbing dispatches on this marker

    def __init__(
        self,
        n_sparse_slots: int,
        emb_width: int,  # pulled row width (cvm_offset + embedding_dim)
        item_slots: Sequence[int],
        dense_dim: int = 0,
        hidden: Sequence[int] = (128, 64),
        cvm_offset: int = 2,
        temperature: float = 0.05,
        compute_dtype: str = "",
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.device = resolve_device(device)
        self.n_sparse_slots = n_sparse_slots
        self.emb_width = emb_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.cvm_offset = cvm_offset
        self.temperature = float(temperature)
        items = sorted(set(int(s) for s in item_slots))
        bad = [s for s in items if not 0 <= s < n_sparse_slots]
        if bad:
            raise ValueError(
                f"item_slots {bad} out of range [0, {n_sparse_slots})"
            )
        if not items or len(items) == n_sparse_slots:
            raise ValueError(
                "item_slots must be a proper non-empty subset of the slots "
                "(both towers need features)"
            )
        self.item_slots = tuple(items)
        self.user_slots = tuple(s for s in range(n_sparse_slots)
                                if s not in set(items))
        self.embed_dim = emb_width - cvm_offset
        if self.embed_dim <= 0:
            raise ValueError(
                f"emb_width {emb_width} leaves no embedding columns past "
                f"cvm_offset {cvm_offset}"
            )
        # the user MLP projects into the item-embedding space
        self.input_dim = len(self.user_slots) * self.embed_dim + dense_dim
        # slot indices on the device: a forward builds no tensor from the
        # host, so it captures in a CUDA graph
        for name, slots in (("_user_idx", self.user_slots),
                            ("_item_idx", self.item_slots)):
            self.register_buffer(name, torch.tensor(slots, device=self.device),
                                 persistent=False)
        gen = torch.Generator().manual_seed(seed)
        self.user = make_mlp(self.input_dim, self.hidden, self.embed_dim, gen,
                             self.device)

    def apply_towers(self, rows: torch.Tensor, key_segments: torch.Tensor,
                     dense: torch.Tensor, batch_size: int) -> tuple:
        """(user [B, D], item [B, D]), both L2-normalized."""
        B = batch_size
        pooled = fused_seqpool_cvm(
            rows, key_segments, B, self.n_sparse_slots,
            use_cvm=False, cvm_offset=self.cvm_offset,
        ).reshape(B, self.n_sparse_slots, self.embed_dim)
        user_x = pooled.index_select(1, self._user_idx).reshape(B, -1)
        if self.dense_dim:
            user_x = torch.cat([user_x, dense], dim=1)
        user = mlp(self.user, user_x, self.compute_dtype)
        # the identity item tower: the summed pooled item-slot embedding
        item = pooled.index_select(1, self._item_idx).sum(dim=1)
        return _l2_normalize(user), _l2_normalize(item)

    def forward(self, rows: torch.Tensor, key_segments: torch.Tensor,
                dense: torch.Tensor, batch_size: int) -> torch.Tensor:
        """Pointwise logits [B]: each instance's own (user, item) pair."""
        user, item = self.apply_towers(rows, key_segments, dense, batch_size)
        return (user * item).sum(dim=1) / self.temperature


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp(x.square().sum(dim=-1, keepdim=True),
                                      min=eps))
