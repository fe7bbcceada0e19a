"""Auxiliary lookup tables: InputTable and ReplicaCache (reference:
paddlebox_tpu/sparse/aux_tables.py).

  * ``InputTable`` (the reference's box_wrapper.h InputTable and the
    ``lookup_input`` op): a host string-key -> dense-row table; keys
    resolve to row ids on the host at feed time (``lookup_idx``) and the
    device gathers from the row matrix (``rows_device``).
  * ``ReplicaCache`` (GpuReplicaCache and the ``pull_cache_value`` op): a
    small dense table on the device, indexed by int ids that arrive as
    feature values; row 0 is the zero row out-of-range ids read.

Both are small side data (ad metadata, position vectors) on one explicit
device, not the main sparse table.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.utils.device import resolve_device


class InputTable:
    """String key -> dense float row; unknown keys read the zero row 0."""

    def __init__(self, dim: int, device="cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        self._index: dict = {}
        self._rows: list = [np.zeros(dim, dtype=np.float32)]
        self._device: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return len(self._rows)

    def add_row(self, key: str, row) -> int:
        row = np.asarray(row, dtype=np.float32)
        if row.shape != (self.dim,):
            raise ValueError(f"row must have shape ({self.dim},), got {row.shape}")
        if key in self._index:
            self._rows[self._index[key]] = row
        else:
            self._index[key] = len(self._rows)
            self._rows.append(row)
        self._device = None  # the device copy is stale
        return self._index[key]

    def lookup_idx(self, keys: Iterable[str]) -> np.ndarray:
        """Host-side key resolution (the feed-time half of lookup_input)."""
        return np.asarray([self._index.get(k, 0) for k in keys], dtype=np.int32)

    def rows_device(self) -> torch.Tensor:
        """The [n, dim] row matrix on the table's device."""
        if self._device is None:
            self._device = torch.from_numpy(np.stack(self._rows)).to(
                self.device)
        return self._device

    def lookup_rows(self, keys: Iterable[str]) -> np.ndarray:
        """Host-side gather: [len(keys), dim]."""
        return np.stack(self._rows)[self.lookup_idx(keys)]

    def state_dict(self) -> dict:
        return {
            "keys": np.asarray(list(self._index.keys()), dtype=np.str_),
            "ids": np.asarray(list(self._index.values()), dtype=np.int64),
            "rows": np.stack(self._rows),
        }

    def load_state_dict(self, state: dict) -> None:
        rows = np.asarray(state["rows"], dtype=np.float32)
        self._rows = [rows[i] for i in range(rows.shape[0])]
        self._index = {str(k): int(i)
                       for k, i in zip(state["keys"], state["ids"])}
        self._device = None


def pull_cache_value(cache_values: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """The replica-cache gather (the pull_cache_value op): out-of-range ids
    read row 0 (the zero/default row).  ids of any shape -> [*ids, dim]."""
    n = cache_values.shape[0]
    safe = torch.where((ids >= 0) & (ids < n), ids, 0)
    return cache_values.index_select(0, safe.reshape(-1)).reshape(
        *ids.shape, cache_values.shape[1])


class ReplicaCache:
    """A small dense table on one device (GpuReplicaCache)."""

    def __init__(self, matrix, device="cuda"):
        m = np.asarray(matrix, dtype=np.float32)
        if m.ndim != 2:
            raise ValueError("ReplicaCache needs a 2-D [n, dim] matrix")
        # row 0 is reserved as the default/zero row for bad ids
        self._host = np.concatenate([np.zeros((1, m.shape[1]), np.float32), m])
        self.values = torch.from_numpy(self._host).to(resolve_device(device))

    @property
    def n_rows(self) -> int:
        return self._host.shape[0] - 1

    def pull(self, ids) -> torch.Tensor:
        """ids are 1-based into the caller's matrix (0 -> default row)."""
        return pull_cache_value(self.values,
                                torch.as_tensor(ids).to(self.values.device))
