"""Bytes-once bounds of the step's two sparse kernels (the arithmetic of
the port's standalone kernel timing, chip_smoke.py ``kernel_specs``): each
input byte read once, each output byte written once.

  * ``pull_rows``: ``k`` int32 indices, the distinct rows they name read
    once (``w`` float32 each), ``k`` rows written.
  * ``scatter_add_rows``: ``u`` int32 indices and ``u`` delta rows read,
    each distinct target row read and written.

A step of the single-chip trainer launches each once, on the batch's plan
(sparse/table.py ``plan_keys``): ``idx`` names one row a key occurrence
(the dead row for padding); ``uniq_idx`` names the live row of each
distinct key in its first ``distinct`` slots; slot ``j`` after them names
scratch row ``n_live + j``, clamped to the dead row ``rows - 1``.
"""

from __future__ import annotations

import numpy as np


def pull_bytes(k: int, w: int, distinct: int) -> int:
    return k * 4 + distinct * w * 4 + k * w * 4


def scatter_add_bytes(u: int, w: int, distinct: int) -> int:
    return u * 4 + u * w * 4 + 2 * distinct * w * 4


def step_bytes(batch_keys: np.ndarray, capacity: int, w: int, n_live: int,
               rows: int) -> tuple:
    """(pull bytes, scatter-add bytes) of one step on a batch's real keys
    (``batch_keys``, every key in the pass census) in a key buffer of
    ``capacity``, a table of ``rows`` rows of which ``n_live`` are live."""
    n_keys = batch_keys.shape[0]
    distinct = int(np.unique(batch_keys).shape[0])
    pull_rows = distinct + (1 if n_keys < capacity else 0)
    scratch = rows - 1 - n_live  # slots below this name a scratch row
    push_rows = (distinct + max(0, min(capacity, scratch) - distinct)
                 + (1 if capacity > max(scratch, distinct) else 0))
    return (pull_bytes(capacity, w, pull_rows),
            scatter_add_bytes(capacity, w, push_rows))
