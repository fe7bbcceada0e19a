"""The sparse table's device kernels, each beside its plain PyTorch twin
(counterpart of paddlebox_tpu/ops/pallas_sparse.py).

  * ``pull_rows(values, idx)`` -> ``values[idx]``, the row gather of the
    pull (csrc/pull_rows.cu; replaces ``pallas_pull_rows``).
  * ``scatter_add_rows(values, idx, delta)`` -> ``values[idx] += delta`` in
    place, duplicates accumulating (csrc/scatter_add_rows.cu; replaces
    ``pallas_scatter_add``).
  * ``gather_slots(table, slots)`` -> ``table[slot]``, the zero row where
    ``slot < 0`` (csrc/gather_slots.cu; replaces ``pallas_gather_slots``).
  * ``scatter_rows(table, slots, rows)`` -> ``table[slots] = rows`` in
    place, negative slots dropped, duplicates last-occurrence-wins
    (csrc/scatter_rows.cu; replaces ``pallas_scatter_rows``).
  * ``sorted_search(hay, n_real, q)`` -> position of each uint64 query in a
    pow2-padded sorted haystack, -1 when absent (csrc/sorted_search.cu;
    replaces ``pallas_sorted_search``).  Keys travel as int64 tensors that
    hold the uint64 bits; they are compared unsigned.
  * ``hot_cold_select(hot, hot_occ, cold_rows)`` -> the hot block's row where
    ``hot_occ < H``, the cold row where ``hot_occ == H``
    (csrc/hot_cold_select.cu; replaces ``pallas_hot_cold_select``).

gather_slots, scatter_rows and sorted_search carry the HBM cache tier
(sparse/engine/hbm_cache.py); hot_cold_select carries the hybrid-placement
pull of the multi-chip trainer (parallel/trainer.py).

A wrapper given CPU tensors computes its twin; given CUDA tensors it
launches the hand-written kernel on the current stream or raises.  There is
no fallback from one to the other.  ``launches`` counts the kernel launches
of each wrapper, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from paddlebox_tpu_torch.ops import cuda_build

KERNELS = ("pull_rows", "scatter_add_rows", "gather_slots", "scatter_rows",
           "sorted_search", "hot_cold_select")
launches = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# each C entry point's arguments; every one ends with the stream
_ARGTYPES = {
    # (table, idx, rows in/out, count, width, table rows, stream)
    "pbt_pull_rows": (_P, _P, _P, _LL, _I, _LL, _P),
    "pbt_scatter_add_rows": (_P, _P, _P, _LL, _I, _LL, _P),
    "pbt_gather_slots": (_P, _P, _P, _LL, _I, _LL, _P),
    # (table, slots, rows, winner scratch, count, width, table rows, stream)
    "pbt_scatter_rows": (_P, _P, _P, _P, _LL, _I, _LL, _P),
    # (hay, hay length, n_real, queries, out, query count, stream)
    "pbt_sorted_search": (_P, _LL, _LL, _P, _P, _LL, _P),
    # (hot, occ, cold, out, count, width, hot rows, stream)
    "pbt_hot_cold_select": (_P, _P, _P, _P, _LL, _I, _LL, _P),
}

_fns: dict = {}


def _c_function(kernel: str, symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(cuda_build.load(kernel), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _launch(kernel: str, symbol: str, *args) -> None:
    rc = _c_function(kernel, symbol)(
        *args, torch.cuda.current_stream().cuda_stream
    )
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    launches[kernel] += 1


def _check_table(values: torch.Tensor, idx: torch.Tensor) -> None:
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError(
            f"values must be a 2-D float32 table, got {tuple(values.shape)} "
            f"{values.dtype}"
        )
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(
            f"idx must be a 1-D int32 vector, got {tuple(idx.shape)} {idx.dtype}"
        )
    if idx.device != values.device:
        raise ValueError(
            f"idx on {idx.device} but values on {values.device}"
        )
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {values.device}")
    if values.device.type == "cuda" and not (
        values.is_contiguous() and idx.is_contiguous()
    ):
        raise ValueError("the CUDA kernels take contiguous tensors only")


# --------------------------------------------------------------------------- #
# pull_rows
# --------------------------------------------------------------------------- #
def pull_rows_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Twin of the gather kernel: ``values[idx]`` as a new [K, W] tensor."""
    return values.index_select(0, idx)


def pull_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values: float32 [P, W]; idx: int32 [K] with entries in [0, P) (an
    entry outside traps the kernel; the CUDA error surfaces at the next
    synchronize).  Returns [K, W], bit-identical to
    ``values.index_select(0, idx)``."""
    _check_table(values, idx)
    if values.device.type == "cpu":
        return pull_rows_plain(values, idx)
    k, w = idx.shape[0], values.shape[1]
    out = torch.empty((k, w), dtype=values.dtype, device=values.device)
    if k and w:
        _launch("pull_rows", "pbt_pull_rows", values.data_ptr(),
                idx.data_ptr(), out.data_ptr(), k, w, values.shape[0])
    return out


# --------------------------------------------------------------------------- #
# scatter_add_rows
# --------------------------------------------------------------------------- #
def scatter_add_rows_plain(values: torch.Tensor, idx: torch.Tensor,
                           delta: torch.Tensor) -> torch.Tensor:
    """Twin of the scatter-add kernel: ``values.index_add_(0, idx, delta)``
    in place; returns ``values``."""
    return values.index_add_(0, idx, delta)


def scatter_add_rows(values: torch.Tensor, idx: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """In-place ``values[idx] += delta`` with duplicate indices accumulating;
    returns ``values``.  values: float32 [P, W]; idx: int32 [U] in [0, P);
    delta: float32 [U, W].  On the card, unique targets (and zero deltas on
    repeated targets) give a result bit-identical to the twin; real
    duplicates accumulate in run-to-run varying order
    (csrc/scatter_add_rows.cu states the bound)."""
    _check_table(values, idx)
    u, w = idx.shape[0], values.shape[1]
    if delta.shape != (u, w) or delta.dtype != values.dtype:
        raise ValueError(
            f"delta must be float32 [{u}, {w}], got {tuple(delta.shape)} "
            f"{delta.dtype}"
        )
    if delta.device != values.device:
        raise ValueError(f"delta on {delta.device} but values on {values.device}")
    if values.device.type == "cpu":
        return scatter_add_rows_plain(values, idx, delta)
    if not delta.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors only")
    if u and w:
        _launch("scatter_add_rows", "pbt_scatter_add_rows", values.data_ptr(),
                idx.data_ptr(), delta.data_ptr(), u, w, values.shape[0])
    return values


# --------------------------------------------------------------------------- #
# gather_slots
# --------------------------------------------------------------------------- #
def gather_slots_plain(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Twin of the cache-slot gather: ``table[max(slot, 0)]`` with the rows
    of negative slots zeroed, as a new [K, W] tensor."""
    miss = slots < 0
    out = table.index_select(0, slots.clamp(min=0))
    return out.masked_fill_(miss[:, None], 0.0)


def gather_slots(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """table: float32 [C, W]; slots: int32 [K], negative = miss, entries
    below C (one at or past C traps the kernel).  Returns [K, W]: the slot's
    row, the zero row where the slot is negative; bit-identical to the
    twin."""
    _check_table(table, slots)
    if table.device.type == "cpu":
        return gather_slots_plain(table, slots)
    k, w = slots.shape[0], table.shape[1]
    out = torch.empty((k, w), dtype=table.dtype, device=table.device)
    if k and w:
        _launch("gather_slots", "pbt_gather_slots", table.data_ptr(),
                slots.data_ptr(), out.data_ptr(), k, w, table.shape[0])
    return out


# --------------------------------------------------------------------------- #
# scatter_rows
# --------------------------------------------------------------------------- #
def scatter_rows_plain(table: torch.Tensor, slots: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Twin of the row replace, by the kernel's own rule: each slot's
    winner is its highest occurrence index, and only winners store (the
    targets are then unique, so the store order cannot matter).  In place;
    returns ``table``."""
    valid = slots >= 0
    occ = torch.arange(slots.shape[0], device=slots.device)
    target = slots.to(torch.int64)
    winner = torch.full((table.shape[0],), -1, dtype=torch.int64,
                        device=slots.device)
    winner.scatter_reduce_(0, target[valid], occ[valid], "amax")
    win = valid & (winner[target.clamp(min=0)] == occ)
    table[target[win]] = rows[win]
    return table


def scatter_rows(table: torch.Tensor, slots: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """In-place ``table[slots] = rows``: negative slots store nothing, and a
    slot named more than once takes the row of its last occurrence,
    decided explicitly (csrc/scatter_rows.cu), never by racing stores.
    table: float32 [C, W]; slots: int32 [K] below C; rows: float32 [K, W].
    Returns ``table``; bit-identical to the twin."""
    _check_table(table, slots)
    k, w = slots.shape[0], table.shape[1]
    if rows.shape != (k, w) or rows.dtype != table.dtype:
        raise ValueError(
            f"rows must be float32 [{k}, {w}], got {tuple(rows.shape)} "
            f"{rows.dtype}"
        )
    if rows.device != table.device:
        raise ValueError(f"rows on {rows.device} but table on {table.device}")
    if table.device.type == "cpu":
        return scatter_rows_plain(table, slots, rows)
    if not rows.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors only")
    if k and w:
        winner = torch.empty(table.shape[0], dtype=torch.int32,
                             device=table.device)
        _launch("scatter_rows", "pbt_scatter_rows", table.data_ptr(),
                slots.data_ptr(), rows.data_ptr(), winner.data_ptr(), k, w,
                table.shape[0])
    return table


# --------------------------------------------------------------------------- #
# sorted_search
# --------------------------------------------------------------------------- #
_SIGN = torch.iinfo(torch.int64).min  # the bit 1 << 63 as an int64


def sorted_search_plain(hay: torch.Tensor, n_real: int,
                        q: torch.Tensor) -> torch.Tensor:
    """Twin of the sorted search.  ``torch.searchsorted`` compares int64
    signed, which misorders keys at or above 2^63; flipping the top bit of
    both sides maps the unsigned order onto the signed one."""
    c = hay.shape[0]
    if q.shape[0] == 0 or c == 0:
        return torch.full((q.shape[0],), -1, dtype=torch.int32,
                          device=q.device)
    pos = torch.searchsorted(hay ^ _SIGN, q ^ _SIGN)
    found = (pos < n_real) & (hay[pos.clamp(max=c - 1)] == q)
    return torch.where(found, pos, -1).to(torch.int32)


def sorted_search(hay: torch.Tensor, n_real: int,
                  q: torch.Tensor) -> torch.Tensor:
    """hay: int64 [C] holding uint64 keys sorted unsigned, unique below
    ``n_real`` and padded to a power of two C with all-ones sentinels;
    q: int64 [Q] uint64 queries.  Returns int32 [Q]: each query's position
    in ``hay``, -1 when it is not among the first ``n_real`` keys."""
    for name, t in (("hay", hay), ("q", q)):
        if t.dim() != 1 or t.dtype != torch.int64:
            raise ValueError(
                f"{name} must be a 1-D int64 vector, got {tuple(t.shape)} "
                f"{t.dtype}"
            )
    if q.device != hay.device:
        raise ValueError(f"q on {q.device} but hay on {hay.device}")
    c = hay.shape[0]
    if c & (c - 1):
        raise ValueError(f"hay must be padded to a power of two, got {c}")
    if not 0 <= n_real <= c:
        raise ValueError(f"n_real {n_real} outside [0, {c}]")
    if hay.device.type == "cpu":
        return sorted_search_plain(hay, n_real, q)
    if hay.device.type != "cuda":
        raise ValueError(f"unsupported device {hay.device}")
    if not (hay.is_contiguous() and q.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous tensors only")
    nq = q.shape[0]
    if c == 0 or nq == 0:
        return torch.full((nq,), -1, dtype=torch.int32, device=q.device)
    out = torch.empty(nq, dtype=torch.int32, device=q.device)
    _launch("sorted_search", "pbt_sorted_search", hay.data_ptr(), c, n_real,
            q.data_ptr(), out.data_ptr(), nq)
    return out


# --------------------------------------------------------------------------- #
# hot_cold_select
# --------------------------------------------------------------------------- #
def hot_cold_select_plain(hot: torch.Tensor, hot_occ: torch.Tensor,
                          cold_rows: torch.Tensor) -> torch.Tensor:
    """Twin of the hot/cold select, the reference's own expression: append
    a zero sink row to the hot block, gather every occurrence's slot from
    it, keep the cold row where the slot is the sink."""
    h, w = hot.shape
    hot_ext = torch.cat([hot, hot.new_zeros((1, w))])
    return torch.where((hot_occ < h)[:, None],
                       hot_ext.index_select(0, hot_occ), cold_rows)


def hot_cold_select(hot: torch.Tensor, hot_occ: torch.Tensor,
                    cold_rows: torch.Tensor) -> torch.Tensor:
    """hot: float32 [H, W], the replicated hot block; hot_occ: int32 [K] in
    [0, H], H meaning "cold or padding" (an entry outside traps the
    kernel); cold_rows: float32 [K, W].  Returns a new [K, W]:
    ``hot[hot_occ[k]]`` where ``hot_occ[k] < H``, else ``cold_rows[k]``;
    bit-identical to the twin."""
    _check_table(hot, hot_occ)
    k, w = hot_occ.shape[0], hot.shape[1]
    if cold_rows.shape != (k, w) or cold_rows.dtype != hot.dtype:
        raise ValueError(
            f"cold_rows must be float32 [{k}, {w}], got "
            f"{tuple(cold_rows.shape)} {cold_rows.dtype}"
        )
    if cold_rows.device != hot.device:
        raise ValueError(
            f"cold_rows on {cold_rows.device} but hot on {hot.device}"
        )
    if hot.device.type == "cpu":
        return hot_cold_select_plain(hot, hot_occ, cold_rows)
    if not cold_rows.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors only")
    out = torch.empty((k, w), dtype=hot.dtype, device=hot.device)
    if k and w:
        _launch("hot_cold_select", "pbt_hot_cold_select", hot.data_ptr(),
                hot_occ.data_ptr(), cold_rows.data_ptr(), out.data_ptr(), k, w,
                hot.shape[0])
    return out
