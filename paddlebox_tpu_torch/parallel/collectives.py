"""The collectives of the parallel axes over stacked ``[n, ...]`` tensors,
one leading entry per position (reference: the ``jax.lax`` collectives in
paddlebox_tpu/parallel/): the four of the multi-chip step's data axis
(trainer.py), then the ring shift of the sequence and pipeline axes and the
tiled all_to_all and all_gather of Ulysses attention (sequence.py,
pipeline.py).

In one process every position lives in the process (parallel/mesh.py), so
each collective is a tensor operation on the stacked values; every sum runs
in a fixed order, so results do not depend on scheduling.

Across the processes of a job (``group``: the job of parallel/mesh.py,
passed by the multi-chip trainer for a mesh built inside one) the four
data-axis collectives take each process's stacked ``[n_local, ...]`` slice
and ride the job's ``torch.distributed`` process group: ``all_to_all`` is
one ``all_to_all_single`` of the blocks regrouped by destination process,
``all_gather`` one ``all_gather``, and ``psum`` / ``pmax`` an all_gather
followed by the SAME ascending-position fold as in one process, never
``all_reduce``: the summation order does not depend on the world, so a
2-process run is bit-equal to the 1-process run.  With ``group=None`` every
function is exactly the in-process tensor operation.  Inner axes never
cross processes (as in the reference), so ``ppermute`` and the tiled
collectives stay in-process.

Transport: NCCL moves card tensors directly; gloo (CPU ranks, or ranks
sharing one card, which NCCL refuses) carries a card tensor through an
explicit pinned host copy each way, counted in ``stats()`` beside the
bytes each kind sends, its calls and its host seconds.  Under an active
liveness watchdog a gloo collective is issued asynchronously and its wait
polls, checking the watchdog and beating ``collective:<kind>`` between
polls: a rank waiting on a stalled peer stays alive, is never misnamed as
the culprit, and unwinds with the job's DistributedStallError (an NCCL
wait is stream-ordered and left to the hard-exit reaper).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

# per collective kind: calls, bytes this process sent through the process
# group, bytes staged through host memory (gloo with card tensors) and the
# host seconds of the calls
_STATS: dict = {}


def stats() -> dict:
    """{kind: {"calls", "bytes", "host_bytes", "seconds"}} of the
    process-group collectives since the last ``reset_stats``."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()


_label = threading.local()


@contextlib.contextmanager
def counted_as(kind: str):
    """Count this thread's process-group collectives under ``kind`` (the
    trainer's pass-end merges count as "merge", apart from the step's)."""
    prev = getattr(_label, "kind", None)
    _label.kind = kind
    try:
        yield
    finally:
        _label.kind = prev


def _count(kind: str, nbytes: int, host_bytes: int, seconds: float) -> None:
    kind = getattr(_label, "kind", None) or kind
    st = _STATS.setdefault(kind, {"calls": 0, "bytes": 0, "host_bytes": 0,
                                  "seconds": 0.0})
    st["calls"] += 1
    st["bytes"] += int(nbytes)
    st["host_bytes"] += int(host_bytes)
    st["seconds"] += seconds


def _to_wire(group, x: torch.Tensor) -> tuple:
    """(tensor the process group sends, host bytes staged): under gloo a
    card tensor crosses through a pinned host copy."""
    x = x.contiguous()
    if group.host_staged and x.is_cuda:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h, h.numel() * h.element_size()
    return x, 0


def _from_wire(group, t: torch.Tensor, like: torch.Tensor) -> tuple:
    if t.device != like.device:
        return t.to(like.device), t.numel() * t.element_size()
    return t, 0


def _empty_wire(group, shape, like: torch.Tensor) -> torch.Tensor:
    if group.host_staged and like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _wait(group, work, kind: str) -> None:
    """Wait for an async process-group op: blocking, or under a watchdog
    on gloo a poll that checks it and beats between polls."""
    from paddlebox_tpu_torch.parallel import watchdog as _wd

    wd = _wd.current()
    if wd is None or group.backend != "gloo":
        work.wait()
        return
    sleep = 0.0001
    try:
        while not work.is_completed():
            wd.check()  # a pending abort interrupts the wait
            wd.report(f"collective:{kind}")
            time.sleep(sleep)
            sleep = min(sleep * 2, 0.005)
        work.wait()  # surfaces a failed op
    except RuntimeError:
        # a peer that aborted on a stall leaves at once, failing its half
        # of the collective: its poison key names the culprit, so the
        # failure surfaces as the job's DistributedStallError (a crash
        # without a poison key stays the error it is)
        wd.check_poison()
        raise


def gather_positions(group, x: torch.Tensor) -> torch.Tensor:
    """This process's [L, ...] -> every position's [P * L, ...], stacked
    in rank order (one process-group all_gather)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    wire, staged = _to_wire(group, x)
    parts = [_empty_wire(group, wire.shape, x) for _ in range(group.world)]
    _wait(group, dist.all_gather(parts, wire, async_op=True), "all_gather")
    out, back = _from_wire(group, torch.cat(parts), x)
    _count("all_gather", wire.numel() * wire.element_size(), staged + back,
           time.perf_counter() - t0)
    return out


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0)``: position s sends
    its block d to position d, which stacks what it receives in source
    order.  x: [n, n, ...] with ``x[s, d]`` the block s sends to d; returns
    ``got`` with ``got[d, s] = x[s, d]``.  In a job x is this process's
    [L, n, ...] (its L positions as sources) and the result [L, n, ...]
    (its L positions as destinations)."""
    if group is None:
        if x.dim() < 2 or x.shape[0] != x.shape[1]:
            raise ValueError(
                f"all_to_all needs [n, n, ...], got {tuple(x.shape)}")
        return x.transpose(0, 1).contiguous()
    import torch.distributed as dist

    P = group.world
    L, n = x.shape[0], x.shape[1]
    if n != P * L:
        raise ValueError(f"all_to_all over {P} processes of {L} positions "
                         f"needs [{L}, {P * L}, ...], got {tuple(x.shape)}")
    t0 = time.perf_counter()
    rest = tuple(x.shape[2:])
    # [L_src, P, L_dst, ...] -> [P, L_src, L_dst, ...]: one block a process
    send = x.reshape(L, P, L, *rest).transpose(0, 1).contiguous()
    wire, staged = _to_wire(group, send)
    recv = _empty_wire(group, wire.shape, x)
    _wait(group, dist.all_to_all_single(recv, wire, async_op=True),
          "all_to_all")
    recv, back = _from_wire(group, recv, x)
    # recv[p, s, d] = process p's source s to our destination d ->
    # got[d, p * L + s]
    got = recv.permute(2, 0, 1, *range(3, 3 + len(rest))).reshape(
        L, P * L, *rest).contiguous()
    _count("all_to_all", wire.numel() * wire.element_size(), staged + back,
           time.perf_counter() - t0)
    return got


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather``: every position receives every position's block.
    x: [n, ...] -> [n, n, ...] (a view: all positions share one copy).  In
    a job x is [L, ...] and the result [L, n, ...]."""
    if group is None:
        return x.unsqueeze(0).expand(x.shape[0], *x.shape)
    full = gather_positions(group, x)
    return full.unsqueeze(0).expand(x.shape[0], *full.shape)


def _fold_rows(x: torch.Tensor, op) -> torch.Tensor:
    acc = x[0]
    for i in range(1, x.shape[0]):  # unrolled: fixed ascending order
        acc = op(acc, x[i])
    return acc


def _fold(x: torch.Tensor, op, group=None) -> torch.Tensor:
    full = x if group is None else gather_positions(group, x)
    return _fold_rows(full, op).unsqueeze(0).expand_as(x)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum`` as an unrolled fold in ascending position order,
    ``((x[0] + x[1]) + x[2]) + ...``; every position holds the sum.
    x: [n, ...] -> [n, ...] (a view of one copy).  In a job x is [L, ...]:
    the n positions of all processes are gathered and folded in the same
    ascending order."""
    return _fold(x, torch.add, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over positions."""
    return _fold(x, torch.maximum, group)


def psum_many(xs, group=None) -> list:
    """``psum`` of several [L, ...] tensors of one dtype, in one gather in
    a job (flattened side by side; the fold is elementwise, so each result
    equals its own ``psum`` bit for bit).  Returns each sum [...] once."""
    xs = list(xs)
    if group is None or not xs or any(x.dtype != xs[0].dtype for x in xs):
        return [psum(x, group)[0] for x in xs]
    L = xs[0].shape[0]
    flat = torch.cat([x.reshape(L, -1) for x in xs], dim=1)
    summed = _fold_rows(gather_positions(group, flat), torch.add)
    out, off = [], 0
    for x in xs:
        k = x[0].numel()
        out.append(summed[off:off + k].view(x.shape[1:]))
        off += k
    return out


def ppermute(x: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute(x, axis_name, perm)``: for each pair ``(s, d)`` of
    ``perm`` position d receives x[s]; a position that no pair targets
    receives zeros.  x: [n, ...] -> [n, ...].  The GPipe chain
    ``[(i, i + 1)]`` (parallel/pipeline.py) relies on the zeros, the ring
    ``[(i, (i + 1) % n)]`` (parallel/sequence.py) on the wrap."""
    n = x.shape[0]
    src = {}
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"ppermute pair {(s, d)} out of range for {n} "
                             "positions")
        if d in src:
            raise ValueError(f"ppermute targets position {d} twice")
        src[d] = s
    zero = x.new_zeros(x.shape[1:])
    return torch.stack([x[src[d]] if d in src else zero for d in range(n)])


def all_to_all_tiled(x: torch.Tensor, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis_name, split_axis, concat_axis, tiled=True)``:
    position s splits its block along ``split_axis`` into n chunks and sends
    chunk d to position d, which concatenates what it receives along
    ``concat_axis`` in source order.  x: [n, ...] with both axes counted in
    a position's block (0 is the block's first axis)."""
    n = x.shape[0]
    if x.shape[1 + split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[1 + split_axis]} does not split over {n} "
                         "positions")
    chunks = x.chunk(n, dim=1 + split_axis)  # chunks[d][s]: s's chunk for d
    return torch.stack([torch.cat(list(chunks[d].unbind(0)), dim=concat_axis)
                        for d in range(n)])


def all_gather_tiled(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=axis, tiled=True)``: every
    position receives the positions' blocks concatenated along ``axis`` (of
    a block) in position order.  x: [n, ...] -> [n, ...] (a view: all
    positions share one copy)."""
    full = torch.cat(list(x.unbind(0)), dim=axis)
    return full.unsqueeze(0).expand(x.shape[0], *full.shape)
