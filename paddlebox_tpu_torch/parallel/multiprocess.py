"""Multi-process glue: this process's positions, and host-side gathers and
merges across the job's processes (reference:
paddlebox_tpu/parallel/multiprocess.py).

The reference's cluster layer is the JAX coordination service and global
arrays assembled from each process's local shards.  Here a job is the
``torch.distributed`` process group and its TCPStore
(parallel/mesh.py:initialize_distributed); each process holds its own
positions' state ``[n_local, ...]`` and these helpers convert between that
local view and the job-wide one.  A single process short-circuits every
helper to the local value.

Two transports, never mixed up: the host gathers (``host_allgather``,
``host_allgather_varlen``) ride one lockstep ``KvChannel`` on the store,
so any thread may issue them without racing the step thread's process-group
collectives; the tensor merges (``merge_device_axis``) are process-group
collectives and run on the step's thread only.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from paddlebox_tpu_torch.parallel import mesh as _mesh

# the process's host-gather channel, made on first use (every rank issues
# host gathers in the same order, so one lockstep channel serves them all)
_HOST_CHANNEL = None


def is_multiprocess() -> bool:
    """True inside a job of more than one process."""
    j = _mesh.job()
    return j is not None and j.world > 1


def local_device_indices(mesh) -> np.ndarray:
    """This process's data positions of ``mesh``, in mesh order (the
    reference's local device indices: positions stand for devices here).
    A composed mesh's data row spanning processes raises
    NotImplementedError when the mesh is built (parallel/mesh.py)."""
    return np.asarray(list(mesh.local_positions), dtype=np.int64)


def _host_channel():
    global _HOST_CHANNEL
    j = _mesh.job()
    if (_HOST_CHANNEL is None or _HOST_CHANNEL._world != j.world
            or _HOST_CHANNEL._rank != j.rank):
        from paddlebox_tpu_torch.parallel.host_plane import KvChannel

        _HOST_CHANNEL = KvChannel("host")
    return _HOST_CHANNEL


def host_allgather(x: np.ndarray) -> np.ndarray:
    """All-processes gather of a same-shaped host array -> [P, ...].  One
    process: adds the leading axis without a gather."""
    if not is_multiprocess():
        return np.asarray(x)[None]
    from paddlebox_tpu_torch.parallel import watchdog

    watchdog.beat("hostplane:host")
    return _host_channel().allgather(np.asarray(x))


def host_allgather_varlen(x: np.ndarray) -> np.ndarray:
    """Gather 1-D arrays of differing lengths from every process and
    concatenate them in rank order: two gathers, sizes then the padded
    payload."""
    if not is_multiprocess():
        return np.asarray(x)
    sizes = host_allgather(np.asarray([x.shape[0]], dtype=np.int64))[:, 0]
    cap = int(sizes.max(initial=0))
    pad = np.zeros(cap, dtype=x.dtype)
    pad[: x.shape[0]] = x
    stacked = host_allgather(pad)  # [P, cap]
    return np.concatenate([stacked[p, : sizes[p]] for p in range(len(sizes))])


def read_replicated(x: torch.Tensor) -> np.ndarray:
    """Host value of a stacked [L, ...] tensor that is identical on every
    position (a psummed scalar, a replicated hot block): position 0's."""
    return x[0].detach().cpu().numpy()


def merge_device_axis(tree: Any, group=None) -> Any:
    """Sum the stacked [L, ...] leaves of ``tree`` (a tensor, a tuple or a
    NamedTuple such as an AucState) over every position of the job, in
    ascending position order, and return host numpy (the cross-position
    metric merge; reference: collect_data_nccl).  ``group``: the job (its
    process group carries the positions of the other processes), None in
    one process.  A process-group collective: the step's thread only."""
    from paddlebox_tpu_torch.parallel import collectives

    def one(x: torch.Tensor) -> np.ndarray:
        return collectives.psum(x, group)[0].cpu().numpy()

    if isinstance(tree, torch.Tensor):
        return one(tree)
    merged = [one(x) for x in tree]
    return type(tree)(*merged) if hasattr(tree, "_fields") else type(tree)(
        merged)
