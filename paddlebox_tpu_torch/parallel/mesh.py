"""Positions of the parallel axes and the multi-process job (reference:
paddlebox_tpu/parallel/mesh.py).

The reference's ``jax.sharding.Mesh`` names its axes: "data" carries data
parallelism and the key-sharded table, and a model axis ("seq", "expert",
"pipe") splits a model's dense compute.  Here every axis is n positions
with the stacked state ``[n, ...]`` on one explicit device, as the
reference's tests run n forced CPU devices of one host; the collectives
(parallel/collectives.py) are then tensor operations.

Positions are not devices, so the reference's "need N devices" check has no
counterpart here: any count of positions fits on one device.

A multi-process job (``initialize_distributed``, which the launcher's
environment drives) splits the data axis over its processes: process p
holds the contiguous positions ``[p * L, (p + 1) * L)`` (L =
``n // n_proc``), their state stacked ``[L, ...]`` on its own device, and
the four collectives of the data axis cross processes through the job's
``torch.distributed`` process group.  A mesh built inside a job knows that
layout (``n_proc``, ``proc_index``, ``n_local``, ``local_positions``).
Model axes never cross processes: their positions stay in-process.

A composed mesh (``make_composed_mesh``) is data-major: the table, the feeds
and the plans see its ``n_data`` data positions, and the inner axis splits
the dense compute inside each.  A model built with ``"inherit"`` takes the
inner axis when the multi-chip trainer is built on the composed mesh
(``inherit_axis``, once), as the reference's model shard_map binds the
inner axis inside the trainer's ``axis_names={"data"}`` shard_map.  Inside
a job a data position is local only when its whole inner group is; a data
row spanning processes raises NotImplementedError, as the reference's
``local_device_indices`` does.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
from typing import Optional

import torch

from paddlebox_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Job:
    """The process's multi-process job: its rank and world, the TCPStore
    (the planning plane's KV, parallel/host_plane.py), the process group's
    backend, this rank's device and the data positions each process holds
    (a data mesh that gives a process more raises; 0 = any).
    ``host_staged``: gloo carries card tensors
    through pinned host copies (parallel/collectives.py)."""

    rank: int
    world: int
    store: object
    backend: str
    device: torch.device
    positions_per_proc: int = 0

    @property
    def host_staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"


_JOB: Optional[Job] = None


def job() -> Optional[Job]:
    """The active job, or None outside one (a single-process run)."""
    return _JOB


def _split_address(addr: str) -> tuple:
    host, _, port = addr.rpartition(":")
    if not host or not port:
        raise ValueError(f"coordinator address must be host:port, got "
                         f"{addr!r}")
    return host, int(port)


def _check_distinct_cards(store, rank: int, world: int,
                          device: torch.device) -> None:
    """NCCL refuses two ranks on one card: every rank posts its card's
    identity on the store and a shared card raises, naming the way out."""
    props = torch.cuda.get_device_properties(device)
    ident = f"{socket.gethostname()}:{getattr(props, 'uuid', device.index)}"
    store.set(f"pbox_dev/{rank}", ident)
    seen = {}
    for r in range(world):
        other = store.get(f"pbox_dev/{r}").decode()
        if other in seen:
            raise ValueError(
                f"ranks {seen[other]} and {r} share the card {other}: NCCL "
                "refuses two ranks on one card, so a job whose ranks share "
                "a card must pass backend='gloo' (launch.py --backend gloo)")
        seen[other] = r


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: Optional[float] = None,
) -> Optional[Job]:
    """Join the multi-process job (reference: ``initialize_distributed``,
    the JAX coordination service): make the TCPStore and initialize the
    default ``torch.distributed`` process group on it.  Arguments default
    to the PADDLEBOX_TORCH_COORDINATOR_ADDRESS, _NUM_PROCESSES,
    _PROCESS_ID and _BACKEND flags the launcher sets; with neither an
    address nor a process count this is a single-process run and returns
    None.  Idempotent.  device: the rank's device (default the
    PADDLEBOX_TORCH_DEVICE flag, else "cuda"; on the card the
    PADDLEBOX_TORCH_LOCAL_DEVICE card).

    backend: "nccl" when each rank owns its own card, "gloo" for CPU
    ranks and for ranks that share one card (NCCL refuses that, and asking
    for it there is an error that says so); "" or None picks gloo on the
    CPU and nccl on the card.  Nothing switches backend silently.
    timeout_s: the store's and the process group's timeout (default
    ``TrainerConfig.host_plane_timeout_s``'s)."""
    global _JOB
    if _JOB is not None:
        return _JOB
    import torch.distributed as dist

    from paddlebox_tpu_torch.config import TrainerConfig, flags

    if coordinator_address is None:
        coordinator_address = flags.coordinator_address or None
    if num_processes is None and flags.num_processes > 0:
        num_processes = flags.num_processes
    if process_id is None:
        process_id = flags.process_id
    if coordinator_address is None and num_processes is None:
        return None
    if coordinator_address is None or num_processes is None:
        raise ValueError("a multi-process job needs both the coordinator "
                         "address and the process count")
    world, rank = int(num_processes), int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    if device is None:
        device = flags.device or "cuda"
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = (flags.local_device if flags.local_device >= 0
                     else torch.cuda.current_device())
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = backend or flags.backend or (
        "nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl|gloo, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs card tensors: run on "
                         "device 'cuda' or pass backend='gloo'")
    if timeout_s is None:
        timeout_s = TrainerConfig().host_plane_timeout_s
    timeout = datetime.timedelta(seconds=float(timeout_s))
    host, port = _split_address(coordinator_address)
    # the launcher may serve the store itself (it bound port 0 and handed
    # the real port on, so no rank races another process for it); else
    # rank 0 serves it
    serve = rank == 0 and not flags.store_hosted
    store = dist.TCPStore(host, port, world, serve, timeout=timeout,
                          wait_for_workers=False)
    if backend == "nccl" and world > 1:
        _check_distinct_cards(store, rank, world, dev)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world, timeout=timeout,
        **({"device_id": dev} if backend == "nccl" else {}))
    _JOB = Job(rank, world, store, backend, dev,
               int(flags.positions_per_proc))
    logger.info("joined job: rank %d of %d, backend %s, device %s", rank,
                world, backend, dev)
    return _JOB


def shutdown_distributed() -> None:
    """Leave the job: destroy the process group and forget the store."""
    global _JOB
    if _JOB is None:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _JOB = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of positions whose stacked state lives on ``device``;
    ``n`` is the leading axis's size (the data axis of a data or composed
    mesh).  Inside a job (``distributed``) the data axis spans ``n_proc``
    processes and this one, ``proc_index``, holds ``local_positions``."""

    n: int
    device: torch.device
    axis_names: tuple = (DATA_AXIS,)
    axis_sizes: tuple = ()
    distributed: bool = False
    n_proc: int = 1
    proc_index: int = 0

    def __post_init__(self):
        if not self.axis_sizes:
            object.__setattr__(self, "axis_sizes", (self.n,))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} with sizes "
                             f"{self.axis_sizes}")
        if self.n % self.n_proc:
            raise ValueError(f"{self.n} positions do not split over "
                             f"{self.n_proc} processes")

    @property
    def n_local(self) -> int:
        """Data positions this process holds."""
        return self.n // self.n_proc

    @property
    def local_positions(self) -> range:
        """This process's data positions (contiguous, in mesh order)."""
        return range(self.proc_index * self.n_local,
                     (self.proc_index + 1) * self.n_local)

    @property
    def shape(self) -> dict:
        """{axis name: positions}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def _job_layout(device, positions: int, n_inner: int = 1) -> tuple:
    """(device, distributed, n_proc, proc_index) of a new mesh: inside a
    job the job's device and its process layout, checked for a data row
    spanning processes."""
    j = job()
    dev = resolve_device(device)
    if j is None:
        return dev, False, 1, 0
    if dev.type != j.device.type:
        raise ValueError(f"mesh on {dev}, the job's rank on {j.device}")
    total = positions * n_inner
    if total % j.world:
        raise ValueError(f"{total} positions do not split over {j.world} "
                         "processes")
    # fewer positions than the job gives a process is a mesh over a subset
    # (a live reshard's smaller mesh), as a reference mesh may take a
    # subset of its process's devices; more is refused
    if j.positions_per_proc and positions // j.world > j.positions_per_proc:
        raise ValueError(
            f"{positions} data positions give each of {j.world} processes "
            f"{positions // j.world}, the job asked for at most "
            f"{j.positions_per_proc} (PADDLEBOX_TORCH_POSITIONS_PER_PROC)")
    per = total // j.world
    for row in range(positions):
        owners = {f // per for f in range(row * n_inner,
                                           (row + 1) * n_inner)}
        if len(owners) > 1:
            raise NotImplementedError(
                "composed meshes need each data position's inner group on "
                f"ONE process; data row {row} spans processes "
                f"{sorted(owners)}")
    return j.device, True, j.world, j.rank


def make_mesh(n: Optional[int] = None, device="cuda",
              axis_name: str = DATA_AXIS) -> Mesh:
    """n positions of one axis on one device (``device="cpu"`` for the
    CPU); a model axis by name, e.g. ``make_mesh(4, axis_name="seq")``.
    Inside a job a data axis of n positions spans the job's processes on
    each rank's device; a model axis stays in-process.

    With no n, the reference's "every device of the job": one position
    alone; in a job, ``positions_per_proc`` (``--positions-per-proc``,
    else 1) a process, over every process for the data axis and this
    process's own for a model axis."""
    if n is None:
        j = job()
        n = 1 if j is None else max(1, j.positions_per_proc)
        if j is not None and axis_name == DATA_AXIS:
            n *= j.world
    if n < 1:
        raise ValueError(f"need at least one shard position, got {n}")
    if axis_name != DATA_AXIS:
        dev = resolve_device(device)
        j = job()
        if j is not None and dev.type == j.device.type:
            dev = j.device
        return Mesh(int(n), dev, (axis_name,), (int(n),))
    dev, dist_, n_proc, pid = _job_layout(device, int(n))
    return Mesh(int(n), dev, (axis_name,), (int(n),), dist_, n_proc, pid)


def make_composed_mesh(n_data: int, n_inner: int, inner_axis: str,
                       device="cuda") -> Mesh:
    """The data x inner mesh of composed parallelism: the sparse table and
    the batch shard over ``data`` as on a one-axis mesh, while the model
    axis ``inner_axis`` ("expert" or "seq") splits the dense compute inside
    each data position."""
    if n_data < 2:
        raise ValueError(
            "make_composed_mesh needs a data axis of >= 2 (a 1-sized manual "
            "data axis trips an XLA partial-manual partitioner RET_CHECK "
            "when nested with an auto inner axis); for one data shard use "
            "the single-chip Trainer with an explicit model mesh "
            "(MMoE(expert_mesh=make_mesh(...)) / LongSeqCtrDnn(seq_mesh=...))"
        )
    if n_inner < 1:
        raise ValueError(f"need at least one {inner_axis!r} position, got "
                         f"{n_inner}")
    dev, dist_, n_proc, pid = _job_layout(device, int(n_data), int(n_inner))
    return Mesh(int(n_data), dev, (DATA_AXIS, inner_axis),
                (int(n_data), int(n_inner)), dist_, n_proc, pid)


def data_axis_size(mesh: Mesh) -> int:
    """Size of the data axis (every position of a one-axis data mesh)."""
    if DATA_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh needs a {DATA_AXIS!r} axis, has "
                         f"{mesh.axis_names}")
    return mesh.shape[DATA_AXIS]


def _unbound(axis: str) -> ValueError:
    return ValueError(
        f"a model built with {axis!r} mesh \"inherit\" runs only inside a "
        f"composed mesh's {axis!r} axis: train it with MultiChipTrainer on "
        f"make_composed_mesh(n_data, n_inner, {axis!r})")


def axis_positions(mesh, axis: str) -> int:
    """Positions of ``axis`` for a model's mesh argument.  A model built
    with ``"inherit"`` that no composed mesh has bound raises."""
    if mesh == "inherit":
        raise _unbound(axis)
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh needs a {axis!r} axis, has {mesh.axis_names}")
    return mesh.shape[axis]


def inner_mesh(composed: Mesh, axis: str) -> Mesh:
    """The ``axis`` of a composed mesh as a one-axis mesh: what a model
    built with ``"inherit"`` binds to when the multi-chip trainer is built
    on ``composed``."""
    if axis not in composed.axis_names:
        raise _unbound(axis)
    return make_mesh(composed.shape[axis], composed.device, axis_name=axis)
