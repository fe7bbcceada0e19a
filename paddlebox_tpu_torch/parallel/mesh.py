"""Positions of the parallel axes (reference: paddlebox_tpu/parallel/mesh.py).

The reference's ``jax.sharding.Mesh`` names its axes: "data" carries data
parallelism and the key-sharded table, and a model axis ("seq", "expert",
"pipe") splits a model's dense compute.  Here every axis is n positions
in one process, with the stacked state ``[n, ...]`` on one explicit device,
as the reference's tests run n forced CPU devices of one host.  The
collectives (parallel/collectives.py) are then exact and move no bytes
between cards; NCCL across processes is a later slice.

Positions are not devices, so the reference's "need N devices" check has no
counterpart here: any count of positions fits on one device.

A composed mesh (``make_composed_mesh``) is data-major: the table, the feeds
and the plans see its ``n_data`` data positions, and the inner axis splits
the dense compute inside each.  A model built with ``"inherit"`` takes the
inner axis when the multi-chip trainer is built on the composed mesh
(``inherit_axis``, once), as the reference's model shard_map binds the
inner axis inside the trainer's ``axis_names={"data"}`` shard_map.
"""

from __future__ import annotations

import dataclasses

import torch

from paddlebox_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of positions whose stacked state lives on ``device``;
    ``n`` is the leading axis's size (the data axis of a data or composed
    mesh)."""

    n: int
    device: torch.device
    axis_names: tuple = (DATA_AXIS,)
    axis_sizes: tuple = ()

    def __post_init__(self):
        if not self.axis_sizes:
            object.__setattr__(self, "axis_sizes", (self.n,))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} with sizes "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> dict:
        """{axis name: positions}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(n: int, device="cuda", axis_name: str = DATA_AXIS) -> Mesh:
    """n positions of one axis on one device (``device="cpu"`` for the
    CPU); a model axis by name, e.g. ``make_mesh(4, axis_name="seq")``."""
    if n < 1:
        raise ValueError(f"need at least one shard position, got {n}")
    return Mesh(int(n), resolve_device(device), (axis_name,), (int(n),))


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
    return Mesh(int(n_data), resolve_device(device), (DATA_AXIS, inner_axis),
                (int(n_data), int(n_inner)))


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
