"""Compile-event witness: per-stage ``jit.compiles`` telemetry (reference:
paddlebox_tpu/telemetry/compiles.py).

The promise both trainers are built on: after warmup a steady-state step
is a cached dispatch, with no compile hidden inside it.  The reference
counts XLA backend compiles through ``jax.monitoring``.  The port has no
XLA compile; its compile events are the two things that cost compile time
in a running process, counted under the reference's stage labels so that
one name means one thing in both packages:

  * a kernel build or load: the first load in a process of a
    ``csrc/<name>.cu`` library (ops/cuda_build.py, an nvcc build when the
    library is not on disk), under ``pallas.<kernel>``, the stage of the
    reference's Pallas kernel it ports (:data:`KERNEL_STAGES`);
  * a CUDA graph capture of the single-chip step group
    (train/trainer.py ``_StepGraph``), under ``train.scan``, the stage of
    the reference's scan program.

Two metrics: ``jit.compiles`` (counter, label ``stage``), whose per-stage
count stops moving in steady state, and ``jit.compile_seconds``
(histogram, label ``stage``).  An event outside any stage and without one
of its own lands under ``untagged``.
"""

from __future__ import annotations

import threading
from typing import Optional

from paddlebox_tpu_torch.telemetry import metrics

#: stage attributed to compile events outside any scope
UNTAGGED = "untagged"

#: csrc kernel name -> the reference's stage label of the Pallas kernel it
#: ports (paddlebox_tpu/ops/pallas_sparse.py's counted_jit stages)
KERNEL_STAGES = {
    "pull_rows": "pallas.pull_rows",
    "scatter_add_rows": "pallas.scatter_add",
    "gather_slots": "pallas.gather_slots",
    "scatter_rows": "pallas.scatter_rows",
    "hot_cold_select": "pallas.hot_cold_select",
    "sorted_search": "pallas.sorted_search",
}

_COMPILES = metrics.counter(
    "jit.compiles",
    "kernel builds and CUDA graph captures by stage (zero per stage in "
    "steady state)",
)
_COMPILE_SECONDS = metrics.histogram(
    "jit.compile_seconds", "kernel build and graph capture wall time by stage",
)

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_stage() -> str:
    st = _stack()
    return st[-1] if st else UNTAGGED


class stage_scope:
    """Attribute compile events on this thread to ``stage`` while the
    scope is active.  Reentrant; the innermost scope wins."""

    def __init__(self, stage: str):
        self.stage = stage

    def __enter__(self):
        _stack().append(self.stage)
        return self

    def __exit__(self, *exc):
        st = _stack()
        if st:
            st.pop()
        return False


def record_compile(seconds: float, stage: Optional[str] = None) -> None:
    """Count one compile event of ``seconds`` under ``stage`` (None = the
    innermost active scope)."""
    stage = stage or current_stage()
    _COMPILES.inc(stage=stage)
    _COMPILE_SECONDS.observe(seconds, stage=stage)


def compiles_by_stage() -> dict:
    """{stage: compile count} since the registry's last reset."""
    out: dict = {}
    for key, cell in _COMPILES.series().items():
        stage = dict(key).get("stage", UNTAGGED)
        out[stage] = out.get(stage, 0) + int(cell[0])
    return out


def total_compiles() -> int:
    return sum(compiles_by_stage().values())
