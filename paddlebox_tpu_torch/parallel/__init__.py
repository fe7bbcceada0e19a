"""The parallel axes (reference: paddlebox_tpu/parallel): the mesh and the
multi-process job, the key-sharded table with the realized hybrid
placement, the multi-chip trainer, the sequence-parallel attention and the
pipeline trainer; the host plane (KvChannel on the job's TCPStore) and the
liveness watchdog of a multi-process job."""

import importlib

from paddlebox_tpu_torch.parallel.mesh import (
    Mesh,
    data_axis_size,
    initialize_distributed,
    make_composed_mesh,
    make_mesh,
    shutdown_distributed,
)
from paddlebox_tpu_torch.parallel.pipeline import PipelineTrainer
from paddlebox_tpu_torch.parallel.sequence import (
    full_attention,
    ring_attention,
    ulysses_attention,
)

# the table and the trainer import the single-chip trainer, which imports
# the models, which import this package's axes: they load on first use
_LAZY = {
    "ShardedSparseTable": "sharded_table",
    "ShardedBatchPlan": "sharded_table",
    "MultiChipTrainer": "trainer",
    "AsyncDenseTable": "async_dense",
    "KvChannel": "host_plane",
    "Watchdog": "watchdog",
    "DistributedStallError": "watchdog",
}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "full_attention",
    "ring_attention",
    "ulysses_attention",
    "Mesh",
    "make_mesh",
    "make_composed_mesh",
    "data_axis_size",
    "initialize_distributed",
    "shutdown_distributed",
    "KvChannel",
    "Watchdog",
    "DistributedStallError",
    "ShardedSparseTable",
    "ShardedBatchPlan",
    "MultiChipTrainer",
    "AsyncDenseTable",
    "PipelineTrainer",
]
