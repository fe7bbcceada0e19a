"""Multi-chip training over n shard positions (reference:
paddlebox_tpu/parallel): the mesh, the key-sharded table with the realized
hybrid placement, and the trainer."""
from paddlebox_tpu_torch.parallel.mesh import Mesh, make_mesh
from paddlebox_tpu_torch.parallel.sharded_table import ShardedSparseTable
from paddlebox_tpu_torch.parallel.trainer import MultiChipTrainer

__all__ = ["Mesh", "make_mesh", "ShardedSparseTable", "MultiChipTrainer"]
