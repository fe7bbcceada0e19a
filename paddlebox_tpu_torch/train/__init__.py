from paddlebox_tpu_torch.train.auto_checkpoint import AutoCheckpointer
from paddlebox_tpu_torch.train.trainer import Trainer

__all__ = ["AutoCheckpointer", "Trainer"]
