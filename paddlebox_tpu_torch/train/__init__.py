from paddlebox_tpu_torch.train.auto_checkpoint import AutoCheckpointer
from paddlebox_tpu_torch.train.trainer import Trainer
from paddlebox_tpu_torch.train.two_phase import PhaseSpec, TwoPhaseTrainer

__all__ = ["AutoCheckpointer", "PhaseSpec", "Trainer", "TwoPhaseTrainer"]
