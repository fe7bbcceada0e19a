"""Scenario trainers over the shared sparse table (reference:
paddlebox_tpu/scenarios/): the retrieval trainer.  The multi-scenario
trainer (``scenarios/multi.py``) is a later slice (ROADMAP.md, item 6)."""

from paddlebox_tpu_torch.scenarios.retrieval import RetrievalTrainer

__all__ = ["RetrievalTrainer"]
