"""Scenario trainers over the shared sparse table (reference:
paddlebox_tpu/scenarios/): the retrieval trainer, and the multi-scenario
trainer that interleaves N heterogeneous towers over ONE table."""

from paddlebox_tpu_torch.scenarios.multi import (
    MultiScenarioTrainer,
    ScenarioSpec,
)
from paddlebox_tpu_torch.scenarios.retrieval import RetrievalTrainer

__all__ = [
    "MultiScenarioTrainer",
    "RetrievalTrainer",
    "ScenarioSpec",
]
