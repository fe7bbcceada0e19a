"""The serving plane (reference: paddlebox_tpu/inference/): export a
trained model and its table as a self-contained artifact (export.py),
score it on the card with the Predictor (predictor.py), the ANN index of
the retrieval scenario (ann.py), admission control (admission.py) and the
HTTP ScoringServer (server.py)."""

from paddlebox_tpu_torch.inference.ann import AnnIndex, export_ann_index
from paddlebox_tpu_torch.inference.export import (
    export_model,
    export_serving_programs,
)
from paddlebox_tpu_torch.inference.predictor import (
    EmbeddingDtypeMismatch,
    Predictor,
)
from paddlebox_tpu_torch.inference.server import ScoringServer

__all__ = [
    "AnnIndex",
    "EmbeddingDtypeMismatch",
    "export_ann_index",
    "export_model",
    "export_serving_programs",
    "Predictor",
    "ScoringServer",
]
