"""The ranking model family (reference: paddlebox_tpu/models/__init__.py).
The retrieval (TwoTower) and sequence models (LongSeqCtrDnn,
PipelinedCtrDnn) are a later slice."""

from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.models.dcn import DCN
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.layers import bce_with_logits, linear, make_mlp, mlp
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.models.rank_ctr import RankCtrDnn
from paddlebox_tpu_torch.models.wide_deep import WideDeep
from paddlebox_tpu_torch.models.xdeepfm import XDeepFM

__all__ = [
    "CtrDnn",
    "DCN",
    "DeepFM",
    "MMoE",
    "RankCtrDnn",
    "WideDeep",
    "XDeepFM",
    "bce_with_logits",
    "linear",
    "make_mlp",
    "mlp",
]
