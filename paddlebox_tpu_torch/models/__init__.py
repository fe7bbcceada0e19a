"""The model family (reference: paddlebox_tpu/models/__init__.py): the
ranking zoo, the retrieval model (TwoTower) and the models on a parallel
axis (LongSeqCtrDnn over ``seq``, PipelinedCtrDnn over ``pipe``, MMoE's
bank over ``expert``)."""

from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.models.dcn import DCN
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.layers import bce_with_logits, linear, make_mlp, mlp
from paddlebox_tpu_torch.models.longseq_ctr import LongSeqCtrDnn
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.models.pipelined_ctr import PipelinedCtrDnn
from paddlebox_tpu_torch.models.rank_ctr import RankCtrDnn
from paddlebox_tpu_torch.models.two_tower import TwoTower
from paddlebox_tpu_torch.models.wide_deep import WideDeep
from paddlebox_tpu_torch.models.xdeepfm import XDeepFM

__all__ = [
    "CtrDnn",
    "DCN",
    "DeepFM",
    "LongSeqCtrDnn",
    "MMoE",
    "PipelinedCtrDnn",
    "RankCtrDnn",
    "TwoTower",
    "WideDeep",
    "XDeepFM",
    "bce_with_logits",
    "linear",
    "make_mlp",
    "mlp",
]
