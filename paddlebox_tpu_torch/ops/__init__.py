"""The CTR operator set (reference: paddlebox_tpu/ops/__init__.py): the
seqpool-CVM family, the standalone CVM, rank_attention and fused_concat as
PyTorch functions.  The sparse kernels' wrappers (``sparse_kernels``) and
their build (``cuda_build``) are imported by name where they are used."""

from paddlebox_tpu_torch.ops.cvm import cvm, cvm_decayed_show
from paddlebox_tpu_torch.ops.fused_concat import fused_concat
from paddlebox_tpu_torch.ops.rank_attention import (
    ins_rank,
    rank_attention,
    rank_attention2,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import (
    fused_seqpool_cvm,
    fused_seqpool_cvm_extended,
    fused_seqpool_cvm_with_conv,
    fused_seqpool_cvm_with_diff_thres,
    fused_seqpool_cvm_with_pcoc,
    pooled_width,
    seqpool,
)

__all__ = [
    "cvm",
    "cvm_decayed_show",
    "fused_concat",
    "fused_seqpool_cvm",
    "pooled_width",
    "fused_seqpool_cvm_extended",
    "fused_seqpool_cvm_with_conv",
    "fused_seqpool_cvm_with_diff_thres",
    "fused_seqpool_cvm_with_pcoc",
    "seqpool",
    "rank_attention",
    "rank_attention2",
    "ins_rank",
]
