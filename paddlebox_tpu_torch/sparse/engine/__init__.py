"""Device-resident embedding engine: the persistent HBM tier (reference:
paddlebox_tpu/sparse/engine/).

A fixed-capacity hot-key row cache (:class:`HbmCache`) persists across
passes above the per-pass working set and the host ``BucketStore``, so
begin_pass fetches only cache misses from the host.
"""

from paddlebox_tpu_torch.sparse.engine.hbm_cache import (  # noqa: F401
    CachePlan,
    HbmCache,
    UpdatePlan,
)
