"""Online model delivery plane: the trainer's publisher, the delta
hot-apply, the versioned registry (reference: paddlebox_tpu/serving_sync/).

It connects the table's delta tracker (``SparseTable.delta_state_dict``)
and the serving export (inference/export.py) to a live ScoringServer, so
an online server stays fresh without the full table shipped again:

  * :mod:`publisher` — base artifacts (``publish_base``,
    ``publish_ann_base``) and sparse row deltas, optionally with
    re-exported programs (``publish_delta``): staged, manifest-verified
    through the remote fs, donefile last, numbered in sequence,
    health-gated;
  * :mod:`syncer` — the serving side's polling agent: new donefile
    entries, verified manifests, deltas merged into a copy of the live
    Predictor's snapshot and swapped in atomically; a full base reload on
    any chain gap or failed verification, the last good version when even
    that fails;
  * :mod:`registry` — the donefile format (the reference's bytes) and the
    versioned registry (base tag and applied delta chain, a bounded
    history, rollback).
"""

from paddlebox_tpu_torch.serving_sync.publisher import (  # noqa: F401
    DELTA_META_NAME,
    DELTA_ROWS_NAME,
    PublishError,
    Publisher,
)
from paddlebox_tpu_torch.serving_sync.registry import (  # noqa: F401
    DONEFILE_NAME,
    DeliveryChainError,
    ModelRegistry,
    ModelVersion,
    PublishEntry,
    parse_donefile,
)
from paddlebox_tpu_torch.serving_sync.syncer import (  # noqa: F401
    Syncer,
    fleet_min_freshness,
)
