"""Online training: streaming mini-pass training with freshness on a
deadline (reference: paddlebox_tpu/streaming/).

  * :mod:`~paddlebox_tpu_torch.streaming.source` — watermarked record
    sources over a bounded, backpressured buffer: a tailing file-set
    source (growing part files and new shards, torn tails held back), a
    TCP socket source and a replaying iterable source;
  * :mod:`~paddlebox_tpu_torch.streaming.minipass` — the mini-pass
    scheduler: windows cut by record count and/or wall-clock age, parsed
    and censused on its own thread, so the table stages the next window
    while the current one trains;
  * :mod:`~paddlebox_tpu_torch.streaming.freshness` — the deadline
    publisher: ``publish_delta`` on a max-staleness deadline, health-gated,
    with backpressure (wider windows) when publish or sync lags, and the
    event-to-served freshness measure;
  * :mod:`~paddlebox_tpu_torch.streaming.runner` — ``StreamingTrainer``,
    the loop of trainer, source, policy, the watchdog and the NaN
    rollback, with a drain-and-checkpoint shutdown.
"""

from paddlebox_tpu_torch.streaming.freshness import DeadlinePublishPolicy
from paddlebox_tpu_torch.streaming.minipass import (
    MiniPassScheduler,
    MiniPassWindow,
    WindowDataset,
)
from paddlebox_tpu_torch.streaming.runner import StreamingTrainer
from paddlebox_tpu_torch.streaming.source import (
    IterableSource,
    SocketSource,
    StreamRecord,
    StreamSource,
    TailingFileSource,
)

__all__ = [
    "DeadlinePublishPolicy",
    "IterableSource",
    "MiniPassScheduler",
    "MiniPassWindow",
    "SocketSource",
    "StreamRecord",
    "StreamSource",
    "StreamingTrainer",
    "TailingFileSource",
    "WindowDataset",
]
