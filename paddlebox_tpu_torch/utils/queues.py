"""Bounded-queue helper for producer/consumer threads (reference:
paddlebox_tpu/utils/queues.py).

A plain blocking ``Queue.put`` deadlocks when the consumer dies or retires
while the queue is full; ``bounded_put`` re-checks an abort predicate
instead.  Used by the feed prefetcher (train/trainer.py).
"""

from __future__ import annotations

import queue
from typing import Any, Callable


def bounded_put(
    q: "queue.Queue",
    item: Any,
    should_abort: Callable[[], bool],
    poll_s: float = 0.2,
) -> bool:
    """Put ``item`` on ``q``, re-checking ``should_abort()`` every ``poll_s``
    while the queue is full.  Returns False (item NOT enqueued) when aborted.
    """
    while not should_abort():
        try:
            q.put(item, timeout=poll_s)
            return True
        except queue.Full:
            continue
    return False
