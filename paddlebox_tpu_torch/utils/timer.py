"""Pause/resume wall timers for host-pipeline accounting (reference:
paddlebox_tpu/utils/timer.py)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._elapsed = 0.0
        self._start = None
        self._count = 0

    def resume(self) -> None:
        if self._start is None:
            self._start = time.perf_counter()

    def pause(self) -> None:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
            self._count += 1

    def elapsed_sec(self) -> float:
        extra = 0.0 if self._start is None else time.perf_counter() - self._start
        return self._elapsed + extra

    def count(self) -> int:
        return self._count

    def __enter__(self):
        self.resume()
        return self

    def __exit__(self, *exc):
        self.pause()
        return False
