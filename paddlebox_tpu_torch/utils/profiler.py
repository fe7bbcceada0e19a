"""Per-step host stage timing and device trace capture (reference:
paddlebox_tpu/utils/profiler.py).

  * :class:`StepProfiler`: named stage timers (plan / feed assembly /
    device step / dump) accumulated per pass and reported like the
    reference's ``log_for_profile`` lines; each stage is also a span of
    the host trace (telemetry/trace.py).
  * :func:`device_trace`: a ``torch.profiler`` window (CPU and CUDA
    activities) around a pass, written as a Chrome trace that Perfetto
    opens, in place of the reference's ``jax.profiler`` trace.

Every stage observation also lands in the registry's
``trainer.stage_seconds`` histogram (labeled by stage), so ``/metrics``
and the pass's event record carry per-stage latency distributions even in
runs that never enable the full profiler (:class:`StatsProfiler`, the
trainers' default).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from paddlebox_tpu_torch.telemetry import metrics as _tm
from paddlebox_tpu_torch.telemetry import trace as _trace
from paddlebox_tpu_torch.utils.timer import Timer

# host stages are sub-ms to seconds: tighter boundaries than the default
# latency ladder so per-stage quantiles don't collapse into one bucket
STAGE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
)


def stage_histogram(metric: str = "trainer.stage_seconds") -> _tm.Histogram:
    return _tm.histogram(
        metric, help="host pipeline stage latency (s)", buckets=STAGE_BUCKETS
    )


class NullProfiler:
    """No-op stand-in so the train loop has ONE body regardless of
    profiling (the two modes must never diverge behaviorally)."""

    enabled = False

    def stage(self, name: str):
        return contextlib.nullcontext()

    def step_done(self) -> None:
        pass


class StatsProfiler(NullProfiler):
    """Histogram-only stage timing: observes each stage's wall seconds into
    the telemetry registry but keeps ``enabled = False`` — no per-step
    device sync, no serial-feed forcing, so the trainers run it ALWAYS
    (per-stage p50/p99 in every run at the cost of two perf_counter calls
    per stage)."""

    def __init__(self, metric: str = "trainer.stage_seconds"):
        self._hist = stage_histogram(metric)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._hist.observe(time.perf_counter() - t0, stage=name)


class StepProfiler:
    """Named stage timers + step counter (TrainFilesWithProfiler analog).

    Stages auto-create on first use — callers add stages freely (the
    hardcoded 4-stage tuple remains only as the canonical report order).
    Each stage body is also observed into the ``trainer.stage_seconds``
    histogram and emitted as a span to the active trace (nested
    plan/feed/step/dump spans in the pass's Chrome-trace dump).
    """

    STAGES = ("plan", "feed", "step", "dump")
    enabled = True

    def __init__(self, metric: str = "trainer.stage_seconds"):
        self.timers = {s: Timer() for s in self.STAGES}
        self.n_steps = 0
        self._hist = stage_histogram(metric)

    def _timer(self, name: str) -> Timer:
        t = self.timers.get(name)
        if t is None:
            t = self.timers[name] = Timer()
        return t

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t = self._timer(name)
        t.resume()
        t0 = time.perf_counter()
        try:
            with _trace.span(name):
                yield
        finally:
            t.pause()
            self._hist.observe(time.perf_counter() - t0, stage=name)

    def step_done(self) -> None:
        self.n_steps += 1

    def _ordered_stages(self) -> list:
        extra = sorted(s for s in self.timers if s not in self.STAGES)
        return [s for s in self.STAGES if s in self.timers] + extra

    def report(self) -> dict:
        """Per-stage totals, resume/pause cycle counts, and means (s)."""
        out = {"steps": self.n_steps}
        for name in self._ordered_stages():
            t = self.timers[name]
            out[f"{name}_sec"] = t.elapsed_sec()
            out[f"{name}_count"] = t.count()
            if self.n_steps:
                out[f"{name}_ms_per_step"] = 1e3 * t.elapsed_sec() / self.n_steps
        return out

    def quantiles(self) -> dict:
        """Per-stage p50/p99 ms from the registry histogram — the
        distribution companion to report()'s means."""
        out = {}
        for name in self._ordered_stages():
            s = self._hist.summary(stage=name)
            if s["count"]:
                out[name] = {
                    "p50_ms": round(s["p50"] * 1e3, 3),
                    "p99_ms": round(s["p99"] * 1e3, 3),
                    "count": s["count"],
                }
        return out

    def log_line(self) -> str:
        """One-line summary (the reference's log_for_profile format spirit)."""
        r = self.report()
        parts = [f"steps={r['steps']}"]
        for s in self._ordered_stages():
            if f"{s}_ms_per_step" in r:
                parts.append(f"{s}={r[f'{s}_ms_per_step']:.2f}ms")
        return " ".join(parts)


@contextlib.contextmanager
def device_trace(logdir: Optional[str], name: str = "device-trace"
                 ) -> Iterator[None]:
    """A torch.profiler window (CPU and CUDA activities) around the body,
    exported as a Chrome trace ``<logdir>/<name>-pid<pid>-<ms>.json``
    (None or "" -> no-op).  The CUDA activity needs a card; on a host
    without one the window records the CPU only."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"{name}-pid{os.getpid()}-{int(time.time() * 1e3)}.json"))
