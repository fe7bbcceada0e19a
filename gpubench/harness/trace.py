"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA activities, the program at its default settings) over whole passes of
the window, and its reduction to the numbers the per-layer readers take.

During the stretch the step's two sparse kernel entries of the port
(``ops/sparse_kernels.py`` ``pull_rows`` and ``scatter_add_rows``, which
the table calls through the module) run inside ranges of their own, so the
profiler gives the device time of whatever kernels they launch
(``gpu_user_annotation`` events).  The benchmark's own ranges name what
the host was doing: ``gpubench.begin_pass``, ``.train_steps`` and
``.end_pass`` on the driving thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("gpubench.begin_pass", "gpubench.train_steps",
              "gpubench.end_pass")
RANGED = ("pull_rows", "scatter_add_rows")
TOP = 10


def _ranged(fn, name: str):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


class Tracer:
    """Profiles passes ``[first, first + count)`` of the window.  The
    seconds its start and stop take inside the window are ``overhead_s``,
    which the window leaves out of its length; ``finish()`` reduces the
    trace after the window."""

    def __init__(self, first: int, count: int, tmp_dir: str, device="cuda"):
        self.first, self.count, self.tmp_dir = first, count, tmp_dir
        self.cuda = torch.device(device).type == "cuda"
        self.result = None
        self.overhead_s = 0.0
        self._prof = None
        self._span = None
        self._saved = {}

    @contextlib.contextmanager
    def pass_scope(self, p: int):
        t0 = time.perf_counter()
        if p == self.first:
            self._start()
        self.overhead_s += time.perf_counter() - t0
        try:
            yield
        finally:
            t0 = time.perf_counter()
            if p == self.first + self.count - 1 and self._prof is not None:
                self._stop()
            self.overhead_s += time.perf_counter() - t0

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _start(self) -> None:
        from paddlebox_tpu_torch.ops import sparse_kernels as sk

        self._sync()
        for name in RANGED:
            self._saved[name] = getattr(sk, name)
            setattr(sk, name, _ranged(self._saved[name], f"gpubench.{name}"))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function("gpubench.trace_stretch")
        self._span.__enter__()

    def _stop(self) -> None:
        from paddlebox_tpu_torch.ops import sparse_kernels as sk

        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        for name, fn in self._saved.items():
            setattr(sk, name, fn)

    def finish(self) -> None:
        """Reduce the profiled passes (after the window)."""
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmp_dir)
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self.result = reduce_trace(events)
        self.result["passes"] = list(range(self.first,
                                           self.first + self.count))


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covering(spans: list, t: float) -> list:
    return [name for name, a, b in spans if a <= t <= b]


def reduce_trace(events: list) -> dict:
    """From Chrome-trace events (microseconds): the stretch's length, the
    device's busy time (the union of kernel, copy and memset intervals),
    the device time of each ranged entry, the kernels' time by name, and
    the idle gaps by what the host was doing."""
    stretch = [e for e in events if e.get("name") == "gpubench.trace_stretch"
               and e.get("ph") == "X"]
    if not stretch:
        raise RuntimeError("the trace holds no gpubench.trace_stretch range")
    lo = float(stretch[0]["ts"])
    hi = lo + float(stretch[0]["dur"])
    dev, by_name = [], {}
    ranges = {}
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a2, b2 = max(a, lo), min(b, hi)
            if b2 > a2:
                dev.append((a2, b2))
                by_name[name] = by_name.get(name, 0.0) + (b2 - a2)
        elif cat == "gpu_user_annotation" and name.startswith("gpubench."):
            ranges[name] = ranges.get(name, 0.0) + (b - a) * 1e-6
        elif cat == "user_annotation" and name in HOST_SPANS:
            host.append((name, a, b))
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, edge = [], lo
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    idle = {}
    for a, b in gaps:
        names = _covering(host, 0.5 * (a + b))
        label = names[-1][len("gpubench."):] if names else "between passes"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    kernels = sorted(((n, s * 1e-6) for n, s in by_name.items()),
                     key=lambda x: -x[1])
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "ranges": ranges,
        "kernels": dict(kernels),
        "device_ops": [[n[:200], s] for n, s in kernels[:TOP]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda x: -x[1])[:TOP],
    }
