"""Cross-rank metric aggregation over the job's KV store (reference:
paddlebox_tpu/telemetry/fleet.py).

Per-rank registries answer "what is MY p99"; operating a job needs ONE
merged view: which rank's stage is slowest, what the job-wide tail looks
like, logged by rank 0 at every pass end (the reference's PrintSyncTimer
prints per-device timers for the same reason).  A slow but live straggler
shows up here passes before the liveness watchdog's deadline would fire.

``gather_fleet_snapshot`` exchanges JSON registry snapshots through any KV
with the ``set/get/delete`` surface (``host_plane.StoreKv`` over the job's
TCPStore, ``InMemoryKv`` in tests), merges them and returns the fleet
view.  Merging: counters sum, gauges take max and mean, histograms sum
bucket-wise (same boundaries by construction), so fleet quantiles cover
every rank's samples; everything also carries the per-rank values, so a
straggler is attributable.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional, Sequence

from paddlebox_tpu_torch.telemetry.metrics import (
    quantile_from_buckets,
    registry as _global_registry,
)

logger = logging.getLogger(__name__)


class FleetGatherTimeout(TimeoutError):
    """The snapshot gather exhausted its deadline; names the missing ranks
    (same spirit as HostPlaneTimeout: the culprit is in the error)."""

    def __init__(self, namespace: str, seq: int, waited_s: float,
                 missing: Sequence[int]):
        self.namespace = namespace
        self.seq = seq
        self.missing = sorted(missing)
        super().__init__(
            f"fleet snapshot gather timed out after {waited_s:.1f}s on "
            f"{namespace!r} seq {seq}: no snapshot from rank(s) "
            f"{self.missing}"
        )


def _key(namespace: str, seq: int, rank: int) -> str:
    return f"pbox_tm/{namespace}/{seq}/{rank}"


def gather_fleet_snapshot(
    kv,
    rank: int,
    world: int,
    seq: int = 0,
    namespace: str = "fleet",
    timeout_s: float = 60.0,
    poll_s: float = 0.05,
    registry=None,
) -> dict:
    """Allgather every rank's registry snapshot; return the merged view.

    Every rank must call this at the same logical point (pass boundary)
    with the same ``seq`` — the same lockstep contract KvChannel imposes.
    Each rank deletes its own PREVIOUS seq's key after posting (a peer
    still reading seq-1 would have returned from its own gather already),
    so a long job leaks nothing into the KV leader.
    """
    reg = registry if registry is not None else _global_registry
    snap = reg.snapshot()
    snap["rank"] = int(rank)
    kv.set(_key(namespace, seq, rank), json.dumps(snap))
    if seq > 0:
        kv.delete(_key(namespace, seq - 1, rank))
    snaps: Dict[int, dict] = {rank: snap}
    deadline = time.monotonic() + timeout_s
    while len(snaps) < world:
        for r in range(world):
            if r in snaps:
                continue
            raw = kv.get(_key(namespace, seq, r))
            if raw is not None:
                try:
                    snaps[r] = json.loads(raw)
                except ValueError:
                    logger.warning(
                        "fleet gather: corrupt snapshot from rank %d", r
                    )
                    snaps[r] = {}
        if len(snaps) < world:
            if time.monotonic() > deadline:
                raise FleetGatherTimeout(
                    namespace, seq, timeout_s,
                    [r for r in range(world) if r not in snaps],
                )
            time.sleep(poll_s)
    return merge_snapshots([snaps[r] for r in sorted(snaps)])


def merge_snapshots(snaps: List[dict]) -> dict:
    """Merge per-rank structured snapshots into one fleet view.

    Returns ``{"world", "ranks", "counters", "gauges", "histograms"}``
    where each counter/gauge entry carries sum/max/mean + per_rank and each
    histogram carries fleet-merged count/mean/p50/p95/p99/max plus the
    per-rank p99 list (the straggler finder).
    """
    ranks = [int(s.get("rank", i)) for i, s in enumerate(snaps)]
    out: dict = {
        "world": len(snaps), "ranks": ranks,
        "counters": {}, "gauges": {}, "histograms": {},
    }

    def scalar_view(kind: str) -> None:
        names: set = set()
        for s in snaps:
            names.update(s.get(kind, {}))
        for name in sorted(names):
            per = [float(s.get(kind, {}).get(name, 0.0)) for s in snaps]
            out[kind][name] = {
                "sum": sum(per),
                "max": max(per),
                "mean": sum(per) / len(per),
                "per_rank": per,
            }

    scalar_view("counters")
    scalar_view("gauges")

    names: set = set()
    for s in snaps:
        names.update(s.get("histograms", {}))
    for name in sorted(names):
        per = [s.get("histograms", {}).get(name) for s in snaps]
        present = [h for h in per if h]
        if not present:
            continue
        boundaries = present[0]["boundaries"]
        counts = [0] * (len(boundaries) + 1)
        total = 0
        hsum = 0.0
        hmin, hmax = float("inf"), float("-inf")
        per_rank_p99: list = []
        per_rank_count: list = []
        for h in per:
            if not h or h.get("boundaries") != boundaries:
                per_rank_p99.append(None)
                per_rank_count.append(0)
                continue
            for i, c in enumerate(h["counts"]):
                counts[i] += c
            total += h["count"]
            hsum += h["sum"]
            if h["count"]:
                hmin = min(hmin, h["min"])
                hmax = max(hmax, h["max"])
            per_rank_count.append(h["count"])
            per_rank_p99.append(
                quantile_from_buckets(
                    boundaries, h["counts"], h["count"],
                    h["min"] if h["count"] else 0.0,
                    h["max"] if h["count"] else 0.0, 0.99,
                )
            )
        qs = {
            f"p{int(q * 100)}": quantile_from_buckets(
                boundaries, counts, total, hmin, hmax, q
            )
            for q in (0.5, 0.95, 0.99)
        }
        out["histograms"][name] = {
            "count": total,
            "mean": (hsum / total) if total else None,
            "min": None if total == 0 else hmin,
            "max": None if total == 0 else hmax,
            **qs,
            "per_rank_p99": per_rank_p99,
            "per_rank_count": per_rank_count,
        }
    return out


def format_fleet_view(merged: dict, prefix: str = "fleet") -> str:
    """One rank-0 log line per pass: merged per-rank stage timings and the
    biggest counters — readable, greppable, bounded length."""
    parts = [f"[{prefix}] world={merged['world']}"]
    for name, h in sorted(merged.get("histograms", {}).items()):
        if not h["count"]:
            continue
        p50 = h["p50"] or 0.0
        p99 = h["p99"] or 0.0
        per = ",".join(
            "-" if p is None else f"{p * 1e3:.0f}"
            for p in h["per_rank_p99"]
        )
        parts.append(
            f"{name}: n={h['count']} p50={p50 * 1e3:.1f}ms "
            f"p99={p99 * 1e3:.1f}ms per_rank_p99_ms=[{per}]"
        )
    for name, c in sorted(merged.get("counters", {}).items()):
        if c["sum"]:
            parts.append(f"{name}={c['sum']:g}")
    return " | ".join(parts)


def log_fleet_view(merged: dict, logger_: Optional[logging.Logger] = None,
                   prefix: str = "fleet") -> str:
    line = format_fleet_view(merged, prefix=prefix)
    (logger_ or logger).info("%s", line)
    return line
