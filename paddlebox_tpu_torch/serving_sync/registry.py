"""Versioned model registry and the publish root's donefile format
(reference: paddlebox_tpu/serving_sync/registry.py; the donefile bytes are
the reference's, so each package reads the other's).

  * :class:`PublishEntry` / :func:`parse_donefile` — the wire format of
    ``<publish_root>/donefile.txt``: one JSON line a published model unit,
    numbered in sequence, append-only, uploaded last.  A delta entry
    carries its chain links (``base_tag`` + ``prev_tag``) so a consumer
    proves continuity before it applies it.
  * :class:`ModelVersion` / :class:`ModelRegistry` — the serving side's
    lineage (a base tag and the applied delta chain) with an atomic commit
    and a rollback to the last good version.  The syncer commits a built
    replacement, then swaps it into the live ScoringServer: a failed apply
    never leaves a half-updated model visible.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from paddlebox_tpu_torch import telemetry

DONEFILE_NAME = "donefile.txt"

_TORN_DONEFILE = telemetry.counter(
    "sync.torn_donefile",
    help="donefile reads whose tail line was unparsable (torn write)",
)
_ROLLBACKS = telemetry.counter(
    "sync.rollbacks", help="registry rollbacks to the previous version"
)


class DeliveryChainError(RuntimeError):
    """A delta entry does not extend the currently-applied chain (wrong
    base tag, wrong predecessor, or a sequence-number gap)."""


@dataclasses.dataclass(frozen=True)
class PublishEntry:
    """One donefile line: a published base artifact or delta dir."""

    seq: int
    kind: str  # "base" | "delta"
    tag: str
    dir: str  # basename under the publish root
    base_tag: str  # chain anchor (== tag for a base)
    prev_tag: Optional[str]  # predecessor tag in the chain (None for seq 0)
    published_at: float
    n_rows: int = 0
    has_programs: bool = True  # delta shipped re-frozen serving programs
    # the chain's embedding payload dtype (inference/quant.py): a base
    # anchors it, every delta on the chain must match — pre-quantization
    # donefiles parse with the fp32 default
    embedding_dtype: str = "fp32"
    # bytes of the published unit as staged+verified (the multi-TB-path
    # shrink, readable straight off the donefile)
    n_bytes: int = 0
    meta: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        extra = d.pop("meta") or {}
        return json.dumps({**extra, **d})

    @staticmethod
    def from_json(line: str) -> "PublishEntry":
        d = json.loads(line)
        known = {f.name for f in dataclasses.fields(PublishEntry)}
        kw = {k: d[k] for k in known if k in d and k != "meta"}
        kw["meta"] = {k: v for k, v in d.items() if k not in known}
        if kw.get("kind") not in ("base", "delta"):
            raise ValueError(f"bad donefile kind {kw.get('kind')!r}")
        kw["seq"] = int(kw["seq"])
        return PublishEntry(**kw)


def parse_donefile(data: bytes, strict: bool = False) -> List[PublishEntry]:
    """Entries of a donefile blob, in file order.

    A donefile is append-only, so the only legitimately malformed line is
    a torn TAIL (the publisher died mid-append / the read raced the
    upload): by default it is dropped and counted
    (``sync.torn_donefile``).  A malformed line with entries AFTER it is
    corruption, not tearing, and always raises.  ``strict`` raises on any
    malformed line (the lint tool's mode)."""
    out: List[PublishEntry] = []
    lines = data.decode(errors="replace").splitlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(PublishEntry.from_json(line))
        except (ValueError, KeyError, TypeError) as e:
            rest = [ln for ln in lines[i + 1:] if ln.strip()]
            if strict or rest:
                raise ValueError(
                    f"donefile line {i + 1} unparsable: {e}"
                ) from e
            _TORN_DONEFILE.inc()
            break
    return out


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """Lineage of one live model: which base it stands on and which delta
    chain has been applied on top."""

    name: str
    base_tag: str
    delta_tags: Tuple[str, ...] = ()
    seq: int = 0  # donefile seq of the newest applied entry
    published_at: float = 0.0  # publish time of that entry
    applied_at: float = 0.0
    # the producing pass/window ID the newest applied entry carried
    # (PublishEntry.meta["lineage"]): the attribution hook — which
    # training window is this served model made of?
    lineage_id: Optional[str] = None
    # the chain's embedding payload dtype (set by the applied base)
    embedding_dtype: str = "fp32"

    @property
    def tag(self) -> str:
        """Tag of the newest applied entry (delta if any, else base)."""
        return self.delta_tags[-1] if self.delta_tags else self.base_tag

    @property
    def deltas_applied(self) -> int:
        return len(self.delta_tags)

    def extend(self, entry: PublishEntry) -> "ModelVersion":
        """This version plus one applied delta entry."""
        if entry.kind != "delta":
            raise ValueError("extend() takes delta entries only")
        return dataclasses.replace(
            self,
            delta_tags=self.delta_tags + (entry.tag,),
            seq=entry.seq,
            published_at=entry.published_at,
            applied_at=time.time(),
            lineage_id=entry.meta.get("lineage", self.lineage_id),
        )

    def lineage(self) -> dict:
        """JSON-ready lineage (the server's /models payload shape)."""
        return {
            "base_tag": self.base_tag,
            "tag": self.tag,
            "deltas_applied": self.deltas_applied,
            "seq": self.seq,
            "published_at": self.published_at,
            "applied_at": self.applied_at,
            "lineage": self.lineage_id,
            "embedding_dtype": self.embedding_dtype,
        }


class ModelRegistry:
    """Thread-safe (version, predictor) registry with bounded last-good
    history per model name.  Pure bookkeeping: committing here does NOT
    touch a server — the syncer commits first, then swaps the predictor
    into the ScoringServer, so the registry always describes what the
    server is (about to be) serving and rollback always has the actual
    predictor object to restore."""

    def __init__(self, keep_versions: int = 3):
        if keep_versions < 1:
            raise ValueError("keep_versions must be >= 1")
        self.keep_versions = int(keep_versions)
        self._lock = threading.Lock()
        self._current: Dict[str, Tuple[ModelVersion, object]] = {}
        self._history: Dict[str, List[Tuple[ModelVersion, object]]] = {}

    def commit(self, name: str, version: ModelVersion, predictor) -> None:
        """Make ``(version, predictor)`` the current entry for ``name``;
        the previous current (if any) joins the rollback history."""
        with self._lock:
            prev = self._current.get(name)
            if prev is not None:
                hist = self._history.setdefault(name, [])
                hist.append(prev)
                del hist[: -self.keep_versions]
            self._current[name] = (version, predictor)

    def current(self, name: str) -> Optional[Tuple[ModelVersion, object]]:
        with self._lock:
            return self._current.get(name)

    def current_version(self, name: str) -> Optional[ModelVersion]:
        cur = self.current(name)
        return cur[0] if cur else None

    def rollback(self, name: str) -> Tuple[ModelVersion, object]:
        """Drop the current version and restore the previous one (the
        last-good ladder rung under a bad swap).  LookupError when there
        is nothing to roll back to — the caller keeps what it has."""
        with self._lock:
            hist = self._history.get(name) or []
            if not hist:
                raise LookupError(f"model {name!r} has no previous version")
            entry = hist.pop()
            self._current[name] = entry
            _ROLLBACKS.inc()
            return entry

    def names(self) -> List[str]:
        with self._lock:
            return list(self._current)

    def lineage(self, name: str) -> Optional[dict]:
        v = self.current_version(name)
        return v.lineage() if v else None
