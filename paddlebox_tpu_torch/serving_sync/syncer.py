"""Server-side sync agent: donefile polling, delta hot-apply, fallback
(reference: paddlebox_tpu/serving_sync/syncer.py).

A :class:`Syncer` watches one publish root (written by
:class:`~paddlebox_tpu_torch.serving_sync.publisher.Publisher`) for one
model name of a live ScoringServer and keeps it fresh:

  * **poll** — read the donefile (retried, fault site ``sync.poll``) and
    take every entry newer than the last applied sequence number;
  * **apply** — fetch the entry's dir into a local cache (site
    ``sync.fetch``) and verify its integrity manifest (required: a
    delivery unit without one is refused), then apply it: a base becomes
    a new ``Predictor`` on the server's device; a delta merges its rows
    into a copy of the live predictor's sorted snapshot on the host
    (``Predictor.with_delta``), which uploads the merged snapshot to the
    card as a new Predictor, complete on the card before
    ``server.swap_model`` installs it.  A request in flight keeps the
    predictor it pinned, so none is blocked or served a half-applied
    model, and every predict on the new one resolves its keys with the
    ``sorted_search`` and ``gather_slots`` kernels;
  * **fall back** — a delta that fails verification or apply, or whose
    chain links do not extend the live version, triggers a full reload
    from the newest base that loads (``sync.full_reload_fallback``); when
    none loads, the last good version keeps serving and the next poll
    retries.  ``rollback()`` restores the previous registry version.

Freshness: ``serve.model_age_seconds``, ``sync.lag_passes``,
``sync.apply_seconds`` by kind, and a counter for every fallback.
``last_apply`` splits the newest apply's seconds into fetch, merge (the
host), upload (to the card) and swap.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.checkpoint import CheckpointCorrupt, verify_checkpoint_dir
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.serving_sync.publisher import (
    DELTA_META_NAME,
    DELTA_ROWS_NAME,
)
from paddlebox_tpu_torch.serving_sync.registry import (
    DONEFILE_NAME,
    DeliveryChainError,
    ModelRegistry,
    ModelVersion,
    PublishEntry,
    parse_donefile,
)
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.fs import resolve_fs
from paddlebox_tpu_torch.utils.retry import retry_call

logger = logging.getLogger(__name__)

_APPLY_SECONDS = telemetry.histogram(
    "sync.apply_seconds",
    help="syncer apply wall time (s) by kind (base/delta)",
)
_APPLIED = telemetry.counter(
    "sync.applied", help="model versions applied by the syncer, by kind"
)
_LAG = telemetry.gauge(
    "sync.lag_passes",
    help="published donefile entries not yet applied to the live model",
)
_MODEL_AGE = telemetry.gauge(
    "serve.model_age_seconds",
    help="seconds since the serving model's current version was published",
)
_FULL_RELOAD = telemetry.counter(
    "sync.full_reload_fallback",
    help="delta-chain failures that fell back to a full base reload",
)
_APPLY_FAILURES = telemetry.counter(
    "sync.apply_failures", help="entry applies that raised, by kind"
)
_CHAIN_GAP = telemetry.counter(
    "sync.chain_gap",
    help="delta entries rejected for not extending the live chain",
)
_RELOAD_FAILED = telemetry.counter(
    "sync.reload_failed",
    help="full reloads that could not produce any model (last-good kept)",
)
_POLL_ERRORS = telemetry.counter(
    "sync.poll_errors", help="syncer poll loops that raised"
)
_AGENT_RESTARTS = telemetry.counter(
    "sync.agent_restarts",
    help="background sync agent loops restarted after an escaped "
         "exception (the loop must never die silently)",
)


class Syncer:
    def __init__(
        self,
        publish_root: str,
        server,
        model_name: str = "live",
        *,
        fs=None,
        cache_dir: Optional[str] = None,
        feed_conf=None,
        poll_interval_s: Optional[float] = None,
        registry: Optional[ModelRegistry] = None,
        keep_versions: int = 3,
        degraded_after_failures: int = 3,
        degraded_lag_entries: int = 10,
        device=None,
    ):
        """feed_conf: parser config for the served model; None reads the
        base artifact's own feed.json (export_model(feed_conf=...)).
        device: where the predictors it builds hold their snapshot (None =
        the server's device).  cache_dir: None reads
        PADDLEBOX_TORCH_SYNC_CACHE_DIR (a directory a model under it), else
        a temporary directory."""
        self.root = publish_root
        self.fs = fs or resolve_fs(publish_root)
        self.server = server
        self.name = model_name
        self.feed_conf = feed_conf
        self.poll_interval_s = (
            poll_interval_s
            if poll_interval_s is not None
            else flags.sync_interval_s
        )
        if cache_dir is None and flags.sync_cache_dir:
            cache_dir = os.path.join(flags.sync_cache_dir, model_name)
        self.cache = cache_dir or os.path.join(
            tempfile.gettempdir(), f"pbox-sync-{os.getpid()}-{model_name}"
        )
        self.device = (device if device is not None
                       else getattr(server, "device", "cuda"))
        # the newest apply's seconds by part: fetch (download + verify),
        # merge (the host merge of a delta, or the load of a base), upload
        # (the snapshot to the device, synchronized) and swap (registry
        # commit + server swap)
        self.last_apply: dict = {}
        os.makedirs(self.cache, exist_ok=True)
        self.registry = registry or ModelRegistry(keep_versions=keep_versions)
        self._applied_seq = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # degraded-mode thresholds: this many consecutive failed poll
        # ticks (degraded_after_failures) or this many unapplied donefile
        # entries (degraded_lag_entries; 0 disables) flip the server's
        # /healthz to degraded — it keeps serving the pinned last-good
        # model, the fleet router deprioritizes it, and the flag clears
        # on the next clean/fresh tick.  Degrade, never fail.
        self.degraded_after_failures = int(degraded_after_failures)
        self.degraded_lag_entries = int(degraded_lag_entries)
        self._consecutive_poll_failures = 0

    @property
    def applied_seq(self) -> int:
        """Newest donefile seq applied into the live server (-1 before the
        first model).  The serving-side freshness confirmation the
        streaming plane's event→served tracker polls
        (``StreamingTrainer(served_seq_fn=lambda: syncer.applied_seq)``):
        by install order the swap into the server happens BEFORE this
        advances, so a reported seq is always actually servable."""
        return self._applied_seq

    # -- poll --------------------------------------------------------------- #
    def _read_entries(self) -> List[PublishEntry]:
        donefile = os.path.join(self.root, DONEFILE_NAME)

        def cat():
            faults.inject("sync.poll")
            if not self.fs.exists(donefile):
                return b""
            return self.fs.cat(donefile)

        return parse_donefile(retry_call(cat, site="sync.poll"))

    def poll_once(self) -> int:
        """One discovery+apply tick; returns how many donefile entries
        the live model advanced by (0 = already fresh)."""
        entries = self._read_entries()
        before = self._applied_seq
        pending = [e for e in entries if e.seq > self._applied_seq]
        for entry in pending:
            if entry.seq <= self._applied_seq:
                continue  # a full reload already advanced past it
            try:
                with telemetry.span(f"sync.apply.{entry.kind}",
                                    tag=entry.tag):
                    self._apply_entry(entry)
            except DeliveryChainError as e:
                logger.warning("sync chain break at seq %d (%s): %s",
                               entry.seq, entry.tag, e)
                _CHAIN_GAP.inc()
                self._full_reload(entries)
                break
            except Exception as e:
                logger.warning("sync apply failed at seq %d (%s): %r",
                               entry.seq, entry.tag, e)
                _APPLY_FAILURES.inc(kind=entry.kind)
                self._full_reload(entries)
                break
        self._update_gauges(entries)
        return self._applied_seq - before

    def _update_gauges(self, entries: List[PublishEntry]) -> None:
        newest = entries[-1].seq if entries else self._applied_seq
        lag = max(0, newest - self._applied_seq)
        _LAG.set(lag, model=self.name)
        version = self.registry.current_version(self.name)
        if version is not None:
            _MODEL_AGE.set(
                max(0.0, time.time() - version.published_at),
                model=self.name,
            )
        if self.degraded_lag_entries > 0:
            if lag > self.degraded_lag_entries:
                self._mark_degraded(
                    "sync_lag",
                    f"{lag} published entries behind (> "
                    f"{self.degraded_lag_entries})",
                )
            else:
                self._clear_degraded("sync_lag")

    # -- degraded-mode advertisement ----------------------------------------- #
    # The syncer is the authority on delivery health; the server is the
    # surface it advertises through.  getattr-guarded so a bare server
    # (or a test stub) without the degraded API still syncs fine.
    def _mark_degraded(self, reason: str, detail: str = "") -> None:
        fn = getattr(self.server, "set_degraded", None)
        if fn is not None:
            fn(f"{reason}:{self.name}", detail)

    def _clear_degraded(self, reason: str) -> None:
        fn = getattr(self.server, "clear_degraded", None)
        if fn is not None:
            fn(f"{reason}:{self.name}")

    # -- apply -------------------------------------------------------------- #
    def _apply_entry(self, entry: PublishEntry) -> None:
        faults.inject("sync.apply")
        with _APPLY_SECONDS.time(kind=entry.kind):
            if entry.kind == "base":
                self._apply_base(entry)
            else:
                self._check_chain(entry)
                self._apply_delta(entry)

    def _check_chain(self, entry: PublishEntry) -> None:
        current = self.registry.current_version(self.name)
        if current is None:
            raise DeliveryChainError(
                f"delta {entry.tag} arrived before any base"
            )
        if entry.base_tag != current.base_tag:
            raise DeliveryChainError(
                f"delta {entry.tag} anchors base {entry.base_tag!r}, "
                f"live chain stands on {current.base_tag!r}"
            )
        if entry.prev_tag != current.tag:
            raise DeliveryChainError(
                f"delta {entry.tag} follows {entry.prev_tag!r}, live chain "
                f"head is {current.tag!r}"
            )
        if entry.seq != current.seq + 1:
            raise DeliveryChainError(
                f"sequence gap: delta {entry.tag} is seq {entry.seq}, live "
                f"chain head is seq {current.seq}"
            )

    def _apply_base(self, entry: PublishEntry) -> None:
        from paddlebox_tpu_torch.inference.predictor import Predictor

        local = self._fetch(entry)
        # artifact-kind dispatch: an ANN (retrieval) base loads as an
        # AnnIndex — it duck-types the Predictor surface this plane
        # touches, so the chain check / delta merge / install path below
        # is shared verbatim.  The kind rides BOTH the artifact's
        # meta.json and the donefile entry meta; the artifact's copy is
        # authoritative (it was manifest-verified with the bytes).
        kind = entry.meta.get("artifact_kind")
        meta_path = os.path.join(local, "meta.json")
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as fh:
                    kind = json.load(fh).get("artifact_kind", kind)
            except (OSError, ValueError):
                pass  # corrupt meta surfaces from the loader below
        if kind == "ann":
            from paddlebox_tpu_torch.inference.ann import AnnIndex

            predictor = self._build(
                "base", lambda: AnnIndex.load(local, device=self.device))
        else:
            predictor = self._build(
                "base", lambda: Predictor.load(local, device=self.device))
        feed_conf = self.feed_conf
        if feed_conf is None:
            path = os.path.join(local, "feed.json")
            if os.path.exists(path):
                from paddlebox_tpu_torch.config import DataFeedConfig

                with open(path) as fh:
                    feed_conf = DataFeedConfig.from_dict(json.load(fh))
            elif kind != "ann":
                # an ANN index serves raw query vectors (/retrieve): it
                # has no slot-text feed and registers without one
                raise CheckpointCorrupt(
                    f"base {entry.tag}: no feed.json in the artifact and "
                    "no feed_conf configured on the syncer"
                )
        version = ModelVersion(
            name=self.name, base_tag=entry.tag, seq=entry.seq,
            published_at=entry.published_at, applied_at=time.time(),
            lineage_id=entry.meta.get("lineage"),
            embedding_dtype=predictor.embedding_dtype,
        )
        self._install(version, predictor, feed_conf=feed_conf)
        _APPLIED.inc(kind="base")

    def _apply_delta(self, entry: PublishEntry) -> None:
        current = self.registry.current(self.name)
        assert current is not None  # _check_chain guaranteed it
        version, predictor = current
        local = self._fetch(entry)
        with open(os.path.join(local, DELTA_META_NAME)) as fh:
            dmeta = json.load(fh)
        w = int(predictor.meta["row_width"])
        if int(dmeta.get("row_width", w)) != w:
            raise CheckpointCorrupt(
                f"delta {entry.tag}: row_width {dmeta.get('row_width')} != "
                f"live artifact {w}"
            )
        buckets = dmeta.get("buckets") or []
        edtype = dmeta.get("embedding_dtype", "fp32")
        # Predictor.with_delta refuses a dtype that doesn't match the live
        # artifact (EmbeddingDtypeMismatch) — that structured refusal
        # lands in poll_once's apply-failure handler and full-reloads,
        # never a corrupt fp32-into-int8 merge
        programs = dict(program_dir=local if buckets else None,
                        bucket_meta=buckets or None)
        with np.load(os.path.join(local, DELTA_ROWS_NAME)) as d:
            if edtype != "fp32":
                from paddlebox_tpu_torch.inference import quant

                def merge():
                    return predictor.with_delta(
                        d["keys"], head=d["head"],
                        embedx_q=quant.load_q(d["embedx_q"], edtype),
                        scales=d["scales"], embedding_dtype=edtype,
                        **programs)
            else:
                def merge():
                    return predictor.with_delta(d["keys"], d["values"],
                                                **programs)

            new_predictor = self._build("delta", merge)
        self._install(version.extend(entry), new_predictor)
        _APPLIED.inc(kind="delta")

    def _build(self, kind: str, make):
        """``make()``'s predictor, its seconds split into the host part
        (merge or load) and the device upload it measured itself."""
        t0 = time.perf_counter()
        predictor = make()
        total = time.perf_counter() - t0
        upload = float(getattr(predictor, "upload_seconds", 0.0))
        self.last_apply.update(kind=kind, merge_s=total - upload,
                               upload_s=upload)
        return predictor

    def _install(self, version: ModelVersion, predictor,
                 feed_conf=None) -> None:
        """Commit to the registry, then swap into the live server — both
        atomic; the server-side swap is one pointer write under its
        registry lock (in-flight scores keep their pinned predictor)."""
        t0 = time.perf_counter()
        self.registry.commit(self.name, version, predictor)
        # a successful install proves the chain works again
        self._clear_degraded("sync_chain")
        lineage = version.lineage()
        if self.name in self.server.model_names():
            self.server.swap_model(self.name, predictor, version=lineage)
        else:
            if feed_conf is None and not hasattr(predictor, "search"):
                raise CheckpointCorrupt(
                    f"model {self.name!r} not registered and no feed "
                    "schema available to register it"
                )
            self.server.register_predictor(
                self.name, predictor, feed_conf, version=lineage
            )
        self.last_apply["swap_s"] = time.perf_counter() - t0
        # pbox-lint: ignore[thread-shared-state] monotonic int latch: a
        # stale read just delays one freshness confirmation poll
        self._applied_seq = version.seq
        # the apply-side half of the publish→apply lag record: pairs with
        # the publisher's "published" event by lineage/seq across
        # processes (pbox_doctor joins them into per-lineage lag)
        telemetry.emit_event(
            "sync_applied", model=self.name, seq=version.seq,
            tag=version.tag, lineage=version.lineage_id,
            published_at=version.published_at,
        )

    # -- fetch -------------------------------------------------------------- #
    def _fetch(self, entry: PublishEntry) -> str:
        """Download an entry dir into the local cache and verify its
        integrity manifest — which must EXIST: delivery artifacts are
        always published with one, so its absence is corruption here,
        not legacy."""
        dest = os.path.join(self.cache, entry.dir)
        t0 = time.perf_counter()

        def fetch_once():
            faults.inject("sync.fetch")
            if os.path.exists(dest):
                shutil.rmtree(dest)  # stale/partial cache: refetch whole
            self.fs.download(os.path.join(self.root, entry.dir), dest)
            if not os.path.exists(os.path.join(dest, "manifest.json")):
                raise CheckpointCorrupt(
                    f"{entry.dir}: published without an integrity manifest"
                )
            verify_checkpoint_dir(dest)

        retry_call(fetch_once, site="sync.fetch")
        self.last_apply = {"tag": entry.tag,
                           "fetch_s": time.perf_counter() - t0}
        return dest

    # -- fallback ladder ---------------------------------------------------- #
    def _full_reload(self, entries: List[PublishEntry]) -> None:
        """Rebuild from scratch: newest base that loads, plus every delta
        that chains onto it.  Applies as far as the chain verifies and
        keeps the result even when partial (still at least as fresh as
        before); when NO base loads, the last-good version keeps serving
        and the next poll retries."""
        _FULL_RELOAD.inc()
        # a fallback-ladder transition is a postmortem moment: dump the
        # flight ring NOW, while it still holds the chain-break/apply
        # failure history that got us here
        telemetry.dump_flight("sync_fallback", {
            "model": self.name, "root": self.root,
            "applied_seq": self._applied_seq,
            "entries": len(entries),
        })
        bases = [e for e in entries if e.kind == "base"]
        for base in reversed(bases):
            try:
                with _APPLY_SECONDS.time(kind="base"):
                    self._apply_base(base)
            except Exception as e:
                logger.warning("full reload: base %s unusable: %r",
                               base.tag, e)
                continue
            prev = base.tag
            seq = base.seq
            for d in entries:
                if d.seq <= base.seq or d.kind != "delta":
                    continue
                if d.base_tag != base.tag or d.prev_tag != prev \
                        or d.seq != seq + 1:
                    break  # chain ends here; anything later is unreachable
                try:
                    with _APPLY_SECONDS.time(kind="delta"):
                        self._apply_delta(d)
                except Exception as e:
                    logger.warning(
                        "full reload: delta %s unusable (%r); serving "
                        "chain up to %s", d.tag, e, prev,
                    )
                    break
                prev, seq = d.tag, d.seq
            return
        logger.error(
            "full reload found no loadable base under %s; keeping the "
            "last-good model", self.root,
        )
        _RELOAD_FAILED.inc()
        # the delta chain is broken AND no base loads: the pinned
        # last-good model keeps serving, but the replica must say so —
        # the router deprioritizes it until a reload lands
        telemetry.dump_flight("sync_last_good", {
            "model": self.name, "root": self.root,
            "applied_seq": self._applied_seq,
        })
        self._mark_degraded(
            "sync_chain", f"no loadable base under {self.root}")

    def rollback(self) -> ModelVersion:
        """Swap the previous registry version back into the live server
        (the operator rung of the fallback ladder).  Returns the restored
        version; LookupError when there is no previous version."""
        version, predictor = self.registry.rollback(self.name)
        self.server.swap_model(self.name, predictor,
                               version=version.lineage())
        self._applied_seq = version.seq
        return version

    # -- background agent ---------------------------------------------------- #
    def _tick_failed(self, exc: BaseException) -> None:
        """Per-tick failure bookkeeping: count, log, and — past the
        threshold — advertise degraded (the last-good model keeps
        serving; the router deprioritizes this replica)."""
        _POLL_ERRORS.inc()
        self._consecutive_poll_failures += 1
        logger.exception("sync poll failed (%d consecutive); retrying",
                         self._consecutive_poll_failures)
        if self._consecutive_poll_failures >= self.degraded_after_failures:
            self._mark_degraded(
                "sync",
                f"{self._consecutive_poll_failures} consecutive poll "
                f"failures; last: {exc!r}"[:200],
            )

    def _agent_loop(self) -> None:
        """The inner poll loop: one tick per interval, per-tick errors
        absorbed with exponential backoff (a publish root that is down
        for an hour must not be polled at full cadence for an hour)."""
        while not self._stop.is_set():
            try:
                self.poll_once()
                self._consecutive_poll_failures = 0
                self._clear_degraded("sync")
            except Exception as e:
                self._tick_failed(e)
            # consecutive failures stretch the next wait up to 16x
            wait = self.poll_interval_s * min(
                2 ** self._consecutive_poll_failures, 16)
            self._stop.wait(wait)

    def _agent(self) -> None:
        """Outer guard: NOTHING may kill the background sync thread
        silently.  An exception escaping the inner loop (including one
        raised by its own error handling) logs, counts
        ``sync.agent_restarts`` and restarts the loop with backoff —
        a replica whose syncer died would otherwise serve an ever-staler
        model while reporting nothing."""
        restarts = 0
        while not self._stop.is_set():
            try:
                self._agent_loop()
            except BaseException:
                if self._stop.is_set():
                    break
                restarts += 1
                _AGENT_RESTARTS.inc()
                logger.exception(
                    "sync agent loop died (restart %d); restarting",
                    restarts,
                )
                self._stop.wait(
                    min(self.poll_interval_s * min(2 ** restarts, 16), 30.0)
                )

    def start(self) -> None:
        """Run the poll loop on a daemon thread until stop()."""
        if self._thread is not None:
            raise RuntimeError("syncer already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._agent, name=f"model-syncer-{self.name}",
            daemon=True,
        )
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def wait_fresh(self, timeout_s: float = 60.0) -> bool:
        """Block until at least one version is live (serve.py's startup
        gate: the HTTP server cannot start with zero models)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.registry.current(self.name) is not None:
                return True
            if self._thread is None:
                self.poll_once()
                if self.registry.current(self.name) is not None:
                    return True
            time.sleep(min(1.0, self.poll_interval_s))
        return self.registry.current(self.name) is not None


def fleet_min_freshness(view: dict) -> dict:
    """Fleet-level freshness from a router ``fleet_view()`` payload: the
    minimum applied seq and maximum model age across SERVING (non-
    ejected) replicas — the number a rolling restart must hold above the
    staleness deadline before taking the next replica down.  Lives here,
    next to the Syncer that defines per-replica freshness, so the
    semantics cannot drift from the thing they aggregate.

    Returns ``{"min_seq", "max_age_seconds", "n_serving"}`` with None
    seq/age when no serving replica reports a model (a fleet of zero
    serving replicas is maximally stale — the caller must treat None as
    failing the freshness gate, not passing it)."""
    min_seq: Optional[int] = None
    max_age: Optional[float] = None
    n_serving = 0
    for r in view.get("replicas", []):
        if r.get("state") == "ejected":
            continue
        n_serving += 1
        for m in (r.get("models") or {}).values():
            seq = m.get("seq")
            age = m.get("age_seconds")
            if seq is not None:
                min_seq = seq if min_seq is None else min(min_seq, seq)
            if age is not None:
                max_age = age if max_age is None else max(max_age, age)
    return {"min_seq": min_seq, "max_age_seconds": max_age,
            "n_serving": n_serving}
