"""Trainer-side model publisher: base and delta model units to a root
(reference: paddlebox_tpu/serving_sync/publisher.py).

A :class:`Publisher` owns one publish root (a local path, or ``hdfs://`` /
``afs://`` through :func:`utils.fs.resolve_fs`) and ships:

  * ``publish_base(tag, ...)`` — a full serving artifact
    (:func:`inference.export.export_model`: the program ladder, the sparse
    snapshot, meta and feed schema);
  * ``publish_ann_base(tag, table, ...)`` — a retrieval scenario's ANN
    index (:func:`inference.ann.export_ann_index`) as the chain's base;
  * ``publish_delta(tag, table, model, params)`` — only the sparse rows
    touched since the last publish (``SparseTable.delta_state_dict``) and,
    given a model, its re-exported serving programs.

Every publish goes, in order: stage locally -> write a recursive integrity
manifest -> upload (retried, fault-injectable) -> read the remote copy
back and verify it -> append the donefile line and upload the donefile
last.  A consumer that follows the donefile never sees an entry whose
remote bytes are missing, torn or wrong; and the table's delta tracker is
cleared only once the entry is visible, so a failed publish ships the same
rows next time.

The files are the reference's: ``sparse_delta.npz`` holds the same arrays
under the same names (``keys`` and ``values``, or ``keys``, ``head``,
``embedx_q`` and ``scales``), ``delta.json`` the same keys; only the
programs differ (torch.export against StableHLO).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.checkpoint import verify_checkpoint_dir, write_manifest
from paddlebox_tpu_torch.serving_sync.registry import (
    DONEFILE_NAME,
    PublishEntry,
    parse_donefile,
)
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.fs import resolve_fs
from paddlebox_tpu_torch.utils.retry import retry_call

logger = logging.getLogger(__name__)

DELTA_META_NAME = "delta.json"
DELTA_ROWS_NAME = "sparse_delta.npz"

_PUBLISH_SECONDS = telemetry.histogram(
    "publish.publish_seconds",
    help="model publish wall time (s) by kind (base/delta)",
)
_PUBLISHED = telemetry.counter(
    "publish.published", help="published model units by kind"
)
_GATED = telemetry.counter(
    "publish.gated", help="publishes held back by the health gate"
)
_PUBLISH_BYTES = telemetry.counter(
    "publish.bytes",
    help="bytes uploaded per published model unit, by kind — the "
         "quantized-artifact byte win, observable at publish time",
)


def _dir_bytes(local: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(local):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


class PublishError(RuntimeError):
    pass


class Publisher:
    def __init__(
        self,
        publish_root: str,
        *,
        staging_dir: Optional[str] = None,
        fs=None,
        verify: bool = True,
        monitor=None,
    ):
        """monitor: an optional ``utils.fleet_util.ModelMonitor`` — when
        set and a publish passes ``metrics=...``, the publish is gated on
        ``monitor.should_publish(metrics)`` (the reference's
        check-before-push-to-serving discipline)."""
        self.root = publish_root
        self.fs = fs or resolve_fs(publish_root)
        self.verify = verify
        self.monitor = monitor
        self.staging = staging_dir or os.path.join(
            tempfile.gettempdir(), f"pbox-publish-{os.getpid()}"
        )
        os.makedirs(self.staging, exist_ok=True)
        self._donefile_local = os.path.join(self.staging, DONEFILE_NAME)
        self._export_kw: Optional[dict] = None  # remembered at publish_base
        self._entries = self._resume()

    # -- state -------------------------------------------------------------- #
    def _resume(self) -> list:
        """Adopt an existing publish root's donefile (restart safety: the
        sequence numbering and chain linkage continue, never restart)."""
        remote = os.path.join(self.root, DONEFILE_NAME)
        entries: list = []
        try:
            if self.fs.exists(remote):
                entries = parse_donefile(self.fs.cat(remote))
        except Exception as e:  # a fresh root is the common case
            logger.warning("publish root donefile unreadable (%s); "
                           "starting fresh", e)
        with open(self._donefile_local, "w") as fh:
            for e in entries:
                fh.write(e.to_json() + "\n")
        return entries

    @property
    def next_seq(self) -> int:
        return self._entries[-1].seq + 1 if self._entries else 0

    @property
    def last_tag(self) -> Optional[str]:
        return self._entries[-1].tag if self._entries else None

    @property
    def base_tag(self) -> Optional[str]:
        for e in reversed(self._entries):
            if e.kind == "base":
                return e.tag
        return None

    def entries(self) -> list:
        return list(self._entries)

    # -- gate --------------------------------------------------------------- #
    def _gated(self, metrics: Optional[dict]) -> bool:
        if metrics is None or self.monitor is None:
            return False
        if self.monitor.should_publish(metrics):
            return False
        _GATED.inc()
        logger.warning("publish gate held the model back")
        return True

    # -- publish ------------------------------------------------------------ #
    def publish_base(
        self,
        tag: str,
        model,
        params,
        table,
        *,
        batch_size: int,
        key_capacity: int,
        dense_dim: int,
        feed_conf=None,
        quantize: bool = False,
        embedding_dtype=None,
        rank_offset_cols: int = 0,
        batch_buckets=None,
        metrics: Optional[dict] = None,
        meta: Optional[dict] = None,
        lineage: Optional[str] = None,
    ) -> Optional[PublishEntry]:
        """Export + publish a full serving artifact; restarts the delta
        chain.  Returns the donefile entry, or None when the health gate
        held it back.

        model, params: the model holds its trained parameters (params None),
        or params is a state_dict loaded into a copy of it (a
        MultiChipTrainer's ``dense_state()[0]`` with its serial model).

        embedding_dtype ("fp32" | "int8" | "fp8"; None reads
        PADDLEBOX_TORCH_EMBEDDING_DTYPE): the artifact's quantized-embedding format
        (inference/quant.py).  It anchors the CHAIN's dtype: every delta
        published on this base ships rows in the same dtype, and a
        consumer refuses to merge a mismatched delta
        (EmbeddingDtypeMismatch → Syncer full reload), so a chain can
        never mix dtypes into a corrupt table.

        lineage: the producing pass/window identity (``pass12``, ``w3-7``)
        — carried through the donefile into the syncer's applied version
        and the ``/fleet`` freshness view, so a served score is
        attributable to the training window that produced it and
        ``pbox_doctor`` can report publish→apply lag per lineage."""
        if self._gated(metrics):
            return None
        meta = dict(meta or {})
        if lineage is not None:
            meta["lineage"] = str(lineage)
        from paddlebox_tpu_torch.inference.export import (
            export_model,
            resolve_embedding_dtype,
        )

        edtype = resolve_embedding_dtype(
            embedding_dtype, table.conf.row_width, table.conf.cvm_offset)
        with telemetry.span("publish.base", tag=tag), \
                _PUBLISH_SECONDS.time(kind="base"):
            local = os.path.join(self.staging, f"base-{tag}")
            if os.path.exists(local):
                shutil.rmtree(local)
            export_model(
                model, table, local,
                batch_size=batch_size, key_capacity=key_capacity,
                dense_dim=dense_dim, quantize=quantize,
                embedding_dtype=edtype,
                rank_offset_cols=rank_offset_cols,
                batch_buckets=batch_buckets, feed_conf=feed_conf,
                params=params,
            )
            write_manifest(local, "manifest.json", recursive=True)
            self._upload(local, f"base-{tag}", site="publish.upload",
                         kind="base")
            self._export_kw = {
                "batch_size": batch_size, "key_capacity": key_capacity,
                "dense_dim": dense_dim, "row_width": table.conf.row_width,
                "rank_offset_cols": rank_offset_cols,
                "batch_buckets": batch_buckets, "feed_conf": feed_conf,
                "embedding_dtype": edtype,
                "cvm_offset": table.conf.cvm_offset,
                "create_threshold": table.conf.create_threshold,
                "pull_embedx_scale": table.conf.pull_embedx_scale,
            }
            entry = PublishEntry(
                seq=self.next_seq, kind="base", tag=tag, dir=f"base-{tag}",
                base_tag=tag, prev_tag=self.last_tag,
                published_at=time.time(), n_rows=int(table.n_features),
                has_programs=True, embedding_dtype=edtype,
                n_bytes=_dir_bytes(local), meta=dict(meta or {}),
            )
            self._append_donefile(entry)
            # a new base anchors a fresh chain: rows tracked so far are
            # inside the full snapshot — clear only once the entry is
            # VISIBLE (donefile landed); any earlier and a failed publish
            # would drop rows from the chain
            table.clear_delta()
            _PUBLISHED.inc(kind="base")
            telemetry.emit_event(
                "published", kind="base", tag=tag, seq=entry.seq,
                lineage=meta.get("lineage"), n_rows=entry.n_rows,
            )
            return entry

    def publish_ann_base(
        self,
        tag: str,
        table,
        *,
        item_key_lo: int,
        item_key_hi: int,
        feed_conf=None,
        coarse_dtype: str = "int8",
        metrics: Optional[dict] = None,
        meta: Optional[dict] = None,
        lineage: Optional[str] = None,
    ) -> Optional[PublishEntry]:
        """Publish a retrieval scenario's ANN artifact as the chain's
        base (inference/ann.py: normalized item rows + int8 coarse
        tier).  Same discipline and donefile chain as publish_base —
        stage, manifest, verified upload, donefile LAST, delta tracker
        cleared only once visible — so subsequent ``publish_delta(tag,
        table)`` calls keep the index fresh: the syncer dispatches on
        ``meta.json["artifact_kind"]`` and merges delta rows through
        ``AnnIndex.with_delta`` (item-range keys update the index, the
        other scenarios' rows drop out).  The chain's embedding dtype is
        fp32: the index stores f32 vectors; int8 is a per-request
        scoring tier, not the transport dtype."""
        if self._gated(metrics):
            return None
        meta = dict(meta or {})
        if lineage is not None:
            meta["lineage"] = str(lineage)
        from paddlebox_tpu_torch.inference.ann import export_ann_index

        with telemetry.span("publish.ann", tag=tag), \
                _PUBLISH_SECONDS.time(kind="base"):
            local = os.path.join(self.staging, f"base-{tag}")
            if os.path.exists(local):
                shutil.rmtree(local)
            idx = export_ann_index(
                local, table,
                item_key_lo=item_key_lo, item_key_hi=item_key_hi,
                coarse_dtype=coarse_dtype, feed_conf=feed_conf,
                device=getattr(table, "device", "cuda"),
                meta={k: v for k, v in meta.items()
                      if k in ("scenario", "lineage")},
            )
            write_manifest(local, "manifest.json", recursive=True)
            self._upload(local, f"base-{tag}", site="publish.upload",
                         kind="base")
            # remember the delta-export shape: an ANN chain's deltas are
            # rows-only (no re-frozen programs), fp32 transport
            self._export_kw = {
                "row_width": table.conf.row_width,
                "embedding_dtype": "fp32",
                "cvm_offset": table.conf.cvm_offset,
                "create_threshold": table.conf.create_threshold,
                "pull_embedx_scale": table.conf.pull_embedx_scale,
                "feed_conf": feed_conf,
            }
            entry = PublishEntry(
                seq=self.next_seq, kind="base", tag=tag, dir=f"base-{tag}",
                base_tag=tag, prev_tag=self.last_tag,
                published_at=time.time(), n_rows=int(idx.n_items),
                has_programs=False, embedding_dtype="fp32",
                n_bytes=_dir_bytes(local),
                meta={**meta, "artifact_kind": "ann"},
            )
            self._append_donefile(entry)
            table.clear_delta()
            _PUBLISHED.inc(kind="base")
            telemetry.emit_event(
                "published", kind="base", tag=tag, seq=entry.seq,
                lineage=meta.get("lineage"), n_rows=entry.n_rows,
                scenario=meta.get("scenario"),
            )
            return entry

    def publish_delta(
        self,
        tag: str,
        table,
        model=None,
        params=None,
        *,
        metrics: Optional[dict] = None,
        meta: Optional[dict] = None,
        lineage: Optional[str] = None,
        **export_overrides,
    ) -> Optional[PublishEntry]:
        """Publish the rows touched since the last publish, plus (given a
        model, and optionally its params as in publish_base) re-exported
        serving programs so dense updates ship too.  The export shapes default to the ones remembered from this
        publisher's publish_base; pass overrides to change them.

        The delta tracker is only cleared after the verified upload and
        donefile append — a failed publish leaves the rows tracked, and
        the next publish ships them again (at-least-once delivery of
        every touched row).

        Delta rows ship in the CHAIN's embedding dtype (the base entry's
        ``embedding_dtype``): a quantized chain publishes per-row-scale
        quantized rows (head + embedx_q + scales — the multi-TB path
        shrinks ~4x), never f32 rows a consumer would refuse to merge.

        lineage: producing pass/window identity (see publish_base)."""
        if self._gated(metrics):
            return None
        meta = dict(meta or {})
        if lineage is not None:
            meta["lineage"] = str(lineage)
        if self.base_tag is None:
            raise PublishError(
                "publish_base first: a delta chain needs a base anchor"
            )
        with_programs = model is not None
        if with_programs:
            if self._export_kw is None and not export_overrides:
                raise PublishError(
                    "no export shapes on record (publisher resumed without "
                    "a publish_base): pass batch_size/key_capacity/"
                    "dense_dim explicitly"
                )
        kw = {**(self._export_kw or {}), **export_overrides}
        edtype = kw.get("embedding_dtype") or self._chain_dtype()
        with telemetry.span("publish.delta", tag=tag), \
                _PUBLISH_SECONDS.time(kind="delta"):
            from paddlebox_tpu_torch.inference import quant
            from paddlebox_tpu_torch.inference.export import (
                export_serving_programs,
            )

            state = table.delta_state_dict()
            w = table.conf.row_width
            co = table.conf.cvm_offset
            keys = np.asarray(state["keys"], dtype=np.uint64)
            values = np.asarray(state["values"], dtype=np.float32)[:, :w]
            local = os.path.join(self.staging, f"delta-{tag}")
            if os.path.exists(local):
                shutil.rmtree(local)
            os.makedirs(local)
            if edtype != "fp32":
                # quantize row-wise with the shared codec: a delta row's
                # bytes are identical to the same row in a full export,
                # so base + deltas == fresh full export stays bit-exact
                head, q, scales = quant.quantize_rows(values, co, edtype)
                np.savez(os.path.join(local, DELTA_ROWS_NAME),
                         keys=keys, head=head, embedx_q=q,
                         scales=scales)
            else:
                np.savez(os.path.join(local, DELTA_ROWS_NAME),
                         keys=keys, values=values)
            buckets = []
            if with_programs:
                buckets = export_serving_programs(
                    model, local, params=params,
                    batch_size=kw["batch_size"],
                    key_capacity=kw["key_capacity"],
                    dense_dim=kw["dense_dim"],
                    row_width=kw.get("row_width", w),
                    rank_offset_cols=kw.get("rank_offset_cols", 0),
                    batch_buckets=kw.get("batch_buckets"),
                    feed_conf=kw.get("feed_conf"),
                    embedding_dtype=edtype,
                    cvm_offset=kw.get("cvm_offset", co),
                    create_threshold=kw.get(
                        "create_threshold", table.conf.create_threshold),
                    pull_embedx_scale=kw.get(
                        "pull_embedx_scale", table.conf.pull_embedx_scale),
                )
            entry = PublishEntry(
                seq=self.next_seq, kind="delta", tag=tag,
                dir=f"delta-{tag}", base_tag=self.base_tag,
                prev_tag=self.last_tag, published_at=time.time(),
                n_rows=int(keys.shape[0]), has_programs=bool(buckets),
                embedding_dtype=edtype, meta=dict(meta or {}),
            )
            with open(os.path.join(local, DELTA_META_NAME), "w") as fh:
                json.dump({
                    "kind": "delta", "tag": tag, "seq": entry.seq,
                    "base_tag": entry.base_tag, "prev_tag": entry.prev_tag,
                    "row_width": w, "n_rows": entry.n_rows,
                    "embedding_dtype": edtype,
                    "buckets": buckets, "published_at": entry.published_at,
                }, fh)
            write_manifest(local, "manifest.json", recursive=True)
            entry = dataclasses.replace(entry, n_bytes=_dir_bytes(local))
            self._upload(local, f"delta-{tag}", site="publish.delta",
                         kind="delta")
            self._append_donefile(entry)
            table.clear_delta()  # only once the entry is visible
            _PUBLISHED.inc(kind="delta")
            telemetry.emit_event(
                "published", kind="delta", tag=tag, seq=entry.seq,
                lineage=meta.get("lineage"), n_rows=entry.n_rows,
            )
            return entry

    def _chain_dtype(self) -> str:
        """The live chain's embedding dtype: the newest base entry's.
        A resumed publisher (no publish_base this process) reads it off
        the donefile so its deltas keep matching the chain."""
        for e in reversed(self._entries):
            if e.kind == "base":
                return getattr(e, "embedding_dtype", "fp32") or "fp32"
        return "fp32"

    # -- transport ---------------------------------------------------------- #
    def _upload(self, local: str, basename: str, site: str,
                kind: str = "base") -> None:
        dest = os.path.join(self.root, basename)
        retry_call(self.fs.mkdir, self.root, site="publish.mkdir")

        def upload_once():
            faults.inject(site)
            self.fs.upload(local, dest)
            if self.verify:
                # re-read THROUGH the remote fs: a partial/corrupt upload
                # fails this attempt and the retry re-uploads
                verify_checkpoint_dir(dest, fs=self.fs)

        retry_call(upload_once, site=site)
        # counted only after the verified upload: publish.bytes describes
        # bytes that actually LANDED, so the fp32-vs-quantized byte win
        # reads straight off the counter
        _PUBLISH_BYTES.inc(_dir_bytes(local), kind=kind)

    def _append_donefile(self, entry: PublishEntry) -> None:
        """Append locally, then upload the whole donefile — LAST, after
        the entry's data landed and verified (fleet_util's
        write_model_donefile discipline)."""
        with open(self._donefile_local, "a") as fh:
            fh.write(entry.to_json() + "\n")

        def upload_donefile():
            faults.inject("publish.donefile")
            self.fs.upload(
                self._donefile_local, os.path.join(self.root, DONEFILE_NAME)
            )

        try:
            retry_call(upload_donefile, site="publish.donefile")
        except BaseException:
            # the donefile never landed: un-append so local state mirrors
            # what consumers can actually see
            with open(self._donefile_local) as fh:
                lines = fh.readlines()
            with open(self._donefile_local, "w") as fh:
                fh.writelines(lines[:-1])
            raise
        self._entries.append(entry)
