"""Crash-consistent log-structured cold tier, the durable floor under the
sparse table (reference: paddlebox_tpu/sparse/logstore.py; segment and
manifest files are byte-compatible with it, so a directory written by either
package opens in the other).

The warm tier (``BucketStore``) is RAM with an LRU spill: a process death
loses everything since the last checkpoint.  This is the durability
boundary: an append-only, per-bucket, segment-file log whose committed state
survives a kill at any byte, plus the manifest-generation chain that makes
checkpoints incremental (a compacted base plus per-pass delta segments).

On-disk layout (one directory per store)::

    root/
      seg-<seq:08d>-b<bucket:03d>.seg   append-only segment files
      manifest-<gen:08d>.json           committed segment set for gen
      CURRENT                           name of the live manifest (LAST)

Crash-consistency rules:

  * Segment files are append-only and become durable ONLY by being
    referenced from a committed manifest.  A torn tail, a half-written
    file, a sealed but uncommitted segment are orphans: recovery ignores
    them, and nothing is lost because nothing referenced them.
  * A manifest commit is write-temp -> fsync -> rename of
    ``manifest-<gen>.json``, then the same for ``CURRENT``: CURRENT last.  A
    crash between the two leaves CURRENT at the old generation; the new
    manifest is an orphan and the store recovers the previous commit.
  * Compaction writes its merged output as a NEW sealed segment, commits a
    manifest that swaps it in, and only then unlinks the replaced files.
    Killed mid-compaction, the output is an orphan and the old segments
    still carry the state.

Segment format: a magic header, then checksummed blocks, each::

    u32 header_len | header json | key_bytes | row_bytes

where the json header carries row and column counts, the byte length of
each payload half, their crc32 and the block's min and max key;
``key_bytes`` is the sorted-delta varint stream of utils/keycodec.py and
``row_bytes`` the float32 row matrix.  Reading a segment verifies every
block: for orphans a torn tail truncates to the valid prefix, for
manifest-referenced segments (whose exact size and crc the manifest pins)
any mismatch is corruption.

Lookups never scan: every committed segment carries a bloom filter and a
min-max key range in the manifest, so a census resolve rejects keys that are
on no segment without touching disk (``might_contain``), and ``lookup``
reads only segments that may hold a still-unfound key, newest first.

Telemetry (the reference's names): the commit and compaction latency
histograms, the compaction counter and the live-segment gauge.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.sparse.store import splitmix64
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.keycodec import (
    KeyCodecError,
    decode_sorted_u64,
    encode_sorted_u64,
)
from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)

_COMMIT_SECONDS = telemetry.histogram(
    "store.log_commit_seconds", "manifest commit latency (fsync + rename x2)"
)
_COMPACT_SECONDS = telemetry.histogram(
    "store.compact_seconds", "per-bucket compaction latency (merge + commit)"
)
_COMPACTIONS = telemetry.counter(
    "store.log_compactions", "bucket compactions committed"
)
_LIVE_SEGMENTS = telemetry.gauge(
    "store.log_live_segments", "committed segment files across all buckets"
)

_MAGIC = b"PBLOG1\x00\n"
_EMPTY_KEYS = np.empty(0, dtype=np.uint64)

class LogStoreCorrupt(RuntimeError):
    """A manifest-referenced segment failed verification — committed state
    is damaged (distinct from orphan/torn files, which recovery ignores)."""


# --------------------------------------------------------------------------- #
# bloom filter (per-segment membership summary, stored hex in the manifest)
# --------------------------------------------------------------------------- #
_BLOOM_SALTS = tuple(
    np.uint64(s)
    for s in (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x27D4EB2F165667C5)
)


class BloomFilter:
    """Fixed-size bloom over uint64 keys: 4 splitmix64-derived probes,
    ~10 bits/key (<1% false positives) — small enough to ride the manifest
    as hex, so membership tests never open the segment file."""

    def __init__(self, bits: np.ndarray):
        self._bits = np.ascontiguousarray(bits, dtype=np.uint8)
        self.n_bits = int(self._bits.shape[0]) * 8

    @classmethod
    def build(cls, keys: np.ndarray, bits_per_key: int = 10) -> "BloomFilter":
        n = max(int(keys.shape[0]), 1)
        n_bytes = max((n * bits_per_key + 7) // 8, 8)
        bits = np.zeros(n_bytes, dtype=np.uint8)
        bf = cls(bits)
        if keys.shape[0]:
            for idx in bf._probes(np.asarray(keys, dtype=np.uint64)):
                np.bitwise_or.at(bits, idx >> 3, np.uint8(1) << (idx & 7).astype(np.uint8))
        return bf

    def _probes(self, q: np.ndarray):
        nb = np.uint64(self.n_bits)
        with np.errstate(over="ignore"):
            for salt in _BLOOM_SALTS:
                yield (splitmix64(q * salt + salt) % nb).astype(np.int64)

    def might_contain(self, q: np.ndarray) -> np.ndarray:
        """Bool per key: False means DEFINITELY absent from this segment."""
        q = np.asarray(q, dtype=np.uint64)
        out = np.ones(q.shape[0], dtype=bool)
        for idx in self._probes(q):
            out &= (self._bits[idx >> 3] >> (idx & 7).astype(np.uint8)) & 1 > 0
        return out

    def to_hex(self) -> str:
        return self._bits.tobytes().hex()

    @classmethod
    def from_hex(cls, s: str) -> "BloomFilter":
        return cls(np.frombuffer(bytes.fromhex(s), dtype=np.uint8))


# --------------------------------------------------------------------------- #
# segment files
# --------------------------------------------------------------------------- #
@dataclass
class SegmentInfo:
    """Manifest row for one committed segment."""

    name: str
    bucket: int
    seq: int
    n_rows: int
    n_cols: int
    min_key: int
    max_key: int
    n_bytes: int  # exact file size the manifest pins
    crc: int  # crc32 over the whole file
    bloom_hex: str

    def to_json(self) -> dict:
        return {
            "name": self.name, "bucket": self.bucket, "seq": self.seq,
            "n_rows": self.n_rows, "n_cols": self.n_cols,
            "min_key": str(self.min_key), "max_key": str(self.max_key),
            "n_bytes": self.n_bytes, "crc": self.crc,
            "bloom": self.bloom_hex,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SegmentInfo":
        return cls(
            name=d["name"], bucket=int(d["bucket"]), seq=int(d["seq"]),
            n_rows=int(d["n_rows"]), n_cols=int(d["n_cols"]),
            min_key=int(d["min_key"]), max_key=int(d["max_key"]),
            n_bytes=int(d["n_bytes"]), crc=int(d["crc"]),
            bloom_hex=d["bloom"],
        )

    def bloom(self) -> BloomFilter:
        return BloomFilter.from_hex(self.bloom_hex)


class SegmentWriter:
    """One segment file, typestate-enforced: open -> append* -> seal (or
    abort).  An unsealed segment must never be read and never reach a
    manifest; the methods raise on misuse."""

    def __init__(self, root: str, bucket: int, seq: int):
        self.name = f"seg-{seq:08d}-b{bucket:03d}.seg"
        self.path = os.path.join(root, self.name)
        self.bucket = bucket
        self.seq = seq
        self._state = "open"
        self._fh = open(self.path, "wb")
        self._fh.write(_MAGIC)
        self._crc = zlib.crc32(_MAGIC)
        self._n_bytes = len(_MAGIC)
        self._n_rows = 0
        self._n_cols: Optional[int] = None
        self._min_key: Optional[int] = None
        self._max_key: Optional[int] = None
        self._keys: List[np.ndarray] = []

    @property
    def state(self) -> str:
        return self._state

    def _require(self, want: str, op: str) -> None:
        if self._state != want:
            raise RuntimeError(
                f"segment {self.name}: {op}() in state {self._state!r} "
                f"(requires {want!r})"
            )

    def append(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Append one checksummed block of sorted-unique keys + rows."""
        self._require("open", "append")
        faults.inject("store.segment_write")
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        if keys.shape[0] == 0:
            return
        if vals.shape[0] != keys.shape[0]:
            raise ValueError(
                f"segment {self.name}: {keys.shape[0]} keys vs "
                f"{vals.shape[0]} rows"
            )
        if self._n_cols is None:
            self._n_cols = int(vals.shape[1])
        elif int(vals.shape[1]) != self._n_cols:
            raise ValueError(
                f"segment {self.name}: row width changed "
                f"{self._n_cols} -> {vals.shape[1]}"
            )
        key_bytes = encode_sorted_u64(keys)  # raises on unsorted input
        row_bytes = vals.tobytes()
        header = json.dumps({
            "n_rows": int(keys.shape[0]),
            "n_cols": int(vals.shape[1]),
            "kb": len(key_bytes),
            "rb": len(row_bytes),
            "crc": zlib.crc32(row_bytes, zlib.crc32(key_bytes)),
            "min_key": str(int(keys[0])),
            "max_key": str(int(keys[-1])),
        }).encode("utf-8")
        block = (
            len(header).to_bytes(4, "little") + header + key_bytes + row_bytes
        )
        self._fh.write(block)
        self._crc = zlib.crc32(block, self._crc)
        self._n_bytes += len(block)
        self._n_rows += int(keys.shape[0])
        lo, hi = int(keys[0]), int(keys[-1])
        self._min_key = lo if self._min_key is None else min(self._min_key, lo)
        self._max_key = hi if self._max_key is None else max(self._max_key, hi)
        self._keys.append(keys)

    def seal(self) -> SegmentInfo:
        """fsync + close; returns the manifest row.  Only sealed segments
        may be committed or read."""
        self._require("open", "seal")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._state = "sealed"
        all_keys = (
            np.concatenate(self._keys) if self._keys else _EMPTY_KEYS
        )
        self._info = SegmentInfo(
            name=self.name, bucket=self.bucket, seq=self.seq,
            n_rows=self._n_rows, n_cols=self._n_cols or 0,
            min_key=self._min_key if self._min_key is not None else 0,
            max_key=self._max_key if self._max_key is not None else 0,
            n_bytes=self._n_bytes, crc=self._crc,
            bloom_hex=BloomFilter.build(all_keys).to_hex(),
        )
        return self._info

    def info(self) -> SegmentInfo:
        self._require("sealed", "info")
        return self._info

    def abort(self) -> None:
        """Close and unlink a never-committed segment (error path)."""
        if self._state == "aborted":
            return
        try:
            self._fh.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
        self._state = "aborted"


def read_segment(
    path: str,
    expect_bytes: Optional[int] = None,
    expect_crc: Optional[int] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Decode a segment into its (keys, rows) blocks, oldest first.

    Two verification regimes:

      * manifest-referenced (``expect_bytes``/``expect_crc`` given): the
        file must match the committed size and crc exactly — any mismatch,
        torn tail, or framing error raises :class:`LogStoreCorrupt`.
      * orphan scan (no expectation): a torn tail — truncated header,
        short payload, or a block whose crc fails — ends the decode at the
        last valid block (the recoverable prefix).  Bytes after a bad
        block are unreachable by construction.
    """
    strict = expect_bytes is not None or expect_crc is not None
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        if strict:
            raise LogStoreCorrupt(f"segment {path}: unreadable: {e}") from e
        return []
    if strict:
        if expect_bytes is not None and len(data) != expect_bytes:
            raise LogStoreCorrupt(
                f"segment {path}: size {len(data)} != committed {expect_bytes}"
            )
        if expect_crc is not None and zlib.crc32(data) != expect_crc:
            raise LogStoreCorrupt(f"segment {path}: file crc mismatch")
    if not data.startswith(_MAGIC):
        if strict:
            raise LogStoreCorrupt(f"segment {path}: bad magic")
        return []
    blocks: List[Tuple[np.ndarray, np.ndarray]] = []
    off = len(_MAGIC)
    n = len(data)
    while off < n:
        tear = f"segment {path}: torn/corrupt block at byte {off}"
        if off + 4 > n:
            if strict:
                raise LogStoreCorrupt(tear)
            break
        hlen = int.from_bytes(data[off : off + 4], "little")
        try:
            if off + 4 + hlen > n:
                raise ValueError("truncated header")
            hdr = json.loads(data[off + 4 : off + 4 + hlen])
            kb, rb = int(hdr["kb"]), int(hdr["rb"])
            body = off + 4 + hlen
            if body + kb + rb > n:
                raise ValueError("truncated payload")
            key_bytes = data[body : body + kb]
            row_bytes = data[body + kb : body + kb + rb]
            if zlib.crc32(row_bytes, zlib.crc32(key_bytes)) != int(hdr["crc"]):
                raise ValueError("block crc mismatch")
            keys = decode_sorted_u64(key_bytes)
            if keys.shape[0] != int(hdr["n_rows"]):
                raise ValueError("key count mismatch")
            rows = np.frombuffer(row_bytes, dtype=np.float32)
            rows = rows.reshape(int(hdr["n_rows"]), int(hdr["n_cols"])).copy()
        except (ValueError, KeyError, TypeError, KeyCodecError) as e:
            if strict:
                raise LogStoreCorrupt(f"{tear}: {e}") from e
            break
        blocks.append((keys, rows))
        off = body + kb + rb
    return blocks


def _merge_newest_wins(
    parts: List[Tuple[np.ndarray, np.ndarray]], n_cols: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge (keys, rows) parts ordered oldest -> newest into one sorted
    key array where the newest occurrence of a duplicate key wins."""
    parts = [p for p in parts if p[0].shape[0]]
    if not parts:
        return _EMPTY_KEYS, np.empty((0, n_cols), dtype=np.float32)
    keys = np.concatenate([p[0] for p in parts])
    vals = np.concatenate([p[1] for p in parts])
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    uniq, last_idx = np.unique(keys[::-1], return_index=True)
    if uniq.shape[0] != keys.shape[0]:
        take = keys.shape[0] - 1 - last_idx  # last (= newest) wins
        return uniq, vals[take]
    return keys, vals


# --------------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------------- #
class LogStore:
    """Append-only per-bucket segment log with an atomically-committed
    manifest chain.  All mutation (append / commit / compact / rewrite)
    is serialized under one lock — appends are pass-boundary events, not
    hot-loop ones, and the lock is what lets background compaction share
    the store with the write-back worker.

    ``keep_history=True`` (the incremental-checkpoint container) preserves
    replaced segments and old manifests so any committed generation stays
    materializable (``materialize_at``); the live table log uses
    ``keep_history=False`` and unlinks replaced files at swap."""

    def __init__(
        self,
        root: str,
        n_cols: Optional[int] = None,
        n_buckets: int = 8,
        compact_threshold: int = 8,
        max_cached_segments: int = 16,
        keep_history: bool = False,
    ):
        if n_buckets & (n_buckets - 1) or n_buckets <= 0:
            raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
        self.root = root
        self.compact_threshold = max(int(compact_threshold), 2)
        self.keep_history = bool(keep_history)
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self._cache: "OrderedDict[str, List[Tuple[np.ndarray, np.ndarray]]]" = OrderedDict()
        self._max_cached = max(int(max_cached_segments), 1)
        current = self._read_current()
        if current is not None:
            man = self._read_manifest(current)
            self.gen = int(man["gen"])
            self.n_cols = int(man["n_cols"])
            self.n_buckets = int(man["n_buckets"])
            if n_cols is not None and n_cols != self.n_cols:
                raise ValueError(
                    f"logstore {root}: n_cols {n_cols} != committed {self.n_cols}"
                )
            if n_buckets != self.n_buckets:
                logger.info(
                    "logstore %s: using committed n_buckets=%d (requested %d)",
                    root, self.n_buckets, n_buckets,
                )
            self._live: List[List[SegmentInfo]] = [
                [] for _ in range(self.n_buckets)
            ]
            for d in man["segments"]:
                info = SegmentInfo.from_json(d)
                self._live[info.bucket].append(info)
            for segs in self._live:
                segs.sort(key=lambda s: s.seq)
            self._seq = int(man.get("seq", 0))
        else:
            if n_cols is None:
                raise ValueError(
                    f"logstore {root}: empty store needs an explicit n_cols"
                )
            self.gen = 0
            self.n_cols = int(n_cols)
            self.n_buckets = n_buckets
            self._live = [[] for _ in range(self.n_buckets)]
            self._seq = 0
        # never reuse a sequence number an orphan file already claims
        self._seq = max(self._seq, self._max_disk_seq() + 1)
        self._shift = np.uint64(64 - (self.n_buckets.bit_length() - 1))
        self._pending: List[SegmentInfo] = []
        self._update_gauges()

    # -- paths / manifest io ------------------------------------------------- #
    def _current_path(self) -> str:
        return os.path.join(self.root, "CURRENT")

    def _manifest_path(self, gen: int) -> str:
        return os.path.join(self.root, f"manifest-{gen:08d}.json")

    def _read_current(self) -> Optional[str]:
        try:
            with open(self._current_path()) as fh:
                name = fh.read().strip()
        except OSError:
            return None
        return name or None

    def _read_manifest(self, name: str) -> dict:
        path = os.path.join(self.root, name)
        try:
            with open(path) as fh:
                man = json.load(fh)
        except (OSError, ValueError) as e:
            raise LogStoreCorrupt(
                f"logstore {self.root}: CURRENT manifest {name} unreadable: {e}"
            ) from e
        if int(man.get("version", -1)) != 1:
            raise LogStoreCorrupt(
                f"logstore {self.root}: manifest {name} has unsupported "
                f"version {man.get('version')!r}"
            )
        return man

    def _max_disk_seq(self) -> int:
        hi = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return hi
        for nm in names:
            if nm.startswith("seg-") and nm.endswith(".seg"):
                try:
                    hi = max(hi, int(nm[4:12]))
                except ValueError:
                    continue
        return hi

    def _atomic_write(self, path: str, payload: bytes) -> None:
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    # -- observability ------------------------------------------------------- #
    def _update_gauges(self) -> None:
        _LIVE_SEGMENTS.set(sum(len(s) for s in self._live))

    @property
    def n_live_segments(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._live)

    @property
    def n_rows_upper(self) -> int:
        """Committed row count UPPER bound (duplicate keys across segments
        count once per segment until compaction merges them)."""
        with self._lock:
            return sum(i.n_rows for segs in self._live for i in segs)

    # -- write path ---------------------------------------------------------- #
    def _bucket_of(self, q: np.ndarray) -> np.ndarray:
        if self.n_buckets == 1:
            # shift-by-64 is undefined for uint64 (x86 leaves the value
            # unchanged): one bucket means every key maps to bucket 0
            return np.zeros(q.shape[0], dtype=np.int64)
        return (splitmix64(q) >> self._shift).astype(np.int64)

    def append(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Stage one sorted-unique batch as sealed (uncommitted) segments,
        one per touched bucket.  Durable only after :meth:`commit`; an
        exception mid-append aborts cleanly (partial segments unlinked,
        committed state untouched)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        if keys.shape[0] == 0:
            return
        if vals.ndim != 2 or int(vals.shape[1]) != self.n_cols:
            raise ValueError(
                f"logstore {self.root}: rows must be [n, {self.n_cols}], "
                f"got {vals.shape}"
            )
        with self._lock:
            bids = self._bucket_of(keys)
            order = np.argsort(bids, kind="stable")
            sb = bids[order]
            ub, starts = np.unique(sb, return_index=True)
            bounds = np.append(starts, keys.shape[0])
            staged: List[SegmentInfo] = []
            writer: Optional[SegmentWriter] = None
            try:
                for j in range(ub.shape[0]):
                    idx = order[starts[j] : bounds[j + 1]]
                    writer = SegmentWriter(self.root, int(ub[j]), self._seq)
                    self._seq += 1
                    writer.append(keys[idx], vals[idx])
                    staged.append(writer.seal())
                    writer = None
            except BaseException:
                if writer is not None:
                    writer.abort()
                for info in staged:
                    self._unlink(info.name)
                raise
            self._pending.extend(staged)

    def commit(self) -> int:
        """Atomically commit every staged segment; returns the new (or
        unchanged, if nothing was staged) generation."""
        with self._lock:
            if not self._pending:
                return self.gen
            with _COMMIT_SECONDS.time():
                new_live = [list(s) for s in self._live]
                for info in self._pending:
                    new_live[info.bucket].append(info)
                self._commit_manifest(new_live)
                self._live = new_live
                self._pending = []
                self._update_gauges()
            return self.gen

    def _commit_manifest(self, live: List[List[SegmentInfo]]) -> int:
        """Write manifest-<gen+1> (temp/fsync/rename), then swing CURRENT
        (temp/fsync/rename) — CURRENT-LAST.  A crash or injected fault
        between the two leaves the store at the old generation with an
        orphan manifest; a retry simply rewrites it."""
        target = self.gen + 1
        man = {
            "version": 1,
            "gen": target,
            "n_cols": self.n_cols,
            "n_buckets": self.n_buckets,
            "seq": self._seq,
            "segments": [i.to_json() for segs in live for i in segs],
        }
        payload = json.dumps(man, indent=1).encode("utf-8")
        self._atomic_write(self._manifest_path(target), payload)
        # the commit point is the CURRENT swing below; a kill/fault here
        # leaves an orphan manifest and the OLD generation live
        faults.inject("store.manifest_commit")
        self._atomic_write(
            self._current_path(),
            f"manifest-{target:08d}.json\n".encode("utf-8"),
        )
        self.gen = target
        if not self.keep_history:
            # a no-history store needs only the committed manifest; sweep
            # here (every commit point) so long runs of per-merge-batch
            # commits can't accumulate manifest files
            self._drop_old_manifests()
        return target

    def rewrite(self, keys: np.ndarray, vals: np.ndarray) -> int:
        """Replace the committed content with exactly (keys, vals) in one
        generation: fresh compacted segments, a manifest referencing only
        them.  Discards staged-but-uncommitted appends (the caller holds
        the full state).  Used by checkpoint save_base, load_state_dict,
        and shrink."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        with self._lock:
            for info in self._pending:
                self._unlink(info.name)
            self._pending = []
            old = [i for segs in self._live for i in segs]
            self.append(keys, vals)
            new_live: List[List[SegmentInfo]] = [
                [] for _ in range(self.n_buckets)
            ]
            for info in self._pending:
                new_live[info.bucket].append(info)
            try:
                self._commit_manifest(new_live)
            except BaseException:
                for info in self._pending:
                    self._unlink(info.name)
                self._pending = []
                raise
            self._live = new_live
            self._pending = []
            if not self.keep_history:
                for info in old:
                    self._unlink(info.name)
            self._update_gauges()
            return self.gen

    def _unlink(self, name: str) -> None:
        self._cache.pop(name, None)
        try:
            os.unlink(os.path.join(self.root, name))
        except OSError:
            pass

    def _drop_old_manifests(self) -> None:
        """Unlink every manifest below the committed generation (orphans
        ABOVE it — a crash between manifest write and CURRENT swing —
        are left for the retry to overwrite)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if not (name.startswith("manifest-") and name.endswith(".json")):
                continue
            try:
                g = int(name[len("manifest-"):-len(".json")])
            except ValueError:
                continue
            if g < self.gen:
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass

    # -- compaction ---------------------------------------------------------- #
    def buckets_over_threshold(self) -> List[int]:
        with self._lock:
            return [
                b for b in range(self.n_buckets)
                if len(self._live[b]) >= self.compact_threshold
            ]

    def _compact_write(self, bucket: int) -> Optional[SegmentInfo]:
        """Stage the newest-wins merge of a bucket as one sealed segment.
        Pure staging: committed state untouched until ``_commit_manifest``."""
        segs = self._live[bucket]
        if len(segs) < 2:
            return None
        merged_k, merged_v = _merge_newest_wins(
            [blk for i in segs for blk in self._read_committed(i)], self.n_cols
        )
        writer = SegmentWriter(self.root, bucket, self._seq)
        self._seq += 1
        try:
            writer.append(merged_k, merged_v)
            return writer.seal()
        except BaseException:
            writer.abort()
            raise

    def _swap_segments(
        self, bucket: int, new: List[SegmentInfo], old: List[SegmentInfo]
    ) -> None:
        """Point the in-RAM live set at the committed swap and retire the
        replaced files.  Only legal AFTER the manifest committed — enforced
        by ``compact``."""
        self._live[bucket] = list(new)
        if not self.keep_history:
            for info in old:
                self._unlink(info.name)
        self._update_gauges()

    def compact(self, bucket: Optional[int] = None) -> int:
        """Compact one bucket (or every bucket over threshold) to a single
        newest-wins segment.  Crash/fault at any point leaves the old
        segments live: the staged output only becomes real at manifest
        commit, and files are only unlinked after the swap."""
        with self._lock:
            targets = (
                [bucket] if bucket is not None
                else self.buckets_over_threshold()
            )
            done = 0
            for b in targets:
                old = list(self._live[b])
                with _COMPACT_SECONDS.time():
                    staged = self._compact_write(b)
                    if staged is None:
                        continue
                    try:
                        faults.inject("store.compact")
                        # staged appends stay uncommitted: the swap
                        # manifest carries the live set with this bucket
                        # replaced
                        new_live = [list(s) for s in self._live]
                        new_live[b] = [staged]
                        self._commit_manifest(new_live)
                    except BaseException:
                        # abort: drop the staged orphan, keep the old
                        # segments
                        self._unlink(staged.name)
                        raise
                    self._swap_segments(b, [staged], old)
                _COMPACTIONS.inc()
                done += 1
            return done

    # -- read path ----------------------------------------------------------- #
    def _read_committed(
        self, info: SegmentInfo
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        blocks = self._cache.get(info.name)
        if blocks is None:
            blocks = read_segment(
                os.path.join(self.root, info.name),
                expect_bytes=info.n_bytes,
                expect_crc=info.crc,
            )
            self._cache[info.name] = blocks
            while len(self._cache) > self._max_cached:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(info.name)
        return blocks

    def might_contain(self, q: np.ndarray) -> np.ndarray:
        """Bool per sorted key: False = provably on NO committed or staged
        segment (min-max range + bloom), without touching disk.  The census
        resolve fast-path: absent keys init fresh with zero reads."""
        q = np.asarray(q, dtype=np.uint64)
        out = np.zeros(q.shape[0], dtype=bool)
        if q.shape[0] == 0:
            return out
        with self._lock:
            bids = self._bucket_of(q)
            for b in np.unique(bids):
                idx = np.nonzero(bids == b)[0]
                sub = q[idx]
                maybe = np.zeros(sub.shape[0], dtype=bool)
                for info in self._live[int(b)] + [
                    i for i in self._pending if i.bucket == int(b)
                ]:
                    rest = ~maybe
                    if not rest.any():
                        break
                    cand = sub[rest]
                    in_range = (cand >= np.uint64(info.min_key)) & (
                        cand <= np.uint64(info.max_key)
                    )
                    if not in_range.any():
                        continue
                    hit = np.zeros(cand.shape[0], dtype=bool)
                    hit[in_range] = info.bloom().might_contain(cand[in_range])
                    maybe[np.nonzero(rest)[0][hit]] = True
                out[idx] = maybe
        return out

    def lookup(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Rows for sorted unique keys: newest-first over each bucket's
        committed segments, skipping segments whose bloom/min-max prove
        they cannot hold a still-unfound key."""
        q = np.asarray(q, dtype=np.uint64)
        out = np.zeros((q.shape[0], self.n_cols), dtype=np.float32)
        found = np.zeros(q.shape[0], dtype=bool)
        if q.shape[0] == 0:
            return out, found
        with self._lock:
            bids = self._bucket_of(q)
            for b in np.unique(bids):
                idx = np.nonzero(bids == b)[0]
                sub = q[idx]
                hit_local = np.zeros(sub.shape[0], dtype=bool)
                for info in reversed(self._live[int(b)]):
                    rest = np.nonzero(~hit_local)[0]
                    if rest.shape[0] == 0:
                        break
                    cand = sub[rest]
                    maybe = (cand >= np.uint64(info.min_key)) & (
                        cand <= np.uint64(info.max_key)
                    )
                    if maybe.any():
                        maybe[maybe] &= info.bloom().might_contain(cand[maybe])
                    if not maybe.any():
                        stats.add("store.log_seg_skips")
                        continue
                    sk, sv = _merge_newest_wins(
                        self._read_committed(info), self.n_cols
                    )
                    if sk.shape[0] == 0:
                        continue
                    pos = np.searchsorted(sk, cand)
                    pos_c = np.minimum(pos, sk.shape[0] - 1)
                    ok = sk[pos_c] == cand
                    out[idx[rest[ok]]] = sv[pos_c[ok]]
                    hit_local[rest[ok]] = True
                found[idx] = hit_local
        return out, found

    # -- full-state reads ---------------------------------------------------- #
    def materialize(self) -> Tuple[np.ndarray, np.ndarray]:
        """The committed state as globally key-sorted (keys, rows),
        newest-wins.  Recovery and checkpoint-restore path."""
        with self._lock:
            parts = [
                blk
                for segs in self._live
                for i in segs
                for blk in self._read_committed(i)
            ]
            return _merge_newest_wins(parts, self.n_cols)

    def materialize_at(self, gen: int) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a PAST committed generation (keep_history stores):
        the incremental-checkpoint restore path — cost is the bytes of the
        segments that generation references, not a table scan."""
        if gen == 0:
            return _EMPTY_KEYS, np.empty((0, self.n_cols), dtype=np.float32)
        man = self._read_manifest(f"manifest-{gen:08d}.json")
        infos = [SegmentInfo.from_json(d) for d in man["segments"]]
        infos.sort(key=lambda i: i.seq)
        parts = []
        with self._lock:
            for info in infos:
                parts.extend(self._read_committed(info))
        return _merge_newest_wins(parts, int(man["n_cols"]))

    def verify_gen(self, gen: int) -> Tuple[bool, str]:
        """Cheap integrity probe of one committed generation: manifest
        parses, every referenced segment exists with the pinned size + crc.
        Returns (ok, reason)."""
        if gen == 0:
            return True, ""
        try:
            man = self._read_manifest(f"manifest-{gen:08d}.json")
        except LogStoreCorrupt as e:
            return False, str(e)
        for d in man["segments"]:
            info = SegmentInfo.from_json(d)
            path = os.path.join(self.root, info.name)
            try:
                if os.path.getsize(path) != info.n_bytes:
                    return False, f"{info.name}: size mismatch"
                with open(path, "rb") as fh:
                    if zlib.crc32(fh.read()) != info.crc:
                        return False, f"{info.name}: crc mismatch"
            except OSError as e:
                return False, f"{info.name}: {e}"
        return True, ""

    # -- lifecycle ----------------------------------------------------------- #
    def discard_pending(self) -> None:
        """Drop staged-but-uncommitted segments (abort path)."""
        with self._lock:
            for info in self._pending:
                self._unlink(info.name)
            self._pending = []

    def close(self) -> None:
        """Orphan (never commit) anything still staged and drop caches."""
        with self._lock:
            self._pending = []
            self._cache.clear()
