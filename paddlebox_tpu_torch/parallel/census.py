"""Shared-dictionary census exchange (reference: paddlebox_tpu/parallel/census.py).

Every rank derives the same **shared dictionary** from the global census
stream: the placement planner's hot set (sparse/placement.py) and the keys
resident in any shard's HBM cache, which every rank predicts by replaying
each shard's cache directory on a rows-free twin (:class:`FleetCacheMirror`).
No collective builds it; determinism does.  A census message is then ``(a
membership bitmap over the dictionary, the varint sorted-delta cold
tail)``: a dictionary key costs one bit, a cold key about 1-2 bytes
(utils/keycodec.py).  Every message carries the dictionary's size and a
64-bit digest, and any divergence, or a peer speaking another wire format,
raises :class:`CensusProtocolError` instead of mis-decoding.  The wire bytes
are identical to the reference's.

Transports: :class:`LoopbackTransport` (one process: the encode -> decode
path still runs) and :class:`InProcessCensusGroup` (N simulated ranks on
threads, for tests).  The reference's multi-host ``KvGatherTransport``
comes with the multi-process slice.

Telemetry (the reference's names): each exchange observes its payload
bytes, raw and encoded, in ``hostplane.gather_bytes`` and the keys that
missed the dictionary in ``census.cold_keys``.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.sparse.engine.hbm_cache import HbmCache
from paddlebox_tpu_torch.sparse.store import splitmix64
from paddlebox_tpu_torch.utils import keycodec

_MAGIC = b"PBCX1"
_CODEC_RAW = 0
_CODEC_VARINT = 1

_EMPTY_U64 = np.empty(0, dtype=np.uint64)

# byte-scale histogram edges: one wire message spans ~100 B (bitmap only)
# to tens of MB (a cold full census at production scale)
BYTE_BUCKETS = (
    64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
    float(1 << 20), float(4 << 20), float(16 << 20), float(64 << 20),
)


def _gather_bytes_hist():
    return telemetry.histogram(
        "hostplane.gather_bytes",
        "host-plane gather payload bytes by channel base and kind "
        "(raw = pre-codec equivalent, encoded = on-wire)",
        buckets=BYTE_BUCKETS,
    )


class CensusProtocolError(RuntimeError):
    """A census message failed negotiation: a peer speaks a different
    wire format/codec, or its shared dictionary diverged from ours."""

    def __init__(self, channel: str, sender: int, reason: str):
        self.channel = channel
        self.sender = sender
        self.reason = reason
        super().__init__(
            f"census exchange on channel {channel!r}: message from rank "
            f"{sender} {reason} (mixed-version peer or dictionary "
            "divergence — set PADDLEBOX_TORCH_PLACEMENT=hash and "
            "PADDLEBOX_TORCH_HOSTPLANE_CODEC=legacy on every rank, or "
            "upgrade all ranks)"
        )


def _dict_digest(keys: np.ndarray) -> int:
    """Order-free 64-bit digest of a key set (xor of splitmix64 hashes):
    the cheap cross-rank dictionary-agreement check."""
    if not keys.shape[0]:
        return 0
    return int(np.bitwise_xor.reduce(splitmix64(keys)))


def _read_varint(buf: memoryview, off: int) -> tuple:
    """One scalar LEB128 read -> (value, next offset); loud on damage."""
    shift = 0
    val = 0
    for _ in range(10):
        if off >= len(buf):
            raise keycodec.KeyCodecError("truncated",
                                         "header varint runs off the buffer")
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            if val >= 1 << 64:
                raise keycodec.KeyCodecError("overlong",
                                             "header varint exceeds 2^64")
            return val, off
        shift += 7
    raise keycodec.KeyCodecError("overlong", "header varint spans > 10 bytes")


# --------------------------------------------------------------------------- #
# transports
# --------------------------------------------------------------------------- #
class LoopbackTransport:
    """World of one: gather returns this process's own payload, so the
    encode -> decode wire path still runs without a fleet."""

    def gather(self, payload: bytes) -> List[bytes]:
        return [payload]


# how long a rank waits at the group's barrier for the others (module
# level, so tests can shrink it)
BARRIER_TIMEOUT_S = 300.0


class InProcessCensusGroup:
    """N simulated ranks (threads) exchanging census payloads through a
    barrier-coordinated mailbox, for tests.  Each barrier wait is bounded
    by BARRIER_TIMEOUT_S: a rank that never arrives (one that raised
    before its exchange) breaks the barrier, and the waiting ranks raise
    ``threading.BrokenBarrierError`` instead of hanging."""

    def __init__(self, n_ranks: int):
        if n_ranks < 1:
            raise ValueError("n_ranks must be >= 1")
        self.n_ranks = n_ranks
        self._box: List[Optional[bytes]] = [None] * n_ranks
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(n_ranks, timeout=BARRIER_TIMEOUT_S)

    def transport(self, rank: int) -> "_GroupTransport":
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"bad rank {rank}")
        return _GroupTransport(self, rank)

    def _gather(self, rank: int, payload: bytes) -> List[bytes]:
        with self._lock:
            self._box[rank] = payload
        self._barrier.wait()  # all deposits visible
        msgs = list(self._box)
        # second barrier: nobody starts the next round (overwriting the
        # mailbox) until every rank has copied this round's messages
        self._barrier.wait()
        return msgs


class _GroupTransport:
    def __init__(self, group: InProcessCensusGroup, rank: int):
        self.group = group
        self.rank = rank

    def gather(self, payload: bytes) -> List[bytes]:
        return self.group._gather(self.rank, payload)


# --------------------------------------------------------------------------- #
# cache mirrors
# --------------------------------------------------------------------------- #
class FleetCacheMirror:
    """Metadata-only twins of EVERY shard's HbmCache directory.

    Cache admission (sparse/engine/hbm_cache.py) is a deterministic
    function of the per-shard census sequence, and every rank holds the
    same global census, so every rank can replay every shard's
    lookup -> touch -> plan_update -> commit sequence on a rows-free twin
    and predict remote residency without a byte on the wire.  Resident
    keys join the shared dictionary: a key resident anywhere rides the
    census as one bit.

    A real cache can diverge from its twin (the fault-site fallbacks evict
    out of band); that costs only compression, since the dictionary is a
    codebook, not a coherence protocol, and the twins themselves stay
    identical across ranks because they never see local-only events.
    """

    def __init__(self, n_shards: int, per_shard_rows: int, aging: float):
        self.n_shards = int(n_shards)
        self._dirs = [
            HbmCache(per_shard_rows, 1, aging=aging, materialize_rows=False)
            for _ in range(self.n_shards)
        ]

    def shard_resident(self, shard: int) -> np.ndarray:
        """Sorted resident keys of one shard's twin."""
        return self._dirs[shard].snapshot_keys()

    def resident_keys(self) -> np.ndarray:
        """All residents, globally sorted (shards partition the key space,
        so the concat is duplicate-free)."""
        parts = [d.snapshot_keys() for d in self._dirs]
        parts = [p for p in parts if p.shape[0]]
        if not parts:
            return _EMPTY_U64.copy()
        return np.sort(np.concatenate(parts))

    def step(self, pk: np.ndarray) -> None:
        """Replay one pass's directory evolution from the global census."""
        owner = pk % np.uint64(self.n_shards)
        for o, d in enumerate(self._dirs):
            sk = pk[owner == np.uint64(o)]
            plan = d.lookup(sk)
            d.touch(plan)
            d.commit_update(plan, d.plan_update(sk, plan))

    def evict(self, keys: np.ndarray) -> None:
        """Mirror the realized hot promotion: keys promoted into the
        replicated block leave the real per-shard caches (``take_rows``),
        so their twins drop them too."""
        keys = np.asarray(keys, dtype=np.uint64)
        if not keys.shape[0]:
            return
        owner = keys % np.uint64(self.n_shards)
        for o, d in enumerate(self._dirs):
            sk = keys[owner == np.uint64(o)]
            if sk.shape[0]:
                d.evict_keys(sk)


# --------------------------------------------------------------------------- #
# the exchange
# --------------------------------------------------------------------------- #
class CensusExchange:
    """One rank's half of the census collective.

    Every rank must construct this with the SAME planner and mirror
    configuration and feed it the same call sequence: the dictionary is
    derived state, and the digest in every message checks that the
    derivation stayed in lockstep.  ``exchange(local_census)`` returns the
    global census, identical on every rank and equal to
    :func:`legacy_union`.

    ``realize=True`` when the owning table materializes the plan's hot set
    on the device: hot keys then never reach the real per-shard caches
    (promotion takes them out), so the twins replay the same split (evict
    the hot keys, see only the cold census) or residency drifts.
    """

    def __init__(self, transport, planner=None,
                 mirror: Optional[FleetCacheMirror] = None,
                 codec: str = "varint", channel: str = "census",
                 realize: bool = False):
        if codec not in ("varint", "raw"):
            raise ValueError(f"codec must be varint|raw, got {codec!r}")
        self.transport = transport
        self.planner = planner
        self.mirror = mirror
        self.codec = codec
        self.channel = channel
        self.realize = bool(realize)
        self._known: np.ndarray = _EMPTY_U64.copy()
        self.last_wire_bytes = 0  # this rank's encoded payload size
        self.last_raw_bytes = 0  # what the legacy wire would have shipped
        self.last_cold_keys = 0

    # -- wire format ------------------------------------------------------ #
    def _encode(self, local_pk: np.ndarray, known: np.ndarray) -> bytes:
        if known.shape[0] and local_pk.shape[0]:
            pos = np.searchsorted(known, local_pk)
            pos_c = np.minimum(pos, known.shape[0] - 1)
            hit = known[pos_c] == local_pk
            seen = np.zeros(known.shape[0], dtype=bool)
            seen[pos_c[hit]] = True
            cold = local_pk[~hit]
        else:
            seen = np.zeros(known.shape[0], dtype=bool)
            cold = local_pk
        self.last_cold_keys = int(cold.shape[0])
        bitmap = np.packbits(seen).tobytes() if known.shape[0] else b""
        if self.codec == "varint":
            cold_payload = keycodec.encode_sorted_u64(cold)
            codec_byte = _CODEC_VARINT
        else:
            cold_payload = np.ascontiguousarray(cold, np.uint64).tobytes()
            codec_byte = _CODEC_RAW
        header = keycodec.encode_varints(
            np.asarray(
                [known.shape[0], _dict_digest(known), cold.shape[0]],
                dtype=np.uint64,
            )
        )
        return (
            _MAGIC + bytes([codec_byte]) + header + bitmap + cold_payload
        )

    def _decode(self, msg: bytes, sender: int, known: np.ndarray):
        """-> (seen bool [n_known], cold keys sorted)."""
        if not msg.startswith(_MAGIC):
            raise CensusProtocolError(
                self.channel, sender,
                "does not carry the PBCX1 census wire magic",
            )
        codec_byte = msg[len(_MAGIC)]
        if codec_byte not in (_CODEC_RAW, _CODEC_VARINT):
            raise CensusProtocolError(
                self.channel, sender, f"declares unknown codec {codec_byte}"
            )
        view = memoryview(msg)
        off = len(_MAGIC) + 1
        try:
            n_known, off = _read_varint(view, off)
            digest, off = _read_varint(view, off)
            n_cold, off = _read_varint(view, off)
        except keycodec.KeyCodecError as e:
            raise CensusProtocolError(
                self.channel, sender, f"has a damaged header ({e})"
            ) from e
        if n_known != known.shape[0] or digest != _dict_digest(known):
            raise CensusProtocolError(
                self.channel, sender,
                f"was encoded against a different dictionary "
                f"({n_known} keys, digest {digest:#x}; ours "
                f"{known.shape[0]} keys, digest {_dict_digest(known):#x})",
            )
        n_bitmap = (n_known + 7) // 8
        if len(msg) < off + n_bitmap:
            raise CensusProtocolError(
                self.channel, sender, "is truncated inside the bitmap"
            )
        if n_known:
            seen = np.unpackbits(
                np.frombuffer(view[off:off + n_bitmap], dtype=np.uint8)
            )[:n_known].astype(bool)
        else:
            seen = np.zeros(0, dtype=bool)
        off += n_bitmap
        body = view[off:]
        try:
            if codec_byte == _CODEC_VARINT:
                cold = keycodec.decode_sorted_u64(body)
                if cold.shape[0] != n_cold:
                    raise keycodec.KeyCodecError(
                        "count-mismatch",
                        f"header says {n_cold} cold keys, "
                        f"stream holds {cold.shape[0]}",
                    )
            else:
                if len(body) != n_cold * 8:
                    raise keycodec.KeyCodecError(
                        "truncated",
                        f"raw cold payload is {len(body)} bytes, "
                        f"expected {n_cold * 8}",
                    )
                cold = np.frombuffer(body, dtype=np.uint64).copy()
        except keycodec.KeyCodecError as e:
            raise CensusProtocolError(
                self.channel, sender, f"has a damaged cold payload ({e})"
            ) from e
        return seen, cold

    # -- the collective --------------------------------------------------- #
    def exchange(self, local_census: np.ndarray) -> np.ndarray:
        """Gather every rank's census -> the global census (sorted unique),
        advancing the planner and mirror dictionary for the NEXT pass."""
        local_pk = np.unique(np.asarray(local_census, dtype=np.uint64))
        known = self._known
        payload = self._encode(local_pk, known)
        self.last_wire_bytes = len(payload)
        self.last_raw_bytes = int(local_pk.nbytes)
        hist = _gather_bytes_hist()
        hist.observe(float(self.last_raw_bytes),
                     channel=self.channel, kind="raw")
        hist.observe(float(self.last_wire_bytes),
                     channel=self.channel, kind="encoded")
        telemetry.histogram(
            "census.cold_keys",
            "keys per census message that missed the shared dictionary "
            "and rode the wire as key payloads",
        ).observe(float(self.last_cold_keys))
        msgs = self.transport.gather(payload)
        seen_any = np.zeros(known.shape[0], dtype=bool)
        colds = []
        for sender, msg in enumerate(msgs):
            seen, cold = self._decode(msg, sender, known)
            seen_any |= seen
            if cold.shape[0]:
                colds.append(cold)
        parts = [known[seen_any]] if known.shape[0] else []
        parts += colds
        if parts:
            pk = np.unique(np.concatenate(parts))
        else:
            pk = _EMPTY_U64.copy()
        self._advance(pk)
        return pk

    def _advance(self, pk: np.ndarray) -> None:
        """Evolve the shared dictionary from the agreed global census: a
        pure function of ``pk``, so every rank stays in lockstep."""
        parts = []
        hot = _EMPTY_U64
        if self.planner is not None:
            self.planner.observe(pk)
            plan = self.planner.update_plan()
            if plan.n_hot:
                parts.append(plan.hot_keys)
                hot = plan.hot_keys
        if self.mirror is not None:
            if self.realize and hot.shape[0]:
                self.mirror.evict(hot)
                self.mirror.step(np.setdiff1d(pk, hot, assume_unique=True))
            else:
                self.mirror.step(pk)
            res = self.mirror.resident_keys()
            if res.shape[0]:
                parts.append(res)
        if not parts:
            self._known = _EMPTY_U64.copy()
        elif len(parts) == 1:
            self._known = parts[0]
        else:
            self._known = np.unique(np.concatenate(parts))


def legacy_union(censuses: Sequence[np.ndarray]) -> np.ndarray:
    """The pre-codec semantics in one place: the union of raw local
    censuses.  Tests pin ``CensusExchange`` output equal to this."""
    parts = [np.asarray(c, dtype=np.uint64) for c in censuses]
    if not parts:
        return _EMPTY_U64.copy()
    return np.unique(np.concatenate(parts))
