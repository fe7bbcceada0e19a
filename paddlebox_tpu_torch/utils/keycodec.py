"""Varint sorted-delta key codec, the host-plane wire compressor
(reference: paddlebox_tpu/utils/keycodec.py; the bytes are identical).

Sorted uint64 key arrays (pass censuses, hot-row migration frames) travel
as delta-of-sorted LEB128 varints, typically 1-2 bytes a key instead of 8.

Wire format of one sorted-u64 stream (everything LEB128 varint, unsigned,
little-endian 7-bit groups, high bit = continuation):

    varint(n)  varint(keys[0])  varint(keys[1]-keys[0]) ... (n-1 deltas)

Decoding is exact or loud: a truncated buffer, an overlong varint (> 10
bytes / a 10th byte above 1), trailing bytes after the last delta, or a
delta stream whose cumulative sum wraps uint64 all raise the structured
:class:`KeyCodecError`; there is no silent short decode.

Both directions are numpy-vectorized.
"""

from __future__ import annotations

import numpy as np

_U8 = np.uint8
_U64 = np.uint64
# LEB128 of a 64-bit value spans at most 10 groups; the 10th carries the
# top bit only, so any 10th byte above 1 encodes > 2^64 (overlong)
_MAX_GROUPS = 10

_EMPTY_U64 = np.empty(0, dtype=np.uint64)
_EMPTY_U8 = np.empty(0, dtype=np.uint8)


class KeyCodecError(ValueError):
    """A key payload failed to encode/decode — structured so callers can
    surface WHERE the wire broke instead of a bare struct error.

    reason: short machine-readable tag (``truncated`` / ``overlong`` /
    ``trailing-bytes`` / ``count-mismatch`` / ``delta-overflow`` /
    ``unsorted-input``).
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(
            f"key codec {reason}" + (f": {detail}" if detail else "")
        )


# --------------------------------------------------------------------------- #
# varint streams (building blocks)
# --------------------------------------------------------------------------- #
def encode_varints(vals: np.ndarray) -> bytes:
    """LEB128-encode a uint64 vector into one contiguous byte stream."""
    v = np.ascontiguousarray(vals, dtype=_U64)
    n = v.shape[0]
    if n == 0:
        return b""
    # bytes per value: number of 7-bit groups in the bit length (min 1)
    nb = np.ones(n, dtype=np.int64)
    rest = v >> _U64(7)
    while rest.any():
        nb += (rest > 0)
        rest >>= _U64(7)
    ends = np.cumsum(nb)
    starts = ends - nb
    out = np.empty(int(ends[-1]), dtype=_U8)
    for j in range(int(nb.max())):
        m = nb > j
        group = ((v[m] >> _U64(7 * j)) & _U64(0x7F)).astype(_U8)
        cont = np.where(nb[m] - 1 > j, _U8(0x80), _U8(0))
        out[starts[m] + j] = group | cont
    return out.tobytes()


def decode_varints(buf, expect: int = -1) -> np.ndarray:
    """Decode a LEB128 byte stream back to uint64.

    ``expect`` >= 0 additionally requires exactly that many values
    (``count-mismatch`` otherwise).  Raises :class:`KeyCodecError` on a
    truncated tail (last byte still has its continuation bit) or an
    overlong group.
    """
    b = np.frombuffer(buf, dtype=_U8)
    if b.shape[0] == 0:
        if expect > 0:
            raise KeyCodecError("count-mismatch",
                                f"expected {expect} values, stream is empty")
        return _EMPTY_U64.copy()
    term = (b & _U8(0x80)) == 0
    if not term[-1]:
        raise KeyCodecError("truncated",
                            "stream ends inside a varint group")
    ends = np.flatnonzero(term)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lengths = ends - starts + 1
    if int(lengths.max()) > _MAX_GROUPS:
        raise KeyCodecError("overlong",
                            f"varint spans {int(lengths.max())} bytes")
    # byte position within its varint group
    pos = np.arange(b.shape[0], dtype=np.int64) - np.repeat(starts, lengths)
    if np.any(b[pos == _MAX_GROUPS - 1] > 1):
        raise KeyCodecError("overlong", "10th varint byte exceeds 2^64")
    shifted = (b & _U8(0x7F)).astype(_U64) << (
        _U64(7) * pos.astype(_U64)
    )
    vals = np.add.reduceat(shifted, starts)
    if expect >= 0 and vals.shape[0] != expect:
        raise KeyCodecError(
            "count-mismatch",
            f"expected {expect} values, stream holds {vals.shape[0]}",
        )
    return vals


# --------------------------------------------------------------------------- #
# sorted uint64 payloads (censuses, routed key sets)
# --------------------------------------------------------------------------- #
def encode_sorted_u64(keys: np.ndarray) -> bytes:
    """Encode a sorted (non-decreasing; duplicates fine) uint64 array.

    Raises ``KeyCodecError("unsorted-input")`` rather than silently
    producing a stream that cannot round-trip.
    """
    k = np.ascontiguousarray(keys, dtype=_U64)
    n = k.shape[0]
    if n == 0:
        return encode_varints(np.zeros(1, dtype=_U64))
    if n > 1 and bool(np.any(k[1:] < k[:-1])):
        raise KeyCodecError("unsorted-input",
                            "sorted-delta needs non-decreasing keys")
    head = np.empty(n + 1, dtype=_U64)
    head[0] = _U64(n)
    head[1] = k[0]
    head[2:] = k[1:] - k[:-1]
    return encode_varints(head)


def decode_sorted_u64(buf) -> np.ndarray:
    """Exact inverse of :func:`encode_sorted_u64`; loud on any damage."""
    vals = decode_varints(buf)
    if vals.shape[0] == 0:
        raise KeyCodecError("truncated", "missing count header")
    n = int(vals[0])
    if vals.shape[0] != n + 1:
        reason = "truncated" if vals.shape[0] < n + 1 else "trailing-bytes"
        raise KeyCodecError(
            reason,
            f"count header says {n} keys, stream holds {vals.shape[0] - 1}",
        )
    if n == 0:
        return _EMPTY_U64.copy()
    with np.errstate(over="ignore"):
        keys = np.cumsum(vals[1:], dtype=_U64)
    if n > 1 and bool(np.any(keys[1:] < keys[:-1])):
        # a wrapped cumsum means the deltas overflowed uint64: the stream
        # was corrupt (a valid encoder can never produce this)
        raise KeyCodecError("delta-overflow",
                            "cumulative deltas wrap uint64")
    return keys


def encode_u64_with_perm(keys: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Encode an UNSORTED uint64 array as (sorted-delta stream, rank) where
    ``rank`` is int32 positions such that ``sorted[rank] == keys`` — the
    shuffle-wire form (record key order is load-bearing, so the permutation
    rides beside the compressed sorted copy)."""
    k = np.ascontiguousarray(keys, dtype=_U64)
    order = np.argsort(k, kind="stable")
    rank = np.empty(k.shape[0], dtype=np.int32)
    rank[order] = np.arange(k.shape[0], dtype=np.int32)
    return encode_sorted_u64(k[order]), rank


def decode_u64_with_perm(buf, rank: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode_u64_with_perm`."""
    srt = decode_sorted_u64(buf)
    r = np.asarray(rank, dtype=np.int64)
    if r.shape[0] != srt.shape[0]:
        raise KeyCodecError(
            "count-mismatch",
            f"perm has {r.shape[0]} entries, stream {srt.shape[0]} keys",
        )
    if r.shape[0] and (int(r.min()) < 0 or int(r.max()) >= srt.shape[0]):
        raise KeyCodecError("count-mismatch", "perm index out of range")
    return srt[r]


def encode_zigzag_delta(vals: np.ndarray) -> bytes:
    """Delta + zigzag + varint of a signed integer vector (int64-safe
    inputs; the caller restores shape and dtype).  A want matrix flattens
    to long runs of equal dead-row ids, whose deltas are zero: one byte
    each instead of four (the KvChannel's "varint" codec)."""
    v = np.ascontiguousarray(vals, dtype=np.int64).ravel()
    if v.shape[0] == 0:
        return b""
    d = np.empty_like(v)
    d[0] = v[0]
    d[1:] = v[1:] - v[:-1]
    zz = ((d << 1) ^ (d >> 63)).view(_U64)
    return encode_varints(zz)


def decode_zigzag_delta(buf, n: int) -> np.ndarray:
    """Inverse of :func:`encode_zigzag_delta` -> int64 [n]."""
    zz = decode_varints(buf, expect=n)
    z = zz.view(np.int64)
    d = (z >> 1) ^ -(z & 1)
    return np.cumsum(d, dtype=np.int64)
