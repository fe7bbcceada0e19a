"""Binary instance archives: framed RecordBlock serialization (reference:
paddlebox_tpu/data/archive.py; an archive written by either package reads
in the other, byte for byte).

One format serves the shuffle wire and the disk spill's files
(``PadBoxSlotDataset.preload_into_disk``).

Layout per frame: ``u64 payload_len`` + payload, payload being an ``.npz``
(zip of arrays) — zero custom parsing, numpy-native, and self-describing
enough to survive schema growth (optional columns are simply absent).
"""

from __future__ import annotations

import io
from typing import BinaryIO, Iterator, Optional

import numpy as np

from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.utils import keycodec

_LEN = np.dtype("<u8")

# shuffle-wire framing (TcpShuffler): 4-byte magic + 1 codec byte ahead
# of the npz body.  Codec 1 replaces the raw uint64 ``keys`` member with
# a varint sorted-delta stream + int32 order permutation
# (utils/keycodec.py) — the key column dominates a routed block's bytes.
# Legacy (bare-npz) payloads stay decodable: npz carries the zip "PK"
# magic, so the two framings can never be confused; anything else fails
# loudly (WireCodecError).  Disk archives (write_archive) keep the bare
# npz format — the frame is a TRANSPORT negotiation, not a storage one.
_WIRE_MAGIC = b"PBS1"
_WIRE_RAW = 0
_WIRE_KEYS_VARINT = 1


class WireCodecError(ValueError):
    """A shuffle-wire payload carries a framing this build does not
    understand (mixed-version peer or corruption) — loud by design."""


def _block_arrays(block: RecordBlock) -> dict:
    arrays = {
        "n_ins": np.int64(block.n_ins),
        "n_sparse_slots": np.int64(block.n_sparse_slots),
        "keys": block.keys,
        "key_offsets": block.key_offsets,
        "dense": block.dense,
        "labels": block.labels,
    }
    if block.ins_ids is not None:
        arrays["ins_ids"] = np.asarray(block.ins_ids, dtype=np.str_)
    for f in ("search_ids", "ranks", "cmatches", "task_labels"):
        v = getattr(block, f)
        if v is not None:
            arrays[f] = v
    return arrays


def _block_from_npz(z) -> RecordBlock:
    get = lambda k: z[k] if k in z.files else None
    ins_ids = get("ins_ids")
    if "keys_enc" in z.files:
        keys = keycodec.decode_u64_with_perm(
            z["keys_enc"].tobytes(), z["keys_rank"]
        )
    else:
        keys = z["keys"]
    return RecordBlock(
        n_ins=int(z["n_ins"]),
        n_sparse_slots=int(z["n_sparse_slots"]),
        keys=keys,
        key_offsets=z["key_offsets"],
        dense=z["dense"],
        labels=z["labels"],
        ins_ids=None if ins_ids is None else [str(s) for s in ins_ids],
        search_ids=get("search_ids"),
        ranks=get("ranks"),
        cmatches=get("cmatches"),
        task_labels=get("task_labels"),
    )


def block_to_bytes(block: RecordBlock) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_block_arrays(block))
    return buf.getvalue()


def block_from_bytes(data: bytes) -> RecordBlock:
    with np.load(io.BytesIO(data)) as z:
        return _block_from_npz(z)


def block_to_wire(block: RecordBlock, codec: str = "varint"):
    """Serialize for the shuffle wire -> (payload, raw_key_bytes,
    wire_key_bytes).  ``legacy`` ships the bare npz; ``raw`` frames it
    uncompressed; ``varint`` compresses the key column.  The byte pair
    feeds the ``shuffle.exchange_bytes`` raw-vs-encoded histogram."""
    raw_kb = int(block.keys.nbytes)
    if codec == "legacy":
        return block_to_bytes(block), raw_kb, raw_kb
    arrays = _block_arrays(block)
    codec_byte = _WIRE_RAW
    wire_kb = raw_kb
    if codec == "varint" and block.keys.shape[0]:
        enc, rank = keycodec.encode_u64_with_perm(block.keys)
        del arrays["keys"]
        arrays["keys_enc"] = np.frombuffer(enc, dtype=np.uint8)
        arrays["keys_rank"] = rank
        codec_byte = _WIRE_KEYS_VARINT
        wire_kb = len(enc) + int(rank.nbytes)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return _WIRE_MAGIC + bytes([codec_byte]) + buf.getvalue(), raw_kb, wire_kb


def block_from_wire(data: bytes) -> RecordBlock:
    """Decode any framing THIS build speaks (framed or legacy npz);
    anything else raises :class:`WireCodecError` — never a silent
    misparse."""
    if data.startswith(_WIRE_MAGIC):
        codec_byte = data[len(_WIRE_MAGIC)]
        if codec_byte not in (_WIRE_RAW, _WIRE_KEYS_VARINT):
            raise WireCodecError(
                f"shuffle wire payload declares unknown codec {codec_byte} "
                "(newer peer? upgrade this rank)"
            )
        return block_from_bytes(data[len(_WIRE_MAGIC) + 1:])
    if data.startswith(b"PK"):  # legacy bare npz (zip magic)
        return block_from_bytes(data)
    raise WireCodecError(
        "shuffle wire payload carries neither the PBS1 frame nor an npz "
        "body — mixed-version peer or corrupted stream"
    )


def write_frame(fh: BinaryIO, payload: bytes) -> None:
    fh.write(np.uint64(len(payload)).tobytes())
    fh.write(payload)


def read_frame(fh: BinaryIO) -> Optional[bytes]:
    head = fh.read(8)
    if not head:
        return None
    if len(head) != 8:
        raise EOFError("truncated archive frame header")
    n = int(np.frombuffer(head, dtype=_LEN)[0])
    payload = fh.read(n)
    if len(payload) != n:
        raise EOFError("truncated archive frame payload")
    return payload


def write_archive(path: str, blocks) -> int:
    """Write blocks to a framed archive file; returns frames written."""
    n = 0
    with open(path, "wb") as fh:
        for b in blocks:
            write_frame(fh, block_to_bytes(b))
            n += 1
    return n


def read_archive(path: str) -> Iterator[RecordBlock]:
    with open(path, "rb") as fh:
        while True:
            payload = read_frame(fh)
            if payload is None:
                return
            yield block_from_bytes(payload)
