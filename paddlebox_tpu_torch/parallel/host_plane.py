"""Host control-plane collectives over the job's TCPStore (reference:
paddlebox_tpu/parallel/host_plane.py, over the JAX coordination service).

The data plane (the pull and push all_to_alls, the dense psums) rides the
job's ``torch.distributed`` process group inside the step
(parallel/collectives.py).  The PLANNING plane (the ragged-tail barrier,
the bucket-capacity consensus, the want-matrix exchange) must not: it runs
on the feed-producer thread, concurrent with the step thread's
collectives, and two threads issuing process-group collectives in racing
order across processes is a cross-process deadlock (a group matches
collectives by issue order).  So the planning plane rides a genuinely
host-side transport: the job's ``torch.distributed.TCPStore``, the store
the process group itself was bootstrapped from.

Each logical stream gets a ``KvChannel`` with its own key namespace and
sequence counter, so streams on different threads never pair mismatched
payloads: an allgather at sequence s only ever reads peers' keys at the
same (channel, s).

Deadlock freedom: a wait polls for one specific key, not for queue order,
so processes may interleave channels arbitrarily.  A ``TCPStore.get`` of a
missing key blocks for the whole store timeout, so a wait never calls it
blindly: it polls ``check`` with a short backoff, and calls the active
watchdog's ``check()`` between polls, so an abort interrupts it within one
poll interval.  GC: a process deletes its own key for sequence s when it
posts s+2; a peer that has posted s+1 has, by the channel's lockstep
definition, finished reading every key at s, so a two-deep window is
always safe.
"""

from __future__ import annotations

import base64
import re
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.utils import faults

# gather latency, labeled by the channel's BASE name (the per-pass "-<n>"
# suffix stripped, so series stay bounded over a long job): the number
# that shows which planning stream's tail gates the feed producer
_GATHER_SECONDS = telemetry.histogram(
    "hostplane.gather_seconds",
    help="host-plane allgather wall time (s) by channel",
)

# wire framing of codec'd payloads (PADDLEBOX_TORCH_HOSTPLANE_CODEC): a
# 4-byte magic and 1 codec byte ahead of the body, byte for byte the
# reference's.  "legacy" ships the bare body; the decode side fails LOUDLY
# on a framing mismatch instead of reinterpreting bytes
_CODEC_MAGIC = b"PBC1"
_CODEC_RAW = 0  # framed, body = array.tobytes()
_CODEC_VARINT = 1  # framed, body = zigzag-delta varints (integer dtypes)


class HostPlaneCodecError(RuntimeError):
    """A KV-channel payload failed codec negotiation: the peer ships a
    framing this process does not understand (mixed-version job) or a
    damaged body.  Loud by design: silently reading a framed payload as
    raw would train on garbage bytes."""

    def __init__(self, channel: str, seq: int, rank: int, reason: str):
        self.channel = channel
        self.seq = seq
        self.rank = rank
        self.reason = reason
        super().__init__(
            f"host-plane codec mismatch on channel {channel!r} sequence "
            f"{seq}: payload from process {rank} {reason}: run every rank "
            "at the same version, or set PADDLEBOX_TORCH_HOSTPLANE_CODEC="
            "legacy on every rank during a rolling upgrade"
        )


def _encode_array(x: np.ndarray, codec: str) -> bytes:
    """Frame one same-shape allgather payload.  ``legacy`` = the bare
    bytes; ``raw`` = framed, uncompressed; ``varint`` = framed,
    zigzag-delta varints for the integer dtypes the transform is exact on
    (signed ints and sub-64-bit unsigned: want matrices are int32 with long
    dead-row runs, about 1 byte each instead of 4); other dtypes take the
    raw frame."""
    if codec == "legacy":
        return x.tobytes()
    kind = x.dtype.kind
    small_uint = kind == "u" and x.dtype.itemsize < 8
    if codec == "varint" and (kind == "i" or small_uint) and x.size:
        from paddlebox_tpu_torch.utils import keycodec

        body = keycodec.encode_zigzag_delta(x.ravel().astype(np.int64))
        return _CODEC_MAGIC + bytes([_CODEC_VARINT]) + body
    return _CODEC_MAGIC + bytes([_CODEC_RAW]) + x.tobytes()


def _decode_array(raw: bytes, template: np.ndarray, codec: str,
                  channel: str, seq: int, rank: int) -> np.ndarray:
    """Inverse of :func:`_encode_array` against the local template's shape
    and dtype; every framing surprise raises HostPlaneCodecError."""
    if codec == "legacy":
        if raw.startswith(_CODEC_MAGIC):
            raise HostPlaneCodecError(
                channel, seq, rank,
                "is codec-framed but this rank runs "
                "PADDLEBOX_TORCH_HOSTPLANE_CODEC=legacy",
            )
        return np.frombuffer(raw, dtype=template.dtype).reshape(
            template.shape)
    if not raw.startswith(_CODEC_MAGIC):
        raise HostPlaneCodecError(
            channel, seq, rank,
            "lacks the PBC1 frame (legacy peer on a codec-enabled job)",
        )
    codec_byte = raw[len(_CODEC_MAGIC)]
    body = raw[len(_CODEC_MAGIC) + 1:]
    if codec_byte == _CODEC_RAW:
        return np.frombuffer(body, dtype=template.dtype).reshape(
            template.shape)
    if codec_byte == _CODEC_VARINT:
        from paddlebox_tpu_torch.utils import keycodec

        try:
            flat = keycodec.decode_zigzag_delta(body, template.size)
        except keycodec.KeyCodecError as e:
            raise HostPlaneCodecError(
                channel, seq, rank, f"has a damaged varint body ({e})"
            ) from e
        return flat.astype(template.dtype).reshape(template.shape)
    raise HostPlaneCodecError(
        channel, seq, rank, f"declares unknown codec byte {codec_byte}"
    )


def _channel_base(name: str) -> str:
    return re.sub(r"-\d+$", "", name)


class HostPlaneTimeout(TimeoutError):
    """A KV-channel gather exhausted its deadline waiting on peers.

    Names the exact missing ``(channel, sequence, peer)`` keys, so the
    operator reads WHO stalled from the error.  ``missing`` is
    [(rank, key), ...].
    """

    def __init__(self, channel: str, seq: int, waited_s: float,
                 missing: Sequence[Tuple[int, str]]):
        self.channel = channel
        self.seq = seq
        self.waited_s = float(waited_s)
        self.missing = list(missing)
        ranks = [r for r, _ in self.missing]
        keys = ", ".join(k for _, k in self.missing)
        super().__init__(
            f"host-plane allgather timed out after {self.waited_s:.1f}s on "
            f"channel {channel!r} sequence {seq}: no payload from "
            f"process(es) {ranks} (missing keys: {keys})"
        )


class StoreKv:
    """The job's ``TCPStore`` with the KV surface the watchdog, the
    channels and the fleet gather share: ``set`` overwrites, ``get`` never
    blocks (None when the key is absent: ``check`` first, since a get of a
    missing key would wait out the store timeout), ``delete`` is
    idempotent.  Values are str.  Each StoreKv opens its own connection to
    the store where the installed torch can (``TCPStore.clone``), so a
    slow read on one thread never queues another's."""

    def __init__(self, store):
        clone = getattr(store, "clone", None)
        self._store = clone() if clone is not None else store
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._store.set(key, value)

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            if not self._store.check([key]):
                return None
            return self._store.get(key).decode()

    def delete(self, key: str) -> None:
        with self._lock:
            self._store.delete_key(key)


def _job_kv():
    """(kv, rank, world) of the process's multi-process job."""
    from paddlebox_tpu_torch.parallel import mesh

    job = mesh.job()
    if job is None:
        raise RuntimeError(
            "host-plane collectives need a multi-process job: call "
            "parallel.mesh.initialize_distributed() (paddlebox_tpu_torch."
            "launch sets its environment)"
        )
    return StoreKv(job.store), job.rank, job.world


class KvChannel:
    """One ordered allgather stream over the job's KV store.

    Every process constructs the channel with the SAME name and calls
    ``allgather`` / ``gather_bytes`` the same number of times in the same
    logical order: the contract process-group collectives impose, minus
    the shared-queue entanglement with other streams.  ``kv``, ``rank``
    and ``world`` default to the job's (tests pass an ``InMemoryKv`` and
    one channel per simulated rank).
    """

    # how long one wait slice lasts before the loop re-checks the watchdog
    # abort latch and beats (a coordinated abort interrupts a gather within
    # this bound, not the channel timeout)
    POLL_S = 1.0
    # the check() backoff inside a slice: first and longest sleep
    _SLEEP_MIN_S = 0.0002
    _SLEEP_MAX_S = 0.005

    def __init__(self, name: str, timeout_s: Optional[float] = None,
                 codec: Optional[str] = None, kv=None,
                 rank: Optional[int] = None, world: Optional[int] = None):
        # resolution: explicit arg > the active watchdog's LivenessConfig >
        # the PADDLEBOX_TORCH_HOSTPLANE_TIMEOUT_S flag
        from paddlebox_tpu_torch.config import flags

        if timeout_s is None:
            from paddlebox_tpu_torch.parallel import watchdog as _wd

            wd = _wd.current()
            if wd is not None:
                timeout_s = wd.conf.hostplane_timeout_s
            else:
                timeout_s = flags.hostplane_timeout_s
        self.name = name
        self.timeout_s = float(timeout_s)
        # payload codec: "varint" compresses integer payloads
        # (zigzag-delta LEB128), "raw" frames without compression, "legacy"
        # is the unframed wire.  The same value on every rank: decoding
        # fails loudly on a framing mismatch
        self.codec = codec if codec is not None else flags.hostplane_codec
        if self.codec not in ("varint", "raw", "legacy"):
            raise ValueError(
                f"PADDLEBOX_TORCH_HOSTPLANE_CODEC must be varint|raw|legacy, "
                f"got {self.codec!r}"
            )
        if kv is None:
            kv, job_rank, job_world = _job_kv()
            rank = job_rank if rank is None else rank
            world = job_world if world is None else world
        self._kv = kv
        self._rank = int(0 if rank is None else rank)
        self._world = int(1 if world is None else world)
        self._seq = 0

    def _key(self, seq: int, rank: int) -> str:
        return f"pbox_hp/{self.name}/{seq}/{rank}"

    def allgather(self, x: np.ndarray) -> np.ndarray:
        """Gather a same-shape, same-dtype host array from every process ->
        [P, ...] (multiprocess.host_allgather's contract).

        The wait is deadline-bounded and watchdog-aware (module
        docstring); a deadline raises :class:`HostPlaneTimeout` listing the
        missing (channel, sequence, peer) keys, and a peer speaking another
        framing raises :class:`HostPlaneCodecError`."""
        x = np.ascontiguousarray(x)
        payload = _encode_array(x, self.codec)
        s = self._seq  # _gather_raw advances it
        raws = self._gather_raw(payload, "allgather", raw_bytes=x.nbytes)
        parts = [
            x if r == self._rank
            else _decode_array(raws[r], x, self.codec, self.name, s, r)
            for r in range(self._world)
        ]
        return np.stack(parts)

    def gather_bytes(self, payload: bytes) -> list:
        """Varlen opaque-bytes allgather -> [P] list in rank order (the
        census wire's transport face; its framing is the caller's)."""
        return self._gather_raw(bytes(payload), "gather_bytes",
                                raw_bytes=len(payload))

    def _gather_raw(self, payload: bytes, op: str, raw_bytes: int) -> list:
        """One lockstep gather of opaque bytes, under allgather and
        gather_bytes.  Returns [P] raw byte payloads."""
        from paddlebox_tpu_torch.parallel import watchdog as _wd
        from paddlebox_tpu_torch.telemetry import flight

        faults.inject("hostplane.allgather")  # chaos site: raise or hang
        _wd.beat(f"hostplane:{self.name}")
        t_start = time.perf_counter()
        s = self._seq
        self._seq += 1
        # the (channel, seq, op) digest goes into the flight ring BEFORE the
        # wait: if this gather wedges, every rank's dump shows which
        # sequence it reached on which channel
        flight.record("collective", "hostplane.allgather",
                      channel=self.name, seq=s, op=op, rank=self._rank)
        self._kv.set(self._key(s, self._rank),
                     base64.b64encode(payload).decode("ascii"))
        fetched = self._wait_peers(s)
        raws = [payload if r == self._rank else fetched[r]
                for r in range(self._world)]
        # windowed GC of our own past key (module docstring)
        if s >= 2:
            self._delete(s - 2)
        dt = time.perf_counter() - t_start
        base = _channel_base(self.name)
        _GATHER_SECONDS.observe(dt, channel=base)
        from paddlebox_tpu_torch.parallel.census import _gather_bytes_hist

        bh = _gather_bytes_hist()
        bh.observe(float(raw_bytes), channel=base, kind="raw")
        bh.observe(float(len(payload)), channel=base, kind="encoded")
        tr = telemetry.get_tracer()
        if tr is not None:
            end = tr.now_us()
            tr.add_span("hostplane.allgather", end - dt * 1e6, dt * 1e6,
                        channel=self.name, seq=s)
        return raws

    def _wait_peers(self, s: int) -> dict:
        """Every peer's payload at sequence ``s``: polls the missing keys,
        slice by slice, re-checking the watchdog and beating between
        slices (an ACTIVE bounded wait on a peer counts as alive: the
        peer's own watchdog covers the peer, this wait's deadline the
        channel)."""
        from paddlebox_tpu_torch.parallel import watchdog as _wd

        missing = [r for r in range(self._world) if r != self._rank]
        fetched: dict = {}
        deadline = time.monotonic() + self.timeout_s
        while missing:
            _wd.check()  # a pending abort interrupts the wait
            _wd.beat(f"hostplane:{self.name}")
            now = time.monotonic()
            if now >= deadline:
                raise HostPlaneTimeout(
                    self.name, s, self.timeout_s,
                    [(r, self._key(s, r)) for r in missing])
            end = min(deadline, now + self.POLL_S)
            sleep = self._SLEEP_MIN_S
            while missing:
                for r in list(missing):
                    raw = self._kv.get(self._key(s, r))
                    if raw is not None:
                        fetched[r] = base64.b64decode(raw)
                        missing.remove(r)
                if not missing:
                    break
                left = end - time.monotonic()
                if left <= 0:
                    break
                time.sleep(min(sleep, left))
                sleep = min(sleep * 2, self._SLEEP_MAX_S)
        _wd.beat(f"hostplane:{self.name}")
        return fetched

    def _delete(self, seq: int) -> None:
        self._kv.delete(self._key(seq, self._rank))

    def close(self, keep_last: bool = False) -> None:
        """Delete this process's remaining keys (the last two sequences).
        Channels are per pass and names never repeat, so without this a
        long job leaks P keys a pass into the store.  Safe once every peer
        finished the channel's last gather; the trainer calls it after the
        pass's last collective, which proves exactly that.  keep_last
        keeps the last sequence's key, for a caller that cannot know every
        peer has read it (a peer that posted sequence s + 1 had read s);
        it stays in the store, a few bytes."""
        for s in (self._seq - 2,) if keep_last else (self._seq - 1,
                                                      self._seq - 2):
            if s >= 0:
                self._delete(s)
