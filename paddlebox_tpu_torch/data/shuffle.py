"""Global data shuffle: route every record to the worker that owns it
(reference: paddlebox_tpu/data/shuffle.py).

  * ``route_ids``: the destination worker of each instance, by
    ``search_id % n``, by a stable 64-bit hash of the ins_id, or at random
    (reference: data_set.cc:1934-1942).
  * ``InProcessShuffleGroup``: n workers inside one process, each a
    dataset loading on its own thread; a barrier and a mailbox exchange
    the routed sub-blocks, with no serialization.
  * ``TcpShuffler``: processes or hosts as workers, over plain TCP sockets
    with the framed archive wire (data/archive.py block_to_wire).  Every
    worker runs a listener; ``exchange`` sends each peer its routed
    sub-block and concatenates what it receives.  Who listens where is the
    caller's: in a launched job each rank binds port 0 and publishes
    ``bound_port()`` through the job's store (a KvChannel gather).

Attach ``group.shuffler(i)`` (or a started ``TcpShuffler``) to dataset i's
``shuffler`` and the records are exchanged while the dataset loads.  The
exchange is a collective: all n datasets load in the same pass (in one
process each on its own thread, ``preload_into_memory``), or the wait
times out.

Each worker's exchange is a ``shuffle.exchange`` span, observed in
``shuffle.exchange_seconds`` and recorded in the flight ring as a
collective; the TCP exchange also observes its raw and encoded bytes in
``shuffle.exchange_bytes`` and counts undecodable payloads in
``shuffle.wire_errors``.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Optional, Sequence

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch._native import hash_ids_native
from paddlebox_tpu_torch.data.archive import block_from_wire, block_to_wire
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.retry import retry_call

logger = logging.getLogger(__name__)


def _watchdog_mod():
    """The liveness watchdog module (parallel/watchdog.py), imported late:
    the data plane loads before the parallel package."""
    from paddlebox_tpu_torch.parallel import watchdog

    return watchdog


class ShufflePeerError(ConnectionError):
    """A shuffle peer is unreachable: names the worker and its endpoint,
    so a dead listener reads as "worker 3 at 10.0.0.7:6071"."""

    def __init__(self, worker_id: int, endpoint, cause: Exception):
        self.worker_id = int(worker_id)
        self.endpoint = tuple(endpoint)
        host, port = self.endpoint
        super().__init__(
            f"shuffle peer worker {worker_id} at {host}:{port} "
            f"unreachable: {cause!r}"
        )

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def _hash_ins_ids(ins_ids: Sequence[str]) -> np.ndarray:
    """64-bit FNV-1a of each ins_id: the native library's when it built,
    else the identical function in numpy, column by column, so routing
    never depends on which of the two ran."""
    if not len(ins_ids):
        return np.empty(0, dtype=np.uint64)
    native = hash_ids_native(ins_ids)
    if native is not None:
        return native
    enc = [s.encode() for s in ins_ids]
    lens = np.asarray([len(e) for e in enc], dtype=np.int64)
    starts = np.zeros(len(enc), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    flat = np.frombuffer(b"".join(enc), dtype=np.uint8)
    h = np.full(len(enc), _FNV_OFFSET, dtype=np.uint64)
    # one column at a time over the rows still that long: no padded
    # [n, max_len] matrix
    alive = np.arange(len(enc))
    with np.errstate(over="ignore"):
        for j in range(int(lens.max(initial=0))):
            alive = alive[lens[alive] > j]
            c = flat[starts[alive] + j].astype(np.uint64)
            h[alive] = (h[alive] ^ c) * _FNV_PRIME
    return h


def route_ids(block: RecordBlock, n_workers: int, mode: str = "search_id",
              seed: int = 0) -> np.ndarray:
    """Destination worker per instance, int32 [n_ins]."""
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    if block.n_ins == 0:
        return np.empty(0, dtype=np.int32)
    if mode == "search_id":
        if block.search_ids is None:
            raise ValueError(
                "search_id routing needs parse_logkey data (search_ids absent)"
            )
        return (block.search_ids % np.uint64(n_workers)).astype(np.int32)
    if mode == "ins_id":
        if block.ins_ids is None:
            raise ValueError("ins_id routing needs parse_ins_id data")
        return (_hash_ins_ids(block.ins_ids)
                % np.uint64(n_workers)).astype(np.int32)
    if mode == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, n_workers, size=block.n_ins, dtype=np.int32)
    raise ValueError(f"unknown shuffle mode {mode!r}")


def split_by_route(block: RecordBlock, dest: np.ndarray,
                   n_workers: int) -> list:
    """One sub-block per worker, each in the input's order."""
    return [block.select(np.nonzero(dest == d)[0]) for d in range(n_workers)]


# how long a worker waits at the exchange's barrier for the others (module
# level, so tests can shrink it)
BARRIER_TIMEOUT_S = 300.0


class InProcessShuffleGroup:
    """Exchange coordinator of n same-process workers.  Each barrier wait
    is bounded by BARRIER_TIMEOUT_S: a worker that never arrives (a dataset
    loaded on the caller's thread, or one that failed before its exchange)
    breaks the barrier, and every waiting worker raises
    ``threading.BrokenBarrierError`` instead of hanging."""

    def __init__(self, n_workers: int, mode: str = "search_id", seed: int = 0):
        self.n_workers = n_workers
        self.mode = mode
        self.seed = seed
        self._mailboxes: list = [[] for _ in range(n_workers)]
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(n_workers,
                                          timeout=BARRIER_TIMEOUT_S)

    def shuffler(self, worker_id: int) -> "_InProcessShuffler":
        if not 0 <= worker_id < self.n_workers:
            raise ValueError(f"bad worker_id {worker_id}")
        return _InProcessShuffler(self, worker_id)

    def _exchange(self, worker_id: int, block: RecordBlock) -> RecordBlock:
        dest = route_ids(block, self.n_workers, self.mode, self.seed)
        parts = split_by_route(block, dest, self.n_workers)
        with self._lock:
            for d, p in enumerate(parts):
                if p.n_ins:
                    self._mailboxes[d].append((worker_id, p))
        self._barrier.wait()  # every deposit is in
        with self._lock:
            mine = self._mailboxes[worker_id]
            self._mailboxes[worker_id] = []
        # in sender order, whatever order the threads deposited in: the
        # exchanged block is the same every run
        mine = [p for _, p in sorted(mine, key=lambda sp: sp[0])]
        out = (RecordBlock.concat(mine) if mine
               else block.select(np.empty(0, dtype=np.int64)))
        # nobody deposits for the next round until every worker took its
        # mailbox of this one
        self._barrier.wait()
        return out


class _InProcessShuffler:
    def __init__(self, group: InProcessShuffleGroup, worker_id: int):
        self.group = group
        self.worker_id = worker_id
        self._round = 0

    def exchange(self, block: RecordBlock) -> RecordBlock:
        rnd = self._round
        self._round += 1
        with telemetry.span("shuffle.exchange", round=rnd,
                            worker=self.worker_id), \
             telemetry.histogram(
                 "shuffle.exchange_seconds",
                 help="shuffle exchange wall time (s)",
             ).time(worker=str(self.worker_id)):
            # the collective's digest, recorded before the exchange, so a
            # wedged round still names (channel, seq, worker) in a dump
            telemetry.flight.record(
                "collective", "shuffle.exchange", channel="shuffle",
                seq=rnd, op="exchange", rank=self.worker_id,
            )
            return self.group._exchange(self.worker_id, block)


# --------------------------------------------------------------------------- #
# TCP exchange (processes or hosts as workers)
# --------------------------------------------------------------------------- #
_FRAME = struct.Struct("<iiQ")  # sender worker_id, exchange round, length


class TcpShuffler:
    """Socket transport of the exchange (the reference's PaddleShuffler over
    MPI).  ``endpoints[i]`` is the (host, port) of worker i's listener;
    ``start()`` binds this worker's, ``exchange(block)`` routes, sends each
    peer its part and waits for one part from every peer.  One exchange
    round at a time, as the reference's pass-scoped shuffle.

    The wait lasts ``timeout`` seconds: the argument, else the active
    watchdog's ``LivenessConfig.shuffle_timeout_s``, else the
    ``PADDLEBOX_TORCH_SHUFFLE_TIMEOUT_S`` flag.  ``codec`` is the host
    plane's (``PADDLEBOX_TORCH_HOSTPLANE_CODEC``): "varint" compresses each
    routed block's key column, "raw" frames it uncompressed, "legacy" ships
    the bare npz; a receiver decodes any of them, and an unknown framing is
    counted in ``shuffle.wire_errors`` and leaves the round to time out
    naming its sender."""

    # how often the exchange wait re-checks the liveness watchdog's abort
    # latch while it waits on peers
    POLL_S = 0.2

    def __init__(self, endpoints: Sequence[tuple], worker_id: int,
                 mode: str = "search_id", seed: int = 0,
                 timeout: Optional[float] = None,
                 codec: Optional[str] = None):
        from paddlebox_tpu_torch.config import flags

        if codec is None:
            codec = flags.hostplane_codec
        if codec not in ("varint", "raw", "legacy"):
            raise ValueError(f"codec must be varint|raw|legacy, got {codec!r}")
        self.codec = codec
        if timeout is None:
            wd = _watchdog_mod().current()
            timeout = (wd.conf.shuffle_timeout_s if wd is not None
                       else flags.shuffle_timeout_s)
        self.endpoints = list(endpoints)
        self.n_workers = len(self.endpoints)
        self.worker_id = worker_id
        self.mode = mode
        self.seed = seed
        self.timeout = float(timeout)
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        # keyed by (sender, round): a fast peer may deliver round N + 1
        # while this worker still waits on round N
        self._received: dict = {}
        self._recv_cv = threading.Condition()
        self._round = 0
        self._stop = False

    # -- listener ---------------------------------------------------------- #
    def start(self) -> None:
        host, port = self.endpoints[self.worker_id]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(self.n_workers)
        srv.settimeout(0.2)
        self._server = srv
        self._accept_thread = threading.Thread(target=self._serve,
                                               daemon=True)
        self._accept_thread.start()

    def bound_port(self) -> int:
        """The listener's port (the one the system picked for port 0)."""
        return self._server.getsockname()[1]

    def _serve(self) -> None:
        while not self._stop:
            srv = self._server
            if srv is None:
                return
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self.timeout)
            sender, rnd, n = _FRAME.unpack(_recv_exact(conn, _FRAME.size))
            payload = _recv_exact(conn, n)
            try:
                block = block_from_wire(payload)
            except Exception:
                # loud: the round then times out naming the sender
                telemetry.counter(
                    "shuffle.wire_errors",
                    "shuffle payloads that failed wire decode "
                    "(codec mismatch or corruption)",
                ).inc()
                logger.error("shuffle wire decode failed for worker %s "
                             "round %s", sender, rnd, exc_info=True)
                return
            with self._recv_cv:
                self._received[(sender, rnd)] = block
                self._recv_cv.notify_all()
        finally:
            conn.close()

    def close(self) -> None:
        """Stop the listener.  Idempotent: the normal exit and an abort
        path may both close."""
        if self._stop:
            return
        self._stop = True
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        t, self._accept_thread = self._accept_thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._server = None

    # -- exchange ---------------------------------------------------------- #
    def _send_to_peer(self, peer: int, rnd: int, payload: bytes) -> None:
        """Connect, frame and send to one peer, retried at the site
        "shuffle.connect" (a peer's listener coming up late is absorbed;
        exhaustion names the peer).  A whole retry is safe: the receiver
        keys delivery by (sender, round), so a duplicate overwrites with
        the same bytes."""

        def attempt() -> None:
            with socket.create_connection(self.endpoints[peer],
                                          timeout=self.timeout) as c:
                c.settimeout(self.timeout)
                c.sendall(_FRAME.pack(self.worker_id, rnd, len(payload)))
                c.sendall(payload)

        try:
            retry_call(attempt, site="shuffle.connect")
        except OSError as e:
            raise ShufflePeerError(peer, self.endpoints[peer], e) from e

    def exchange(self, block: RecordBlock) -> RecordBlock:
        """This worker's own routed part, then every peer's in worker
        order."""
        with telemetry.span("shuffle.exchange", round=self._round,
                            worker=self.worker_id), \
             telemetry.histogram(
                 "shuffle.exchange_seconds",
                 help="shuffle exchange wall time (s)",
             ).time(worker=str(self.worker_id)):
            return self._exchange(block)

    def _exchange(self, block: RecordBlock) -> RecordBlock:
        wd_mod = _watchdog_mod()
        wd_mod.beat("shuffle")
        faults.inject("shuffle.exchange")  # chaos site: raise or hang
        rnd = self._round
        self._round += 1
        # the collective's digest, recorded before the sends: a wedged round
        # still names (channel, seq, worker) in this worker's flight dump
        telemetry.flight.record(
            "collective", "shuffle.exchange", channel="shuffle", seq=rnd,
            op="exchange", rank=self.worker_id,
        )
        dest = route_ids(block, self.n_workers, self.mode, self.seed)
        parts = split_by_route(block, dest, self.n_workers)
        raw_b = wire_b = 0
        for peer, part in enumerate(parts):
            if peer == self.worker_id:
                continue
            payload, rb, wb = block_to_wire(part, self.codec)
            raw_b += rb
            wire_b += wb
            self._send_to_peer(peer, rnd, payload)
        if self.n_workers > 1:
            from paddlebox_tpu_torch.parallel.census import BYTE_BUCKETS

            bh = telemetry.histogram(
                "shuffle.exchange_bytes",
                "shuffle key-payload bytes sent per exchange by worker "
                "(raw = 8B/key equivalent, encoded = on-wire)",
                buckets=BYTE_BUCKETS,
            )
            bh.observe(float(raw_b), worker=str(self.worker_id), kind="raw")
            bh.observe(float(wire_b), worker=str(self.worker_id),
                       kind="encoded")
        expected = {(p, rnd) for p in range(self.n_workers)
                    if p != self.worker_id}
        deadline = time.monotonic() + self.timeout
        with self._recv_cv:
            while not expected.issubset(self._received):
                # a coordinated abort interrupts the wait; an active bounded
                # wait on peers counts as alive (each peer's own watchdog
                # covers the peer, this wait's timeout names the laggards)
                wd_mod.check()
                wd_mod.beat("shuffle")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(p for p, _ in
                                     expected - set(self._received))
                    where = ", ".join(
                        f"worker {p} at {self.endpoints[p][0]}:"
                        f"{self.endpoints[p][1]}" for p in missing)
                    raise TimeoutError(
                        f"shuffle exchange round {rnd} timed out after "
                        f"{self.timeout:.1f}s: no data from {where}")
                self._recv_cv.wait(timeout=min(self.POLL_S, remaining))
            got = [self._received.pop(k) for k in sorted(expected)]
        wd_mod.beat("shuffle")
        return RecordBlock.concat([parts[self.worker_id], *got])


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = conn.recv(min(1 << 20, n - got))
        if not chunk:
            raise EOFError("peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
