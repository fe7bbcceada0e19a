"""Global data shuffle: route every record to the worker that owns it
(reference: paddlebox_tpu/data/shuffle.py, its routing and in-process
exchange; the TCP transport comes with the multi-process plane, ROADMAP.md
Queue A item 8).

  * ``route_ids``: the destination worker of each instance, by
    ``search_id % n``, by a stable 64-bit hash of the ins_id, or at random
    (reference: data_set.cc:1934-1942).
  * ``InProcessShuffleGroup``: n workers inside one process, each a
    dataset loading on its own thread; a barrier and a mailbox exchange
    the routed sub-blocks, with no serialization.

Attach ``group.shuffler(i)`` to dataset i's ``shuffler`` and the records
are exchanged while the dataset loads.  The exchange is a collective: all
n datasets load in the same pass, each on its own thread
(``preload_into_memory``), or the barrier times out.

Each worker's exchange is a ``shuffle.exchange`` span, observed in
``shuffle.exchange_seconds`` and recorded in the flight ring as a
collective, as the reference's TCP exchange records its own; nothing
crosses a wire in one process, so ``shuffle.exchange_bytes`` and
``shuffle.wire_errors`` come with the TCP transport.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch._native import hash_ids_native
from paddlebox_tpu_torch.data.record import RecordBlock

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
