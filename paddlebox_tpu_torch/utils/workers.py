"""Background threads of the host tier: a FIFO serial worker and a small
thread pool, both of daemon threads started on first use.

The table's pass-boundary pipeline (sparse/table.py) needs strictly ordered
background work (store merges land in pass order), futures for its barrier
sites, and daemon threads, so that a merge held by an injected hang never
blocks interpreter exit.  ``concurrent.futures.ThreadPoolExecutor`` gives
none of the three.  The bucket store (sparse/store.py) fans per-bucket work
over a ``DaemonPool``.

Both retire their threads on ``close()`` and start new ones on the next
submit, so their owner stays usable after a close.  A thread holds only its
job queue, never its owner, and a worker or pool that is garbage collected
retires its threads through a finalizer: a table a test forgets to close
leaves no thread behind once it is collected.
"""

from __future__ import annotations

import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Optional

# how long close() waits for a retiring thread (a job held by an injected
# hang is never waited out: the thread is a daemon and retires after it)
CLOSE_JOIN_S = 5.0


def _loop(q: "queue.Queue") -> None:
    """Run (future, fn, args) jobs from ``q`` until a None arrives."""
    while True:
        item = q.get()
        if item is None:
            return
        fut, fn, args = item
        if not fut.set_running_or_notify_cancel():
            continue
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # surfaced at the future's result()
            fut.set_exception(e)
        # an idle thread must not keep its last job's owner alive
        del item, fut, fn, args


def _stop(q: "queue.Queue", n: int) -> None:
    for _ in range(n):
        q.put(None)


class _Threads:
    """``n`` daemon threads over one job queue, started on first submit."""

    def __init__(self, name: str, n: int):
        self._name = name
        self._n = max(int(n), 1)
        self._lock = threading.Lock()
        self._q: Optional[queue.Queue] = None
        self._threads: list = []
        self._finalizer = None

    @property
    def started(self) -> bool:
        return self._q is not None

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._q is None:
                q: queue.Queue = queue.Queue()
                self._threads = [
                    threading.Thread(target=_loop, args=(q,), daemon=True,
                                     name=f"{self._name}-{i}"
                                     if self._n > 1 else self._name)
                    for i in range(self._n)
                ]
                for t in self._threads:
                    t.start()
                self._q = q
                self._finalizer = weakref.finalize(self, _stop, q, self._n)
            self._q.put((fut, fn, args))
        return fut

    def close(self, wait: bool = True) -> bool:
        """Retire the threads once the jobs queued so far have run.  With
        ``wait``, join them for up to CLOSE_JOIN_S; True when every thread
        exited (or none ran)."""
        with self._lock:
            q, threads = self._q, self._threads
            self._q, self._threads = None, []
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None
        if q is None:
            return True
        _stop(q, len(threads))
        if not wait:
            return True
        for t in threads:
            t.join(CLOSE_JOIN_S)
        return not any(t.is_alive() for t in threads)


class SerialWorker(_Threads):
    """One daemon thread running submitted jobs in submission order."""

    def __init__(self, name: str):
        super().__init__(name, 1)


class DaemonPool(_Threads):
    """``n`` daemon threads running submitted jobs in any order."""
