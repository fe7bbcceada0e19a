"""Async dense parameter server: host-held master parameters and a
background optimizer thread (reference: paddlebox_tpu/parallel/async_dense.py,
the ``BoxPSAsynDenseTable`` analog).

The multi-chip trainer's ``sync_dense_mode="async"`` sums the positions'
dense gradients on the device as "step" mode does, but applies no dense
optimizer there: ``push()`` queues the summed gradient (host numpy) into a
bounded queue, whose depth is the reference's double buffer (a full queue
blocks the producer, which bounds staleness); a daemon thread takes each
gradient and applies a numpy optimizer to the master copy, leaf by leaf
over a small daemon pool; ``pull()`` snapshots the master copy for the
periodic refresh of the device parameters.

Staleness: with queue depth q and pull interval k, a step's parameters lag
at most q + k pushes.  The trainer pushes each step's gradient one step
late: each step's gradient leaves the card by a non-blocking copy into
pinned memory with an event behind it, and the push waits on that event,
so it never waits on the step just dispatched.

A dead update thread surfaces on the next ``push``, ``pull``, ``drain`` or
``stop``.  ``stop`` retires the threads; the threads hold their queue and
shared state, never the table, and a table that is collected stops them.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Any, Optional

import numpy as np

from paddlebox_tpu_torch.utils.queues import bounded_put
from paddlebox_tpu_torch.utils.workers import CLOSE_JOIN_S, DaemonPool


class _NumpyAdam:
    """optax.adam semantics (bias-corrected first and second moments) in
    numpy."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m: Optional[list] = None
        self.v: Optional[list] = None
        self.t = 0

    def init(self, leaves: list) -> None:
        self.m = [np.zeros_like(l) for l in leaves]
        self.v = [np.zeros_like(l) for l in leaves]

    def update_leaf(self, i: int, param: np.ndarray, grad: np.ndarray) -> None:
        m = self.m[i] = self.b1 * self.m[i] + (1 - self.b1) * grad
        v = self.v[i] = self.b2 * self.v[i] + (1 - self.b2) * grad * grad
        mh = m / (1 - self.b1 ** self.t)
        vh = v / (1 - self.b2 ** self.t)
        param -= self.lr * mh / (np.sqrt(vh) + self.eps)

    def step_begin(self) -> None:
        self.t += 1


class _NumpySgd:
    def __init__(self, lr: float):
        self.lr = lr

    def init(self, leaves: list) -> None:
        pass

    def update_leaf(self, i: int, param: np.ndarray, grad: np.ndarray) -> None:
        param -= self.lr * grad

    def step_begin(self) -> None:
        pass


class _Shared:
    """What the update thread and the table share: the thread's error
    latch (one reference store, tested by the readers) and the count of
    gradients applied."""

    def __init__(self):
        self.err: Optional[BaseException] = None
        self.applied = 0
        self.stop = threading.Event()


def _update_loop(q: "queue.Queue", leaves: list, opt, lock: threading.Lock,
                 pool: DaemonPool, shared: _Shared) -> None:
    """Apply queued gradients to ``leaves`` until a None arrives or stop is
    set; on an error, latch it and drain the queue so that no producer
    stays blocked on a full one."""
    try:
        while True:
            grads = q.get()
            if grads is None or shared.stop.is_set():
                q.task_done()
                return
            opt.step_begin()
            with lock:
                futures = [pool.submit(opt.update_leaf, i, leaves[i], g)
                           for i, g in enumerate(grads)]
                for f in futures:
                    f.result()
            shared.applied += 1
            q.task_done()
    except BaseException as e:  # surfaced on the next push/pull/drain/stop
        shared.err = e
        q.task_done()  # the item in flight
        while True:
            try:
                q.get_nowait()
                q.task_done()
            except queue.Empty:
                return


def _retire(q: "queue.Queue", shared: _Shared, pool: DaemonPool) -> None:
    shared.stop.set()
    try:
        q.put_nowait(None)  # wake the thread; Full: it has work and sees stop
    except queue.Full:
        pass
    pool.close(wait=False)


def _leaves(tree: Any) -> tuple:
    """(names or None, float32 numpy leaves) of a dict or a sequence of
    arrays (torch tensors are read to the host)."""
    def np_of(x):
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.array(x, dtype=np.float32)

    if isinstance(tree, dict):
        return list(tree), [np_of(v) for v in tree.values()]
    return None, [np_of(v) for v in tree]


class AsyncDenseTable:
    """Host master parameters, a bounded gradient queue and a background
    update thread.

    params: a dict of arrays (or a sequence of them), the initial dense
    state; the table keeps its own copy, and ``push`` takes gradients of
    the same structure (or a flat list of leaves in the same order)."""

    def __init__(self, params: Any, optimizer: str = "adam",
                 lr: float = 1e-3, queue_depth: int = 2,
                 update_threads: int = 4):
        self._names, self._leaves = _leaves(params)
        if optimizer == "adam":
            self._opt = _NumpyAdam(lr)
        elif optimizer == "sgd":
            self._opt = _NumpySgd(lr)
        else:
            raise ValueError(f"unknown async dense optimizer {optimizer!r}")
        self._opt.init(self._leaves)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._lock = threading.Lock()  # the leaves against pull()
        self._pool = DaemonPool("async-dense", update_threads)
        self._shared = _Shared()
        self.pushes = 0  # gradients queued
        self._thread = threading.Thread(
            target=_update_loop, name="async-dense-master", daemon=True,
            args=(self._q, self._leaves, self._opt, self._lock, self._pool,
                  self._shared),
        )
        self._thread.start()
        self._finalizer = weakref.finalize(self, _retire, self._q,
                                           self._shared, self._pool)

    @property
    def applied(self) -> int:
        """Gradients folded into the master copy."""
        return self._shared.applied

    def _raise_if_dead(self) -> None:
        if self._shared.err is not None:
            raise RuntimeError(
                "async dense update thread died") from self._shared.err

    # -- worker-facing API -------------------------------------------------- #
    def push(self, grads: Any) -> None:
        """Queue one summed dense gradient.  Blocks while queue_depth
        gradients are in flight (the double buffer's backpressure), and
        raises instead of waiting forever when the update thread died."""
        leaves = list(grads) if isinstance(grads, list) else _leaves(grads)[1]
        if not bounded_put(self._q, leaves,
                           lambda: self._shared.err is not None):
            self._raise_if_dead()
        self.pushes += 1

    def pull(self) -> Any:
        """Copy of the master parameters in the structure they came in."""
        self._raise_if_dead()
        with self._lock:
            leaves = [l.copy() for l in self._leaves]
        if self._names is None:
            return leaves
        return dict(zip(self._names, leaves))

    def drain(self) -> None:
        """Wait until every pushed gradient has been applied (the pass
        boundary).  Polls, so a dying update thread raises here instead of
        hanging the boundary."""
        while True:
            self._raise_if_dead()
            with self._q.all_tasks_done:
                if self._q.unfinished_tasks == 0:
                    return
                self._q.all_tasks_done.wait(timeout=0.2)

    def stop(self) -> None:
        """Retire the update thread and its pool; raises when the thread
        had died."""
        self._finalizer.detach()
        _retire(self._q, self._shared, self._pool)
        self._thread.join(CLOSE_JOIN_S)
        self._raise_if_dead()
