"""Instance field dumps and parameter dumps (reference:
paddlebox_tpu/train/dump.py; DumpField / DumpParam of the reference's
trainers).

Line format, one per real instance:

    <ins_id>\t<label>\t<pred>[\t<name>:<value>...]

The ins_id is the instance's (``parse_ins_id``) or its running number in
the dump; the extra columns come from ``fields``, any of "task_labels",
"cmatch", "rank" and "dense".  The train thread only queues the batch and
its predictions; a daemon writer thread formats and writes them.
"""

from __future__ import annotations

import os
import queue
import threading
import weakref
from typing import Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.weights import jax_key_paths, params_to_jax

# how long close() waits for the writer to drain its queue
CLOSE_JOIN_S = 60.0


def format_batch(batch, preds: np.ndarray, base: int,
                 fields: Sequence[str]) -> str:
    """The dump lines of one batch's real instances (padding rows have
    none); ``base`` numbers the instances when the batch has no ins_ids."""
    lines = []
    for i in range(batch.n_real_ins):
        ins_id = batch.ins_ids[i] if batch.ins_ids else str(base + i)
        cols = [ins_id, f"{batch.labels[i]:.0f}", f"{preds[i]:.6f}"]
        for f in fields:
            if f == "task_labels" and batch.task_labels is not None:
                cols.append("task_labels:" + ",".join(
                    f"{v:.0f}" for v in batch.task_labels[i]))
            elif f == "cmatch" and batch.cmatches is not None:
                cols.append(f"cmatch:{batch.cmatches[i]}")
            elif f == "rank" and batch.ranks is not None:
                cols.append(f"rank:{batch.ranks[i]}")
            elif f == "dense":
                cols.append("dense:" + ",".join(
                    f"{v:.6g}" for v in batch.dense[i]))
        lines.append("\t".join(cols))
    return "\n".join(lines) + "\n" if lines else ""


def _write_loop(q: "queue.Queue", fh, fields: tuple, error: list) -> None:
    """Format and write queued batches until a None arrives.  After a
    failure it keeps draining, so that no producer blocks on a full queue;
    the first error is latched in ``error``."""
    while True:
        item = q.get()
        if item is None:
            return
        if error:
            continue
        try:
            fh.write(format_batch(*item, fields))
        except Exception as e:  # disk full or quota: raised at the next call
            error.append(e)


class FieldDumper:
    """Per-instance text dump of a pass: a bounded queue and one daemon
    writer thread.  The thread holds the queue and the file, never the
    dumper, and a dumper that is collected unclosed stops it."""

    def __init__(self, path: str, fields: Sequence[str] = ()):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.fields = tuple(fields)
        self.n_dumped = 0
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._fh = open(path, "w")
        self._error: list = []
        self._thread = threading.Thread(
            target=_write_loop, args=(self._q, self._fh, self.fields,
                                      self._error),
            name="field-dump", daemon=True,
        )
        self._thread.start()
        self._finalizer = weakref.finalize(self, self._q.put, None)

    def _raise_latched(self) -> None:
        if self._error:
            raise RuntimeError(
                f"field dump to {self.path} failed") from self._error[0]

    def dump_batch(self, batch, preds: np.ndarray) -> None:
        """Queue one batch's real instances.  The batch's arrays must not
        change afterwards (the feed builds a new HostBatch per batch)."""
        self._raise_latched()
        self._q.put((batch, np.asarray(preds), self.n_dumped))
        self.n_dumped += batch.n_real_ins

    def close(self) -> None:
        """Drain the queue, join the writer (for at most CLOSE_JOIN_S) and
        close the file; raises a latched write error."""
        if self._finalizer.detach() is not None:
            self._q.put(None)
        self._thread.join(timeout=CLOSE_JOIN_S)
        if self._thread.is_alive():
            raise RuntimeError(
                f"field dump writer for {self.path} did not drain in time")
        self._fh.close()
        self._raise_latched()

    def __enter__(self) -> "FieldDumper":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def dump_params(path: str, model_state: dict, table=None,
                select: Sequence[str] = ()) -> None:
    """Post-pass parameter dump (reference: DumpParam): the dense tower at
    ``path + ".dense.npz"``, keyed by the reference's parameter paths
    (``['tower'][0]['w']``, weights.params_to_jax), and, with a table, its
    rows at ``path + ".sparse.npz"`` (keys, values with the g2sum column;
    mid-pass safe).  ``select`` keeps the dense leaves whose path contains
    one of its substrings; empty keeps all."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = jax_key_paths(params_to_jax(model_state))
    if select:
        flat = {k: v for k, v in flat.items() if any(s in k for s in select)}
    np.savez(path + ".dense.npz", **flat)
    if table is not None:
        state = table.pass_state_dict()
        np.savez(path + ".sparse.npz", keys=state["keys"],
                 values=state["values"])
