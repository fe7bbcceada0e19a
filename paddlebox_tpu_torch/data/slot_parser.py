"""Slot-formatted text parsing into columnar RecordBlocks (reference:
paddlebox_tpu/data/slot_parser.py).

One instance per line, slots in config order:

    [ins_id] [search_id:rank:cmatch] <n> v1 ... vn  <n> v1 ... vn  ...

The ``ins_id`` prefix is read with ``parse_ins_id``, the logkey prefix with
``parse_logkey``.  uint64 slots hold feature signs, float slots hold floats.
The slot named ``label_slot`` supplies the label (its first value) and a
slot of ``task_label_slots`` a task label (its first value); neither enters
the dense matrix.  ``pipe_command`` runs a shell command over each file
and parses its output (a non-zero exit raises the retryable ``FsError``).

Two implementations share one walk layout: the pure-Python ``parse_lines``
and the native C++ parser (``_native/slot_parser.cpp``) that ``parse_file``
prefers when it builds and ``malformed_policy`` is "raise", as in the
reference.  PADDLEBOX_TORCH_USE_NATIVE_PARSER=0 turns the native one off.
"""

from __future__ import annotations

import gzip
import io
import logging
import subprocess
import threading
from typing import Iterable, Optional

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, flags
from paddlebox_tpu_torch.data.record import RecordBlock
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.fs import FsError
from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)

# bytes the native parser reads from a stream (.gz) at a time
_NATIVE_CHUNK = 64 << 20


class SlotParser:
    def __init__(self, conf: DataFeedConfig):
        self.conf = conf
        self.sparse_slots = conf.sparse_slots()
        sparse_names = {s.name: i for i, s in enumerate(self.sparse_slots)}
        dense_cols = {}
        col = 0
        for s in conf.dense_slots():
            dense_cols[s.name] = col
            col += int(np.prod(s.shape))
        task_cols = {name: i for i, name in enumerate(conf.task_label_slots)}
        # walk order over every slot present in a line (used or not)
        self._walk = []  # (kind, width, sparse index or dense/task column)
        for s in conf.slots:
            if s.name == conf.label_slot:
                self._walk.append(("label", int(np.prod(s.shape)), -1))
            elif s.name in task_cols:
                self._walk.append(
                    ("task", int(np.prod(s.shape)), task_cols[s.name])
                )
            elif s.name in sparse_names:
                self._walk.append(("sparse", -1, sparse_names[s.name]))
            elif s.name in dense_cols:
                self._walk.append(
                    ("dense", int(np.prod(s.shape)), dense_cols[s.name])
                )
            else:
                self._walk.append(("skip", -1, -1))
        self.dense_width = col
        self.n_task_labels = len(task_cols)
        self.n_sparse = len(self.sparse_slots)
        self._native = None
        self._native_tried = False
        # reader threads call parse_file together: the first builds the
        # native parser while the others wait for it
        self._native_lock = threading.Lock()
        # quarantine accounting (malformed_policy="skip"); parse_file runs
        # in reader threads, hence the lock
        self._quar_lock = threading.Lock()
        self.quarantined_lines = 0
        self.quarantined_files = 0
        self.parsed_lines = 0

    def _native_parser(self):
        """The C++ parser, built and bound on first use; None when the flag
        is off, the policy is "skip" or the library did not build."""
        with self._native_lock:
            if self._native_tried:
                return self._native
            self._native_tried = True
            if not flags.use_native_parser:
                return None
            if self.conf.malformed_policy != "raise":
                # the native parser aborts on the first malformed line; the
                # quarantine walk (skip, count, roll back) is Python only
                return None
            from paddlebox_tpu_torch._native import NativeParser

            try:
                self._native = NativeParser(
                    self._walk, self.n_sparse, self.dense_width,
                    self.n_task_labels, self.conf.parse_ins_id,
                    self.conf.parse_logkey,
                )
            except (RuntimeError, OSError):
                self._native = None  # unavailable: the Python parser
            return self._native

    def _native_parse_stream(self, native, fh, path: str) -> RecordBlock:
        """Feed a binary stream to the native parser in 64 MB chunks cut at
        line boundaries (a .gz shard is never held whole), the tail after
        the last newline carried into the next chunk."""
        blocks = []
        carry = b""
        while True:
            data = fh.read(_NATIVE_CHUNK)
            if not data:
                break
            data = carry + data
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            carry = data[cut + 1:]
            blocks.append(native.parse_bytes(data[: cut + 1], path=path))
        if carry:
            blocks.append(native.parse_bytes(carry, path=path))
        if not blocks:
            return native.parse_bytes(b"", path=path)
        return RecordBlock.concat(blocks)

    def parse_lines(self, lines: Iterable[str], path: str = "<lines>") -> RecordBlock:
        conf = self.conf
        keys: list[int] = []
        offsets: list[int] = [0]
        dense_rows: list[list[float]] = []
        labels: list[float] = []
        task_rows: Optional[list] = [] if self.n_task_labels else None
        ins_ids: Optional[list] = [] if conf.parse_ins_id else None
        search_ids: Optional[list] = [] if conf.parse_logkey else None
        ranks: Optional[list] = [] if conf.parse_logkey else None
        cmatches: Optional[list] = [] if conf.parse_logkey else None
        acc = [a for a in (keys, offsets, dense_rows, labels, task_rows,
                           ins_ids, search_ids, ranks, cmatches)
               if a is not None]
        skip_malformed = conf.malformed_policy == "skip"
        n_ins = 0
        n_skipped = 0
        first_bad = None
        for lineno, line in enumerate(lines, start=1):
            toks = line.split()
            if not toks:
                continue
            marks = [len(a) for a in acc]
            try:
                self._parse_one(toks, keys, offsets, dense_rows, labels,
                                task_rows, ins_ids, search_ids, ranks,
                                cmatches)
            except (IndexError, ValueError) as e:
                if not skip_malformed:
                    raise ValueError(
                        f"{path}:{lineno}: malformed instance ({e})"
                    ) from e
                # quarantine: roll back the partial appends, count, move on
                for a, m in zip(acc, marks):
                    del a[m:]
                n_skipped += 1
                if first_bad is None:
                    first_bad = f"{path}:{lineno}: {e}"
                continue
            n_ins += 1

        with self._quar_lock:
            self.parsed_lines += n_ins
            if n_skipped:
                self.quarantined_lines += n_skipped
                self.quarantined_files += 1
        if n_skipped:
            stats.add("data.quarantined_lines", n_skipped)
            stats.add("data.quarantined_files")
            logger.warning(
                "quarantined %d malformed line(s) in %s (first: %s)",
                n_skipped, path, first_bad,
            )
        opt = lambda v, dt: None if v is None else np.asarray(v, dtype=dt)
        return RecordBlock(
            n_ins=n_ins,
            n_sparse_slots=self.n_sparse,
            keys=np.asarray(keys, dtype=np.uint64),
            key_offsets=np.asarray(offsets, dtype=np.int64),
            dense=np.asarray(dense_rows, dtype=np.float32).reshape(
                n_ins, self.dense_width
            ),
            labels=np.asarray(labels, dtype=np.float32),
            ins_ids=ins_ids,
            search_ids=opt(search_ids, np.uint64),
            ranks=opt(ranks, np.int32),
            cmatches=opt(cmatches, np.int32),
            task_labels=None if task_rows is None else np.asarray(
                task_rows, dtype=np.float32).reshape(n_ins, self.n_task_labels),
        )

    def _parse_one(self, toks, keys, offsets, dense_rows, labels, task_rows,
                   ins_ids, search_ids, ranks, cmatches) -> None:
        """Parse one tokenized instance into the accumulator lists."""
        p = 0
        if ins_ids is not None:
            ins_ids.append(toks[p])
            p += 1
        if search_ids is not None:
            sid, rk, cm = toks[p].split(":")
            search_ids.append(int(sid))
            ranks.append(int(rk))
            cmatches.append(int(cm))
            p += 1
        drow = [0.0] * self.dense_width
        trow = [0.0] * self.n_task_labels
        label = 0.0
        per_slot_counts = []
        for kind, width, col in self._walk:
            n = int(toks[p])
            p += 1
            if kind == "skip":
                p += n
            elif kind in ("label", "task"):
                if n != width:
                    raise ValueError(
                        f"{'label' if kind == 'label' else 'task label'} "
                        f"slot expected {width} values, got {n}"
                    )
                if kind == "label":
                    label = float(toks[p])
                else:
                    trow[col] = float(toks[p])  # its first value
                p += n
            elif kind == "dense":
                if n != width:
                    raise ValueError(
                        f"dense slot expected {width} values, got {n}"
                    )
                for j in range(n):
                    drow[col + j] = float(toks[p + j])
                p += n
            else:  # sparse
                for j in range(n):
                    keys.append(int(toks[p + j]))
                p += n
                per_slot_counts.append(n)
        if p < len(toks):
            raise ValueError(f"{len(toks) - p} trailing tokens")
        for c in per_slot_counts:
            offsets.append(offsets[-1] + c)
        dense_rows.append(drow)
        if task_rows is not None:
            task_rows.append(trow)
        labels.append(label)

    def parse_file(self, path: str) -> RecordBlock:
        """Read one plain or .gz file, or ``pipe_command``'s output over it,
        and parse it: natively when the native parser is available (a plain
        file in one read, a stream in line-aligned chunks), else line by
        line in Python.  The fault site ``data.read``; a failed pipe raises
        the retryable ``FsError`` (the dataset retries the read)."""
        faults.inject("data.read")
        native = self._native_parser()
        if self.conf.pipe_command:
            return self._parse_pipe(native, path)
        if path.endswith(".gz"):
            if native is not None:
                with gzip.open(path, "rb") as f:
                    return self._native_parse_stream(native, f, path)
            with gzip.open(path, "rt") as f:
                return self.parse_lines(f, path=path)
        if native is not None:
            with open(path, "rb") as f:
                return native.parse_bytes(f.read(), path=path)
        with open(path, "r") as f:
            return self.parse_lines(f, path=path)

    def _parse_pipe(self, native, path: str) -> RecordBlock:
        """``pipe_command`` over the file, its output streamed to the parser
        (reference: LoadIntoMemoryByLine forks the command over the file)."""
        with open(path, "rb") as src:
            proc = subprocess.Popen(self.conf.pipe_command, shell=True,
                                    stdin=src, stdout=subprocess.PIPE)
            try:
                if native is not None:
                    block = self._native_parse_stream(native, proc.stdout, path)
                else:
                    text = io.TextIOWrapper(proc.stdout, encoding="utf-8")
                    block = self.parse_lines(text, path=path)
            finally:
                proc.stdout.close()
                ret = proc.wait()
        if ret != 0:
            raise FsError(
                f"pipe_command {self.conf.pipe_command!r} on {path} "
                f"exited {ret}"
            )
        return block
