"""Native (C++) host components, loaded through ctypes (reference:
paddlebox_tpu/_native/__init__.py).

Two plain-C libraries, each from its source beside this file:

  * ``slot_parser.cpp``: the slot-text parser (``NativeParser``) and the
    batch FNV-1a hash of instance ids (``hash_ids_native``);
  * ``plan_resolve.cpp``: the batch planner's per-pass census hash index
    (``CensusIndex``, ``build_census_index``) and the stateless first-seen
    dedup of the sharded serve side (``dedup_rows_native``).

Each builds with ``g++`` at its first use, once per process under a lock,
into ``paddlebox_tpu_torch/_build/`` under a name that carries a hash of the
source, the flags and the target ``-march=native`` resolves to, so an
edited source or another host CPU rebuilds and an unchanged one is reused
(the reference builds next to its source and decides staleness by mtime,
which a checkout that flattens mtimes defeats).  ``build_log`` keeps each
build's seconds and compiler output.

As in the reference, a failed build is not an error: ``get_lib`` and
``get_plan_lib`` return None and the callers take their numpy and Python
paths.  ``chip_smoke.py`` checks that both libraries built.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

# name -> {"seconds": float, "log": str, "ok": bool} for builds this
# process attempted (a library found already built has no entry)
build_log: dict = {}

_target_lock = threading.Lock()
_target: Optional[str] = None


def compiler_version() -> str:
    """First line of ``g++ --version``, or why there is none."""
    try:
        out = subprocess.run([CXX, "--version"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{CXX} unavailable ({e})"
    return (out.stdout.splitlines() or [""])[0]


def _native_target() -> str:
    """What ``-march=native`` means on this host: the compiler's verbose
    preprocessor line, which spells out the target and its features."""
    global _target
    with _target_lock:
        if _target is None:
            try:
                out = subprocess.run(
                    [CXX, "-march=native", "-E", "-v", "-x", "c++", "-"],
                    input="", capture_output=True, text=True, timeout=60,
                )
                _target = out.stderr
            except (OSError, subprocess.SubprocessError):
                _target = ""
        return _target


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_native_target().encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build_so(name: str) -> Optional[Path]:
    """The built library for ``<name>.cpp``, compiled now if it is not
    there yet; None on any failure (the reason lands in build_log)."""
    try:
        out = library_path(name)
    except OSError as e:  # the source is missing
        build_log[name] = {"seconds": 0.0, "log": str(e), "ok": False}
        return None
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
    t0 = time.perf_counter()
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        log = proc.stdout + proc.stderr
        ok = proc.returncode == 0
        if ok:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    except (OSError, subprocess.SubprocessError) as e:
        log, ok = str(e), False
    build_log[name] = {"seconds": time.perf_counter() - t0, "log": log,
                       "ok": ok}
    if not ok:
        if tmp.exists():
            tmp.unlink()
        logger.warning("native %s did not build; numpy/Python paths: %s",
                       name, log)
        return None
    return out


class _Loaded:
    """One library, built and bound once per process under its lock."""

    def __init__(self, name: str, bind):
        self.name = name
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def get(self):
        with self._lock:
            if not self._tried:
                self._tried = True
                # holding the lock through the compile is the point: every
                # caller waits for the one build instead of racing its own
                so = _build_so(self.name)
                if so is not None:
                    lib = ctypes.CDLL(str(so))
                    self._bind(lib)
                    self._lib = lib
            return self._lib


def _bind_parser_symbols(lib) -> None:
    lib.pbx_parse_buffer.restype = ctypes.c_void_p
    lib.pbx_parse_buffer.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    for name in ("pbx_n_ins", "pbx_n_keys", "pbx_ins_id_bytes"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.pbx_fill.restype = None
    lib.pbx_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 10
    lib.pbx_free.restype = None
    lib.pbx_free.argtypes = [ctypes.c_void_p]
    lib.pbx_hash_ids.restype = None
    lib.pbx_hash_ids.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
    ]


def _bind_plan_symbols(lib) -> None:
    lib.pbx_census_index_build.restype = ctypes.c_void_p
    lib.pbx_census_index_build.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
    ]
    lib.pbx_census_index_free.restype = None
    lib.pbx_census_index_free.argtypes = [ctypes.c_void_p]
    lib.pbx_plan_resolve.restype = ctypes.c_int64
    lib.pbx_plan_resolve.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.pbx_dedup_rows.restype = ctypes.c_int64
    lib.pbx_dedup_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pbx_census_lookup_unique.restype = ctypes.c_int64
    lib.pbx_census_lookup_unique.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64),
    ]


_parser_lib = _Loaded("slot_parser", _bind_parser_symbols)
_plan_lib = _Loaded("plan_resolve", _bind_plan_symbols)


def get_lib():
    """The loaded parser library, or None (the build failed)."""
    return _parser_lib.get()


def get_plan_lib():
    """The loaded planner library, or None (the build failed)."""
    return _plan_lib.get()


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def hash_ids_native(ins_ids) -> Optional[np.ndarray]:
    """Batch FNV-1a 64 of instance ids; None when the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    enc = [s.encode() for s in ins_ids]
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    out = np.empty(len(enc), dtype=np.uint64)
    lib.pbx_hash_ids(b"".join(enc),
                     offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     len(enc), _u64p(out))
    return out


_KIND_CODE = {"skip": 0, "label": 1, "task": 2, "dense": 3, "sparse": 4}


class NativeParser:
    """ctypes front end bound to one SlotParser's walk layout: a list of
    (kind, width, sparse index or dense/task column) per slot in line
    order, with the task-label count and the ins_id / logkey prefixes."""

    def __init__(self, walk, n_sparse: int, dense_width: int, n_tasks: int,
                 parse_ins_id: bool, parse_logkey: bool):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native parser unavailable")
        self._kinds = np.asarray([_KIND_CODE[k] for k, _, _ in walk],
                                 dtype=np.int8)
        self._widths = np.asarray([max(w, 0) for _, w, _ in walk],
                                  dtype=np.int32)
        self._cols = np.asarray([max(c, 0) for _, _, c in walk],
                                dtype=np.int32)
        self.n_sparse = n_sparse
        self.dense_width = dense_width
        self.n_tasks = n_tasks
        self.parse_ins_id = parse_ins_id
        self.parse_logkey = parse_logkey

    def parse_bytes(self, data: bytes, path: str = "<buffer>"):
        """Parse a whole buffer of lines into one RecordBlock; a malformed
        line raises ValueError naming ``path`` and the line."""
        from paddlebox_tpu_torch.data.record import RecordBlock

        lib = self.lib
        err = ctypes.create_string_buffer(256)
        handle = lib.pbx_parse_buffer(
            data, len(data),
            self._kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            _i32p(self._widths), _i32p(self._cols),
            len(self._kinds), self.n_sparse, self.dense_width, self.n_tasks,
            int(self.parse_ins_id), int(self.parse_logkey), err, 256,
        )
        if not handle:
            raise ValueError(
                f"{path}: malformed instance ({err.value.decode()})"
            )
        try:
            n = lib.pbx_n_ins(handle)
            keys = np.empty(lib.pbx_n_keys(handle), dtype=np.uint64)
            offsets = np.empty(n * self.n_sparse + 1, dtype=np.int64)
            dense = np.zeros((n, self.dense_width), dtype=np.float32)
            labels = np.empty(n, dtype=np.float32)
            tasks = (np.empty((n, self.n_tasks), dtype=np.float32)
                     if self.n_tasks else None)
            sids = ranks = cmatches = None
            if self.parse_logkey:
                sids = np.empty(n, dtype=np.uint64)
                ranks = np.empty(n, dtype=np.int32)
                cmatches = np.empty(n, dtype=np.int32)
            id_buf = id_offs = None
            if self.parse_ins_id:
                id_buf = np.empty(lib.pbx_ins_id_bytes(handle), dtype=np.uint8)
                id_offs = np.empty(n + 1, dtype=np.int64)
            ptr = lambda a: (None if a is None
                             else a.ctypes.data_as(ctypes.c_void_p))
            lib.pbx_fill(handle, ptr(keys), ptr(offsets), ptr(dense),
                         ptr(labels), ptr(tasks), ptr(sids), ptr(ranks),
                         ptr(cmatches), ptr(id_buf), ptr(id_offs))
        finally:
            lib.pbx_free(handle)
        ins_ids = None
        if self.parse_ins_id:
            raw = id_buf.tobytes()
            ins_ids = [raw[id_offs[i]:id_offs[i + 1]].decode()
                       for i in range(n)]
        return RecordBlock(
            n_ins=int(n), n_sparse_slots=self.n_sparse, keys=keys,
            key_offsets=offsets, dense=dense, labels=labels, ins_ids=ins_ids,
            search_ids=sids, ranks=ranks, cmatches=cmatches,
            task_labels=tasks,
        )


def _key_buffer(keys: np.ndarray, n_real: int):
    """(contiguous uint64 keys, K); the native walk reads keys[:n_real]."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64).reshape(-1)
    if not 0 <= n_real <= keys.shape[0]:
        raise ValueError(f"n_real {n_real} outside [0, {keys.shape[0]}]")
    return keys, keys.shape[0]


class CensusIndex:
    """Per-pass census hash index (native).  Holds a reference to the
    census array, which the native index points into, for its lifetime."""

    def __init__(self, lib, census: np.ndarray):
        self._lib = lib
        self._census = np.ascontiguousarray(census, dtype=np.uint64)
        self._lock = threading.Lock()  # close against a concurrent resolve
        self._handle = lib.pbx_census_index_build(
            _u64p(self._census), self._census.shape[0]
        )

    def close(self) -> None:
        with self._lock:
            if self._handle:
                self._lib.pbx_census_index_free(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            # interpreter teardown: the lib or the lock may be half
            # collected; never raise out of __del__
            logger.debug("census index close failed in __del__",
                         exc_info=True)

    def lookup_unique(self, keys: np.ndarray, n_real: int):
        """(inverse[:n_real], uniq_key[:n_uniq], uniq_pos[:n_uniq]) in
        first-seen slot order, census position -1 for absent keys; None
        once closed.  The sharded planner's per-position dedup and
        resolve."""
        keys, K = _key_buffer(keys, n_real)
        inverse = np.empty(K, dtype=np.int32)
        uniq_key = np.empty(K, dtype=np.uint64)
        uniq_pos = np.empty(K, dtype=np.int64)
        with self._lock:
            if not self._handle:
                return None
            n_uniq = self._lib.pbx_census_lookup_unique(
                self._handle, _u64p(keys), K, int(n_real), _i32p(inverse),
                _u64p(uniq_key),
                uniq_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        if n_uniq < 0:
            return None
        return inverse[:n_real], uniq_key[:n_uniq], uniq_pos[:n_uniq]

    def resolve(self, keys: np.ndarray, n_real: int, dead: int,
                scratch_base: int):
        """(idx, uniq_idx, inverse, key_mask, n_missing) of a padded key
        buffer, or None once closed."""
        keys, K = _key_buffer(keys, n_real)
        idx = np.empty(K, dtype=np.int32)
        uniq_idx = np.empty(K, dtype=np.int32)
        inverse = np.empty(K, dtype=np.int32)
        key_mask = np.empty(K, dtype=np.float32)
        with self._lock:
            if not self._handle:
                return None
            n_missing = self._lib.pbx_plan_resolve(
                self._handle, _u64p(keys), K, int(n_real), int(dead),
                int(scratch_base), _i32p(idx), _i32p(uniq_idx),
                _i32p(inverse),
                key_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        if n_missing < 0:
            return None
        return idx, uniq_idx, inverse, key_mask, int(n_missing)


def build_census_index(census: np.ndarray) -> Optional[CensusIndex]:
    """A CensusIndex over the sorted pass keys, or None (no library)."""
    lib = get_plan_lib()
    if lib is None:
        return None
    return CensusIndex(lib, census)


def dedup_rows_native(rows: np.ndarray):
    """First-seen-order unique of an int32 buffer: (inverse, uniq), or None
    when the library is unavailable.  The sharded serve side's np.unique
    replacement (stateless, no census)."""
    lib = get_plan_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1)
    n = rows.shape[0]
    inverse = np.empty(n, dtype=np.int32)
    uniq = np.empty(max(n, 1), dtype=np.int32)
    n_uniq = lib.pbx_dedup_rows(_i32p(rows), n, _i32p(inverse), _i32p(uniq))
    return inverse, uniq[:n_uniq]
