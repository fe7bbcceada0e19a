"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C function and compiles with
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in
``paddlebox_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing builds at import time: the first launch of a kernel, or
``build()``, compiles it.  Processes that build at once (the ranks of a
job on a cold tree) take turns on a lock file in the build directory, and
each library lands by an atomic rename, so a process loads a whole
library or builds it itself.  The first load of a kernel in a process (with
the build it needed, if any) counts once in ``jit.compiles`` under the
stage of the reference kernel it ports (telemetry/compiles.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from paddlebox_tpu_torch.telemetry import compiles

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
# name -> {"seconds": float, "log": str} for builds made by this process
build_log: dict = {}


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
        f"{SRC_DIR} on a machine with the CUDA toolkit"
    )


def source_path(name: str) -> Path:
    return SRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_dir_lock():
    """Exclusive hold of the build directory across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names) -> dict:
    """Compile every listed kernel that is not built yet, one nvcc process
    per source, all started together.  Returns {name: build seconds} for the
    ones compiled now; raises with nvcc's output if any build fails.  A
    process that finds another building waits for it and reuses what it
    built."""
    if all(library_path(n).exists() for n in names):
        return {}
    with _build_dir_lock():
        return _build_missing(names)


def _build_missing(names) -> dict:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    seconds = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = {"seconds": seconds[name], "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            if tmp.exists():
                tmp.unlink()
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use.  The first load in
    the process is its compile event: counted under the kernel's stage
    with the seconds of this build (if any) and load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
            compiles.record_compile(time.perf_counter() - t0,
                                    stage=compiles.KERNEL_STAGES[name])
        return lib
