"""The local filesystem surface that checkpoint verification reads through
(reference: paddlebox_tpu/utils/fs.py, its ``LocalFS``).

Each operation is a fault-injection site (``fs.<op>``).  The reference's
``HadoopFS`` and the rest of its write surface come with the publishing
plane (ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import os

from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.retry import register_retryable


class FsError(RuntimeError):
    """A filesystem operation failed: a missing path, or a failed pipe
    (usually a remote cat).  The transient class: retry_call retries it."""


register_retryable(FsError)


class LocalFS:
    """os-backed ls and cat."""

    def ls(self, path: str) -> list:
        faults.inject("fs.ls")
        if not os.path.isdir(path):
            raise FsError(f"ls: not a directory: {path}")
        return sorted(os.path.join(path, name) for name in os.listdir(path))

    def cat(self, path: str) -> bytes:
        faults.inject("fs.cat")
        with open(path, "rb") as f:
            return f.read()
