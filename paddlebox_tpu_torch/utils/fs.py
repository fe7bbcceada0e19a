"""Remote filesystem surface: ls, exists, upload, download for HDFS/AFS
(reference: paddlebox_tpu/utils/fs.py).

The read path for training data does not need it (a
``DataFeedConfig.pipe_command`` of ``hadoop fs -cat ...`` streams files
through the parser); this module serves the write and admin path:
publishing checkpoints, donefiles and serving model units, and listing
remote roots.

Two implementations behind one duck-typed surface:

  * ``LocalFS``  — os and shutil, for tests and single-host runs;
  * ``HadoopFS`` — the ``hadoop fs`` command line, one subprocess a call,
    retried through utils/retry.py.

``resolve_fs(path)`` picks by scheme: ``hdfs://`` and ``afs://`` give a
HadoopFS configured from the flags PADDLEBOX_TORCH_HADOOP_BIN, _FS_NAME and
_FS_UGI; anything else a LocalFS.  Every operation is a fault-injection
site (``fs.<op>``; HadoopFS names it by the hadoop verb).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.retry import (
    RetryPolicy,
    register_retryable,
    retry_call,
)


class FsError(RuntimeError):
    """A filesystem operation failed: a missing path, or a failed pipe
    (usually a remote cat).  The transient class: retry_call retries it."""


register_retryable(FsError)


class LocalFS:
    """The local filesystem with HadoopFS's surface."""

    def ls(self, path: str) -> list:
        faults.inject("fs.ls")
        if not os.path.isdir(path):
            raise FsError(f"ls: not a directory: {path}")
        return sorted(os.path.join(path, name) for name in os.listdir(path))

    def exists(self, path: str) -> bool:
        faults.inject("fs.exists")
        return os.path.exists(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def mkdir(self, path: str) -> None:
        faults.inject("fs.mkdir")
        os.makedirs(path, exist_ok=True)

    def upload(self, local: str, remote: str) -> None:
        faults.inject("fs.upload")
        self.mkdir(os.path.dirname(remote) or ".")
        if os.path.isdir(local):
            shutil.copytree(local, remote, dirs_exist_ok=True)
        else:
            shutil.copy2(local, remote)

    def download(self, remote: str, local: str) -> None:
        faults.inject("fs.download")
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        if os.path.isdir(remote):
            shutil.copytree(remote, local, dirs_exist_ok=True)
        else:
            shutil.copy2(remote, local)

    def rm(self, path: str) -> None:
        faults.inject("fs.rm")
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def touch(self, path: str) -> None:
        faults.inject("fs.touch")
        self.mkdir(os.path.dirname(path) or ".")
        with open(path, "a"):
            pass

    def cat(self, path: str) -> bytes:
        faults.inject("fs.cat")
        with open(path, "rb") as f:
            return f.read()


class HadoopFS:
    """The ``hadoop fs`` command line: every call runs one command with the
    job confs prepended, and retries a failed one."""

    def __init__(
        self,
        fs_name: str = "",
        fs_ugi: str = "",
        hadoop_bin: Optional[str] = None,
        retries: Optional[int] = None,
    ):
        from paddlebox_tpu_torch.config import flags

        self.hadoop_bin = hadoop_bin or flags.hadoop_bin
        self.fs_name = fs_name or flags.fs_name
        self.fs_ugi = fs_ugi or flags.fs_ugi
        # None: the flag shim's retry policy; N: N retries after the first
        # attempt
        self.retries = retries

    def _base(self) -> list:
        cmd = [self.hadoop_bin, "fs"]
        if self.fs_name:
            cmd += ["-D", f"fs.default.name={self.fs_name}"]
        if self.fs_ugi:
            cmd += ["-D", f"hadoop.job.ugi={self.fs_ugi}"]
        return cmd

    def _run_once(self, args: list,
                  text: bool = True) -> subprocess.CompletedProcess:
        """One hadoop command; a non-zero exit raises FsError."""
        faults.inject("fs." + args[0].lstrip("-"))
        proc = subprocess.run(self._base() + args, capture_output=True,
                              text=text)
        if proc.returncode != 0:
            err = proc.stderr if text else proc.stderr.decode(
                errors="replace")
            raise FsError(
                f"hadoop fs {' '.join(args)} failed rc={proc.returncode}: "
                f"{err.strip()[-500:]}"
            )
        return proc

    def _run(self, args: list, check: bool = True,
             text: bool = True) -> subprocess.CompletedProcess:
        if not check:
            # a -test probe: exit code 1 is an answer, not a failure, so
            # it runs once
            return subprocess.run(self._base() + args, capture_output=True,
                                  text=text)
        policy = RetryPolicy.from_flags()
        if self.retries is not None:
            policy = RetryPolicy(
                max_attempts=self.retries + 1,
                base_delay_s=policy.base_delay_s,
                max_delay_s=policy.max_delay_s,
            )
        return retry_call(self._run_once, args, text=text,
                          site="fs." + args[0].lstrip("-"), policy=policy)

    def ls(self, path: str) -> list:
        out = self._run(["-ls", path]).stdout
        names = []
        for line in out.splitlines():
            # "drwxr-xr-x - user group size date time /path": split off the
            # 7 metadata fields only, so a path with spaces survives; the
            # "Found N items" header has no path
            parts = line.split(None, 7)
            if len(parts) == 8 and parts[7].startswith(("/", "hdfs:",
                                                        "afs:")):
                names.append(parts[7])
        return sorted(names)

    def exists(self, path: str) -> bool:
        return self._run(["-test", "-e", path], check=False).returncode == 0

    def is_dir(self, path: str) -> bool:
        return self._run(["-test", "-d", path], check=False).returncode == 0

    def mkdir(self, path: str) -> None:
        self._run(["-mkdir", "-p", path])

    def upload(self, local: str, remote: str) -> None:
        self._run(["-put", "-f", local, remote])

    def download(self, remote: str, local: str) -> None:
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        self._run(["-get", remote, local])

    def rm(self, path: str) -> None:
        self._run(["-rm", "-r", "-f", path])

    def touch(self, path: str) -> None:
        self._run(["-touchz", path])

    def cat(self, path: str) -> bytes:
        return self._run(["-cat", path], text=False).stdout


def resolve_fs(path: str):
    """The filesystem of a path: HadoopFS for a remote scheme, else
    LocalFS."""
    if path.startswith(("hdfs://", "afs://")):
        return HadoopFS()
    return LocalFS()


def publish_checkpoint(manager, tag: str, remote_root: str, fs=None,
                       verify: bool = True) -> None:
    """Upload a saved checkpoint tag and then the donefile to a remote root,
    the donefile last, so a consumer never sees an entry whose data is
    still uploading.

    Each upload retries (sites "publish.upload" and "publish.donefile"),
    and with ``verify`` every uploaded checkpoint dir is read back through
    the remote fs and checked against its manifest before the donefile
    lands."""
    from paddlebox_tpu_torch import telemetry

    with telemetry.span("ckpt.publish", tag=tag), \
            telemetry.histogram(
                "ckpt.publish_seconds",
                help="checkpoint publish wall time (s)",
            ).time():
        _publish_checkpoint_timed(manager, tag, remote_root, fs, verify)


def _publish_checkpoint_timed(manager, tag, remote_root, fs, verify) -> None:
    from paddlebox_tpu_torch.checkpoint import verify_checkpoint_dir

    fs = fs or resolve_fs(remote_root)
    entries = [e for e in manager.list_checkpoints() if e.tag == tag]
    if not entries:
        raise FsError(f"tag {tag!r} not in {manager.root}/donefile.txt")
    retry_call(fs.mkdir, remote_root, site="publish.mkdir")
    for e in entries:  # a tag may have a base and a delta entry
        dest = os.path.join(remote_root, os.path.basename(e.dirname))

        def upload_entry(e=e, dest=dest):
            faults.inject("publish.upload")
            fs.upload(e.dirname, dest)
            if verify:
                # through the remote fs: a torn upload fails this attempt
                # and the retry uploads again
                verify_checkpoint_dir(dest, fs=fs)

        retry_call(upload_entry, site="publish.upload")

    def upload_donefile():
        faults.inject("publish.donefile")
        fs.upload(os.path.join(manager.root, "donefile.txt"),
                  os.path.join(remote_root, "donefile.txt"))

    retry_call(upload_donefile, site="publish.donefile")
