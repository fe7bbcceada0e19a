"""The port's remote filesystem surface (paddlebox_tpu_torch/utils/fs.py)
held to the reference's tests/test_fs.py: LocalFS, HadoopFS against a fake
``hadoop`` script, resolve_fs, publish_checkpoint.  A checkpoint root the
port publishes passes the reference's own ``verify_checkpoint_dir``, and
the reference's donefile there lists the port's tag.
"""

import os
import stat

import numpy as np
import pytest
import torch

from paddlebox_tpu.checkpoint import verify_checkpoint_dir as ref_verify
from paddlebox_tpu.utils.fs import LocalFS as RefLocalFS
from paddlebox_tpu_torch.checkpoint import CheckpointManager
from paddlebox_tpu_torch.config import SparseTableConfig
from paddlebox_tpu_torch.sparse.table import SparseTable
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401
from paddlebox_tpu_torch.utils import faults
from paddlebox_tpu_torch.utils.fs import (
    FsError,
    HadoopFS,
    LocalFS,
    publish_checkpoint,
    resolve_fs,
)
from paddlebox_tpu_torch.utils.monitor import stats

torch.set_num_threads(1)

# the reference test's fake `hadoop fs`: a local tree under $FAKE_ROOT;
# strips the -D confs (recording every call) and emulates the verbs
FAKE_HADOOP = r"""#!/bin/bash
echo "$@" >> "$FAKE_ROOT/.calls"
shift  # "fs"
args=()
while [[ $# -gt 0 ]]; do
  if [[ "$1" == "-D" ]]; then shift 2; else args+=("$1"); shift; fi
done
set -- "${args[@]}"
verb=$1; shift
p() { echo "$FAKE_ROOT/${1#hdfs://ns/}"; }
case "$verb" in
  -ls)
    d=$(p "$1"); [[ -d "$d" ]] || exit 1
    echo "Found $(ls "$d" | wc -l) items"
    for f in "$d"/*; do
      echo "-rw-r--r-- 3 u g 0 2026-07-29 00:00 hdfs://ns/${f#$FAKE_ROOT/}"
    done ;;
  -test)
    flag=$1; d=$(p "$2")
    [[ "$flag" == "-d" ]] && { [[ -d "$d" ]]; exit $?; }
    [[ -e "$d" ]] ;;
  -mkdir) [[ "$1" == "-p" ]] && shift; mkdir -p "$(p "$1")" ;;
  -put) [[ "$1" == "-f" ]] && shift; src=$1; dst=$(p "$2")
        mkdir -p "$(dirname "$dst")"; cp -r "$src" "$dst" ;;
  -get) src=$(p "$1"); cp -r "$src" "$2" ;;
  -rm) while [[ "$1" == -* ]]; do shift; done; rm -rf "$(p "$1")" ;;
  -touchz) d=$(p "$1"); mkdir -p "$(dirname "$d")"; : > "$d" ;;
  -cat) cat "$(p "$1")" ;;
  *) exit 2 ;;
esac
"""


@pytest.fixture
def fake_hadoop(tmp_path, monkeypatch):
    root = tmp_path / "remote"
    root.mkdir()
    bin_path = tmp_path / "hadoop"
    bin_path.write_text(FAKE_HADOOP)
    bin_path.chmod(bin_path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("FAKE_ROOT", str(root))
    return str(bin_path), str(root)


def _saved_checkpoint(tmp_path):
    table = SparseTable(SparseTableConfig(embedding_dim=4), device="cpu")
    table.begin_pass(np.arange(10, dtype=np.uint64))
    table.end_pass()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_base("20260729", table, {"w": torch.ones(3)})
    table.close()
    return mgr


class TestLocalFS:
    def test_roundtrip(self, tmp_path):
        fs = LocalFS()
        src = tmp_path / "a.txt"
        src.write_text("hello")
        fs.mkdir(str(tmp_path / "sub"))
        fs.upload(str(src), str(tmp_path / "sub" / "b.txt"))
        assert fs.exists(str(tmp_path / "sub" / "b.txt"))
        assert fs.is_dir(str(tmp_path / "sub"))
        assert fs.cat(str(tmp_path / "sub" / "b.txt")) == b"hello"
        assert str(tmp_path / "sub") in fs.ls(str(tmp_path))
        fs.download(str(tmp_path / "sub" / "b.txt"), str(tmp_path / "c.txt"))
        assert (tmp_path / "c.txt").read_text() == "hello"
        fs.touch(str(tmp_path / "deep" / "mark"))
        assert (tmp_path / "deep" / "mark").read_bytes() == b""
        fs.rm(str(tmp_path / "sub"))
        assert not fs.exists(str(tmp_path / "sub"))
        fs.rm(str(tmp_path / "never-there"))  # absent: a no-op

    def test_directory_upload_and_download(self, tmp_path):
        fs = LocalFS()
        (tmp_path / "d" / "x").mkdir(parents=True)
        (tmp_path / "d" / "x" / "f.bin").write_bytes(b"\x00\x01")
        fs.upload(str(tmp_path / "d"), str(tmp_path / "remote" / "d"))
        fs.download(str(tmp_path / "remote" / "d"), str(tmp_path / "back"))
        assert (tmp_path / "back" / "x" / "f.bin").read_bytes() == b"\x00\x01"

    def test_ls_non_dir_raises(self, tmp_path):
        with pytest.raises(FsError):
            LocalFS().ls(str(tmp_path / "nope"))

    @pytest.mark.parametrize("op", ["exists", "mkdir", "rm", "touch",
                                    "upload", "download"])
    def test_every_operation_is_a_fault_site(self, tmp_path, op):
        site = f"fs.{op}"
        assert site in faults.KNOWN_SITES
        args = {"upload": (str(tmp_path), str(tmp_path / "u")),
                "download": (str(tmp_path), str(tmp_path / "v"))}.get(
                    op, (str(tmp_path / "p"),))
        with faults.fault_plan({site: "first:1"}):
            with pytest.raises(faults.FaultInjected):
                getattr(LocalFS(), op)(*args)


class TestHadoopFS:
    def test_verbs_and_confs(self, fake_hadoop, tmp_path):
        bin_path, root = fake_hadoop
        fs = HadoopFS(fs_name="hdfs://ns", fs_ugi="user,pass",
                      hadoop_bin=bin_path)
        assert not fs.exists("hdfs://ns/dir/x.txt")
        local = tmp_path / "x.txt"
        local.write_text("payload")
        fs.mkdir("hdfs://ns/dir")
        fs.upload(str(local), "hdfs://ns/dir/x.txt")
        assert fs.exists("hdfs://ns/dir/x.txt")
        assert fs.is_dir("hdfs://ns/dir")
        assert fs.cat("hdfs://ns/dir/x.txt") == b"payload"
        assert fs.ls("hdfs://ns/dir") == ["hdfs://ns/dir/x.txt"]
        fs.touch("hdfs://ns/dir/_SUCCESS")
        assert fs.exists("hdfs://ns/dir/_SUCCESS")
        fs.download("hdfs://ns/dir/x.txt", str(tmp_path / "back.txt"))
        assert (tmp_path / "back.txt").read_text() == "payload"
        fs.rm("hdfs://ns/dir")
        assert not fs.exists("hdfs://ns/dir")
        # the job confs went on every command
        calls = (tmp_path / "remote" / ".calls").read_text()
        assert "fs.default.name=hdfs://ns" in calls
        assert "hadoop.job.ugi=user,pass" in calls

    def test_failure_raises_fserror(self, fake_hadoop):
        bin_path, _ = fake_hadoop
        fs = HadoopFS(hadoop_bin=bin_path, retries=0)
        with pytest.raises(FsError):
            fs.ls("hdfs://ns/absent")

    def test_failure_is_retried_then_raises(self, fake_hadoop, monkeypatch):
        monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.001")
        bin_path, _ = fake_hadoop
        before = stats.get("retry.fs.ls.attempts")
        with pytest.raises(FsError):
            HadoopFS(hadoop_bin=bin_path, retries=2).ls("hdfs://ns/absent")
        assert stats.get("retry.fs.ls.attempts") == before + 3

    def test_flags_configure_it(self, fake_hadoop, monkeypatch):
        bin_path, root = fake_hadoop
        monkeypatch.setenv("PADDLEBOX_TORCH_HADOOP_BIN", bin_path)
        monkeypatch.setenv("PADDLEBOX_TORCH_FS_NAME", "hdfs://flagged")
        monkeypatch.setenv("PADDLEBOX_TORCH_FS_UGI", "u,p")
        fs = resolve_fs("hdfs://ns/x")
        assert isinstance(fs, HadoopFS) and fs.hadoop_bin == bin_path
        fs.mkdir("hdfs://ns/flagged")
        calls = open(os.path.join(root, ".calls")).read()
        assert "fs.default.name=hdfs://flagged" in calls
        assert "hadoop.job.ugi=u,p" in calls


class TestResolveAndPublish:
    def test_resolve_by_scheme(self):
        assert isinstance(resolve_fs("hdfs://ns/a"), HadoopFS)
        assert isinstance(resolve_fs("afs://x/y"), HadoopFS)
        assert isinstance(resolve_fs("/tmp/x"), LocalFS)

    def test_publish_checkpoint(self, tmp_path):
        mgr = _saved_checkpoint(tmp_path)
        remote = str(tmp_path / "published")
        publish_checkpoint(mgr, "20260729", remote)
        assert os.path.isdir(os.path.join(remote, "base-20260729"))
        assert os.path.exists(os.path.join(remote, "donefile.txt"))
        # the reference reads the port's published root as its own
        ref_verify(os.path.join(remote, "base-20260729"), fs=RefLocalFS())
        with open(os.path.join(remote, "donefile.txt")) as fh:
            assert '"20260729"' in fh.read()

        with pytest.raises(FsError):
            publish_checkpoint(mgr, "absent-tag", remote)

    def test_publish_checkpoint_through_hadoop(self, tmp_path, fake_hadoop):
        bin_path, root = fake_hadoop
        mgr = _saved_checkpoint(tmp_path)
        fs = HadoopFS(hadoop_bin=bin_path)
        publish_checkpoint(mgr, "20260729", "hdfs://ns/pub", fs=fs)
        assert fs.exists("hdfs://ns/pub/donefile.txt")
        ref_verify(os.path.join(root, "pub", "base-20260729"))

    def test_torn_upload_fails_verification_and_keeps_the_donefile_out(
            self, tmp_path, monkeypatch):
        """A remote copy that reads back wrong is retried; when every
        attempt is wrong the donefile never lands."""
        monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_MAX_ATTEMPTS", "2")
        monkeypatch.setenv("PADDLEBOX_TORCH_RETRY_BASE_DELAY_S", "0.001")
        mgr = _saved_checkpoint(tmp_path)

        class TornFS(LocalFS):
            def cat(self, path):
                data = super().cat(path)
                return data[:-1] if path.endswith(".npz") else data

        remote = str(tmp_path / "published")
        with pytest.raises(Exception, match="size"):
            publish_checkpoint(mgr, "20260729", remote, fs=TornFS())
        assert not os.path.exists(os.path.join(remote, "donefile.txt"))
