"""The port's launcher and job bootstrap (paddlebox_tpu_torch/launch.py,
parallel/mesh.py; reference: paddlebox_tpu/launch.py): each rank's
environment, per-rank log files, the first failing rank's exit code
propagated with the survivors killed, the job timeout, a job of real
ranks joining through the launcher's store, and the mesh's process layout
(a composed mesh's data row spanning processes is refused).
"""

import os
import time

import pytest
import torch

from paddlebox_tpu_torch.launch import find_free_port, launch, main, rank_env
from paddlebox_tpu_torch.parallel import mesh as mesh_mod
from paddlebox_tpu_torch.testing import time_limit  # noqa: F401


@pytest.mark.parametrize("device,backend,local", [
    ("cpu", "gloo", None), ("cuda", "nccl", "1"), ("cuda", "gloo", "0"),
    (None, None, None)])
def test_rank_env(device, backend, local):
    env = rank_env(1, 2, "127.0.0.1:1234", positions_per_proc=2,
                   device=device, backend=backend, base_env={"KEEP": "x"},
                   store_hosted=True, liveness_deadline_s=9.0,
                   metrics_port=9100, trace_dir="/t", flight_dir="/f")
    assert env["KEEP"] == "x"
    assert env["PADDLEBOX_TORCH_COORDINATOR_ADDRESS"] == "127.0.0.1:1234"
    assert env["PADDLEBOX_TORCH_NUM_PROCESSES"] == "2"
    assert env["PADDLEBOX_TORCH_PROCESS_ID"] == "1"
    assert env["PADDLEBOX_TORCH_STORE_HOSTED"] == "1"
    assert env["PADDLEBOX_TORCH_POSITIONS_PER_PROC"] == "2"
    assert env.get("PADDLEBOX_TORCH_BACKEND") == backend
    assert env.get("PADDLEBOX_TORCH_DEVICE") == device
    assert env.get("PADDLEBOX_TORCH_LOCAL_DEVICE") == local
    assert env["PADDLEBOX_TORCH_LIVENESS_DEADLINE_S"] == "9.0"
    assert env["PADDLEBOX_TORCH_METRICS_PORT"] == "9101"  # base + rank
    assert env["PADDLEBOX_TORCH_TRACE_DIR"] == "/t"
    assert env["PADDLEBOX_TORCH_FLIGHT_DIR"] == "/f"
    # the port's flags only: the reference's variables steer the reference
    assert not [k for k in env if k.startswith("PBOX_")]


def _script(tmp_path, body: str) -> str:
    p = tmp_path / "rank_prog.py"
    p.write_text("import os, sys, time\n"
                 "rank = int(os.environ['PADDLEBOX_TORCH_PROCESS_ID'])\n"
                 "world = int(os.environ['PADDLEBOX_TORCH_NUM_PROCESSES'])\n"
                 + body)
    return str(p)


def test_per_rank_logs_and_success(tmp_path):
    prog = _script(tmp_path, "print(f'rank {rank} of {world}', flush=True)\n")
    logs = tmp_path / "logs"
    assert launch([prog], nproc=3, log_dir=str(logs)) == 0
    for r in range(3):
        assert (logs / f"rank{r}.log").read_text() == f"rank {r} of 3\n"


def test_failing_rank_code_propagates_and_survivors_die(tmp_path):
    prog = _script(tmp_path, (
        "if rank == 1:\n"
        "    sys.exit(5)\n"
        "print('waiting', flush=True)\n"
        "time.sleep(120)\n"
        "print('survived', flush=True)\n"))
    logs = tmp_path / "logs"
    t0 = time.monotonic()
    rc = launch([prog], nproc=3, log_dir=str(logs), poll_interval=0.05)
    assert rc == 5
    assert time.monotonic() - t0 < 60.0  # the survivors were killed
    for r in (0, 2):
        assert "survived" not in (logs / f"rank{r}.log").read_text()


def test_job_timeout_returns_124(tmp_path):
    prog = _script(tmp_path, "time.sleep(120)\n")
    t0 = time.monotonic()
    assert launch([prog], nproc=2, job_timeout_s=1.0,
                  poll_interval=0.05) == 124
    assert time.monotonic() - t0 < 60.0


def test_main_parses_the_command_line(tmp_path):
    prog = _script(tmp_path, (
        "assert os.environ['PADDLEBOX_TORCH_DEVICE'] == 'cpu'\n"
        "assert os.environ['PADDLEBOX_TORCH_BACKEND'] == 'gloo'\n"
        "assert os.environ['PADDLEBOX_TORCH_POSITIONS_PER_PROC'] == '3'\n"
        "assert sys.argv[1:] == ['--epochs', '1']\n"))
    assert main(["--nproc", "2", "--positions-per-proc", "3", "--device",
                 "cpu", "--backend", "gloo", prog, "--epochs", "1"]) == 0


def test_ranks_join_through_the_launchers_store(tmp_path):
    """Two real ranks join the job (the launcher serves the store on a
    port the system picks), check the job and the mesh layout, and run an
    all_gather over gloo."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = _script(tmp_path, (
        f"sys.path.insert(0, {repo!r})\n"
        "import torch, torch.distributed as dist\n"
        "from paddlebox_tpu_torch.parallel import make_mesh\n"
        "from paddlebox_tpu_torch.parallel.mesh import (\n"
        "    initialize_distributed, job, shutdown_distributed)\n"
        "j = initialize_distributed()\n"
        "assert j is job() and (j.rank, j.world) == (rank, 2)\n"
        "assert j.backend == 'gloo' and j.device.type == 'cpu'\n"
        "assert j.positions_per_proc == 2 and not j.host_staged\n"
        "m = make_mesh(4, device='cpu')\n"
        "assert m.distributed and m.n_local == 2\n"
        "assert list(m.local_positions) == [2 * rank, 2 * rank + 1]\n"
        "assert not make_mesh(3, device='cpu', axis_name='seq').distributed\n"
        "out = [torch.zeros(1) for _ in range(2)]\n"
        "dist.all_gather(out, torch.tensor([float(rank)]))\n"
        "assert [float(t) for t in out] == [0.0, 1.0]\n"
        "shutdown_distributed()\n"
        "assert job() is None\n"
        "print('ok', flush=True)\n"))
    logs = tmp_path / "logs"
    rc = launch([prog], nproc=2, positions_per_proc=2, device="cpu",
                backend="gloo", log_dir=str(logs), job_timeout_s=120.0)
    text = "".join((logs / f"rank{r}.log").read_text() for r in range(2))
    assert rc == 0, text
    assert text.count("ok\n") == 2


def test_find_free_port():
    assert 0 < find_free_port() < 65536


# --------------------------------------------------------------------------- #
# the bootstrap's refusals and the mesh's process layout
# --------------------------------------------------------------------------- #
def test_single_process_needs_no_job(monkeypatch):
    for k in ("PADDLEBOX_TORCH_COORDINATOR_ADDRESS",
              "PADDLEBOX_TORCH_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.initialize_distributed() is None
    assert mesh_mod.job() is None


@pytest.mark.parametrize("kw,err", [
    (dict(coordinator_address="127.0.0.1:1"), ValueError),
    (dict(coordinator_address="127.0.0.1:1", num_processes=2,
          process_id=2), ValueError),
    (dict(coordinator_address="127.0.0.1:1", num_processes=1,
          backend="nccl", device="cpu"), ValueError),
    (dict(coordinator_address="127.0.0.1:1", num_processes=1,
          backend="mpi", device="cpu"), ValueError),
])
def test_initialize_distributed_refuses(kw, err):
    with pytest.raises(err):
        mesh_mod.initialize_distributed(**kw)
    assert mesh_mod.job() is None


@pytest.fixture
def fake_job(monkeypatch):
    def make(rank, world, positions_per_proc=0):
        j = mesh_mod.Job(rank, world, None, "gloo", torch.device("cpu"),
                         positions_per_proc)
        monkeypatch.setattr(mesh_mod, "_JOB", j)
        return j
    return make


@pytest.mark.parametrize("n,ok", [(4, True), (6, False)])
def test_mesh_holds_the_jobs_positions_per_process(fake_job, n, ok):
    fake_job(0, 2, positions_per_proc=2)
    if ok:
        assert mesh_mod.make_mesh(n, device="cpu").n_local == 2
    else:
        with pytest.raises(ValueError, match="POSITIONS_PER_PROC"):
            mesh_mod.make_mesh(n, device="cpu")


def test_mesh_layout_in_a_job(fake_job):
    fake_job(1, 2)
    m = mesh_mod.make_mesh(4, device="cpu")
    assert (m.distributed, m.n_proc, m.proc_index, m.n_local) == (
        True, 2, 1, 2)
    assert list(m.local_positions) == [2, 3]
    c = mesh_mod.make_composed_mesh(2, 3, "expert", device="cpu")
    assert c.n_local == 1 and list(c.local_positions) == [1]
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(3, device="cpu")  # 3 positions over 2 processes


def test_composed_row_spanning_processes_is_refused(fake_job):
    fake_job(0, 4)
    with pytest.raises(NotImplementedError, match="spans processes"):
        mesh_mod.make_composed_mesh(2, 2, "expert", device="cpu")


def test_reshard_across_processes_names_item_8b(fake_job):
    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.parallel import ShardedSparseTable

    """A reshard across processes is ported (tests/test_torch_reshard_mp.py
    runs it); what it still refuses, before anything moves, is a new mesh
    of another process layout."""
    fake_job(0, 1)
    table = ShardedSparseTable(SparseTableConfig(), mesh_mod.Mesh(
        4, torch.device("cpu"), distributed=True, n_proc=2, proc_index=0))
    with pytest.raises(ValueError, match="process layout") as ei:
        table.reshard(mesh_mod.make_mesh(2, device="cpu"))
    assert "8b" not in str(ei.value)
    assert table.n_shards == 4

