"""Multi-process training launcher (``python -m paddlebox_tpu_torch.launch``;
reference: paddlebox_tpu/launch.py).

    python -m paddlebox_tpu_torch.launch --nproc 2 --positions-per-proc 2 \\
        --device cpu --backend gloo train.py --epochs 1
    python -m paddlebox_tpu_torch.launch --nproc 2 --backend nccl train.py

The launcher (1) serves the job's TCPStore itself, on a port the operating
system picks, so no rank races another process for a free port, (2) spawns
N ranks of ``python script ...`` with the PADDLEBOX_TORCH_COORDINATOR_ADDRESS,
_NUM_PROCESSES, _PROCESS_ID, _STORE_HOSTED, _BACKEND, _DEVICE,
_LOCAL_DEVICE and _POSITIONS_PER_PROC flags set, which
``parallel.mesh.initialize_distributed()`` reads, and (3) babysits them:
per-rank log files, the survivors killed when any rank dies, the first bad
exit code propagated.

Backends: "nccl" when each rank owns its own card (rank r takes card r);
"gloo" for CPU ranks and for ranks that share one card (every rank takes
card 0), since NCCL refuses two ranks on one card.  Nothing switches
backend silently.
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional


def find_free_port() -> int:
    """A port free at the time of asking (another process may take it
    before it is bound: the launcher serves the store on port 0 instead)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(
    rank: int,
    nproc: int,
    coordinator: str,
    positions_per_proc: Optional[int] = None,
    device: Optional[str] = None,
    backend: Optional[str] = None,
    base_env: Optional[dict] = None,
    store_hosted: bool = False,
    liveness_deadline_s: Optional[float] = None,
    metrics_port: Optional[int] = None,
    trace_dir: Optional[str] = None,
    flight_dir: Optional[str] = None,
) -> dict:
    """The environment of one rank (exported for tests and embedders)."""
    env = dict(base_env if base_env is not None else os.environ)
    env["PADDLEBOX_TORCH_COORDINATOR_ADDRESS"] = coordinator
    env["PADDLEBOX_TORCH_NUM_PROCESSES"] = str(nproc)
    env["PADDLEBOX_TORCH_PROCESS_ID"] = str(rank)
    env["PADDLEBOX_TORCH_STORE_HOSTED"] = "1" if store_hosted else "0"
    if positions_per_proc:
        env["PADDLEBOX_TORCH_POSITIONS_PER_PROC"] = str(positions_per_proc)
    if backend:
        env["PADDLEBOX_TORCH_BACKEND"] = backend
    if device:
        env["PADDLEBOX_TORCH_DEVICE"] = device
        if device == "cuda":
            # nccl: a card a rank; gloo: the ranks share card 0
            env["PADDLEBOX_TORCH_LOCAL_DEVICE"] = str(
                rank if backend == "nccl" else 0)
    if liveness_deadline_s is not None:
        # every rank's watchdog reads it: one knob bounds every stage stall
        env["PADDLEBOX_TORCH_LIVENESS_DEADLINE_S"] = str(liveness_deadline_s)
    if metrics_port is not None and metrics_port > 0:
        # one /metrics listener a rank: base port + rank
        env["PADDLEBOX_TORCH_METRICS_PORT"] = str(metrics_port + rank)
    if trace_dir:
        # host span traces; file names carry the rank
        env["PADDLEBOX_TORCH_TRACE_DIR"] = trace_dir
    if flight_dir:
        # every rank's flight-recorder dumps land here, named by rank
        env["PADDLEBOX_TORCH_FLIGHT_DIR"] = flight_dir
    return env


def _serve_store(nproc: int, timeout_s: float):
    """The job's TCPStore, served by this process on a port the operating
    system picks: (store, "127.0.0.1:<port>")."""
    import torch.distributed as dist

    store = dist.TCPStore(
        "127.0.0.1", 0, nproc, True,
        timeout=datetime.timedelta(seconds=timeout_s),
        wait_for_workers=False)
    return store, f"127.0.0.1:{store.port}"


def launch(
    script_args: list,
    nproc: int,
    coordinator: Optional[str] = None,
    positions_per_proc: Optional[int] = None,
    device: Optional[str] = None,
    backend: Optional[str] = None,
    log_dir: Optional[str] = None,
    poll_interval: float = 0.2,
    liveness_deadline_s: Optional[float] = None,
    job_timeout_s: Optional[float] = None,
    metrics_port: Optional[int] = None,
    trace_dir: Optional[str] = None,
    flight_dir: Optional[str] = None,
    env: Optional[dict] = None,
) -> int:
    """Spawn nproc ranks of ``python script_args...``; return the first
    non-zero exit code (0 when every rank succeeds).  Any rank dying kills
    the rest: a half-alive job would hang in its next collective.

    coordinator: "host:port" of a store rank 0 serves (default: this
    process serves one on a port the system picks).  job_timeout_s: the
    launcher's last-resort bound: past it every live rank is terminated
    and the result is 124.  env: the ranks' base environment (default this
    process's)."""
    store = None
    if coordinator is None:
        store, coordinator = _serve_store(
            nproc, job_timeout_s or 3600.0)
    procs: list = []
    logs = []
    start_t = time.monotonic()
    for rank in range(nproc):
        renv = rank_env(
            rank, nproc, coordinator, positions_per_proc, device, backend,
            base_env=env, store_hosted=store is not None,
            liveness_deadline_s=liveness_deadline_s,
            metrics_port=metrics_port, trace_dir=trace_dir,
            flight_dir=flight_dir,
        )
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"rank{rank}.log"), "wb")
            logs.append(out)
            stdout, stderr = out, subprocess.STDOUT
        else:
            stdout = stderr = None  # inherited: one interleaved console
        procs.append(subprocess.Popen([sys.executable] + list(script_args),
                                      env=renv, stdout=stdout,
                                      stderr=stderr))
    rc = 0
    try:
        live = set(range(nproc))
        while live:
            if (job_timeout_s is not None and rc == 0
                    and time.monotonic() - start_t > job_timeout_s):
                # nothing below freed the job: the launcher does
                rc = 124
                for r in live:
                    procs[r].send_signal(signal.SIGTERM)
            for r in sorted(live):
                code = procs[r].poll()
                if code is None:
                    continue
                live.discard(r)
                if code != 0 and rc == 0:
                    rc = code
                    # the first failure: kill the survivors
                    for other in live:
                        procs[other].send_signal(signal.SIGTERM)
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        rc = 130
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
    finally:
        deadline = time.monotonic() + 10.0
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for f in logs:
            f.close()
        del store  # the store outlives every rank
    return rc


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddlebox_tpu_torch.launch",
        description="spawn an N-process training job",
    )
    ap.add_argument("--nproc", type=int, required=True,
                    help="number of processes")
    ap.add_argument("--positions-per-proc", type=int, default=None,
                    help="data positions each process holds "
                         "(PADDLEBOX_TORCH_POSITIONS_PER_PROC)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the ranks' device (PADDLEBOX_TORCH_DEVICE)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend: nccl (a card a rank) or "
                         "gloo (CPU ranks, or ranks sharing one card)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of a store rank 0 serves (default: "
                         "the launcher serves it)")
    ap.add_argument("--log-dir", default=None,
                    help="write per-rank logs here instead of the console")
    ap.add_argument("--liveness-deadline", type=float, default=None,
                    help="per-stage stall bound (s) of every rank's "
                         "watchdog (PADDLEBOX_TORCH_LIVENESS_DEADLINE_S)")
    ap.add_argument("--job-timeout", type=float, default=None,
                    help="terminate the job after this many seconds "
                         "(exit code 124)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="/metrics base port, rank r at base + r")
    ap.add_argument("--trace-dir", default=None,
                    help="host span traces of every rank go here")
    ap.add_argument("--flight-dir", default=None,
                    help="flight-recorder dumps of every rank go here")
    ap.add_argument("script", help="the rank program")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    return launch(
        [args.script] + args.script_args,
        nproc=args.nproc,
        coordinator=args.coordinator,
        positions_per_proc=args.positions_per_proc,
        device=args.device,
        backend=args.backend,
        log_dir=args.log_dir,
        liveness_deadline_s=args.liveness_deadline,
        job_timeout_s=args.job_timeout,
        metrics_port=args.metrics_port,
        trace_dir=args.trace_dir,
        flight_dir=args.flight_dir,
    )


if __name__ == "__main__":
    sys.exit(main())
