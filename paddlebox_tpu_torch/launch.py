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
``parallel.mesh.initialize_distributed()`` reads (and, when given, the
online loop's _PUBLISH_ROOT, _STREAM_ROOT and _MAX_STALENESS_S), and (3)
babysits them: per-rank log files, the survivors killed when any rank dies,
the first bad exit code propagated.  ``--serve-replicas N`` co-runs a
serving fleet beside the job: ``python -m paddlebox_tpu_torch.serve
--replicas N --cpu`` syncing from ``--publish-root`` behind its router on
``--serve-router-port`` (CPU replicas: serving never contends for the
training cards); its exit is logged and never stops the job.

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
    publish_root: Optional[str] = None,
    stream_root: Optional[str] = None,
    max_staleness_s: Optional[float] = None,
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
    if publish_root:
        # the training program's Publisher ships model units here
        env["PADDLEBOX_TORCH_PUBLISH_ROOT"] = publish_root
    if stream_root:
        # the root a StreamingTrainer tails (StreamingConfig.from_flags)
        env["PADDLEBOX_TORCH_STREAM_ROOT"] = stream_root
    if max_staleness_s is not None:
        # the freshness budget of the deadline publisher
        env["PADDLEBOX_TORCH_MAX_STALENESS_S"] = str(max_staleness_s)
    return env


def serve_fleet_argv(publish_root: str, replicas: int,
                     router_port: int) -> list:
    """Command line of the serving fleet a training launch co-runs: N
    CPU-pinned replica servers syncing from the job's publish root behind
    a health-checked router (serving_fleet/), so one launch runs the whole
    train -> publish -> serve loop."""
    return [
        sys.executable, "-m", "paddlebox_tpu_torch.serve",
        "--sync-root", publish_root,
        "--replicas", str(replicas),
        "--router-port", str(router_port),
        "--cpu",  # serving must never contend for the training cards
    ]


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
    publish_root: Optional[str] = None,
    stream_root: Optional[str] = None,
    max_staleness_s: Optional[float] = None,
    serve_replicas: int = 0,
    serve_router_port: Optional[int] = None,
) -> int:
    """Spawn nproc ranks of ``python script_args...``; return the first
    non-zero exit code (0 when every rank succeeds).  Any rank dying kills
    the rest: a half-alive job would hang in its next collective.

    coordinator: "host:port" of a store rank 0 serves (default: this
    process serves one on a port the system picks).  job_timeout_s: the
    launcher's last-resort bound: past it every live rank is terminated
    and the result is 124.  env: the ranks' base environment (default this
    process's).  serve_replicas: co-run a serving fleet of that many CPU
    replicas syncing from ``publish_root`` (router on serve_router_port,
    default PADDLEBOX_TORCH_ROUTER_PORT); auxiliary: its death is logged
    and the job trains on, and it is stopped when the job ends."""
    if serve_replicas > 0 and not publish_root:
        raise ValueError(
            "--serve-replicas needs --publish-root: the fleet syncs its "
            "models from the job's publish root")
    store = None
    if coordinator is None:
        store, coordinator = _serve_store(
            nproc, job_timeout_s or 3600.0)
    procs: list = []
    logs = []
    start_t = time.monotonic()
    serve_proc: Optional[subprocess.Popen] = None
    if serve_replicas > 0:
        from paddlebox_tpu_torch.config import flags

        argv = serve_fleet_argv(
            publish_root, serve_replicas,
            serve_router_port if serve_router_port is not None
            else flags.router_port)
        out = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, "serve-fleet.log"), "wb")
            logs.append(out)
        serve_proc = subprocess.Popen(
            argv, env=env, stdout=out,
            stderr=subprocess.STDOUT if out is not None else None)
    for rank in range(nproc):
        renv = rank_env(
            rank, nproc, coordinator, positions_per_proc, device, backend,
            base_env=env, store_hosted=store is not None,
            liveness_deadline_s=liveness_deadline_s,
            metrics_port=metrics_port, trace_dir=trace_dir,
            flight_dir=flight_dir, publish_root=publish_root,
            stream_root=stream_root, max_staleness_s=max_staleness_s,
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
            if serve_proc is not None and serve_proc.poll() is not None:
                # serving is auxiliary: its death never stops the job
                print(f"WARNING: the co-run serving fleet exited rc="
                      f"{serve_proc.returncode}; training continues",
                      file=sys.stderr)
                serve_proc = None
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
        if serve_proc is not None and serve_proc.poll() is None:
            serve_proc.terminate()  # the fleet stops its replicas
            try:
                serve_proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                serve_proc.kill()
                serve_proc.wait()
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
    ap.add_argument("--publish-root", default=None,
                    help="online model delivery: the publish root of the "
                         "ranks' Publisher (PADDLEBOX_TORCH_PUBLISH_ROOT)")
    ap.add_argument("--stream-root", default=None,
                    help="online training: the root the ranks' "
                         "StreamingTrainer tails "
                         "(PADDLEBOX_TORCH_STREAM_ROOT)")
    ap.add_argument("--max-staleness-s", type=float, default=None,
                    help="online training: the freshness budget (s) of the "
                         "deadline publisher "
                         "(PADDLEBOX_TORCH_MAX_STALENESS_S)")
    ap.add_argument("--serve-replicas", type=int, default=0,
                    help="co-run a serving fleet: this many CPU replica "
                         "servers syncing from --publish-root behind a "
                         "health-checked router (serving_fleet/)")
    ap.add_argument("--serve-router-port", type=int, default=None,
                    help="port of the co-run fleet's router (default "
                         "PADDLEBOX_TORCH_ROUTER_PORT)")
    ap.add_argument("script", help="the rank program")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.serve_replicas > 0 and not args.publish_root:
        ap.error("--serve-replicas needs --publish-root: the fleet syncs "
                 "its models from the job's publish root")
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
        publish_root=args.publish_root,
        stream_root=args.stream_root,
        max_staleness_s=args.max_staleness_s,
        serve_replicas=args.serve_replicas,
        serve_router_port=args.serve_router_port,
    )


if __name__ == "__main__":
    sys.exit(main())
