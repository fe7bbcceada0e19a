"""Stub serving replica of the port's fleet tests (port of
tests/_replica_child.py; not a pytest module): the port's REAL
ScoringServer (HTTP stack, admission gate, drain and degraded machinery) on
the CPU whose scoring is a stub (no artifact, no device work), so a fleet
spawns in seconds and SIGKILL chaos exercises the router and the
supervisor.  It imports the port only.

    python tests/_torch_replica_child.py --port N [--service-ms M]
        [--max-queue Q] [--max-concurrency C] [--deadline-ms D]
        [--degraded REASON] [--crash-after S]
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class StubPredictor:
    """Just enough Predictor surface for ModelEntry + /healthz."""

    meta = {"n_tasks": 1, "row_width": 4}
    bucket_shapes = [(8, 64)]
    n_features = 1


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--service-ms", type=float, default=1.0,
                    help="simulated per-request scoring time")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-concurrency", type=int, default=1)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--degraded", default=None,
                    help="advertise this degraded reason from startup")
    ap.add_argument("--crash-after", type=float, default=0.0,
                    help="os._exit(1) this many seconds after startup "
                         "(crash-loop simulation; 0 = never)")
    args = ap.parse_args()

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
    from paddlebox_tpu_torch.inference.server import ScoringServer

    # labeled flight dumps and the SIGTERM ring capture, as a real
    # serve.py replica
    telemetry.set_process_name("replica")
    telemetry.install_signal_dump()

    conf = DataFeedConfig(
        slots=(
            SlotConfig("click", type="float", is_dense=True),
            SlotConfig("s0"),
        ),
        batch_size=8,
    )
    srv = ScoringServer(
        max_queue=args.max_queue,
        max_concurrency=args.max_concurrency,
        request_deadline_ms=args.deadline_ms or None,
        device="cpu",
    )
    srv.register_predictor("stub", StubPredictor(), conf)
    if args.degraded:
        srv.set_degraded(args.degraded, "stub replica flag")

    pid = os.getpid()
    service_s = args.service_ms / 1e3

    def score_lines(text: bytes, name=None) -> list:
        # the stub model: one score a line, this process's pid, so a test
        # tells which replica answered; behind the server's real scoring
        # lock, so admission and concurrency behave as in production
        lines = [ln for ln in text.decode().splitlines() if ln.strip()]
        with srv._lock:
            if service_s > 0:
                time.sleep(service_s)
        return [float(pid)] * len(lines)

    srv.score_lines = score_lines

    if args.crash_after > 0:
        def crash():
            time.sleep(args.crash_after)
            os._exit(1)

        threading.Thread(target=crash, daemon=True).start()

    port = srv.start(port=args.port)
    print(f"stub replica pid={pid} port={port}", flush=True)
    srv.wait()


if __name__ == "__main__":
    main()
