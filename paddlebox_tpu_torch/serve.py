"""One-command scoring server over self-contained artifacts (reference:
paddlebox_tpu/serve.py, its single-server mode).

    python -m paddlebox_tpu_torch.serve --artifact [NAME=]DIR [...more] \\
        [--port 8080] [--host 127.0.0.1] [--cpu] [--max-queue 64] \\
        [--request-deadline-ms 500] [--max-batch 8] [--batch-linger-ms 2] \\
        [--serving-policy NAME:deadline_ms=50,batch_linger_ms=1]
    python -m paddlebox_tpu_torch.serve --sync-root [NAME=]ROOT [...more] \\
        [--sync-model live] [--sync-interval 10] [--sync-cache DIR] [--cpu]

Each --artifact is DIR or NAME=DIR (NAME defaults to the directory's
basename; the first one registered is the default model).  Artifacts carry
their feed schema (export_model(feed_conf=...)); the endpoints are POST
/score[/NAME], POST /retrieve[/NAME], GET /healthz, /models and /metrics
(inference/server.py).  The models serve on the card unless --cpu is
given.

Admission control (--max-queue / --request-deadline-ms, or
PADDLEBOX_TORCH_SERVE_MAX_QUEUE / _REQUEST_DEADLINE_MS) bounds the queue:
past the cap, or once the estimated wait exceeds the request deadline, the
server sheds with 429 + Retry-After.

--sync-root attaches the online delivery plane (serving_sync/): one Syncer
a synced model follows its publish root's donefile and hot-applies sparse
deltas into the live model between requests (on the card each predict
then resolves its keys with the sorted_search and gather_slots kernels),
falling back to a full reload on any verification failure.  A bare ROOT
serves under --sync-model (default "live"), NAME=ROOT under NAME.  Without
an --artifact the server starts once every synced model has its first
version (at most --sync-timeout seconds).  GET /models reports each
model's lineage (base tag, deltas applied, publish time).

The reference's fleet mode (--replicas, --autoscale) is not ported yet
(ROADMAP.md, Queue A item 6b: the fleet, serving_fleet/): given here, it
stops the command with an error instead of serving without it.
"""

from __future__ import annotations

import argparse
import os

_NOT_PORTED = ("is not ported yet (ROADMAP.md, Queue A item 6b: the "
               "fleet, serving_fleet/); serve one server without it")


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m paddlebox_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--artifact", action="append", default=[],
                    metavar="[NAME=]DIR",
                    help="artifact directory (repeatable); first = default")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU instead of the card")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission queue bound: requests beyond it shed "
                         "with 429 (default PADDLEBOX_TORCH_SERVE_MAX_QUEUE)")
    ap.add_argument("--request-deadline-ms", type=float, default=None,
                    help="default per-request deadline: arrivals whose "
                         "estimated queue wait exceeds it shed with 429 + "
                         "Retry-After (clients override it with the "
                         "X-Request-Deadline-Ms header; default "
                         "PADDLEBOX_TORCH_REQUEST_DEADLINE_MS, 0 = none)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="micro-batching width: up to this many queued "
                         "/score requests coalesce into one device call "
                         "(default PADDLEBOX_TORCH_SERVE_MAX_BATCH; 1 = "
                         "one at a time)")
    ap.add_argument("--batch-linger-ms", type=float, default=None,
                    help="longest wait for a forming micro-batch to fill "
                         "(default PADDLEBOX_TORCH_SERVE_BATCH_LINGER_MS; "
                         "an idle queue never waits)")
    ap.add_argument("--serving-policy", action="append", default=[],
                    metavar="NAME:k=v[,k=v...]",
                    help="per-scenario serving policy (repeatable): "
                         "NAME[:deadline_ms=..][,batch_linger_ms=..]"
                         "[,embedding_dtype=fp32|int8|fp8]"
                         "[,max_staleness_s=..]; overrides the server "
                         "defaults for POST /score/NAME and /retrieve/NAME")
    ap.add_argument("--sync-root", action="append", default=[],
                    metavar="[NAME=]ROOT",
                    help="publish root to keep a model synced from "
                         "(repeatable; the serving_sync delivery plane)")
    ap.add_argument("--sync-model", default="live",
                    help="model name a bare --sync-root serves under "
                         "(default: live)")
    ap.add_argument("--sync-interval", type=float, default=None,
                    help="donefile poll interval in seconds (default "
                         "PADDLEBOX_TORCH_SYNC_INTERVAL_S)")
    ap.add_argument("--sync-cache", default=None,
                    help="local cache directory of fetched model units (a "
                         "directory a model under it; default "
                         "PADDLEBOX_TORCH_SYNC_CACHE_DIR, else a temporary "
                         "one)")
    ap.add_argument("--sync-timeout", type=float, default=300.0,
                    help="longest wait for the first synced model at "
                         "startup")
    # the reference's fleet mode: refused (item 6b, the fleet)
    ap.add_argument("--replicas", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--autoscale", action="store_true",
                    help=argparse.SUPPRESS)
    return ap


def _parse_serving_policy(spec: str):
    """``NAME:k=v,k=v`` -> ScenarioServingConfig.  Numeric keys take
    floats; embedding_dtype passes through for the config to validate."""
    from paddlebox_tpu_torch.config import ScenarioServingConfig

    name, _, rest = spec.partition(":")
    name = name.strip()
    if not name:
        raise ValueError(f"--serving-policy {spec!r}: empty scenario name")
    kw = {}
    for part in filter(None, (p.strip() for p in rest.split(","))):
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep:
            raise ValueError(
                f"--serving-policy {spec!r}: expected k=v, got {part!r}")
        if key in ("deadline_ms", "batch_linger_ms", "max_staleness_s"):
            kw[key] = float(val)
        elif key == "embedding_dtype":
            kw[key] = val.strip()
        else:
            raise ValueError(
                f"--serving-policy {spec!r}: unknown key {key!r}")
    return ScenarioServingConfig(name=name, **kw)


def main(argv=None) -> None:
    ap = _build_parser()
    args = ap.parse_args(argv)
    if args.replicas and args.replicas > 0:
        ap.error(f"--replicas {args.replicas} (fleet mode) {_NOT_PORTED}")
    if args.autoscale:
        ap.error(f"--autoscale {_NOT_PORTED}")
    if not args.artifact and not args.sync_root:
        ap.error("pass at least one --artifact or a --sync-root")
    synced = []
    for spec in args.sync_root:
        name, sep, root = spec.partition("=")
        if not sep:
            name, root = args.sync_model, spec
        if name in (n for n, _ in synced):
            ap.error(f"--sync-root: model name {name!r} given twice")
        synced.append((name, root))

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.inference import ScoringServer

    # label this process's flight dumps, and dump the ring on SIGTERM
    telemetry.set_process_name("replica")
    telemetry.install_signal_dump()

    server = ScoringServer(
        max_queue=args.max_queue,
        request_deadline_ms=args.request_deadline_ms,
        max_batch=args.max_batch,
        batch_linger_ms=args.batch_linger_ms,
        device="cpu" if args.cpu else "cuda",
    )
    for spec in args.serving_policy:
        try:
            policy = _parse_serving_policy(spec)
        except ValueError as exc:
            ap.error(str(exc))
        server.set_serving_policy(policy.name, policy)
        print(f"serving policy {policy.name!r}: {policy.to_dict()}")
    for spec in args.artifact:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = os.path.basename(os.path.normpath(spec)), spec
        if name in server.model_names():
            ap.error(
                f"model name {name!r} given twice (basenames collide?) — "
                "disambiguate with NAME=DIR"
            )
        server.register(name, path)
        print(f"registered {name!r} <- {path}")
    from paddlebox_tpu_torch.serving_sync import Syncer

    syncers = []
    for name, root in synced:
        cache = (os.path.join(args.sync_cache, name) if args.sync_cache
                 else None)
        syncer = Syncer(root, server, name, cache_dir=cache,
                        poll_interval_s=args.sync_interval)
        print(f"syncing {name!r} <- {root}")
        if not args.artifact:
            # the HTTP server needs a model: wait for the root's first one
            if not syncer.wait_fresh(timeout_s=args.sync_timeout):
                for other in syncers:
                    other.stop()
                ap.error(f"no model appeared under {root} within "
                         f"{args.sync_timeout:.1f}s")
        else:
            syncer.poll_once()
        syncer.start()
        syncers.append(syncer)
    port = server.start(port=args.port, host=args.host)
    print(f"serving on http://{args.host}:{port}/score "
          f"(models: {', '.join(server.model_names())}; device "
          f"{server.device})", flush=True)
    try:
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        for syncer in syncers:
            syncer.stop()
        server.stop()


if __name__ == "__main__":
    main()
