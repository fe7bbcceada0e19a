#!/usr/bin/env python
"""Online training with the PyTorch port, end to end: a live feed ->
served scores with measured freshness (the counterpart of
examples/streaming_online.py).

A writer appends slot-text records to a stream directory.  A
TailingFileSource follows it; a MiniPassScheduler cuts windows and
censuses them off the training thread; StreamingTrainer trains window by
window (each window's steps launch pull_rows and scatter_add_rows on the
card, its boundary the cache kernels); a DeadlinePublishPolicy ships
sparse deltas on a max-staleness deadline; a Syncer'd ScoringServer
hot-applies them; and the confirmation poller records the event-to-served
latency (``stream.freshness_seconds``).

Halfway through, the writer flips the label of a hot key pattern: the
served score moves within seconds.

    python examples/streaming_online_torch.py [--seconds 12] [--cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=12.0,
                    help="how long the live stream runs")
    ap.add_argument("--staleness", type=float, default=1.5,
                    help="freshness budget (s): the publish deadline")
    ap.add_argument("--rate", type=float, default=400.0,
                    help="records/s the writer appends")
    ap.add_argument("--cpu", action="store_true",
                    help="train and serve on the CPU instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    import numpy as np

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.feed import BatchBuilder
    from paddlebox_tpu_torch.data.slot_parser import SlotParser
    from paddlebox_tpu_torch.data.synth import make_synth_config, stream_line
    from paddlebox_tpu_torch.inference import ScoringServer
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.serving_sync import Publisher, Syncer
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.streaming import (
        DeadlinePublishPolicy,
        MiniPassScheduler,
        StreamingTrainer,
        TailingFileSource,
    )
    from paddlebox_tpu_torch.streaming.minipass import (
        MiniPassWindow,
        WindowDataset,
    )
    from paddlebox_tpu_torch.train import Trainer

    S, DENSE, B = 2, 2, 16
    conf = make_synth_config(n_sparse_slots=S, dense_dim=DENSE,
                             batch_size=B, max_feasigns_per_ins=8)
    tconf = SparseTableConfig(embedding_dim=4, learning_rate=0.3,
                              store_buckets=8, plan_scratch_rows=64)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(8,),
                   device=device)
    table = SparseTable(tconf, seed=0, device=device)
    trainer = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 12),
                      device=device)

    work = tempfile.mkdtemp(prefix="pbox_streaming_torch_")
    root = os.path.join(work, "publish")
    stream = os.path.join(work, "stream")
    os.makedirs(stream)
    rng = np.random.default_rng(0)

    def line(label: int) -> str:
        """One record: the hot key pair (5, 1005) and a noise key each."""
        return stream_line(rng, label, n_sparse_slots=S, dense_dim=DENSE,
                           hot_keys=(5, 1005))

    # -- warm start: one small pass anchors the delta chain ------------------ #
    warm = [line(1) for _ in range(4 * B)]
    block = SlotParser(conf).parse_lines(warm)
    w0 = MiniPassWindow(0, block, np.unique(block.keys), len(warm),
                        time.time(), time.time(), "warm", time.time())
    table.begin_pass(w0.census)
    trainer.train_from_dataset(WindowDataset(w0, BatchBuilder(conf)), table)
    table.end_pass()

    pub = Publisher(root, staging_dir=os.path.join(work, "staging"))
    pub.publish_base("base", model, None, table, lineage="warmup",
                     batch_size=B, key_capacity=B * conf.max_feasigns_per_ins,
                     dense_dim=DENSE, feed_conf=conf)

    # -- serving side ---------------------------------------------------------- #
    server = ScoringServer(device=device)
    syncer = Syncer(root, server, "live",
                    cache_dir=os.path.join(work, "cache"),
                    poll_interval_s=0.1)
    syncer.poll_once()
    syncer.start()
    port = server.start(port=0)
    probe = b"1 0 2 5 30 2 1005 1030 2 0.0 0.0\n"

    def score() -> float:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/score/live", data=probe, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())["scores"][0]

    # -- the streaming plane ---------------------------------------------------- #
    source = TailingFileSource(stream, poll_interval_s=0.02)
    sched = MiniPassScheduler(source, conf, window_records=4 * B,
                              window_seconds=0.5)
    policy = DeadlinePublishPolicy(pub, args.staleness, scheduler=sched)
    runner = StreamingTrainer(trainer, table, sched, policy=policy,
                              model=model,
                              served_seq_fn=lambda: syncer.applied_seq)
    source.start()
    sched.start()
    done = threading.Event()

    def writer():
        t0 = time.monotonic()
        flipped = False
        with open(os.path.join(stream, "part-000"), "w", buffering=1) as fh:
            while time.monotonic() - t0 < args.seconds:
                late = time.monotonic() - t0 >= args.seconds / 2
                if late and not flipped:
                    flipped = True
                    print(f"[writer] t+{time.monotonic() - t0:.1f}s: label "
                          "flip 1 -> 0 for the hot keys")
                fh.write(line(0 if late else 1))
                time.sleep(1.0 / args.rate)
        runner.stop()  # the drain-and-checkpoint shutdown

    def reporter():
        while not done.wait(1.0):
            try:
                s = f"{score():.4f}"
            except OSError as e:
                s = f"unavailable ({e})"
            fresh = policy.last_freshness_s
            print(f"[serve] score={s} seq={syncer.applied_seq} "
                  f"freshness={'-' if fresh is None else round(fresh, 2)}s "
                  f"windows={runner.windows_trained}")

    threading.Thread(target=writer, daemon=True).start()
    threading.Thread(target=reporter, daemon=True).start()
    try:
        summary = runner.run()
    finally:
        done.set()
    final = score()
    syncer.stop()
    server.stop()
    hist = telemetry.registry.get("stream.freshness_seconds")
    print("\nstream summary:", json.dumps(summary, indent=2))
    last = runner.last_metrics or {}
    print(f"last window: loss={last.get('loss', float('nan')):.4f} "
          f"auc={last.get('auc', float('nan')):.4f}")
    if hist is not None:
        print("stream.freshness_seconds:", hist.summary())
    print(f"final served score: {final:.4f}")
    print("workdir:", work)


if __name__ == "__main__":
    main()
