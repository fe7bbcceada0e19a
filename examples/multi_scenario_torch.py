#!/usr/bin/env python
"""Multi-scenario training and two-tower retrieval with the PyTorch port
(the counterpart of examples/multi_scenario.py).

THREE scenarios (a feed CTR tower, a CVR tower over a slot subset with its
own create threshold, and a two-tower retrieval objective) train against
ONE shared SparseTable through MultiScenarioTrainer: one pass a round over
the union working set, the scenarios' batches interleaved, per-scenario
AUC and loss separately attributable in telemetry.

Then the serving split:

  * the retrieval scenario publishes its item rows as an ANN artifact and a
    Syncer'd ScoringServer answers POST /retrieve with top-k item keys,
    under a per-scenario serving policy (deadline, linger);
  * the feed scenario goes ONLINE through the streaming plane
    (TailingFileSource -> MiniPassScheduler -> StreamingTrainer ->
    DeadlinePublishPolicy tagged with the scenario name) under its own
    freshness deadline, hot-synced into the same server.

    python examples/multi_scenario_torch.py [--passes 3]   # on the card
    python examples/multi_scenario_torch.py --cpu          # on the CPU
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
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--stream-seconds", type=float, default=6.0)
    ap.add_argument("--staleness", type=float, default=1.5,
                    help="the feed scenario's freshness budget (s)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    import numpy as np

    from paddlebox_tpu_torch.config import (
        ScenarioServingConfig,
        SparseTableConfig,
        TrainerConfig,
    )
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import (
        make_synth_config,
        stream_line,
        write_synth_files,
    )
    from paddlebox_tpu_torch.inference import ScoringServer
    from paddlebox_tpu_torch.models import CtrDnn, TwoTower, WideDeep
    from paddlebox_tpu_torch.scenarios import MultiScenarioTrainer, ScenarioSpec
    from paddlebox_tpu_torch.serving_sync import Publisher, Syncer
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.streaming import (
        DeadlinePublishPolicy,
        MiniPassScheduler,
        StreamingTrainer,
        TailingFileSource,
    )

    S, DENSE, B, VOCAB = 4, 4, 64, 50
    work = tempfile.mkdtemp(prefix="pbox_scenarios_torch_")
    conf = make_synth_config(n_sparse_slots=S, dense_dim=DENSE,
                             batch_size=B, max_feasigns_per_ins=16)
    files = write_synth_files(
        os.path.join(work, "data"), n_files=2, ins_per_file=512,
        n_sparse_slots=S, vocab_per_slot=VOCAB, dense_dim=DENSE, seed=7)
    tconf = SparseTableConfig(embedding_dim=8, learning_rate=0.5,
                              initial_range=0.05)
    table = SparseTable(tconf, seed=0, device=device)
    W = tconf.row_width
    trconf = lambda: TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 12)

    # -- the three scenarios over ONE table --------------------------------- #
    specs = [
        ScenarioSpec("feed", CtrDnn(S, W, dense_dim=DENSE, hidden=(32, 16),
                                    seed=1, device=device),
                     trainer_conf=trconf()),
        ScenarioSpec("cvr", WideDeep(S, W, dense_dim=DENSE, hidden=(16,),
                                     seed=2, device=device),
                     slot_mask=(0, 1, 2),  # slot 3 is item-only: absent here
                     create_threshold=0.0,  # pull-time admission override
                     trainer_conf=trconf()),
        ScenarioSpec("retrieval",
                     TwoTower(S, W, item_slots=(3,), dense_dim=DENSE,
                              hidden=(32, 16), temperature=0.05, seed=3,
                              device=device),
                     kind="retrieval", trainer_conf=trconf()),
    ]
    mst = MultiScenarioTrainer(tconf, specs, device=device)
    datasets = {}
    for name in mst.scenario_names():
        ds = PadBoxSlotDataset(conf, read_threads=2)
        ds.set_filelist(files)
        ds.load_into_memory()
        datasets[name] = ds
    print(f"device {device}")
    for p in range(args.passes):
        res = mst.train_pass(datasets, table)
        print(f"[pass {p}] " + "  ".join(
            f"{n}: auc={m.get('auc', 0):.3f} loss={m['loss']:.3f}"
            for n, m in res.items()))
    for ds in datasets.values():
        ds.close()

    # -- retrieval serving: ANN artifact -> /retrieve ------------------------ #
    ann_root = os.path.join(work, "publish-ann")
    pub = Publisher(ann_root, staging_dir=os.path.join(work, "stage-ann"))
    lo, hi = 3 * VOCAB + 1, 4 * VOCAB  # slot 3 owns this key range
    pub.publish_ann_base("r0", table, item_key_lo=lo, item_key_hi=hi,
                         meta={"scenario": "retrieval"})
    server = ScoringServer(device=device)
    server.set_serving_policy("retrieval", ScenarioServingConfig(
        name="retrieval", deadline_ms=150.0, batch_linger_ms=0.0))
    syn_r = Syncer(ann_root, server, "retrieval",
                   cache_dir=os.path.join(work, "cache-ann"),
                   poll_interval_s=0.1)
    syn_r.poll_once()
    port = server.start(port=0)
    q = np.random.default_rng(5).normal(size=(2, tconf.embedding_dim))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/retrieve/retrieval",
        data=json.dumps({"queries": q.tolist(), "k": 5,
                         "tier": "int8"}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        out = json.loads(r.read())
    print(f"[retrieve] top-5 item keys for query 0: "
          f"{out['results'][0]['keys']} (tier={out['tier']}, "
          f"{out['n_items']} items)")

    # -- the feed scenario goes online: the streaming plane ------------------ #
    feed_root = os.path.join(work, "publish-feed")
    feed_pub = Publisher(feed_root,
                         staging_dir=os.path.join(work, "stage-feed"))
    feed_tr = mst.trainers["feed"]
    feed_pub.publish_base("base", feed_tr.model, None, table,
                          lineage="feed-warm", batch_size=B,
                          key_capacity=B * conf.max_feasigns_per_ins,
                          dense_dim=DENSE, feed_conf=conf)
    syn_f = Syncer(feed_root, server, "feed",
                   cache_dir=os.path.join(work, "cache-feed"),
                   poll_interval_s=0.1)
    syn_f.poll_once()
    syn_f.start()
    stream = os.path.join(work, "stream")
    os.makedirs(stream)
    source = TailingFileSource(stream, poll_interval_s=0.02)
    sched = MiniPassScheduler(source, conf, window_records=2 * B,
                              window_seconds=0.5)
    # the scenario's name is the publish tag prefix: every delta this plane
    # ships is attributable to the feed scenario in the donefile
    policy = DeadlinePublishPolicy(feed_pub, args.staleness,
                                   scheduler=sched, tag_prefix="feed")
    runner = StreamingTrainer(
        feed_tr, table, sched, policy=policy, model=feed_tr.model,
        served_seq_fn=lambda: (server.model_version("feed") or {}).get("seq"))
    source.start()
    sched.start()

    def writer():
        rng = np.random.default_rng(1)
        t0 = time.monotonic()
        with open(os.path.join(stream, "part-000"), "w", buffering=1) as fh:
            while time.monotonic() - t0 < args.stream_seconds:
                fh.write(stream_line(rng, 1, n_sparse_slots=S,
                                     dense_dim=DENSE,
                                     hot_keys=(5, 1005, 2005, 3005)))
                time.sleep(1 / 300.0)
        runner.stop()

    threading.Thread(target=writer, daemon=True).start()
    summary = runner.run()
    fresh = summary.get("last_freshness_s")
    print(f"[stream] feed scenario online: {summary['windows']} windows, "
          f"{summary['publishes']} publishes, last freshness "
          f"{fresh and round(fresh, 2)}s (budget {args.staleness}s)")
    syn_f.stop()
    server.stop()
    print("workdir:", work)


if __name__ == "__main__":
    main()
