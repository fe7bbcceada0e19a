#!/usr/bin/env python
"""The online model delivery loop with the PyTorch port, end to end: train
-> publish -> sync -> score, the server up and fresh the whole time (the
counterpart of examples/online_delivery.py).

  pass 0:  publish_base   — a full artifact (programs + sparse snapshot)
  pass k:  publish_delta  — the rows touched this pass and the re-exported
                            programs (never the whole table)
  serving: a Syncer follows the donefile and hot-applies each delta into
           the live model between requests; on the card every predict
           resolves its keys with the sorted_search and gather_slots
           kernels.

    python examples/online_delivery_torch.py [--passes 3]          # card
    python examples/online_delivery_torch.py --cpu                 # CPU
"""

import argparse
import json
import os
import sys
import tempfile
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3,
                    help="delta passes to publish after the base")
    ap.add_argument("--cpu", action="store_true",
                    help="train and serve on the CPU instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import (
        make_synth_config,
        write_synth_files,
    )
    from paddlebox_tpu_torch.inference import ScoringServer
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.serving_sync import Publisher, Syncer
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    S, DENSE, B = 4, 2, 32
    conf = make_synth_config(n_sparse_slots=S, dense_dim=DENSE,
                             batch_size=B, max_feasigns_per_ins=8)
    tconf = SparseTableConfig(embedding_dim=8)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(16, 8),
                   device=device)
    table = SparseTable(tconf, seed=0, device=device)
    trainer = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 12),
                      device=device)

    work = tempfile.mkdtemp(prefix="pbox_delivery_torch_")
    root = os.path.join(work, "publish")
    kcap = B * conf.max_feasigns_per_ins

    def train_pass(i):
        files = write_synth_files(
            os.path.join(work, f"d{i}"), n_files=1, ins_per_file=256,
            n_sparse_slots=S, vocab_per_slot=200, dense_dim=DENSE,
            seed=10 + i,
        )
        ds = PadBoxSlotDataset(conf, read_threads=1)
        ds.set_filelist(files)
        ds.load_into_memory()
        table.begin_pass(ds.unique_keys())
        metrics = trainer.train_from_dataset(ds, table)
        table.end_pass()
        ds.close()
        return metrics

    # -- trainer side: the base ---------------------------------------------- #
    pub = Publisher(root, staging_dir=os.path.join(work, "staging"))
    m = train_pass(0)
    pub.publish_base("pass0", model, None, table, lineage="pass0",
                     batch_size=B, key_capacity=kcap, dense_dim=DENSE,
                     feed_conf=conf)
    print(f"pass 0: auc={m['auc']:.4f} -> published base "
          f"({table.n_features} features)")

    # -- serving side: the live server and its sync agent -------------------- #
    server = ScoringServer(device=device)
    syncer = Syncer(root, server, "live",
                    cache_dir=os.path.join(work, "cache"),
                    poll_interval_s=0.2)
    syncer.poll_once()
    port = server.start(port=0)
    body = b"1 0 2 7 9 2 11 3 2 5 1 1 8 2 0.5 0.25\n"

    def score():
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/score/live", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())["scores"][0]

    def models():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/models", timeout=30) as r:
            return json.loads(r.read())["models"]["live"]

    print(f"serving on :{port} (device {server.device}); first score = "
          f"{score():.6f}")

    # -- the loop: train, publish a delta, watch it apply -------------------- #
    for i in range(1, args.passes + 1):
        m = train_pass(i)
        entry = pub.publish_delta(f"pass{i}", table, model,
                                  lineage=f"pass{i}")
        applied = syncer.poll_once()  # the agent thread polls in production
        info = models()
        split = ", ".join(f"{k} {v:.4f}s" for k, v in syncer.last_apply.items()
                          if k.endswith("_s"))
        print(
            f"pass {i}: auc={m['auc']:.4f} -> delta {entry.n_rows} rows, "
            f"{entry.n_bytes} bytes (applied {applied}: {split}); live = "
            f"base {info['base_tag']} + {info['deltas_applied']} deltas; "
            f"score = {score():.6f}"
        )

    server.stop()
    table.close()
    print("delivery loop done;", work)


if __name__ == "__main__":
    main()
