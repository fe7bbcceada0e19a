#!/usr/bin/env python
"""Train -> export -> serve with the PyTorch port (the counterpart of
examples/serve_ctr.py).

A short synthetic training pass, ``export_model`` into a self-contained
artifact (a ``torch.export`` program with the tower frozen in, the table
snapshot and the feed schema), then the packaged ``ScoringServer`` (POST
/score with slot-text lines, /healthz, /models) and one demo request.

    python examples/serve_ctr_torch.py             # on the card
    python examples/serve_ctr_torch.py --cpu       # on the CPU
    python examples/serve_ctr_torch.py --port 0    # stay up on a free port
"""

import argparse
import json
import os
import sys
import tempfile
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_artifact(work: str, device: str) -> str:
    """Quick synthetic training run, then export; returns the artifact."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.inference import export_model
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    S, DENSE, B = 4, 4, 32
    conf = make_synth_config(
        n_sparse_slots=S, dense_dim=DENSE, batch_size=B, max_feasigns_per_ins=16
    )
    files = write_synth_files(
        os.path.join(work, "data"), n_files=2, ins_per_file=512,
        n_sparse_slots=S, vocab_per_slot=1000, dense_dim=DENSE, seed=1,
    )
    ds = PadBoxSlotDataset(conf, read_threads=2)
    ds.set_filelist(files)
    ds.load_into_memory()
    tconf = SparseTableConfig(embedding_dim=8)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(64, 32),
                   device=device)
    table = SparseTable(tconf, device=device)
    trainer = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 16),
                      device=device)
    table.begin_pass(ds.unique_keys())
    metrics = trainer.train_from_dataset(ds, table)
    table.end_pass()
    print(f"trained: auc={metrics['auc']:.4f}")
    art = os.path.join(work, "artifact")
    export_model(
        model, table, art,
        batch_size=B, key_capacity=conf.batch_key_capacity or (
            B * conf.max_feasigns_per_ins),
        dense_dim=DENSE,
        feed_conf=conf,  # self-contained artifact: serving needs no config
    )
    table.close()
    ds.close()
    return art


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=None,
                    help="serve until killed on this port (0 = pick free)")
    ap.add_argument("--cpu", action="store_true",
                    help="train and serve on the CPU instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    from paddlebox_tpu_torch.data.synth import write_synth_files
    from paddlebox_tpu_torch.inference import ScoringServer

    work = tempfile.mkdtemp(prefix="pbox_serve_torch_")
    art = build_artifact(work, device)
    server = ScoringServer(device=device)
    server.register("ctr", art)  # the feed schema comes from the artifact
    port = server.start(port=args.port or 0)
    print(f"serving on http://127.0.0.1:{port}/score "
          f"(also /score/ctr, /healthz, /models; device {server.device})")

    if args.port is None:
        # demo mode: one request against ourselves, then exit
        demo = write_synth_files(
            os.path.join(work, "demo"), n_files=1, ins_per_file=8,
            n_sparse_slots=4, vocab_per_slot=1000, dense_dim=4, seed=9,
        )
        with open(demo[0], "rb") as f:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/score", data=f.read(),
                method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            print("scores:", json.load(resp)["scores"])
        server.stop()
    else:
        server.wait()  # foreground until killed


if __name__ == "__main__":
    main()
