#!/usr/bin/env python
"""Criteo CTR-DNN end to end with the PyTorch port (the counterpart of
examples/train_criteo.py): raw TSV -> convert -> train -> AUC.

With real Criteo data (day_0, day_1, ... or train.txt, optionally .gz):

    python examples/train_criteo_torch.py --input day_0 --passes 2

Without, a spec-exact synthetic sample is written first (the real format,
synthetic values with a planted learnable signal), so the whole path runs
either way: Criteo TSV parse, categorical hashing, the log1p dense
transform, the native slot parser, the pass loop and AUC.

    python examples/train_criteo_torch.py --lines 8192 --passes 3   # the card
    python examples/train_criteo_torch.py --cpu                     # the CPU

The published recipe at its widths: 26 hashed categorical slots, 13 log1p
counts, ``embedding_dim`` 8, tower 512-256-128, batch 2048, at the port's
defaults (native parser and planner, HBM cache, prefetch thread).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", nargs="*", default=None,
                    help="real Criteo TSV file(s); omit to synthesize")
    ap.add_argument("--lines", type=int, default=8192,
                    help="synthetic sample size when no --input")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--emb", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    if args.passes < 1:
        ap.error("--passes must be >= 1")
    device = "cpu" if args.cpu else "cuda"

    import torch

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.criteo import (
        CRITEO_N_CAT,
        CRITEO_N_DENSE,
        convert_criteo_files,
        criteo_feed_config,
        write_criteo_format_sample,
    )
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as td:
        inputs = args.input
        kind = "real"
        if not inputs:
            kind = "criteo-format synthetic"
            inputs = [write_criteo_format_sample(
                os.path.join(td, "sample.tsv"), n_lines=args.lines)]
        t0 = time.perf_counter()
        shards = convert_criteo_files(inputs, os.path.join(td, "slots"),
                                      batch_size=args.batch_size)
        t_conv = time.perf_counter() - t0
        conf = criteo_feed_config(args.batch_size)
        ds = PadBoxSlotDataset(conf, read_threads=4)
        ds.set_filelist(shards)
        t0 = time.perf_counter()
        ds.load_into_memory()
        t_parse = time.perf_counter() - t0

        tconf = SparseTableConfig(embedding_dim=args.emb)
        model = CtrDnn(CRITEO_N_CAT, tconf.row_width,
                       dense_dim=CRITEO_N_DENSE, hidden=(512, 256, 128),
                       device=device)
        table = SparseTable(tconf, seed=0, device=device)
        trainer = Trainer(model, tconf, TrainerConfig(auc_buckets=1 << 16),
                          device=device)
        print(f"device {device}")
        m = None
        t_train = 0.0
        for p in range(args.passes):
            table.begin_pass(ds.unique_keys())
            sync()
            t0 = time.perf_counter()
            m = trainer.train_from_dataset(
                ds, table, auc_state=trainer.last_metric_state)
            sync()
            dt = time.perf_counter() - t0
            t_train += dt
            table.end_pass()
            print(f"pass {p}: loss={m['loss']:.4f} auc={m['auc']:.4f} "
                  f"count={m['count']:.0f} samples/s={m['samples'] / dt:,.0f}")
        n_total = int(m["count"])
        ds.close()
        print(f"data: {kind}")
        print(f"convert: {t_conv:.2f}s  parse: {t_parse:.2f}s  "
              f"features: {table.n_features:,}")
        print(f"train: {n_total} samples in {t_train:.2f}s = "
              f"{n_total / t_train:,.0f} samples/s  final AUC {m['auc']:.4f}")
        trainer.close()
        table.close()


if __name__ == "__main__":
    main()
