#!/usr/bin/env python
"""Long-sequence CTR training with the PyTorch port (the counterpart of
examples/train_longseq.py): DIN-style behaviour attention.

One behaviour slot (the click history: file order is behaviour order) feeds
an attention tower beside the pooled CVM features; long sequences split
over ``seq`` positions with ring or Ulysses attention.  It runs through the
same Dataset/Trainer lifecycle as every other model.

    python examples/train_longseq_torch.py [--seq-mesh N] [--impl ring|ulysses]
    python examples/train_longseq_torch.py --cpu        # the CPU

``--seq-mesh N`` gives N ``seq`` positions of the one device
(``make_mesh(N, axis_name="seq")``); N must divide ``--max-seq-len``.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-mesh", type=int, default=0,
                    help="split the sequence axis over N positions (0 = off)")
    ap.add_argument("--impl", default="ring", choices=["ring", "ulysses"])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--max-seq-len", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import LongSeqCtrDnn
    from paddlebox_tpu_torch.parallel import make_mesh
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    S, DENSE, B = 8, 8, 256
    MAX_KEYS_PER_SLOT = 24
    conf = make_synth_config(
        n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
        max_feasigns_per_ins=args.max_seq_len + 16,
        # capacity must cover the worst batch (B * S * keys-per-slot) or the
        # feed clips tail keys, the behaviour sequences included
        batch_key_capacity=B * S * MAX_KEYS_PER_SLOT,
        sequence_slot="slot0",  # slot0's keys double as the behaviour sequence
        max_seq_len=args.max_seq_len,
    )

    seq_mesh = None
    if args.seq_mesh:
        seq_mesh = make_mesh(args.seq_mesh, device=device, axis_name="seq")

    tconf = SparseTableConfig(embedding_dim=16, learning_rate=0.5,
                              initial_range=0.05)
    model = LongSeqCtrDnn(
        S, tconf.row_width, dense_dim=DENSE, hidden=(256, 128),
        max_seq_len=args.max_seq_len, n_heads=4, head_dim=16,
        seq_mesh=seq_mesh, seq_impl=args.impl, device=device,
    )
    table = SparseTable(tconf, seed=0, device=device)
    trainer = Trainer(
        model, tconf, TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 16),
        device=device,
    )
    print(f"device {device}")

    with tempfile.TemporaryDirectory() as td:
        files = write_synth_files(
            td, n_files=2, ins_per_file=2048, n_sparse_slots=S,
            vocab_per_slot=5000, dense_dim=DENSE, seed=7,
            max_keys_per_slot=MAX_KEYS_PER_SLOT,
        )
        ds = PadBoxSlotDataset(conf, read_threads=2)
        ds.set_filelist(files)
        ds.load_into_memory()
        for p in range(args.passes):
            ds.local_shuffle(seed=p)
            table.begin_pass(ds.unique_keys())
            m = trainer.train_from_dataset(ds, table)
            table.end_pass()
            mesh_note = (
                f" [seq-mesh {args.seq_mesh}x {args.impl}]" if seq_mesh else ""
            )
            print(
                f"pass {p}{mesh_note}: loss={m['loss']:.4f} "
                f"auc={m['auc']:.4f} steps={m['steps']}"
            )
        ds.close()
    table.close()


if __name__ == "__main__":
    main()
