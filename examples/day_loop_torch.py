#!/usr/bin/env python
"""The production day loop with the PyTorch port (the counterpart of
examples/day_loop.py).

  day d:
    pass p:
      join phase -> update phase (two dense programs, one shared sparse
                                  table: TwoPhaseTrainer)
      monitor.observe(metrics)   (AUC floor and drop, loss)
      save_delta                 (incremental checkpoint)
    shrink()                     (decay show/clk, evict cold features)
    save_base + publish gate     (only a healthy model ships)

    python examples/day_loop_torch.py [--days 2] [--passes 2]   # the card
    python examples/day_loop_torch.py --cpu                     # the CPU
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=2)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    if args.days < 1 or args.passes < 1:
        ap.error("--days and --passes must be >= 1")
    device = "cpu" if args.cpu else "cuda"

    from paddlebox_tpu_torch.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import PhaseSpec, TwoPhaseTrainer
    from paddlebox_tpu_torch.utils.fleet_util import (
        HealthPolicy,
        ModelMonitor,
        check_model,
    )

    S, DENSE, B = 6, 4, 128
    conf = make_synth_config(n_sparse_slots=S, dense_dim=DENSE, batch_size=B,
                             max_feasigns_per_ins=16)
    tconf = SparseTableConfig(
        embedding_dim=8, learning_rate=0.5, initial_range=0.05,
        show_decay_rate=0.9, delete_threshold=0.5,  # the day-boundary shrink
    )
    trconf = TrainerConfig(dense_lr=3e-3, auc_buckets=1 << 16)
    # the join phase trains the user and context slots, the update phase
    # every slot: two dense programs over ONE sparse table
    tp = TwoPhaseTrainer(
        [PhaseSpec("join", CtrDnn(S, tconf.row_width, dense_dim=DENSE,
                                  hidden=(64, 32), seed=0, device=device),
                   slots=tuple(range(S // 2))),
         PhaseSpec("update", CtrDnn(S, tconf.row_width, dense_dim=DENSE,
                                    hidden=(64, 32), seed=1, device=device))],
        tconf, trconf, device=device,
    )
    table = SparseTable(tconf, seed=0, device=device)
    monitor = ModelMonitor(HealthPolicy(min_auc=0.5, max_auc_drop=0.2))
    work = tempfile.mkdtemp(prefix="pbox_dayloop_torch_")
    cm = CheckpointManager(os.path.join(work, "ckpt"))
    seed = 0
    print(f"device {device}")
    for day in range(args.days):
        date = f"202607{28 + day:02d}"
        print(f"== day {date}")
        for p in range(args.passes):
            with tempfile.TemporaryDirectory() as td:
                files = write_synth_files(
                    td, n_files=2, ins_per_file=512, n_sparse_slots=S,
                    vocab_per_slot=300, dense_dim=DENSE, seed=seed)
                seed += 1
                ds = PadBoxSlotDataset(conf, read_threads=2)
                ds.set_filelist(files)
                ds.set_date(date)
                ds.load_into_memory()
                table.begin_pass(ds.unique_keys())
                metrics = tp.train_pass(ds, table)
                table.end_pass()
                ds.close()
            up = metrics["update"]
            report = monitor.observe(up)
            print(f"  pass {p}: join auc={metrics['join']['auc']:.4f} "
                  f"update auc={up['auc']:.4f} loss={up['loss']:.4f} "
                  f"healthy={bool(report)}")
            cm.save_delta(f"{date}-p{p}", table)
        evicted = table.shrink()
        rep = check_model(table, tp.trainers["update"])
        print(f"  shrink evicted {evicted}; features={rep['n_features']} "
              f"sparse={rep['sparse_bytes'] / 1e6:.1f}MB "
              f"finite={rep['sparse_finite']}")
        if monitor.should_publish(up):
            params, opt = tp.trainers["update"].dense_state()
            path = cm.save_base(f"{date}-base", table, params, opt)
            print(f"  published base checkpoint: {os.path.basename(path)}")
        else:
            print("  publish gate held the model back")
    tp.close()
    table.close()
    print("day loop done;", work)


if __name__ == "__main__":
    main()
