#!/usr/bin/env python
"""End-to-end CTR-DNN training with the PyTorch port (the counterpart of
examples/train_ctr_dnn.py): the user program the reference's
test_paddlebox_datafeed.py template describes.

Runs the full production shape: day loop -> preload/train overlap across
passes -> pass lifecycle -> streaming AUC -> base/delta checkpoints ->
shrink.

    python examples/train_ctr_dnn_torch.py [--multichip] [--days 2] [--passes 3]
    python examples/train_ctr_dnn_torch.py --cpu            # the CPU

``--multichip`` trains the sharded table on ``make_mesh()``: one position
alone, and under the launcher one a rank (or ``--positions-per-proc``),
each rank feeding its own data and saving its own checkpoint shard:

    python -m paddlebox_tpu_torch.launch --nproc 2 --device cpu \\
        --backend gloo examples/train_ctr_dnn_torch.py --multichip --cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--multichip", action="store_true")
    ap.add_argument("--days", type=int, default=2)
    ap.add_argument("--passes", type=int, default=3, help="passes per day")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--ins-per-pass", type=int, default=4096)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    from paddlebox_tpu_torch.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import DatasetFactory
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn

    S, DENSE = 8, 8
    work = tempfile.mkdtemp(prefix="pbox_example_torch_")
    conf = make_synth_config(
        n_sparse_slots=S, dense_dim=DENSE, batch_size=args.batch_size
    )
    tconf = SparseTableConfig(embedding_dim=8)
    trconf = TrainerConfig(auc_buckets=1 << 16)
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(128, 64),
                   device=device)

    rank, world = 0, 1
    if args.multichip:
        from paddlebox_tpu_torch.parallel import (
            MultiChipTrainer,
            ShardedSparseTable,
            initialize_distributed,
            make_mesh,
        )

        job = initialize_distributed()  # None outside the launcher
        if job is not None:
            rank, world = job.rank, job.world
        mesh = make_mesh(device=device)
        table = ShardedSparseTable(tconf, mesh)
        trainer = MultiChipTrainer(model, tconf, mesh, trconf)
        print(f"mesh: {mesh.n} positions on {mesh.device}, {mesh.n_local} "
              f"in this process (rank {rank} of {world})")
    else:
        from paddlebox_tpu_torch.sparse.table import SparseTable
        from paddlebox_tpu_torch.train import Trainer

        table = SparseTable(tconf, device=device)
        trainer = Trainer(model, tconf, trconf, device=device)
        print(f"device {device}")

    ckpt = CheckpointManager(os.path.join(work, "ckpt"), shard=rank,
                             n_shards=world)
    ds = DatasetFactory().create_dataset("BoxPSDataset", conf, read_threads=4)

    # pass p trains while pass p+1 preloads (the reference's double-buffered
    # day pipeline); in a job each rank writes and feeds its own files
    def files_for(day, p):
        return write_synth_files(
            os.path.join(work, f"day{day}-p{p}"), n_files=2,
            ins_per_file=args.ins_per_pass // 2, n_sparse_slots=S,
            vocab_per_slot=5000, dense_dim=DENSE,
            seed=day * 100 + p + 10_000 * rank,
        )

    for day in range(args.days):
        date = f"202607{20 + day:02d}"
        ds.set_date(date)
        ds.set_filelist(files_for(day, 0))
        ds.preload_into_memory()
        for p in range(args.passes):
            ds.wait_preload_done()  # pass p's data becomes current
            if p + 1 < args.passes:
                # kick off pass p+1's read NOW so it overlaps training
                ds.set_filelist(files_for(day, p + 1))
                ds.preload_into_memory()
            table.begin_pass(ds.unique_keys())
            metrics = trainer.train_from_dataset(ds, table)
            table.end_pass()
            print(
                f"day {date} pass {p}: loss={metrics['loss']:.4f} "
                f"auc={metrics['auc']:.4f} count={metrics['count']:.0f}"
            )
        params, opt = trainer.dense_state()
        if day == 0:
            ckpt.save_base(date, table, params, opt)
        else:
            ckpt.save_delta(date, table, params, opt)
        print(f"day {date}: checkpoint saved, table rows={table.n_features}")
        evicted = table.shrink()
        print(f"day {date}: shrink evicted {evicted} cold features")

    ds.close()
    trainer.close()
    table.close()
    print("done; artifacts in", work)


if __name__ == "__main__":
    main()
