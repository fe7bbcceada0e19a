"""Rank program of the port's frozen-rank liveness test (not a pytest
module; reference: tests/_stall_child.py).

Launched by ``paddlebox_tpu_torch.launch`` on the CPU over gloo: every rank
joins the job and trains one position of a small multi-chip world under a
liveness watchdog with heartbeats on the job's store.  The rank
``stall_rank`` arms a hang at the ``train.step`` fault site through the
PADDLEBOX_TORCH_FAULT_PLAN flag, freezing its first step; the whole job
must then abort with a DistributedStallError naming that rank instead of
hanging.

argv: out_dir deadline_s stall_rank files_json
Writes rank<r>.json {"culprit", "stage", "kind", "t_start", "t_abort"};
exit codes: 7 = aborted with DistributedStallError (expected), 3 = the
pass completed (a failure), anything else = a crash.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

out_dir = sys.argv[1]
deadline_s = float(sys.argv[2])
stall_rank = int(sys.argv[3])
with open(sys.argv[4]) as f:
    files = json.load(f)
rank = int(os.environ["PADDLEBOX_TORCH_PROCESS_ID"])
if rank == stall_rank:
    # the flag path: the plan is read on the first inject()
    os.environ["PADDLEBOX_TORCH_FAULT_PLAN"] = "train.step=hang:first:1"


def main() -> int:
    import torch

    from paddlebox_tpu_torch.config import (
        LivenessConfig,
        SparseTableConfig,
        TrainerConfig,
    )
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )
    from paddlebox_tpu_torch.parallel.mesh import initialize_distributed
    from paddlebox_tpu_torch.parallel.watchdog import DistributedStallError

    torch.set_num_threads(1)
    job = initialize_distributed()
    mesh = make_mesh(job.world, device="cpu")
    tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0)
    liveness = LivenessConfig(
        deadline_s=deadline_s, heartbeat_interval_s=deadline_s / 6,
        poll_interval_s=min(0.2, deadline_s / 10), hard_exit_grace_s=30.0)
    trainer = MultiChipTrainer(
        CtrDnn(3, tconf.row_width, dense_dim=2, hidden=(8,), device="cpu"),
        tconf, mesh, TrainerConfig(auc_buckets=1 << 8, liveness=liveness,
                                   prefetch_batches=0))
    table = ShardedSparseTable(tconf, mesh)
    ds = PadBoxSlotDataset(make_synth_config(3, 2, 8, 16), read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    table.begin_pass(ds.unique_keys())
    t_start = time.time()
    try:
        trainer.train_from_dataset(ds, table)
    except DistributedStallError as e:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"culprit": e.culprit, "stage": e.stage,
                       "kind": e.kind, "t_start": t_start,
                       "t_abort": time.time()}, f)
        print(f"STALL-ABORT rank={rank}: {e}", flush=True)
        # the peer's half of a collective may still be pending: leave
        # without tearing the process group down
        os._exit(7)
    print("COMPLETED-UNEXPECTEDLY", flush=True)
    return 3


if __name__ == "__main__":
    sys.exit(main())
