"""Rank program of the port's multi-process tests (not a pytest module).

Launched by ``paddlebox_tpu_torch.launch`` with N ranks of K positions on
the CPU over gloo.  It imports the port only.

    train <out_dir> <spec.json>
        every rank trains the SAME global batch stream as one process of
        N * K positions, each feeding its own slice of every position
        group, over the passes of spec["passes"] (lists of files); per
        pass it writes its metrics, and at the end its dense parameters and
        its store (rank<r>.json, rank<r>.npz).  spec: "lrmap" (the slot LR
        map), "tower" (an npz of the dense tower to start from).
    collectives <out_dir> <seed>
        the four data-axis collectives on this rank's slices of seeded
        global tensors, written to rank<r>.npz.
    mesh <out_dir>
        ``make_mesh()`` with no count, on the data axis and on a model
        axis: positions, process layout and this rank's positions,
        written to rank<r>.json.
    reshard <out_dir> <spec.json>
        train's world over spec["passes"], pass p on spec["schedule"][p]
        positions: the table reshards live across the ranks whenever the
        count changes, and a new trainer on the new mesh continues the
        dense state.  spec["fault"] = [rank, site] arms that fault site
        once on that rank at the first reshard: the reshard must raise on
        every rank with the old map whole, then a retry commits.
        spec["device"] ("cpu" by default; "cuda": the ranks share the
        card) and spec["deterministic"] (deterministic algorithms).
        Writes rank<r>.json (per pass the metrics and rows moved, the
        fault's record) and rank<r>.npz (its store and dense state).
"""

import itertools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from paddlebox_tpu_torch.parallel.mesh import initialize_distributed  # noqa: E402

torch.set_num_threads(1)
S, DENSE, B, N_POS = 3, 2, 8, 4


def _load(files):
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config

    ds = PadBoxSlotDataset(make_synth_config(S, DENSE, B, 16),
                           read_threads=1)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def local_groups(ds, n, rank, n_local):
    """The global groups of n batches (the ragged tail padded, as the
    one-process _group_batches pads it), sliced to this rank's
    positions."""
    from paddlebox_tpu_torch.data.feed import empty_like

    out = []
    it = iter(ds.batches(drop_last=False))
    while True:
        group = list(itertools.islice(it, n))
        if not group:
            return out
        if len(group) < n:
            group += [empty_like(group[0])] * (n - len(group))
        out.append(group[rank * n_local:(rank + 1) * n_local])


def train(out_dir, spec):
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )
    from paddlebox_tpu_torch.weights import params_from_jax

    job = initialize_distributed()
    rank = job.rank
    mesh = make_mesh(N_POS, device="cpu")
    tconf = SparseTableConfig(
        embedding_dim=8, placement_update_interval=1,
        slot_learning_rates=tuple(tuple(p) for p in spec["lrmap"]))
    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(32, 16),
                   device="cpu")
    tower = np.load(spec["tower"])
    model.load_state_dict(params_from_jax(
        [{"w": tower[f"w{i}"], "b": tower[f"b{i}"]}
         for i in range(len(tower.files) // 2)]))
    trainer = MultiChipTrainer(model, tconf, mesh,
                               TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(tconf, mesh, seed=5)
    passes, auc = [], None
    for files in spec["passes"]:
        ds = _load(files)
        groups = local_groups(ds, N_POS, rank, mesh.n_local)
        census = np.unique(np.concatenate(
            [b.keys[: b.n_keys] for g in groups for b in g]))
        table.begin_pass(census)
        hits = int(sum(table.last_shard_hits))
        m = trainer.train_groups(table, iter(groups), auc_state=auc)
        auc = trainer.last_metric_state
        table.end_pass()
        ds.close()
        passes.append({k: m[k] for k in (
            "loss", "auc", "count", "steps", "samples", "missing_keys",
            "hot_occurrences", "grad_norm", "weight_norm")}
            | {"hits": hits,
               "hot": int(table.hot_resident_keys().shape[0])})
    state = table.state_dict()
    table.close()
    dense = {k: v.numpy() for k, v in trainer.dense_state()[0].items()}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), keys=state["keys"],
             values=state["values"], **{f"dense/{k}": v
                                        for k, v in dense.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"passes": passes, "n_local": mesh.n_local}, f)


def _tower_model(spec, tconf):
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.weights import params_from_jax

    model = CtrDnn(S, tconf.row_width, dense_dim=DENSE, hidden=(32, 16),
                   device=spec.get("device", "cpu"))
    tower = np.load(spec["tower"])
    model.load_state_dict(params_from_jax(
        [{"w": tower[f"w{i}"], "b": tower[f"b{i}"]}
         for i in range(len(tower.files) // 2)]))
    return model


def reshard(out_dir, spec):
    import time

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )
    from paddlebox_tpu_torch.utils import faults

    job = initialize_distributed()
    rank = job.rank
    device = spec.get("device", "cpu")
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    tconf = SparseTableConfig(embedding_dim=8, placement_update_interval=1)
    schedule = spec["schedule"]
    mesh = make_mesh(schedule[0], device=device)
    trainer = MultiChipTrainer(_tower_model(spec, tconf), tconf, mesh,
                               TrainerConfig(auc_buckets=1 << 10))
    table = ShardedSparseTable(tconf, mesh, seed=5)
    passes, fault, auc = [], None, None
    for files, n in zip(spec["passes"], schedule):
        moved = 0
        if n != table.n_shards:
            new_mesh = make_mesh(n, device=device)
            if spec.get("fault") and fault is None:
                frank, site = spec["fault"]
                table.flush()  # the reshard's own cut point
                before = table._store.materialize()
                old_mesh = table.mesh
                if rank == frank:
                    faults.install(faults.FaultPlan({site: "first:1"}))
                t0 = time.monotonic()
                try:
                    table.reshard(new_mesh)
                except Exception as e:
                    err = f"{type(e).__name__}: {e}"
                else:
                    err = None
                faults.clear()
                after = table._store.materialize()
                fault = {
                    "error": err, "seconds": time.monotonic() - t0,
                    "old_map": table.mesh is old_mesh
                    and table.n_shards == old_mesh.n,
                    "store_whole": bool(
                        np.array_equal(before[0], after[0])
                        and np.array_equal(before[1], after[1])),
                }
            moved = table.reshard(new_mesh)
            dense = trainer.dense_state()
            trainer = MultiChipTrainer(_tower_model(spec, tconf), tconf,
                                       new_mesh,
                                       TrainerConfig(auc_buckets=1 << 10))
            trainer.load_dense_state(*dense)
            auc = None  # the metric streams are stacked by position
        ds = _load(files)
        groups = local_groups(ds, table.n_shards, rank, table.n_local)
        census = np.unique(np.concatenate(
            [b.keys[: b.n_keys] for g in groups for b in g]))
        table.begin_pass(census)
        m = trainer.train_groups(table, iter(groups), auc_state=auc)
        auc = trainer.last_metric_state
        table.end_pass()
        ds.close()
        passes.append({k: m[k] for k in ("loss", "auc", "count", "steps")}
                      | {"moved": moved, "n_local": table.n_local})
    state = table.state_dict()
    table.close()
    dense = {k: v.cpu().numpy()
             for k, v in trainer.dense_state()[0].items()}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), keys=state["keys"],
             values=state["values"], **{f"dense/{k}": v
                                        for k, v in dense.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"passes": passes, "fault": fault}, f)


def collectives_case(out_dir, seed):
    from paddlebox_tpu_torch.parallel import collectives

    job = initialize_distributed()
    rng = np.random.default_rng(seed)
    n = N_POS
    L = n // job.world
    x = torch.from_numpy(rng.standard_normal((n, n, 3, 5)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32))
    z = torch.from_numpy(rng.integers(-9, 9, (n, 6)).astype(np.int64))
    mine = slice(job.rank * L, (job.rank + 1) * L)
    out = {
        "all_to_all": collectives.all_to_all(x[mine], job),
        "all_gather": collectives.all_gather(y[mine], job),
        "psum": collectives.psum(y[mine], job),
        "pmax": collectives.pmax(y[mine], job),
        "psum_int": collectives.psum(z[mine], job),
        "psum_many_1": collectives.psum_many([y[mine], 2 * y[mine]], job)[1],
    }
    np.savez(os.path.join(out_dir, f"rank{job.rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})


def mesh_case(out_dir):
    from paddlebox_tpu_torch.parallel import make_mesh

    job = initialize_distributed()
    out = {}
    for axis in ("data", "seq"):
        m = make_mesh(device="cpu", axis_name=axis)
        out[axis] = {"n": m.n, "distributed": m.distributed,
                     "n_proc": m.n_proc, "local": list(m.local_positions)}
    with open(os.path.join(out_dir, f"rank{job.rank}.json"), "w") as f:
        json.dump(out, f)


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    if mode == "train":
        with open(sys.argv[3]) as f:
            train(out_dir, json.load(f))
    elif mode == "reshard":
        with open(sys.argv[3]) as f:
            reshard(out_dir, json.load(f))
    elif mode == "collectives":
        collectives_case(out_dir, int(sys.argv[3]))
    elif mode == "mesh":
        mesh_case(out_dir)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
