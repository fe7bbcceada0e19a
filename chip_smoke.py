#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   — compile every CUDA kernel of the paths from csrc/ (one nvcc
               per source, all started together) and print the build time
               and each kernel's registers and spills.
  2. parity  — hold each kernel against its plain PyTorch twin on the card,
               at the main paths' shapes, at a ragged size and at size 0
               (pull_rows and scatter_add_rows on their float2 and their
               scalar paths, hot_cold_select on its float4 and its scalar
               path with ragged tails; the cache kernels with negative and
               duplicate slots, scatter_rows also with 65 536 occurrences on
               8 slots, duplicates across every tile boundary, calls in a
               row and a larger table; keys at and above 2^63 and the
               all-ones key).
  3. pass    — write synthetic slot files at the full width of the repo's
               benchmark CTR-DNN (16 sparse slots, 13 dense, batch 2048,
               embedding_dim 8 -> device row width 10, tower 512-256-128, vocab
               100 000 per slot) and run begin_pass -> train_from_dataset ->
               end_pass for PASSES passes on device="cuda" with the HBM
               cache off, every kernel launch counter reset just before and
               read just after.
     check   — the same small pass on the card and on the CPU (plain twins)
               from identical initial weights must agree.
     stages  — one more pass, synchronized after each host stage and step,
               for the per-step breakdown (--profile adds a profiler window).
  4. cached  — the same model with the reference's default HBM cache (65 536
               rows) over CACHED_PASSES passes, each over its own Zipf(1.3)
               file set, counters reset just before and read just after;
               per pass the census, hits, misses, evicted and written-back
               rows, begin_pass / end_pass seconds and samples/s, beside the
               same passes without the cache.  With deterministic algorithms
               on, cached and uncached trained passes from the same initial
               weights must be bit-equal.
     lifecycle — the three censuses through a cached and an uncached table
               with a deterministic in-pass update: bit-equal state_dicts.
  5. hybrid  — the multi-chip trainer on POSITIONS shard positions of the
               card with the realized hybrid placement (the reference's
               hybrid arm: placement "loopback", realized, update interval
               1, hot capacity 4096, cache off), same model, HYBRID_PASSES
               passes, each over its own Zipf(1.3) file set, counters reset
               just before and read just after; per pass the census, the
               hot set, the hot occurrences routed, the host row traffic,
               begin_pass / end_pass seconds and samples/s.  The hot block
               must realize and route; under deterministic algorithms two
               runs are bit-equal, and the largest difference against the
               hash placement is printed.
     check   — a small hybrid run on the card and on the CPU (plain twins)
               from identical initial weights must agree.
  6. times   — the CUDA kernels one call of each wrapper launches (from
               torch.profiler; one each, two for scatter_rows), and the
               median time of each kernel, its twin and the equivalent
               PyTorch library call at the main paths' shapes with the L2
               cache cold, beside the least time the card's memory rate
               allows (for the row kernels also the floor of the distinct
               32-byte sectors their rows touch; pull_rows' and
               scatter_add_rows' scalar paths, and the zero fill a per-call
               scatter_rows scratch would add), and the time the cold
               method gives a launch that does almost nothing.
Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or without
the rest of the repository beside it.  It needs one card and no network.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO, ".chip_smoke")

# The benchmark CTR-DNN of bench.py (--slots 16 --emb 8 --vocab 100000
# --hidden 512,256,128, batch 2048, key capacity batch * slots * 4).
N_SLOTS, DENSE, BATCH, EMB, VOCAB = 16, 13, 2048, 8, 100_000
HIDDEN = (512, 256, 128)
KEY_CAPACITY = BATCH * N_SLOTS * 4
# Depth cut to fit the time limit: 8 files x 25 000 instances (97 full
# batches and one partial per pass), 3 passes.
N_FILES, INS_PER_FILE, PASSES = 8, 25_000, 3

# The cached path: the reference's default cache, and per pass its own
# file set of 64 000 instances drawn with Zipf(1.3), the skew of the
# reference's cache ablation (bench.py:1129-1165), at the model's vocab.
CACHE_ROWS = 1 << 16
CACHED_PASSES, CACHED_FILES, CACHED_INS_PER_FILE, ZIPF_A = 3, 4, 16_000, 1.3

# The hybrid path: the reference's hybrid arm (bench.py:1442-1536, 4
# devices, placement_update_interval 1, cache off) on 4 shard positions of
# one card, batch BATCH per position, 4 passes over the Zipf file sets (the
# cached path's three and one more).  A key seen in every pass turns hot at
# the third begin_pass, so passes 2 and 3 route hot occurrences.
POSITIONS, HOT_CAPACITY, HYBRID_PASSES = 4, 4096, 4
ZIPF_SETS = max(CACHED_PASSES, HYBRID_PASSES)

# H100 SXM device memory rate and float32 rate outside the tensor cores
# (NVIDIA data sheet): the bytes and operations bounds.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
TPU_KERNELS = {
    "pull_rows": "paddlebox_tpu/ops/pallas_sparse.py:129",
    "scatter_add_rows": "paddlebox_tpu/ops/pallas_sparse.py:215",
    "gather_slots": "paddlebox_tpu/ops/pallas_sparse.py:274",
    "scatter_rows": "paddlebox_tpu/ops/pallas_sparse.py:335",
    "sorted_search": "paddlebox_tpu/ops/pallas_sparse.py:464",
    "hot_cold_select": "paddlebox_tpu/ops/pallas_sparse.py:393",
}
# CUDA kernels one wrapper call launches: one each, but scatter_rows elects
# winners and stores them in two (csrc/scatter_rows.cu says why)
CUDA_LAUNCHES_PER_CALL = {"scatter_rows": 2}
# Real duplicates reach scatter_add_rows' atomics in an order that changes
# from run to run.  For a row hit n times the result differs from a
# sequential sum by at most about 2 * n * 2^-24 * (|v| + sum |delta|); with
# unit-normal values and deltas and at most ~16 hits per row (4 on
# average) that stays under 5e-5, so 1e-4 bounds it.
DUP_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _write_part(args) -> str:
    out_dir, ins, seed, zipf_a = args
    from paddlebox_tpu_torch.data.synth import write_synth_files

    return write_synth_files(
        out_dir, n_files=1, ins_per_file=ins, n_sparse_slots=N_SLOTS,
        vocab_per_slot=VOCAB, dense_dim=DENSE, seed=seed, zipf_a=zipf_a,
    )[0]


def write_data() -> tuple:
    """Synthetic files, one writer process per file (spawned, so no child
    inherits a CUDA context): the uncached path's N_FILES, and CACHED_FILES
    per Zipf file set.  Returns (files, [files of each set])."""
    jobs = [(os.path.join(WORK_DIR, f"w{i}"), INS_PER_FILE, 7 + i, 0.0)
            for i in range(N_FILES)]
    for p in range(ZIPF_SETS):
        jobs += [(os.path.join(WORK_DIR, f"z{p}-{i}"), CACHED_INS_PER_FILE,
                  100 + CACHED_FILES * p + i, ZIPF_A)
                 for i in range(CACHED_FILES)]
    ctx = multiprocessing.get_context("spawn")
    workers = min(len(jobs), os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        paths = list(ex.map(_write_part, jobs))
    per_pass = [paths[N_FILES + CACHED_FILES * p:
                      N_FILES + CACHED_FILES * (p + 1)]
                for p in range(ZIPF_SETS)]
    return paths[:N_FILES], per_pass


def based4(t):
    """A copy of ``t`` as a view that starts 4 bytes into its storage, so
    not 8-byte aligned: the kernels' scalar paths."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def pass_capacity(n_census: int) -> int:
    """Table rows of a pass over n_census keys once a batch has been
    planned (live rows + one scratch row per key slot + the dead row)."""
    from paddlebox_tpu_torch.sparse.table import _next_pow2

    return _next_pow2(n_census + 1 + KEY_CAPACITY)


# --------------------------------------------------------------------------- #
# phase 2: kernel parity
# --------------------------------------------------------------------------- #
def check_parity(P: int, device) -> dict:
    """Each kernel against its twin on the card; returns the max abs error
    per kernel at the main path's shapes."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    W = EMB + 2
    gen = torch.Generator(device=device).manual_seed(0)
    values = torch.randn((P, W), device=device, generator=gen)
    wide = torch.randn((P, W + 1), device=device, generator=gen)
    errs = {}
    # the float2 path on the 10-float table (204 rows a tile: K = 205 ends
    # in a tile of one row), the scalar path on the same table based 4
    # bytes in and on an 11-float table
    pulls = (("float2, W=10", values, (KEY_CAPACITY, 12_345, 205, 1, 0)),
             ("scalar, W=10 based 4 bytes in", based4(values),
              (KEY_CAPACITY, 12_345, 1)),
             ("scalar, W=11", wide, (KEY_CAPACITY, 1)))
    for what, table, ks in pulls:
        for k in ks:
            idx = torch.randint(0, P, (k,), device=device, generator=gen,
                                dtype=torch.int32)
            got = sk.pull_rows(table, idx)
            want = sk.pull_rows_plain(table, idx)
            if got.shape != (k, table.shape[1]) or not torch.equal(got, want):
                raise AssertionError(
                    f"pull_rows ({what}) differs from its twin at K={k}")
            if k == KEY_CAPACITY and table is values:
                errs["pull_rows"] = float((got - want).abs().max())
    log("parity pull_rows: bit-exact, " + "; ".join(
        f"{what} at K={', '.join(map(str, ks))}" for what, _, ks in pulls))

    dead = P - 1
    for u in (KEY_CAPACITY, 12_345, 0):
        # unique targets plus repeated dead-row entries with zeroed deltas,
        # the pattern push_and_update hands the kernel
        idx = torch.randperm(P - 1, device=device, generator=gen)[:u]
        idx = idx.to(torch.int32)
        n_dead = u // 8
        idx[u - n_dead:] = dead
        delta = torch.randn((u, W), device=device, generator=gen)
        delta[u - n_dead:] = 0.0
        got = sk.scatter_add_rows(values.clone(), idx, delta)
        want = sk.scatter_add_rows_plain(values.clone(), idx, delta)
        if not torch.equal(got, want):
            raise AssertionError(
                f"scatter_add_rows differs from its twin at U={u} "
                "(unique targets + zero-delta dead repeats)"
            )
        if u == KEY_CAPACITY:
            errs["scatter_add_rows"] = float((got - want).abs().max())
    log(f"parity scatter_add_rows: bit-exact at U={KEY_CAPACITY}, 12345, 0 "
        "(unique targets + zero-delta dead-row repeats)")

    # the kernel's two reduction paths at the full shape: float2 on the
    # 8-byte aligned 10-float table above, scalar on an 11-float table and
    # on a 10-float view that starts 4 bytes into its storage
    u = KEY_CAPACITY
    tables = (("float2, W=10", values, torch.clone),
              ("scalar, W=11", wide, torch.clone),
              ("scalar, W=10 based 4 bytes in", values, based4))
    dup_errs = []
    for what, table, copy in tables:
        w = table.shape[1]
        idx = torch.randperm(P - 1, device=device, generator=gen)[:u]
        idx = idx.to(torch.int32)
        idx[u - u // 8:] = dead
        delta = torch.randn((u, w), device=device, generator=gen)
        delta[u - u // 8:] = 0.0
        got = sk.scatter_add_rows(copy(table), idx, delta)
        if not torch.equal(got, sk.scatter_add_rows_plain(table.clone(), idx,
                                                          delta)):
            raise AssertionError(f"scatter_add_rows ({what}) differs from its "
                                 "twin on unique targets + dead repeats")
        # real duplicates: ~4 hits per target row
        idx = torch.randint(0, u // 4, (u,), device=device, generator=gen,
                            dtype=torch.int32)
        delta = torch.randn((u, w), device=device, generator=gen)
        got = sk.scatter_add_rows(copy(table), idx, delta)
        want = sk.scatter_add_rows_plain(table.clone(), idx, delta)
        dup_errs.append(float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=DUP_TOL, atol=DUP_TOL):
            raise AssertionError(
                f"scatter_add_rows ({what}) with duplicates: max abs err "
                f"{dup_errs[-1]} over tolerance {DUP_TOL}")
    log(f"parity scatter_add_rows paths ({'; '.join(t[0] for t in tables)}): "
        f"bit-exact at U={u} on unique targets + dead repeats; with "
        f"duplicates max abs err {dup_errs!r} (tolerance {DUP_TOL})")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return errs


def check_cache_parity(census, device) -> dict:
    """The cache kernels against their twins at the cached path's shapes
    (the cache's [CACHE_ROWS, W+1] rows, a census of real keys), at a
    ragged size and at size 0; all bit-exact."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    W1 = EMB + 3
    C = CACHE_ROWS
    gen = torch.Generator(device=device).manual_seed(2)
    rows = torch.randn((C, W1), device=device, generator=gen)
    errs = {}
    for k in (C, 12_345, 0):
        slots = torch.randint(-1, C, (k,), device=device, generator=gen,
                              dtype=torch.int32)
        got = sk.gather_slots(rows, slots)
        want = sk.gather_slots_plain(rows, slots)
        if got.shape != (k, W1) or not torch.equal(got, want):
            raise AssertionError(f"gather_slots differs from its twin at K={k}")
        if k == C:
            errs["gather_slots"] = float((got - want).abs().max())
    log(f"parity gather_slots: bit-exact at K={C}, 12345, 0 (negative slots)")

    for k in (C, min(12_345, C // 2 + 1), 0):
        # unique slots (the main path's hits + admits), then duplicates
        # (about 1.6 occurrences a slot) mixed with negative slots
        cases = (("unique", torch.randperm(C, device=device,
                                           generator=gen)[:k].to(torch.int32)),
                 ("duplicates", torch.randint(-1, C, (k,), device=device,
                                              generator=gen,
                                              dtype=torch.int32)))
        for what, slots in cases:
            new = torch.randn((k, W1), device=device, generator=gen)
            got = sk.scatter_rows(rows.clone(), slots, new)
            want = sk.scatter_rows_plain(rows.clone(), slots, new)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"scatter_rows differs from its twin at K={k} ({what})")
            if k == C and what == "duplicates":
                errs["scatter_rows"] = float((got - want).abs().max())
    # stress: 65 536 occurrences on 8 slots (every block competes for the
    # same winners); pairs of occurrences sharing a slot across every tile
    # boundary, the first and last occurrence too; K = 1
    straddle = ((torch.arange(C, device=device) + 1) // 2).to(torch.int32)
    straddle[-1] = straddle[0]
    stress = (("65536 on 8 slots", torch.randint(0, 8, (C,), device=device,
                                                 generator=gen,
                                                 dtype=torch.int32)),
              ("straddling pairs", straddle),
              ("K=1", torch.randint(0, C, (1,), device=device, generator=gen,
                                    dtype=torch.int32)))
    for what, slots in stress:
        new = torch.randn((slots.shape[0], W1), device=device, generator=gen)
        got = sk.scatter_rows(rows.clone(), slots, new)
        want = sk.scatter_rows_plain(rows.clone(), slots, new)
        if not torch.equal(got, want):
            raise AssertionError(f"scatter_rows differs from its twin ({what})")
    # three calls in a row on one table, then one on a table twice as large:
    # no winner of an earlier call may leak into a later one
    table, want = rows.clone(), rows.clone()
    for k in (C, 20_000, 12_345):
        slots = torch.randint(-1, C, (k,), device=device, generator=gen,
                              dtype=torch.int32)
        new = torch.randn((k, W1), device=device, generator=gen)
        sk.scatter_rows_plain(want, slots, new)
        if not torch.equal(sk.scatter_rows(table, slots, new), want):
            raise AssertionError(f"scatter_rows differs from its twin on the "
                                 f"same table in a row (K={k})")
    big = torch.randn((2 * C, W1), device=device, generator=gen)
    slots = torch.randint(-1, 2 * C, (C,), device=device, generator=gen,
                          dtype=torch.int32)
    new = torch.randn((C, W1), device=device, generator=gen)
    if not torch.equal(sk.scatter_rows(big.clone(), slots, new),
                       sk.scatter_rows_plain(big.clone(), slots, new)):
        raise AssertionError("scatter_rows differs from its twin on a larger "
                             "table after calls on a smaller one")
    if device.type == "cuda" and bool(
            sk._scatter_rows_tags[torch.cuda.current_device()].any()):
        raise AssertionError("scatter_rows left tags set in its scratch")
    log(f"parity scatter_rows: bit-exact at K={C}, 12345, 0 (unique slots; "
        "duplicates with negatives, last occurrence wins), K=65536 on 8 "
        "slots, pairs straddling every tile boundary, K=1, three calls in a "
        f"row on one table, then a table of {2 * C} rows; tags all zero after")

    rng = np.random.default_rng(3)
    hay_keys = np.unique(np.concatenate([
        rng.integers(0, 2**64 - 1, size=C - 2, dtype=np.uint64),
        census[: C // 4], np.array([2**63], np.uint64),
    ]))[: C - 1]
    hay = np.append(hay_keys, np.uint64(2**64 - 1))  # a real all-ones key
    q_all = np.concatenate([census, hay[::2], hay[-1:]])
    hay_t = torch.from_numpy(np.ascontiguousarray(hay).view(np.int64)).to(device)
    for nq in (q_all.shape[0], 12_345, 0):
        q = torch.from_numpy(q_all[:nq].view(np.int64)).to(device)
        # n_real = C: the all-ones key is real; C - 1: it is padding
        for n_real in (C, C - 1):
            got = sk.sorted_search(hay_t, n_real, q)
            want = sk.sorted_search_plain(hay_t, n_real, q)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"sorted_search differs from its twin at Q={nq}, "
                    f"n_real={n_real}")
            if nq == q_all.shape[0] and n_real == C:
                errs["sorted_search"] = float((got - want).abs().max())
                found = int((got >= 0).sum())
    log(f"parity sorted_search: bit-exact at Q={q_all.shape[0]}, 12345, 0 over "
        f"{C} keys ({int((hay >= np.uint64(2**63)).sum())} at or above 2^63, "
        f"the all-ones key real and as padding); {found} found")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return errs


# --------------------------------------------------------------------------- #
# phase 3: the slice pass
# --------------------------------------------------------------------------- #
def make_world(n_slots, dense, batch, emb, hidden, device, key_capacity=None,
               cache_rows=0):
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.synth import make_synth_config
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    conf = make_synth_config(
        n_sparse_slots=n_slots, dense_dim=dense, batch_size=batch,
        max_feasigns_per_ins=64, batch_key_capacity=key_capacity,
    )
    tconf = SparseTableConfig(embedding_dim=emb, hbm_cache_rows=cache_rows)
    table = SparseTable(tconf, seed=0, device=device)
    model = CtrDnn(n_slots, tconf.row_width, dense_dim=dense, hidden=hidden,
                   seed=0, device=device)
    trainer = Trainer(model, tconf, TrainerConfig(), device=device)
    return conf, table, trainer


def run_passes(ds, table, trainer, passes: int) -> list:
    import torch

    out = []
    for p in range(passes):
        ds.local_shuffle(seed=p)
        table.begin_pass(ds.unique_keys())
        if table.values.device.type != trainer.device.type:
            raise AssertionError(f"table values on {table.values.device}")
        m = trainer.train_from_dataset(ds, table)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        table.end_pass()
        out.append(m)
    return out


def slice_pass(ds, device="cuda") -> dict:
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN, device,
                                   KEY_CAPACITY)
    n_census = ds.unique_keys().shape[0]
    sk.reset_launches()
    per_pass = run_passes(ds, table, trainer, PASSES)
    launches = dict(sk.launches)
    steps = sum(m["steps"] for m in per_pass)
    seconds = sum(m["duration_s"] for m in per_pass)
    samples = sum(m["samples"] for m in per_pass)
    for p, m in enumerate(per_pass):
        log(f"pass {p}: loss {m['loss']!r} auc {m['auc']!r} steps {m['steps']} "
            f"seconds {m['duration_s']!r}")
    log(f"slice pass: {steps} steps in {seconds!r} s = {steps / seconds!r} "
        f"steps/s, {samples / seconds!r} samples/s; launches {launches}")
    last = per_pass[-1]
    if not all(math.isfinite(m["loss"]) for m in per_pass):
        raise AssertionError("non-finite loss")
    if not 0.0 < last["auc"] < 1.0 or last["count"] != ds.get_memory_data_size():
        raise AssertionError(f"bad pass metrics {last}")
    for name in ("pull_rows", "scatter_add_rows"):  # the uncached path's
        if launches[name] <= 0 and device == "cuda":
            raise AssertionError(f"kernel {name} never launched on the main path")
    if table.missing_key_count or table.n_features != n_census:
        raise AssertionError(
            f"table holds {table.n_features} of {n_census} census keys, "
            f"{table.missing_key_count} missing"
        )
    state = table.state_dict()
    import numpy as np

    if not np.isfinite(state["values"]).all():
        raise AssertionError("non-finite table rows after end_pass")
    return {"launches": launches, "table": table, "trainer": trainer}


def small_agreement() -> None:
    """A small pass on the card and on the CPU from the same initial
    weights (CtrDnn draws them on the CPU from its seed) must agree.
    Tolerance: the card sums segments with atomics in another order, and
    its matmuls split sums differently, so float32 results differ in the
    last bits and grow over steps; 1e-4 bounds that at this size."""
    import numpy as np

    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import write_synth_files

    files = write_synth_files(
        os.path.join(WORK_DIR, "small"), n_files=2, ins_per_file=256,
        n_sparse_slots=4, vocab_per_slot=50, dense_dim=3, seed=3,
    )
    results = {}
    for device in ("cuda", "cpu"):
        conf, table, trainer = make_world(4, 3, 64, 4, (16, 8), device)
        ds = PadBoxSlotDataset(conf, read_threads=2)
        ds.set_filelist(files)
        ds.load_into_memory()
        metrics = run_passes(ds, table, trainer, 2)
        results[device] = (metrics, table.state_dict())
        ds.close()
    (mg, sg), (mc, sc) = results["cuda"], results["cpu"]
    for a, b in zip(mg, mc):
        if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
            raise AssertionError(f"card/CPU loss differ: {a['loss']} {b['loss']}")
        if abs(a["auc"] - b["auc"]) > 1e-3:
            raise AssertionError(f"card/CPU auc differ: {a['auc']} {b['auc']}")
    if not np.array_equal(sg["keys"], sc["keys"]):
        raise AssertionError("card/CPU tables hold different keys")
    err = float(np.abs(sg["values"] - sc["values"]).max())
    if err > 1e-4:
        raise AssertionError(f"card/CPU table rows differ by {err}")
    log(f"small pass card vs CPU: losses {[m['loss'] for m in mg]} vs "
        f"{[m['loss'] for m in mc]}, table max abs diff {err!r}")


def load(files, read_threads: int):
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config

    ds = PadBoxSlotDataset(make_synth_config(
        n_sparse_slots=N_SLOTS, dense_dim=DENSE, batch_size=BATCH,
        max_feasigns_per_ins=64, batch_key_capacity=KEY_CAPACITY,
    ), read_threads=read_threads)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def drive_passes(datasets, table, trainer) -> list:
    """One pass over each dataset, timing begin_pass and end_pass to a
    synchronize; per pass the census, the cache's hits and misses (the
    promotion patch), the evicted and written-back rows and the metrics."""
    import torch

    out = []
    for ds in datasets:
        census = ds.unique_keys()
        t0 = time.perf_counter()
        table.begin_pass(census)
        torch.cuda.synchronize()
        begin_s = time.perf_counter() - t0
        hits, misses = table.last_cache_hits, table.last_cache_misses
        m = trainer.train_from_dataset(ds, table)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table.end_pass()
        torch.cuda.synchronize()
        out.append(dict(
            census=int(census.shape[0]), hits=hits,
            promotion_rows=misses if table._caches() else int(census.shape[0]),
            evicted=table.last_evicted_rows,
            written_back=table.last_write_back_rows, begin_s=begin_s,
            end_s=time.perf_counter() - t0,
            samples_per_s=m["samples"] / m["duration_s"], metrics=m,
        ))
    return out


def cached_path(datasets) -> dict:
    """The full-width model with the reference's default HBM cache over
    CACHED_PASSES passes, each over its own Zipf file set, launch counters
    reset just before and read just after; then the same passes without
    the cache, for the boundary numbers beside it.

    Two trained runs differ on the card in the last bits even without the
    cache: the step's index_add_ segment sums add duplicates with atomics in
    an order that changes from run to run, and the difference grows over
    the steps.  So the cached and uncached trained passes are compared once
    more with torch.use_deterministic_algorithms on (index_add_ then sums in
    a fixed order), from the same initial weights, and must be bit-equal:
    losses, keys and every row."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    runs = {}
    for label, rows, det in (("cached", CACHE_ROWS, False),
                             ("uncached", 0, False),
                             ("cached deterministic", CACHE_ROWS, True),
                             ("uncached deterministic", 0, True)):
        torch.use_deterministic_algorithms(det)
        try:
            _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                           "cuda", KEY_CAPACITY,
                                           cache_rows=rows)
            if label == "cached":
                sk.reset_launches()
            per_pass = drive_passes(datasets, table, trainer)
            if label == "cached":
                launches = dict(sk.launches)
        finally:
            torch.use_deterministic_algorithms(False)
        runs[label] = (per_pass, table)
        for p, r in enumerate(per_pass):
            m = r["metrics"]
            log(f"{label} pass {p}: census {r['census']}, hits {r['hits']}, "
                f"promotion rows {r['promotion_rows']}, evicted "
                f"{r['evicted']}, written back {r['written_back']}; "
                f"begin_pass {r['begin_s']!r} s, end_pass {r['end_s']!r} s; "
                f"{r['samples_per_s']!r} samples/s; loss {m['loss']!r} "
                f"auc {m['auc']!r} steps {m['steps']}")
    log(f"cached path launches {launches}")
    cached, table = runs["cached"]
    for name in ("pull_rows", "scatter_add_rows", "gather_slots",
                 "scatter_rows", "sorted_search"):  # the cached path's
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the cached path")
    if not any(r["hits"] and r["evicted"] for r in cached):
        raise AssertionError("no cached pass had both hits and evictions")
    if not all(math.isfinite(r["metrics"]["loss"]) for r in cached):
        raise AssertionError("non-finite loss on the cached path")
    union = np.unique(np.concatenate([ds.unique_keys() for ds in datasets]))
    if table.n_features != union.shape[0]:  # n_features drains the cache
        raise AssertionError(f"cached table holds {table.n_features} features "
                             f"of the censuses' {union.shape[0]}")
    if not np.isfinite(table.state_dict()["values"]).all():
        raise AssertionError("non-finite rows in the cached table")
    (det_c, det_ct), (det_u, det_ut) = (runs["cached deterministic"],
                                        runs["uncached deterministic"])
    sc, su = det_ct.state_dict(), det_ut.state_dict()
    losses_c = [r["metrics"]["loss"] for r in det_c]
    losses_u = [r["metrics"]["loss"] for r in det_u]
    if (losses_c != losses_u or not np.array_equal(sc["keys"], su["keys"])
            or not np.array_equal(sc["values"], su["values"])):
        raise AssertionError(
            f"deterministic cached and uncached trained passes differ: losses "
            f"{losses_c} vs {losses_u}")
    noise = float(np.abs(table.state_dict()["values"]
                         - runs["uncached"][1].state_dict()["values"]).max())
    log(f"cached vs uncached trained passes, deterministic: bit-equal (losses "
        f"{losses_c}, {sc['keys'].shape[0]} rows); without determinism the "
        f"rows differ by up to {noise!r}")
    return {"launches": launches, "table": table}


def lifecycle_check(censuses) -> None:
    """The censuses through a cached and an uncached table on the card with
    a deterministic in-pass update: the state_dicts must be bit-equal."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.sparse.table import SparseTable

    states = {}
    for rows in (CACHE_ROWS, 0):
        table = SparseTable(SparseTableConfig(embedding_dim=EMB,
                                              hbm_cache_rows=rows), seed=0)
        times = []
        for pk in censuses:
            t0 = time.perf_counter()
            table.begin_pass(pk)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n = pk.shape[0]
            table.values[:n] += 1.0
            table.g2sum[:n] += 0.5
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            table.end_pass()
            torch.cuda.synchronize()
            times.append((t1 - t0, time.perf_counter() - t2))
        states[rows] = table.state_dict()
        log(f"lifecycle {'cached' if rows else 'uncached'}: begin_pass / "
            f"end_pass s per pass {times}")
    a, b = states[CACHE_ROWS], states[0]
    if not (np.array_equal(a["keys"], b["keys"])
            and np.array_equal(a["values"], b["values"])):
        raise AssertionError("cached and uncached lifecycles differ on the card")
    log(f"lifecycle: cached and uncached state_dicts bit-equal "
        f"({a['keys'].shape[0]} rows)")


def stage_breakdown(ds, table, trainer, profile: bool) -> None:
    """One more pass driven stage by stage with a synchronize after each,
    so the host stages and the device step can be told apart.  With
    ``profile``, torch.profiler records steps 10-29 and the script prints
    the device time by kernel and the device's busy share of that window."""
    import torch

    from paddlebox_tpu_torch.metrics.auc import init_auc_state
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.train.trainer import host_feed

    saved = dict(sk.launches)
    ds.local_shuffle(seed=PASSES)
    t0 = time.perf_counter()
    table.begin_pass(ds.unique_keys())
    begin_s = time.perf_counter() - t0
    auc = init_auc_state(trainer.conf.auc_buckets, trainer.device)
    acc = dict(batch=0.0, plan=0.0, feed=0.0, step=0.0, step_span=0.0)
    batches = ds.batches()
    prof = None
    n = 0
    while True:
        if profile and n == 10:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA,
            ])
            prof.__enter__()
            window_t0 = time.perf_counter()
        t0 = time.perf_counter()
        batch = next(batches, None)
        t1 = time.perf_counter()
        if batch is None:
            break
        plan = table.plan_batch(batch)
        t2 = time.perf_counter()
        dev = trainer._to_device(host_feed(batch, plan))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        _, auc = trainer._step(table, dev, auc)
        ev1.record()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in (("batch", t1 - t0), ("plan", t2 - t1), ("feed", t3 - t2),
                     ("step", t4 - t3),
                     ("step_span", ev0.elapsed_time(ev1) / 1e3)):
            acc[k] += v
        n += 1
        if prof is not None and n == 30:
            window_s = time.perf_counter() - window_t0
            prof.__exit__(None, None, None)
            report_profile(prof, window_s)
            prof = None
    t0 = time.perf_counter()
    table.end_pass()
    end_s = time.perf_counter() - t0
    sk.launches.update(saved)  # not main-path launches
    per = {k: v / n * 1e3 for k, v in acc.items()}
    log(f"stages over {n} steps, ms per step: " + ", ".join(
        f"{k} {v!r}" for k, v in per.items())
        + f"; begin_pass {begin_s!r} s, end_pass {end_s!r} s")


def report_profile(prof, window_s: float) -> None:
    # device-side entries only (kernels, copies, memsets): the host ops that
    # launched them carry the same time again, and a user annotation such
    # as Optimizer.step spans its kernels and the gaps between them
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:12]
    log(f"profile window {window_s!r} s (20 staged steps): device busy "
        f"{busy!r} s = {busy / window_s!r} of the window")
    for e in top:
        log(f"  {dev_us(e) / 1e3:.3f} ms device, {e.count} calls: {e.key}")


# --------------------------------------------------------------------------- #
# phase 5: the multi-chip hybrid path
# --------------------------------------------------------------------------- #
def check_hybrid_parity(device) -> dict:
    """hot_cold_select against its twin on the card, bit-exact: at the main
    path's shape (K = KEY_CAPACITY, H = HOT_CAPACITY, W = 10) on the float4
    path and, with the cold rows based 4 bytes in, the scalar path; a
    ragged K (K * W mod 4 = 2) mixed, all-sink and all-hot; K = 1 (two
    vectors and a tail of 2); K = 0; all-sink, all-hot and a hot block of
    one row at the main K."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    W = EMB + 2
    gen = torch.Generator(device=device).manual_seed(5)
    cases = (("main", HOT_CAPACITY, KEY_CAPACITY, None),
             ("scalar: cold based 4 bytes in", HOT_CAPACITY, KEY_CAPACITY,
              None),
             ("ragged", HOT_CAPACITY, 12_345, None),
             ("ragged all-sink", HOT_CAPACITY, 12_345, "sink"),
             ("ragged all-hot", HOT_CAPACITY, 12_345, "hot"),
             ("K=1", HOT_CAPACITY, 1, None),
             ("empty", HOT_CAPACITY, 0, None),
             ("all-sink", HOT_CAPACITY, KEY_CAPACITY, "sink"),
             ("all-hot", HOT_CAPACITY, KEY_CAPACITY, "hot"),
             ("one-row", 1, KEY_CAPACITY, None))
    errs = {}
    for what, H, K, only in cases:
        hot = torch.randn((H, W), device=device, generator=gen)
        cold = torch.randn((K, W), device=device, generator=gen)
        if what.startswith("scalar"):
            cold = based4(cold)
        lo, hi = {"sink": (H, H + 1), "hot": (0, H)}.get(only, (0, H + 1))
        occ = torch.randint(lo, hi, (K,), device=device, generator=gen,
                            dtype=torch.int32)
        got = sk.hot_cold_select(hot, occ, cold)
        want = sk.hot_cold_select_plain(hot, occ, cold)
        if got.shape != (K, W) or not torch.equal(got, want):
            raise AssertionError(f"hot_cold_select differs from its twin "
                                 f"({what}: K={K}, H={H})")
        if what == "main":
            errs["hot_cold_select"] = float((got - want).abs().max())
    torch.cuda.synchronize()
    log(f"parity hot_cold_select: bit-exact at K={KEY_CAPACITY} "
        f"H={HOT_CAPACITY} W={W}: " + ", ".join(c[0] for c in cases)
        + " (ragged: K=12345)")
    return errs


def make_hybrid_world(device, placement="loopback", n_slots=N_SLOTS,
                      dense=DENSE, emb=EMB, hidden=HIDDEN,
                      positions=POSITIONS, hot_capacity=HOT_CAPACITY):
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )

    tconf = SparseTableConfig(
        embedding_dim=emb, hbm_cache_rows=0, placement=placement,
        placement_realize=True, placement_update_interval=1,
        placement_hot_capacity=hot_capacity,
    )
    mesh = make_mesh(positions, device=device)
    table = ShardedSparseTable(tconf, mesh, seed=0)
    model = CtrDnn(n_slots, tconf.row_width, dense_dim=dense, hidden=hidden,
                   seed=0, device=device)
    return table, MultiChipTrainer(model, tconf, mesh, TrainerConfig())


def drive_hybrid(datasets, table, trainer) -> list:
    """One pass over each dataset, the AUC streams continued, begin_pass
    and end_pass timed to a synchronize; per pass the census, the hot set,
    the host row traffic and the metrics."""
    import torch

    out, auc = [], None
    for ds in datasets:
        census = ds.unique_keys()
        t0 = time.perf_counter()
        table.begin_pass(census)
        torch.cuda.synchronize()
        begin_s = time.perf_counter() - t0
        promoted, moved = table.last_promotion_rows, table.last_hot_moved_rows
        m = trainer.train_from_dataset(ds, table, auc_state=auc)
        auc = trainer.last_metric_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table.end_pass()
        torch.cuda.synchronize()
        plan = table.placement_plan()
        out.append(dict(
            census=int(census.shape[0]),
            n_hot=0 if plan is None else plan.n_hot,
            resident=int(table.hot_resident_keys().shape[0]),
            hot_occ=m["hot_occurrences"], promotion_rows=promoted,
            hot_moved_rows=moved, written_back=table.last_write_back_rows,
            begin_s=begin_s, end_s=time.perf_counter() - t0,
            samples_per_s=m["samples"] / m["duration_s"], metrics=m,
        ))
    return out


def hybrid_path(datasets) -> dict:
    """The full-width model on POSITIONS positions with the realized hybrid
    placement, launch counters reset just before and read just after; the
    hash placement and the hybrid one again, in turns, for the times; then
    two hybrid runs under torch.use_deterministic_algorithms, which must be
    bit-equal, and the hash placement under it for the difference."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    runs = {}
    # in turns for the hybrid-against-hash times: hybrid, hash, hash, hybrid
    for label, placement, det in (("hybrid", "loopback", False),
                                  ("hash", "hash", False),
                                  ("hash again", "hash", False),
                                  ("hybrid again", "loopback", False),
                                  ("hybrid deterministic", "loopback", True),
                                  ("hybrid deterministic rerun", "loopback",
                                   True),
                                  ("hash deterministic", "hash", True)):
        torch.use_deterministic_algorithms(det)
        try:
            table, trainer = make_hybrid_world("cuda", placement)
            if label == "hybrid":
                sk.reset_launches()
            per_pass = drive_hybrid(datasets, table, trainer)
            if label == "hybrid":
                launches = dict(sk.launches)
                runs_trainer = trainer
        finally:
            torch.use_deterministic_algorithms(False)
        runs[label] = (per_pass, table)
        for p, r in enumerate(per_pass):
            m = r["metrics"]
            log(f"{label} pass {p}: census {r['census']}, n_hot {r['n_hot']}, "
                f"resident hot rows {r['resident']}, hot occurrences routed "
                f"{r['hot_occ']}; host rows in {r['promotion_rows']}, out "
                f"{r['written_back']}, hot rows moved {r['hot_moved_rows']}; "
                f"begin_pass {r['begin_s']!r} s, end_pass {r['end_s']!r} s; "
                f"{r['samples_per_s']!r} samples/s; loss {m['loss']!r} auc "
                f"{m['auc']!r} steps {m['steps']}")
    per_pass, table = runs["hybrid"]
    steps = sum(r["metrics"]["steps"] for r in per_pass)
    log(f"hybrid path launches {launches} over {steps} step groups of "
        f"{POSITIONS} positions")
    for name in ("pull_rows", "scatter_add_rows", "hot_cold_select"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the hybrid path")
    if launches["hot_cold_select"] != POSITIONS * steps:
        raise AssertionError(
            f"hot_cold_select launched {launches['hot_cold_select']} times, "
            f"not once per position and step ({POSITIONS * steps})")
    if not table.hot_resident_keys().shape[0]:
        raise AssertionError("the hot block never realized")
    if not all(r["hot_occ"] > 0 for r in per_pass[-2:]):
        raise AssertionError("hot occurrences were not routed in the last "
                             "two passes")
    if not all(math.isfinite(r["metrics"]["loss"]) for r in per_pass):
        raise AssertionError("non-finite loss on the hybrid path")
    union = np.unique(np.concatenate([ds.unique_keys() for ds in datasets]))
    state = table.state_dict()  # the barrier lands the resident hot rows
    if (not np.array_equal(state["keys"], union)
            or not np.isfinite(state["values"]).all()):
        raise AssertionError("the hybrid table lost keys or holds non-finite rows")
    (da, ta), (db, tb) = (runs["hybrid deterministic"],
                          runs["hybrid deterministic rerun"])
    sa, sb = ta.state_dict(), tb.state_dict()
    auc_a = [r["metrics"]["auc"] for r in da]
    auc_b = [r["metrics"]["auc"] for r in db]
    if (auc_a != auc_b or not np.array_equal(sa["keys"], sb["keys"])
            or not np.array_equal(sa["values"], sb["values"])):
        raise AssertionError(f"deterministic hybrid reruns differ: auc {auc_a} "
                             f"vs {auc_b}")
    sh = runs["hash deterministic"][1].state_dict()
    if not np.array_equal(sh["keys"], sa["keys"]):
        raise AssertionError("hash and hybrid tables hold different keys")
    diff = float(np.abs(sh["values"] - sa["values"]).max())
    noise = float(np.abs(state["values"] - sa["values"]).max())
    log(f"hybrid deterministic reruns: bit-equal ({sa['keys'].shape[0]} rows, "
        f"auc {auc_a}); largest difference against the hash placement "
        f"{diff!r}; without determinism the rows differ by up to {noise!r}")
    return {"launches": launches, "table": table, "trainer": runs_trainer,
            "datasets": datasets}


def hybrid_stages(hybrid: dict) -> None:
    """One more pass of the trained hybrid table over the last data set,
    driven stage by stage with a synchronize after each: ms per step group
    of batch assembly (POSITIONS batches), plan_group, the feed copy and
    the device step of all positions."""
    import torch

    from paddlebox_tpu_torch.metrics.auc import unstack_auc_state
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.parallel.trainer import _group_batches, _stack_group

    saved = dict(sk.launches)
    table, trainer = hybrid["table"], hybrid["trainer"]
    ds = hybrid["datasets"][-1]
    ds.local_shuffle(seed=HYBRID_PASSES)
    table.begin_pass(ds.unique_keys())
    stacked = trainer.init_auc()
    aucs = [unstack_auc_state(stacked, d) for d in range(POSITIONS)]
    acc = dict(batch=0.0, plan=0.0, feed=0.0, step=0.0)
    groups = _group_batches(ds.batches(), POSITIONS)
    n = 0
    while True:
        t0 = time.perf_counter()
        group = next(groups, None)
        t1 = time.perf_counter()
        if group is None:
            break
        plan = table.plan_group(group)
        t2 = time.perf_counter()
        feed = trainer._to_device(_stack_group(group, plan))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        trainer._step(table, feed, aucs)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in (("batch", t1 - t0), ("plan", t2 - t1), ("feed", t3 - t2),
                     ("step", t4 - t3)):
            acc[k] += v
        n += 1
    table.end_pass()
    sk.launches.update(saved)  # not main-path launches
    log(f"hybrid stages over {n} step groups of {POSITIONS} positions, ms per "
        "group: " + ", ".join(f"{k} {v / n * 1e3!r}" for k, v in acc.items()))


def small_hybrid_agreement() -> None:
    """The hybrid path at small size (4 positions, a narrow tower, 3 passes
    over the same files, so the hot block realizes in the third) on the
    card and on the CPU from the same initial weights must agree, at the
    tolerances of small_agreement, for the same reasons."""
    import numpy as np

    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files

    files = write_synth_files(
        os.path.join(WORK_DIR, "small-hybrid"), n_files=2, ins_per_file=256,
        n_sparse_slots=4, vocab_per_slot=50, dense_dim=3, seed=5,
        zipf_a=ZIPF_A,
    )
    results = {}
    for device in ("cuda", "cpu"):
        table, trainer = make_hybrid_world(device, n_slots=4, dense=3, emb=4,
                                           hidden=(16, 8), hot_capacity=64)
        ds = PadBoxSlotDataset(make_synth_config(4, 3, 16, 16), read_threads=2)
        ds.set_filelist(files)
        ds.load_into_memory()
        metrics = []
        for _ in range(3):
            table.begin_pass(ds.unique_keys())
            metrics.append(trainer.train_from_dataset(ds, table))
            table.end_pass()
        results[device] = (metrics, table.state_dict(),
                           table.hot_resident_keys())
        ds.close()
    (mg, sg, hg), (mc, sc, hc) = results["cuda"], results["cpu"]
    if not (hg.shape[0] and np.array_equal(hg, hc)
            and mg[-1]["hot_occurrences"] == mc[-1]["hot_occurrences"] > 0):
        raise AssertionError("card/CPU hybrid runs realized different hot sets")
    for a, b in zip(mg, mc):
        if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
            raise AssertionError(f"card/CPU hybrid loss differ: {a['loss']} "
                                 f"{b['loss']}")
        if abs(a["auc"] - b["auc"]) > 1e-3:
            raise AssertionError(f"card/CPU hybrid auc differ: {a['auc']} "
                                 f"{b['auc']}")
    if not np.array_equal(sg["keys"], sc["keys"]):
        raise AssertionError("card/CPU hybrid tables hold different keys")
    err = float(np.abs(sg["values"] - sc["values"]).max())
    if err > 1e-4:
        raise AssertionError(f"card/CPU hybrid table rows differ by {err}")
    log(f"small hybrid run card vs CPU: {hg.shape[0]} hot keys, losses "
        f"{[m['loss'] for m in mg]} vs {[m['loss'] for m in mc]}, table max "
        f"abs diff {err!r}")


def hybrid_specs(hybrid: dict) -> dict:
    """Timing inputs of hot_cold_select at the hybrid path's shapes: the
    trained table's hot block and position 0's hot slots and cold rows of a
    real group of the last pass's data (the pass is left open; the caller
    ends it)."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.parallel.trainer import _group_batches, sharded_pull

    table, ds = hybrid["table"], hybrid["datasets"][-1]
    table.begin_pass(ds.unique_keys())
    plan = table.plan_group(next(_group_batches(ds.batches(), POSITIONS)))
    dev = lambda a: torch.from_numpy(a).cuda()
    cold = sharded_pull(table.values, dev(plan.serve_rows), dev(plan.occ_flat),
                        0.0, 2)[0]
    hot = table.hot_values[0]
    occ = dev(plan.hot_occ[0])
    H, W = hot.shape
    k = occ.shape[0]
    hot_mask = occ < H
    n_hot = int(hot_mask.sum())
    hot_rows = torch.unique(occ[hot_mask])
    hot_rows_read = int(hot_rows.shape[0])
    hot_ext = torch.cat([hot, hot.new_zeros((1, W))])
    mask = hot_mask[:, None]
    # float4 vectors of the output whose elements all lie in hot rows: the
    # cold loads a kernel that loads only where needed would skip
    e4 = 4 * torch.arange(k * W // 4, device="cuda")
    skip = int((hot_mask[e4 // W] & hot_mask[(e4 + 3) // W]).sum())
    log(f"hot_cold_select shapes: K={k}, H={H}: {n_hot} hot occurrences of "
        f"{hot_rows_read} hot rows; {skip} of {k * W // 4} cold vectors lie "
        f"wholly in hot rows ({skip * 16} bytes)")
    return {
        # the cold rows of the cold occurrences, the named hot rows once
        "hot_cold_select": dict(
            fn=lambda: sk.hot_cold_select(hot, occ, cold),
            plain=lambda: sk.hot_cold_select_plain(hot, occ, cold),
            library=lambda: torch.where(mask, hot_ext.index_select(0, occ),
                                        cold),
            bytes=k * 4 + (k - n_hot) * W * 4 + hot_rows_read * W * 4
            + k * W * 4, ops=0,
            # the sectors those rows span, each read whole once
            floor_bytes=k * 4 + 32 * touched_sectors(
                cold, torch.nonzero(~hot_mask).flatten())
            + 32 * touched_sectors(hot, hot_rows) + k * W * 4,
        ),
    }


# --------------------------------------------------------------------------- #
# phase 6: kernel times
# --------------------------------------------------------------------------- #
def device_ms(fn, inner: int = 20, reps: int = 25) -> float:
    """Median device time of one call with the L2 cache warm: ``inner``
    calls on the same inputs are captured into a CUDA graph (so host launch
    overhead drops out), the graph is replayed ``reps`` times between CUDA
    events."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def cold_ms(fn, flush, reps: int = 50) -> float:
    """Median device time of one call that finds the L2 cache cold, as the
    step's pull does (its 2 M-row table is larger than the 50 MB L2):
    ``flush`` (larger than the L2) is overwritten before each call, and CUDA
    events bracket the call alone.  The flush runs long enough for the call
    to be queued behind it, so host launch time stays out."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def touched_sectors(table, rows) -> int:
    """Distinct 32-byte sectors of ``table`` that the rows ``rows`` span:
    a 40-byte row spans two, a 44-byte row two or three, and neighbouring
    rows can share one."""
    import torch

    if rows.numel() == 0:
        return 0
    row_bytes = table.shape[1] * table.element_size()
    start = table.data_ptr() % 32 + rows.long() * row_bytes
    first, last = start // 32, (start + row_bytes - 1) // 32
    span = torch.arange(int((last - first).max()) + 1, device=rows.device)
    sectors = first[:, None] + span
    return int(torch.unique(sectors[sectors <= last[:, None]]).shape[0])


def cuda_launches(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches, one entry a
    launch, from a torch.profiler window around the call.  The call is
    kept 20 ms from each edge of the window, where the profiler has been
    seen to lose the record of a kernel that ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return [e.name for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Memcpy", "Memset"))]


def slice_specs(table, ds) -> dict:
    """Timing inputs of the step's two kernels: a real batch's plan of the
    trained uncached table (a pass is left open; the caller ends it)."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    table.begin_pass(ds.unique_keys())
    plan = table.plan_batch(next(ds.batches()))
    values = table.values
    P, W = values.shape
    idx = torch.from_numpy(plan.idx).cuda()
    uidx = torch.from_numpy(plan.uniq_idx).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    delta = torch.randn((uidx.shape[0], W), device="cuda", generator=gen) * 1e-3
    delta[uidx == P - 1] = 0.0
    work = values.clone()
    work4 = based4(values)  # the scalar paths
    f4 = 4
    k, u = idx.shape[0], uidx.shape[0]
    pull_rows = torch.unique(idx)
    pull_rows_read = int(pull_rows.shape[0])
    push_rows = int(torch.unique(uidx).shape[0])
    return {
        "pull_rows": dict(
            fn=lambda: sk.pull_rows(values, idx),
            plain=lambda: sk.pull_rows_plain(values, idx),
            library=lambda: torch.index_select(values, 0, idx),
            bytes=k * 4 + pull_rows_read * W * f4 + k * W * f4, ops=0,
            # each distinct sector of the named rows read whole once
            floor_bytes=k * 4 + 32 * touched_sectors(values, pull_rows)
            + k * W * f4,
            variants={"scalar path (table based 4 bytes in)":
                      lambda: sk.pull_rows(work4, idx)},
        ),
        "scatter_add_rows": dict(
            fn=lambda: sk.scatter_add_rows(work, uidx, delta),
            plain=lambda: sk.scatter_add_rows_plain(work, uidx, delta),
            library=lambda: work.index_add_(0, uidx, delta),
            bytes=u * 4 + u * W * f4 + 2 * push_rows * W * f4, ops=u * W,
            # each target sector read and written whole
            floor_bytes=u * 4 + u * W * f4
            + 2 * 32 * touched_sectors(work, torch.unique(uidx)),
            variants={"scalar path (table based 4 bytes in)":
                      lambda: sk.scatter_add_rows(work4, uidx, delta)},
        ),
    }


def cache_specs(table, census) -> dict:
    """Timing inputs of the cache kernels at the cached path's shapes: the
    trained cache resolved against the last pass's census, the hit slots it
    gathers, the hit + admit slots end_pass would write, the device key
    mirror the census is searched in."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    cache = table._caches()[0]
    plan = cache.lookup(census)  # also builds the device key mirror
    upd = cache.plan_update(census, plan)  # a decision only: not committed
    rows = cache.rows
    W1 = rows.shape[1]
    hits = torch.from_numpy(plan.hit_slots).cuda()
    upd_slots = np.concatenate([plan.hit_slots, upd.admit_slots])
    slots = torch.from_numpy(upd_slots).cuda()
    slots_long = slots.long()
    gen = torch.Generator(device="cuda").manual_seed(4)
    new = torch.randn((slots.shape[0], W1), device="cuda", generator=gen)
    work = rows.clone()
    hay, n_real = cache._dev_index
    q = torch.from_numpy(np.ascontiguousarray(census).view(np.int64)).cuda()
    hay_f, q_f = hay ^ sk._SIGN, q ^ sk._SIGN
    h, k, nq, c = hits.shape[0], slots.shape[0], q.shape[0], hay.shape[0]
    log(f"cache kernel shapes: {h} hit slots, {k} hit + admit slots "
        f"({upd.victim_slots.shape[0]} victims), {nq} census keys searched in "
        f"{c} ({n_real} real)")
    return {
        # hits are unique slots: each distinct row is read once
        "gather_slots": dict(
            fn=lambda: sk.gather_slots(rows, hits),
            plain=lambda: sk.gather_slots_plain(rows, hits),
            library=lambda: torch.index_select(rows, 0, hits),
            bytes=h * 4 + 2 * h * W1 * 4, ops=0,
        ),
        "scatter_rows": dict(
            fn=lambda: sk.scatter_rows(work, slots, new),
            plain=lambda: sk.scatter_rows_plain(work, slots, new),
            library=lambda: work.index_copy_(0, slots_long, new),
            bytes=k * 4 + 2 * k * W1 * 4, ops=0,
            # the slots are unique: each target sector written whole once
            floor_bytes=k * 4 + k * W1 * 4 + 32 * touched_sectors(work, slots),
            # what a scratch zeroed in every call would add to the kernel's
            variants={"zero fill of a per-call tag scratch":
                      lambda: torch.zeros(work.shape[0], dtype=torch.int32,
                                          device="cuda")},
        ),
        # one 64-bit compare per step of the descent
        "sorted_search": dict(
            fn=lambda: sk.sorted_search(hay, n_real, q),
            plain=lambda: sk.sorted_search_plain(hay, n_real, q),
            library=lambda: torch.searchsorted(hay_f, q_f),
            bytes=c * 8 + nq * 8 + nq * 4,
            ops=nq * max(1, (c - 1).bit_length()),
        ),
    }


def kernel_times(res: dict, ds, cached: dict, census, hybrid: dict,
                 errs: dict) -> list:
    """Time each kernel at its main path's shapes; the launches are those of
    the main-path run that launched it."""
    import torch

    from paddlebox_tpu_torch.ops import cuda_build
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    specs = slice_specs(res["table"], ds)
    specs.update(cache_specs(cached["table"], census))
    specs.update(hybrid_specs(hybrid))
    launches = dict(res["launches"])
    for name in ("gather_slots", "scatter_rows", "sorted_search"):
        launches[name] = cached["launches"][name]
    launches["hot_cold_select"] = hybrid["launches"]["hot_cold_select"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    one = torch.empty(1, device="cuda")
    log(f"time floor of the L2-cold method (a one-float fill after the "
        f"flush): {cold_ms(lambda: one.fill_(1.0), flush)!r} ms")
    rows = []
    for name, s in specs.items():
        per_call = cuda_launches(s["fn"])
        log(f"launches {name}: {len(per_call)} CUDA kernel(s) a call "
            f"{sorted(set(per_call))}")
        want = CUDA_LAUNCHES_PER_CALL.get(name, 1)
        if len(per_call) != want:
            raise AssertionError(f"{name} launched {len(per_call)} CUDA "
                                 f"kernels in one call, not {want}")
        # turns, L2 cold: twin, kernel, kernel, twin, library
        plain_a = cold_ms(s["plain"], flush)
        ms_a = cold_ms(s["fn"], flush)
        ms_b = cold_ms(s["fn"], flush)
        plain_b = cold_ms(s["plain"], flush)
        lib = cold_ms(s["library"], flush)
        warm = device_ms(s["fn"])
        bytes_ms = s["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = s["ops"] / OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(cuda_build.source_path(name), REPO),
            "replaces": TPU_KERNELS[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib,
        })
        floor = ""
        if "floor_bytes" in s:
            floor_ms = s["floor_bytes"] / HBM_BYTES_PER_S * 1e3
            floor = (f", sector floor {floor_ms!r} ms ({s['floor_bytes']} "
                     "bytes)")
        log(f"time {name} (L2 cold): kernel {ms_a!r} / {ms_b!r} ms, twin "
            f"{plain_a!r} / {plain_b!r} ms, library {lib!r} ms, bound "
            f"{max(bytes_ms, ops_ms)!r} ms ({s['bytes']} bytes, {s['ops']} "
            f"operations){floor}; kernel with L2 warm {warm!r} ms")
        for what, fn in s.get("variants", {}).items():
            log(f"time {name}, {what} (L2 cold): {cold_ms(fn, flush)!r} / "
                f"{cold_ms(fn, flush)!r} ms")
    sk.launches.update(saved)  # timing launches are not main-path launches
    res["table"].end_pass()
    hybrid["table"].end_pass()
    torch.cuda.synchronize()
    return rows


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also record 20 steps with torch.profiler")
    profile = ap.parse_args(argv).profile

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # a copy of this script alone, without the package beside it, fails here
    from paddlebox_tpu_torch.ops import cuda_build
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS reads this when it is first used: the deterministic phase of
    # cached_path needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    try:
        t0 = time.perf_counter()
        built = cuda_build.build(sk.KERNELS)
        log(f"build: {time.perf_counter() - t0!r} s for {sorted(built)}")
        for name in built:
            ptxas = [line for line in cuda_build.build_log[name]["log"].splitlines()
                     if "registers" in line or "spill" in line]
            log(f"  {name}: " + " | ".join(ptxas))

        t0 = time.perf_counter()
        files, cached_files = write_data()
        ds = load(files, N_FILES)
        n_census = ds.unique_keys().shape[0]
        cached_ds = [load(fs, CACHED_FILES) for fs in cached_files]
        censuses = [d.unique_keys() for d in cached_ds]
        log(f"data: {ds.get_memory_data_size()} instances, {n_census} census "
            f"keys; Zipf sets {[d.get_memory_data_size() for d in cached_ds]} "
            f"instances, censuses {[c.shape[0] for c in censuses]}; in "
            f"{time.perf_counter() - t0!r} s")

        P = pass_capacity(n_census)
        errs = check_parity(P, torch.device("cuda"))
        errs.update(check_cache_parity(censuses[0], torch.device("cuda")))
        errs.update(check_hybrid_parity(torch.device("cuda")))
        res = slice_pass(ds)
        stage_breakdown(ds, res["table"], res["trainer"], profile)
        small_agreement()
        cached = cached_path(cached_ds[:CACHED_PASSES])
        lifecycle_check(censuses[:CACHED_PASSES])
        hybrid = hybrid_path(cached_ds[:HYBRID_PASSES])
        hybrid_stages(hybrid)
        small_hybrid_agreement()
        rows = kernel_times(res, ds, cached, censuses[CACHED_PASSES - 1],
                            hybrid, errs)
        ds.close()
        for d in cached_ds:
            d.close()
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
