#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Every path runs at the port's defaults, which are the reference's: the
native C++ slot parser and batch planner, the feed prefetch thread two
batches ahead, and the overlapped pass boundary (the merge into the host
store on a background thread, the next pass staged while the current one
trains: every driver hands ``next_pass_keys`` to the trainer).  A phase
fails unless it saw them run: both host libraries built, every dataset
loaded through a native parser, every table planned through a live native
census index, the producer thread fed every step, and every begin_pass
after the first consumed its stage.

Phases, each fatal on failure:
  1. build   — compile every CUDA kernel of the paths from csrc/ (one nvcc
               per source, all started together) and, beside them, the two
               host libraries from _native/ with g++; print the g++ version,
               the build times and each kernel's registers and spills.
     load    — load the data sets through the native parser (seconds
               printed), and the uncached set once more with the Python
               parser: both times, and the blocks must be bit-equal.
  2. parity  — hold each kernel against its plain PyTorch twin on the card,
               at the main paths' shapes, at a ragged size and at size 0
               (pull_rows and scatter_add_rows on their float2 and their
               scalar paths, hot_cold_select on its float4 and its scalar
               path with ragged tails; the cache kernels with negative and
               duplicate slots, gather_slots also at widths 1 to 12, block
               edges, ragged tails, grid-stride sizes, a table based 4 bytes
               in and all misses, scatter_rows also with 65 536 occurrences
               on 8 slots, duplicates across every tile boundary, calls in a
               row and a larger table; sorted_search with keys at and above
               2^63 and the all-ones key, shuffled queries and a haystack of
               2^20 keys).
  3. pass    — write synthetic slot files at the full width of the repo's
               benchmark CTR-DNN (16 sparse slots, 13 dense, batch 2048,
               embedding_dim 8 -> device row width 10, tower 512-256-128, vocab
               100 000 per slot) and run begin_pass -> train_from_dataset ->
               end_pass for PASSES passes on device="cuda" with the HBM
               cache off, every kernel launch counter reset just before and
               read just after; then the same passes with the serial pass
               boundary: begin_pass / end_pass seconds, the begin_pass
               breakdown (stage wait, patch, resolve, H2D, cache fill) and
               samples/s of both.
     check   — the same small pass on the card and on the CPU (plain twins)
               from identical initial weights must agree.
     stages  — one more pass, serial (as the reference profiles) and
               synchronized after each host stage and step, for the per-step
               breakdown (--profile adds a profiler window); then the same
               batches planned alone with the native and the numpy planner,
               ms per step of each, and every native plan must agree with
               the numpy one under the reference's order-free equivalence.
     feed    — two more passes of the trained table, fed serially and
               prefetched: samples/s of each.
     prefetch — at a small size under deterministic algorithms, a cached
               single-chip run and a 4-position hybrid run with the prefetch
               thread must be bit-equal to the same runs fed serially.
  4. cached  — the same model with the reference's default HBM cache (65 536
               rows) over CACHED_PASSES passes, each over its own Zipf(1.3)
               file set, counters reset just before and read just after;
               per pass the census, hits, misses, evicted and written-back
               rows, begin_pass / end_pass seconds and samples/s, beside the
               same passes without the cache and with the serial pass
               boundary, each with its begin_pass breakdown.  With
               deterministic algorithms on, cached (overlapped), cached
               serial and uncached trained passes from the same initial
               weights must be bit-equal.
     lifecycle — the three censuses through a cached and an uncached table
               with a deterministic in-pass update: bit-equal state_dicts.
     persist — under deterministic algorithms, the cached model with a
               durable log: two passes, a base checkpoint of the card table
               and tower, a third pass; a fresh world restored from the
               checkpoint trains the third pass bit-equal, and a table
               rebuilt from the log holds exactly the store it logged.
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
     stages  — one more hybrid pass stage by stage, and its groups
               planned alone with the native and the numpy planner (ms per
               group of each; the plans must pull the same rows).
     check   — a small hybrid run on the card and on the CPU (plain twins)
               from identical initial weights must agree.
     sharded — the hybrid path's world at the reference's defaults: the
               per-shard HBM caches on (CACHE_ROWS, CACHE_ROWS / POSITIONS
               rows a shard), the same HYBRID_PASSES passes, overlapped and
               staged, counters reset just before and read just after (all
               six kernels must launch); per pass each shard's hits and
               misses, the promotion, write-back, evicted and hot rows
               moved, begin_pass / end_pass seconds with the begin_pass
               phases, and samples/s.  Under deterministic algorithms all
               its passes must be bit-equal to the uncached hybrid run's,
               and agree with the same passes on the CPU.
     reshard — under deterministic algorithms, that table resharded live
               from POSITIONS to 2 shard positions at the pass boundary
               and trained RESHARD_BATCHES more batches, then back to
               POSITIONS: each pass bit-equal to a table rebuilt from
               state_dict at the new count, no kernel built after a
               cutover; rows moved and seconds printed.
     check   — the small hybrid run again with the per-shard caches on,
               card against CPU, hits included.
     dense   — the "kstep" (sync_weight_step 4) and "async" dense sync, two
               small passes each on the card and on the CPU: finite losses
               that agree.
  6. graph   — TrainerConfig(scan_steps=GRAPH_K) on the uncached slice
               world: the k-step body captured once a pass as a CUDA graph
               and replayed; under deterministic algorithms bit-equal to
               eager steps over GRAPH_PASSES Zipf sets, one capture a pass;
               then eager, graph, graph, eager turns: samples/s, host
               seconds in the step a step, synchronized ms per step.
     policies — at full width: skip_batch (a poisoned batch leaves the
               state of the run without it, eager and under the graph, bit
               for bit), rollback to the first pass's checkpoint, evaluate
               without updates, the bf16 and fp16 towers and SGD against
               the CPU.
     slots   — the hybrid world with a slot mask and a per-slot LR map over
               three passes (hot block realized): excluded slots untouched,
               card against CPU.
  7. data    — the data half (data_half): logkey and ins_id data at the
               slice's width through the native parser's preload, a
               4-dataset shuffle group, a pass with a 4-spec metric group,
               a dumped pass, the group under the step graph, the disk
               spill, PV merge and the 4-position world with the group,
               each checked as its docstring says.
  8. times   — the CUDA kernels one call of each wrapper launches (from
               torch.profiler; one each, two for scatter_rows), and the
               median time of each kernel, its twin and the equivalent
               PyTorch library call at the main paths' shapes with the L2
               cache cold, beside the least time the card's memory rate
               allows (for the row kernels also the floor of the distinct
               32-byte sectors their rows touch; pull_rows' and
               scatter_add_rows' scalar paths, the zero fill a per-call
               scatter_rows scratch would add, gather_slots at end_pass's
               shape, sorted_search on shuffled queries and on 2^20 keys,
               and for those two the same bytes moved without the gather or
               the search), and the time the cold and the warm method give
               a launch that does almost nothing.
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

# The step policies: scan_steps GRAPH_K (a CUDA graph of 8 steps) on the
# uncached slice world, against eager steps over GRAPH_PASSES Zipf sets,
# timed in turns over the uncached set, and synchronized over its first
# STEP_MS_BATCHES; the NaN policies and evaluate over its first
# POLICY_BATCHES batches (two groups of 8: the warm-up and the captured
# one), the compute dtypes and SGD card against CPU over
# POLICY_CPU_BATCHES; the slot policy over the first SLOT_BATCHES batches
# of three Zipf sets (2 step groups of the 4 positions a pass).
GRAPH_K, GRAPH_PASSES, STEP_MS_BATCHES = 8, 2, 48
POLICY_BATCHES, POLICY_CPU_BATCHES, SLOT_BATCHES = 16, 2, 8
# Depth cut to keep the run's phases near 350 s since the data half: the
# passes after a live reshard train the first RESHARD_BATCHES batches of
# their Zipf set (of 32)
RESHARD_BATCHES = 16

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
    out_dir, ins, seed, zipf_a, logkey = args
    from paddlebox_tpu_torch.data.synth import write_synth_files

    extra = {}
    if logkey:
        extra = dict(with_logkey=True, max_ads_per_pv=4,
                     cmatch_values=(222, 223, 1), n_task_labels=1)
    path = write_synth_files(
        out_dir, n_files=1, ins_per_file=ins, n_sparse_slots=N_SLOTS,
        vocab_per_slot=VOCAB, dense_dim=DENSE, seed=seed, zipf_a=zipf_a,
        **extra,
    )[0]
    if logkey:
        # the ins_id prefix: "<set>-<line>"
        with open(path) as f:
            lines = f.read().splitlines()
        name = os.path.basename(out_dir)
        with open(path, "w") as f:
            f.writelines(f"{name}-{i} {line}\n" for i, line in enumerate(lines))
    return path


def write_data() -> tuple:
    """Synthetic files, one writer process per file (spawned, so no child
    inherits a CUDA context): the uncached path's N_FILES, CACHED_FILES per
    Zipf file set, and the data half's N_FILES with the ins_id and logkey
    prefixes and a task label.  Returns (files, [files of each set],
    logkey files)."""
    jobs = [(os.path.join(WORK_DIR, f"w{i}"), INS_PER_FILE, 7 + i, 0.0, False)
            for i in range(N_FILES)]
    for p in range(ZIPF_SETS):
        jobs += [(os.path.join(WORK_DIR, f"z{p}-{i}"), CACHED_INS_PER_FILE,
                  100 + CACHED_FILES * p + i, ZIPF_A, False)
                 for i in range(CACHED_FILES)]
    jobs += [(os.path.join(WORK_DIR, f"l{i}"), INS_PER_FILE, 300 + i, 0.0,
              True) for i in range(N_FILES)]
    ctx = multiprocessing.get_context("spawn")
    workers = min(len(jobs), os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        paths = list(ex.map(_write_part, jobs))
    per_pass = [paths[N_FILES + CACHED_FILES * p:
                      N_FILES + CACHED_FILES * (p + 1)]
                for p in range(ZIPF_SETS)]
    return paths[:N_FILES], per_pass, paths[-N_FILES:]


def based4(t):
    """A copy of ``t`` as a view that starts 4 bytes into its storage, so
    not 8-byte aligned: the kernels' scalar paths."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def big_haystack(keys, rng, device):
    """A sorted search haystack of 2^20 keys: ``keys`` (uint64) and random
    ones, the last 1000 entries all-ones padding.  Returns the int64
    tensor of its bits on ``device`` and the real keys."""
    import numpy as np
    import torch

    big = 1 << 20
    real = np.unique(np.concatenate([
        keys, rng.integers(0, 2**64 - 1, size=big, dtype=np.uint64)
    ]))[: big - 1000]
    hay = np.full(big, 2**64 - 1, np.uint64)
    hay[: real.shape[0]] = real
    return torch.from_numpy(hay.view(np.int64)).to(device), real


def pass_capacity(n_census: int) -> int:
    """Table rows of a pass over n_census keys once a batch has been
    planned (live rows + one scratch row per key slot + the dead row)."""
    from paddlebox_tpu_torch.sparse.table import _next_pow2

    return _next_pow2(n_census + 1 + KEY_CAPACITY)


def native_index_live(table) -> None:
    """The table planned this pass through a live native census index."""
    ix = table._census_index
    if ix is None or not ix._handle:
        raise AssertionError("the table planned without a live native census "
                             "index")


def prefetched_feeds() -> float:
    """Feeds the prefetch producers have handed over so far."""
    from paddlebox_tpu_torch.utils.monitor import stats

    return stats.get("trainer.prefetched_feeds")


def check_prefetched(trainer, before: float, steps: int) -> None:
    """Every step of the run since ``before`` took its feed from the
    producer thread."""
    fed = prefetched_feeds() - before
    if trainer.conf.prefetch_batches != 2 or fed != steps:
        raise AssertionError(
            f"prefetch_batches {trainer.conf.prefetch_batches}: the producer "
            f"fed {fed} of {steps} steps")


def plans_agree(a, b) -> None:
    """Two single-chip plans of one batch agree under the reference's
    order-free equivalence (tests/test_native_planner.py): the same pull
    rows, mask and missing count; the same push target for every
    occurrence of a live key; one slot per key in each plan."""
    import numpy as np

    if not (np.array_equal(a.idx, b.idx)
            and np.array_equal(a.key_mask, b.key_mask)
            and a.n_missing == b.n_missing):
        raise AssertionError("native and numpy plans pull different rows")
    tgt_a, tgt_b = a.uniq_idx[a.inverse], b.uniq_idx[b.inverse]
    found_a = (a.idx == tgt_a) & (a.key_mask > 0)
    found_b = (b.idx == tgt_b) & (b.key_mask > 0)
    if not (np.array_equal(found_a, found_b)
            and np.array_equal(tgt_a[found_a], b.idx[found_b])):
        raise AssertionError("native and numpy plans push to different rows")
    for p in (a, b):
        real = p.key_mask > 0
        inv = p.inverse[real].astype(np.int64)
        pairs = (inv << 32) | p.idx[real].astype(np.int64)
        if np.unique(pairs).shape[0] != np.unique(inv).shape[0]:
            raise AssertionError("a plan gives one key two slots")


def group_plans_agree(a, b) -> None:
    """Two sharded plans of one group pull the same row for every
    occurrence: the same (owner, row) for a cold one, the same hot slot for
    a hot one, whatever their slot layouts."""
    import numpy as np

    n, C = a.serve_rows.shape[1], a.serve_rows.shape[2]

    def pulled(p):
        sink = p.occ_flat == n * C
        o = np.where(sink, 0, p.occ_flat // C)
        c = np.where(sink, 0, p.occ_flat % C)
        d = np.arange(n)[:, None]
        rows = np.where(sink, -1, p.serve_rows[o, d, c])
        return np.where(sink, -1, o), rows

    if (b.serve_rows.shape != a.serve_rows.shape
            or a.n_missing != b.n_missing
            or not np.array_equal(a.key_mask, b.key_mask)
            or not all(np.array_equal(x, y)
                       for x, y in zip(pulled(a), pulled(b)))
            or (a.hot_occ is None) != (b.hot_occ is None)
            or (a.hot_occ is not None
                and not np.array_equal(a.hot_occ, b.hot_occ))):
        raise AssertionError("native and numpy group plans pull different rows")


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
    # the kernel's edges: a block gathers 512 output floats (K = 46 and 47
    # at W = 11 end inside and past the first block), K * W mod 4 of 1, 2
    # and 3 leaves a ragged tail, K = 100 003 makes blocks walk grid-stride;
    # widths 1, 3, 10 and 12, a table based 4 bytes in, the last slot, and
    # all slots negative
    tables = {f"W={w}": torch.randn((C, w), device=device, generator=gen)
              for w in (1, 3, 10, 12)}
    tables.update({"W=11": rows, "W=11 based 4 bytes in": based4(rows)})
    ks = (1, 2, 3, 46, 47, 129, 100_003)
    for what, table in tables.items():
        for k in ks:
            slots = torch.randint(-1, C, (k,), device=device, generator=gen,
                                  dtype=torch.int32)
            slots[-1] = C - 1
            if not torch.equal(sk.gather_slots(table, slots),
                               sk.gather_slots_plain(table, slots)):
                raise AssertionError(
                    f"gather_slots differs from its twin ({what}, K={k})")
    miss = torch.full((4097,), -1, device=device, dtype=torch.int32)
    if bool(sk.gather_slots(rows, miss).any()):
        raise AssertionError("gather_slots: an all-miss gather is not all zero")
    log(f"parity gather_slots: bit-exact at K={C}, 12345, 0 (negative slots); "
        f"{', '.join(tables)} at K={', '.join(map(str, ks))} with the last "
        "slot; all-miss K=4097 zero")

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
    # the queries shuffled (the contract does not need them sorted), and a
    # haystack of 2^20 keys, the last 1000 of them padding, searched for
    # the census, every 7th key and the all-ones key, sorted and shuffled
    big_t, big_keys = big_haystack(census[: C // 4], rng, device)
    q_big = np.concatenate([census, big_keys[::7],
                            np.array([2**64 - 1], np.uint64)])
    cases = (("shuffled", hay_t, (C, C - 1), rng.permutation(q_all)),
             ("2^20 keys, sorted", big_t, (big_keys.shape[0], 0), q_big),
             ("2^20 keys, shuffled", big_t, (big_keys.shape[0],),
              rng.permutation(q_big)))
    for what, h, n_reals, qs in cases:
        q = torch.from_numpy(np.ascontiguousarray(qs).view(np.int64)).to(device)
        for n_real in n_reals:
            if not torch.equal(sk.sorted_search(h, n_real, q),
                               sk.sorted_search_plain(h, n_real, q)):
                raise AssertionError(f"sorted_search differs from its twin "
                                     f"({what}, n_real={n_real})")
    log(f"parity sorted_search: bit-exact at Q={q_all.shape[0]}, 12345, 0 over "
        f"{C} keys ({int((hay >= np.uint64(2**63)).sum())} at or above 2^63, "
        f"the all-ones key real and as padding); {found} found; the queries "
        f"shuffled; {q_big.shape[0]} queries over {big_t.shape[0]} keys "
        f"({big_keys.shape[0]} real, and none), sorted and shuffled")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return errs


def check_shard_cache_parity(census, device) -> None:
    """The cache kernels against their twins at the sharded cached path's
    shapes, all bit-exact: one shard's cache of C = CACHE_ROWS //
    POSITIONS rows [C, W+1]; gather_slots for the drain (all C slots), the
    hit fill (a shard census's worth of slots, misses among them) and
    take_rows (a promotion's share of the hot block); scatter_rows for an
    admission of C unique slots and with duplicates; sorted_search of the
    keys one shard owns against a directory of C keys padded with
    all-ones, full and part full."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    W1 = EMB + 3
    C = CACHE_ROWS // POSITIONS
    gen = torch.Generator(device=device).manual_seed(7)
    rows = torch.randn((C, W1), device=device, generator=gen)
    owned = census[census % np.uint64(POSITIONS) == 0]
    n_own = owned.shape[0]
    gathers = (("drain", torch.randperm(C, device=device,
                                        generator=gen).to(torch.int32)),
               ("hit fill", torch.randint(-1, C, (n_own,), device=device,
                                          generator=gen, dtype=torch.int32)),
               ("take_rows", torch.randperm(C, device=device, generator=gen)
                [:HOT_CAPACITY // POSITIONS].to(torch.int32)))
    for what, slots in gathers:
        if not torch.equal(sk.gather_slots(rows, slots),
                           sk.gather_slots_plain(rows, slots)):
            raise AssertionError(f"gather_slots differs from its twin at the "
                                 f"shard's {what} (K={slots.shape[0]}, C={C})")
    scatters = (("admission", torch.randperm(C, device=device,
                                             generator=gen).to(torch.int32)),
                ("duplicates", torch.randint(-1, C, (C,), device=device,
                                             generator=gen,
                                             dtype=torch.int32)))
    for what, slots in scatters:
        new = torch.randn((slots.shape[0], W1), device=device, generator=gen)
        if not torch.equal(sk.scatter_rows(rows.clone(), slots, new),
                           sk.scatter_rows_plain(rows.clone(), slots, new)):
            raise AssertionError(f"scatter_rows differs from its twin at the "
                                 f"shard's {what} (K={C}, C={C})")
    rng = np.random.default_rng(8)
    # half of the directory from the shard's census, half other keys of
    # the shard, in a random order, so that a part-full one keeps both
    pool = np.unique(np.concatenate([
        owned[rng.permutation(n_own)[: C // 2]],
        rng.integers(0, 2**62, size=C, dtype=np.uint64)
        * np.uint64(POSITIONS)]))
    resident = pool[rng.permutation(pool.shape[0])[:C]]
    q = torch.from_numpy(np.ascontiguousarray(owned).view(np.int64)).to(device)
    for n_real in (C, C - 300):
        hay = np.full(C, 2**64 - 1, dtype=np.uint64)
        hay[:n_real] = np.sort(resident[:n_real])
        hay_t = torch.from_numpy(hay.view(np.int64)).to(device)
        got = sk.sorted_search(hay_t, n_real, q)
        if not torch.equal(got, sk.sorted_search_plain(hay_t, n_real, q)):
            raise AssertionError(f"sorted_search differs from its twin at the "
                                 f"shard's lookup (Q={n_own}, C={C}, "
                                 f"n_real={n_real})")
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"parity at a shard's cache of C={C} rows: gather_slots bit-exact for "
        f"the drain (K={C}), the hit fill (K={n_own}) and take_rows "
        f"(K={HOT_CAPACITY // POSITIONS}); scatter_rows for an admission of "
        f"{C} unique slots and with duplicates; sorted_search of the "
        f"{n_own} keys shard 0 owns against {C} keys, full and "
        f"{C - 300} real ({int((got >= 0).sum())} found)")


# --------------------------------------------------------------------------- #
# phase 3: the slice pass
# --------------------------------------------------------------------------- #
def make_world(n_slots, dense, batch, emb, hidden, device, key_capacity=None,
               cache_rows=0, overlap=True, seed=0, trainer_kw=None,
               **table_kw):
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.synth import make_synth_config
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    conf = make_synth_config(
        n_sparse_slots=n_slots, dense_dim=dense, batch_size=batch,
        max_feasigns_per_ins=64, batch_key_capacity=key_capacity,
    )
    tconf = SparseTableConfig(embedding_dim=emb, hbm_cache_rows=cache_rows,
                              overlap_pass_boundary=overlap, **table_kw)
    table = SparseTable(tconf, seed=seed, device=device)
    model = CtrDnn(n_slots, tconf.row_width, dense_dim=dense, hidden=hidden,
                   seed=seed, device=device)
    trainer = Trainer(model, tconf, TrainerConfig(**(trainer_kw or {})),
                      device=device)
    return conf, table, trainer


def run_passes(ds, table, trainer, passes: int) -> list:
    """``passes`` passes over the reshuffled ``ds``, each handing the next
    pass's census to the staging thread (``next_pass_keys``, as a driver
    at the defaults does; a no-op on a serial table).  Per pass the
    metrics, begin_pass / end_pass seconds to a synchronize and the
    begin_pass breakdown."""
    import torch

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    out = []
    census = ds.unique_keys()  # every pass's: the set is only reshuffled
    for p in range(passes):
        ds.local_shuffle(seed=p)
        t0 = time.perf_counter()
        table.begin_pass(census)
        sync()
        begin_s = time.perf_counter() - t0
        breakdown = dict(table.last_begin_breakdown)
        if table.values.device.type != trainer.device.type:
            raise AssertionError(f"table values on {table.values.device}")
        m = trainer.train_from_dataset(
            ds, table, next_pass_keys=census if p + 1 < passes else None)
        sync()
        native_index_live(table)
        t0 = time.perf_counter()
        table.end_pass()
        sync()
        out.append(dict(m, begin_s=begin_s, end_s=time.perf_counter() - t0,
                        breakdown=breakdown))
    return out


def staged_as_expected(table, per_pass, early: bool = False) -> None:
    """An overlapped table consumed its stage at every begin_pass after the
    first (the census matched); a serial one never stages.  A stage started
    right after the first begin_pass, before any batch was planned, sizes
    its scratch rows from the config's default and may be discarded."""
    want = [False] + [table.overlap_enabled] * (len(per_pass) - 1)
    got = [r["breakdown"]["staged"] for r in per_pass]
    if early and len(got) > 1:
        want[1] = got[1]
    if got != want:
        raise AssertionError(f"stages consumed {got}, expected {want}")


def fmt_breakdown(b: dict) -> str:
    return ", ".join(f"{k[:-2]} {b[k]!r}" for k in
                     ("census_s", "stage_wait_s", "patch_s", "resolve_s",
                      "h2d_s", "cache_fill_s"))


def slice_pass(ds, device="cuda") -> dict:
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN, device,
                                   KEY_CAPACITY)
    n_census = ds.unique_keys().shape[0]
    fed = prefetched_feeds()
    sk.reset_launches()
    per_pass = run_passes(ds, table, trainer, PASSES)
    launches = dict(sk.launches)
    steps = sum(m["steps"] for m in per_pass)
    check_prefetched(trainer, fed, steps)
    seconds = sum(m["duration_s"] for m in per_pass)
    samples = sum(m["samples"] for m in per_pass)
    for p, m in enumerate(per_pass):
        log(f"pass {p}: loss {m['loss']!r} auc {m['auc']!r} steps {m['steps']} "
            f"seconds {m['duration_s']!r}; begin_pass {m['begin_s']!r} s, "
            f"end_pass {m['end_s']!r} s")
    log(f"slice pass (overlapped, staged): {steps} steps in {seconds!r} s = "
        f"{steps / seconds!r} steps/s, {samples / seconds!r} samples/s; "
        f"launches {launches}")
    if device == "cuda":
        staged_as_expected(table, per_pass)
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
    return {"launches": launches, "table": table, "trainer": trainer,
            "per_pass": per_pass}


def slice_serial_turn(ds, overlapped: list) -> None:
    """The slice pass once more with the serial pass boundary, beside the
    overlapped run: begin_pass / end_pass seconds and samples/s of each."""
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN, "cuda",
                                   KEY_CAPACITY, overlap=False)
    serial = run_passes(ds, table, trainer, PASSES)
    staged_as_expected(table, serial)
    sk.launches.update(saved)  # not main-path launches
    table.close()
    for label, runs in (("overlapped", overlapped), ("serial", serial)):
        log(f"slice boundary, {label}: begin_pass s "
            f"{[r['begin_s'] for r in runs]}, end_pass s "
            f"{[r['end_s'] for r in runs]}, samples/s "
            f"{[r['samples'] / r['duration_s'] for r in runs]}")
        for p, r in enumerate(runs):
            log(f"  {label} pass {p} begin_pass breakdown (staged "
                f"{r['breakdown']['staged']}): {fmt_breakdown(r['breakdown'])}")


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
    if os.environ.get("PADDLEBOX_TORCH_USE_NATIVE_PARSER") != "0" and \
            ds.parser._native is None:
        raise AssertionError("a dataset loaded without the native parser")
    return ds


def python_parse_check(files, ds) -> float:
    """Load ``files`` once more with the Python parser: its seconds, and
    the block must equal the native parser's ``ds``'s bit for bit."""
    import numpy as np

    os.environ["PADDLEBOX_TORCH_USE_NATIVE_PARSER"] = "0"
    try:
        t0 = time.perf_counter()
        py = load(files, len(files))
        seconds = time.perf_counter() - t0
    finally:
        del os.environ["PADDLEBOX_TORCH_USE_NATIVE_PARSER"]
    a, b = ds._block, py._block
    if py.parser._native is not None or a.n_ins != b.n_ins or not all(
            getattr(a, f).dtype == getattr(b, f).dtype
            and np.array_equal(getattr(a, f), getattr(b, f))
            for f in ("keys", "key_offsets", "dense", "labels")):
        raise AssertionError("native and Python parsers gave different blocks")
    py.close()
    return seconds


def drive_passes(datasets, table, trainer, early: bool = False) -> list:
    """One pass over each dataset, each staging the next dataset's census
    (computed beforehand, untimed): through the trainer's
    ``next_pass_keys`` once the feed is exhausted, as the reference does,
    or with ``early`` by ``table.prepare_pass`` right after begin_pass.
    begin_pass and end_pass are timed to a synchronize; per pass the
    census, the cache's hits and misses (the promotion patch), the evicted
    and written-back rows, the begin_pass breakdown (the card synchronized
    between its phases) and the metrics."""
    import torch

    out = []
    table.boundary_timing = True
    censuses = [ds.unique_keys() for ds in datasets]
    for i, ds in enumerate(datasets):
        census = censuses[i]
        t0 = time.perf_counter()
        table.begin_pass(census)
        torch.cuda.synchronize()
        begin_s = time.perf_counter() - t0
        hits, misses = table.last_cache_hits, table.last_cache_misses
        breakdown = dict(table.last_begin_breakdown)
        nxt = censuses[i + 1] if i + 1 < len(datasets) else None
        if early and nxt is not None:
            table.prepare_pass(nxt)
            nxt = None
        m = trainer.train_from_dataset(ds, table, next_pass_keys=nxt)
        torch.cuda.synchronize()
        native_index_live(table)
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
            breakdown=breakdown,
        ))
    return out


def cached_path(datasets) -> dict:
    """The full-width model with the reference's default HBM cache over
    CACHED_PASSES passes, each over its own Zipf file set, launch counters
    reset just before and read just after; then the same passes without
    the cache, for the boundary numbers beside it, and the cached passes
    with the serial pass boundary and with the stage started right after
    begin_pass (every other run is overlapped and staged by the trainer,
    the defaults).

    Two trained runs differ on the card in the last bits even without the
    cache: the step's index_add_ segment sums add duplicates with atomics in
    an order that changes from run to run, and the difference grows over
    the steps.  So the cached and uncached trained passes are compared once
    more with torch.use_deterministic_algorithms on (index_add_ then sums in
    a fixed order), from the same initial weights, and must be bit-equal:
    losses, keys and every row, the serial cached run included."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    runs = {}
    for label, rows, det, overlap in (
            ("cached", CACHE_ROWS, False, True),
            ("cached serial", CACHE_ROWS, False, False),
            ("cached early stage", CACHE_ROWS, False, True),
            ("uncached", 0, False, True),
            ("cached deterministic", CACHE_ROWS, True, True),
            ("cached serial deterministic", CACHE_ROWS, True, False),
            ("cached early stage deterministic", CACHE_ROWS, True, True),
            ("uncached deterministic", 0, True, True)):
        torch.use_deterministic_algorithms(det)
        try:
            _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                           "cuda", KEY_CAPACITY,
                                           cache_rows=rows, overlap=overlap)
            if label == "cached":
                fed = prefetched_feeds()
                sk.reset_launches()
            per_pass = drive_passes(datasets, table, trainer,
                                    early="early" in label)
            if label == "cached":
                launches = dict(sk.launches)
                check_prefetched(trainer, fed, sum(r["metrics"]["steps"]
                                                   for r in per_pass))
        finally:
            torch.use_deterministic_algorithms(False)
        runs[label] = (per_pass, table, trainer)
        staged_as_expected(table, per_pass, early="early" in label)
        for p, r in enumerate(per_pass):
            m = r["metrics"]
            log(f"{label} pass {p}: census {r['census']}, hits {r['hits']}, "
                f"promotion rows {r['promotion_rows']}, evicted "
                f"{r['evicted']}, written back {r['written_back']}; "
                f"begin_pass {r['begin_s']!r} s, end_pass {r['end_s']!r} s; "
                f"{r['samples_per_s']!r} samples/s; loss {m['loss']!r} "
                f"auc {m['auc']!r} steps {m['steps']}")
            log(f"  {label} pass {p} begin_pass breakdown (staged "
                f"{r['breakdown']['staged']}): {fmt_breakdown(r['breakdown'])}")
    log(f"cached path launches {launches}")
    cached, table, _ = runs["cached"]
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
    det_c, det_ct, _ = runs["cached deterministic"]
    sc = det_ct.state_dict()
    losses_c = [r["metrics"]["loss"] for r in det_c]
    for other in ("uncached deterministic", "cached serial deterministic",
                  "cached early stage deterministic"):
        det_o, det_ot, _ = runs[other]
        so = det_ot.state_dict()
        losses_o = [r["metrics"]["loss"] for r in det_o]
        if (losses_c != losses_o or not np.array_equal(sc["keys"], so["keys"])
                or not np.array_equal(sc["values"], so["values"])
                or [r["metrics"]["auc"] for r in det_c]
                != [r["metrics"]["auc"] for r in det_o]):
            raise AssertionError(
                f"deterministic cached (overlapped) and {other} trained "
                f"passes differ: losses {losses_c} vs {losses_o}")
    noise = float(np.abs(table.state_dict()["values"]
                         - runs["uncached"][1].state_dict()["values"]).max())
    log(f"cached overlapped vs cached serial vs cached early stage vs "
        f"uncached trained passes, deterministic: bit-equal (losses "
        f"{losses_c}, {sc['keys'].shape[0]} rows); without determinism the "
        f"rows differ by up to {noise!r}")
    for label in ("cached", "cached serial", "cached early stage"):
        per_pass = runs[label][0]
        log(f"cached boundary, {label}: begin_pass s "
            f"{[r['begin_s'] for r in per_pass]}, end_pass s "
            f"{[r['end_s'] for r in per_pass]}, samples/s "
            f"{[r['samples_per_s'] for r in per_pass]}")
    for _, t, _ in runs.values():
        if t is not table:
            t.close()
    return {"launches": launches, "table": table}


def persistence_check(datasets) -> None:
    """Under deterministic algorithms, the full-width cached model at the
    defaults (overlapped, staged) with a durable log: two passes, a base
    checkpoint of the card table and tower (checkpoint.py), a third pass.
    A fresh world restored from the checkpoint then trains the third pass
    bit-equal to the uninterrupted run (loss, AUC, every row), and a table
    rebuilt from the log directory holds exactly the store it logged."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.sparse.table import SparseTable

    saved = dict(sk.launches)
    log_dir = os.path.join(WORK_DIR, "log")
    mgr = CheckpointManager(os.path.join(WORK_DIR, "ckpt"))
    torch.use_deterministic_algorithms(True)
    try:
        _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                       "cuda", KEY_CAPACITY,
                                       cache_rows=CACHE_ROWS,
                                       store_log_dir=log_dir)
        drive_passes(datasets[:2], table, trainer)
        t0 = time.perf_counter()
        mgr.save_base("p1", table, *trainer.dense_state())
        save_s = time.perf_counter() - t0
        (last,) = drive_passes(datasets[2:3], table, trainer)
        want = table.state_dict()
        _, fresh, trainer2 = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                        "cuda", KEY_CAPACITY,
                                        cache_rows=CACHE_ROWS, seed=1)
        t0 = time.perf_counter()
        params, opt, meta = mgr.load(fresh, *trainer2.dense_state())
        trainer2.load_dense_state(params, opt)
        load_s = time.perf_counter() - t0
        (again,) = drive_passes(datasets[2:3], fresh, trainer2)
        got = fresh.state_dict()
    finally:
        torch.use_deterministic_algorithms(False)
        sk.launches.update(saved)  # not main-path launches
    ma, mb = last["metrics"], again["metrics"]
    if ((ma["loss"], ma["auc"]) != (mb["loss"], mb["auc"])
            or not np.array_equal(want["keys"], got["keys"])
            or not np.array_equal(want["values"], got["values"])):
        raise AssertionError(
            f"the pass after a checkpoint restore differs from the "
            f"uninterrupted one: loss {mb['loss']} vs {ma['loss']}")
    log(f"checkpoint: base of {meta['n_sparse_rows']} rows saved in "
        f"{save_s!r} s, loaded in {load_s!r} s; the next pass is bit-equal "
        f"to the uninterrupted run (loss {ma['loss']!r}, auc {ma['auc']!r}, "
        f"{got['keys'].shape[0]} rows)")
    fresh.close()
    table.close()  # commits and closes the log
    t0 = time.perf_counter()
    rebuilt = SparseTable(SparseTableConfig(embedding_dim=EMB,
                                            store_log_dir=log_dir), seed=0)
    rebuild_s = time.perf_counter() - t0
    got = rebuilt.state_dict()
    if not (np.array_equal(want["keys"], got["keys"])
            and np.array_equal(want["values"], got["values"])):
        raise AssertionError("a table rebuilt from the durable log differs "
                             "from the store it logged")
    log(f"durable log: a table rebuilt from the log (gen "
        f"{rebuilt._log.gen}) in {rebuild_s!r} s holds the logged store, "
        f"bit-equal ({got['keys'].shape[0]} rows)")
    rebuilt.close()


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
        table.close()
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
    native_index_live(table)
    plan_ms = plan_only(ds.batches(), table.plan_batch, plans_agree)
    t0 = time.perf_counter()
    table.end_pass()
    end_s = time.perf_counter() - t0
    sk.launches.update(saved)  # not main-path launches
    per = {k: v / n * 1e3 for k, v in acc.items()}
    log(f"stages over {n} steps, ms per step: " + ", ".join(
        f"{k} {v!r}" for k, v in per.items())
        + f"; begin_pass {begin_s!r} s, end_pass {end_s!r} s")
    log(f"plan alone over the same {n} batches, ms per step: native "
        f"{plan_ms[True]!r}, numpy {plan_ms[False]!r}; every native plan "
        "agrees with the numpy one (order-free)")


def feed_turns(ds, table, trainer) -> None:
    """The trained uncached table, one more pass each fed serially and with
    the prefetch thread, in turns 0, 2: unsynchronized samples/s of each,
    as slice_pass reports them."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    rates = []
    for turn, depth in enumerate((0, 2)):
        trainer.conf.prefetch_batches = depth
        ds.local_shuffle(seed=PASSES + 1 + turn)
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table)
        torch.cuda.synchronize()
        table.end_pass()
        rates.append(m["samples"] / m["duration_s"])
    trainer.conf.prefetch_batches = 2
    sk.launches.update(saved)  # not main-path launches
    log("feed turns, samples/s of one uncached pass each: serial "
        f"{rates[0]!r}, prefetch 2 {rates[1]!r}")


def plan_only(batches, plan, agree) -> dict:
    """Plan each batch (or group) of ``batches`` with the native and with
    the numpy planner, in turns, timing each call alone; the plans must
    agree.  Returns {native: ms per call}."""
    total = {True: 0.0, False: 0.0}
    n = 0
    try:
        for b in batches:
            plans = {}
            for native in ((True, False) if n % 2 == 0 else (False, True)):
                os.environ["PADDLEBOX_TORCH_USE_NATIVE_PLANNER"] = (
                    "1" if native else "0")
                t0 = time.perf_counter()
                plans[native] = plan(b)
                total[native] += time.perf_counter() - t0
            agree(plans[True], plans[False])
            n += 1
    finally:
        del os.environ["PADDLEBOX_TORCH_USE_NATIVE_PLANNER"]
    return {k: v / max(n, 1) * 1e3 for k, v in total.items()}


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
                      positions=POSITIONS, hot_capacity=HOT_CAPACITY,
                      cache_rows=0, table_kw=None, slot_mask=None,
                      metric_group=None, **trainer_kw):
    """The hybrid arm's table and trainer; ``cache_rows`` > 0 gives the
    per-shard caches (CACHE_ROWS: the reference's default), ``table_kw``
    go to SparseTableConfig (the LR map), ``slot_mask`` and
    ``metric_group`` to the trainer and ``trainer_kw`` to TrainerConfig
    (the dense-sync modes)."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )

    tconf = SparseTableConfig(
        embedding_dim=emb, hbm_cache_rows=cache_rows, placement=placement,
        placement_realize=True, placement_update_interval=1,
        placement_hot_capacity=hot_capacity, **(table_kw or {}),
    )
    mesh = make_mesh(positions, device=device)
    table = ShardedSparseTable(tconf, mesh, seed=0)
    model = CtrDnn(n_slots, tconf.row_width, dense_dim=dense, hidden=hidden,
                   seed=0, device=device)
    return table, MultiChipTrainer(model, tconf, mesh,
                                   TrainerConfig(**trainer_kw),
                                   slot_mask=slot_mask,
                                   metric_group=metric_group)


def drive_hybrid(datasets, table, trainer) -> list:
    """One pass over each dataset, the AUC streams continued, begin_pass
    and end_pass timed to a synchronize; per pass the census, the hot set,
    the host row traffic, each shard's cache hits and misses, the
    begin_pass breakdown and the metrics."""
    import torch

    out, auc = [], None
    censuses = [ds.unique_keys() for ds in datasets]
    for i, ds in enumerate(datasets):
        census = censuses[i]
        t0 = time.perf_counter()
        table.begin_pass(census)
        torch.cuda.synchronize()
        begin_s = time.perf_counter() - t0
        promoted, moved = table.last_promotion_rows, table.last_hot_moved_rows
        shard_hits = list(table.last_shard_hits)
        shard_misses = list(table.last_shard_misses)
        breakdown = dict(table.last_begin_breakdown)
        m = trainer.train_from_dataset(
            ds, table, auc_state=auc,
            next_pass_keys=censuses[i + 1] if i + 1 < len(datasets) else None)
        auc = trainer.last_metric_state
        torch.cuda.synchronize()
        native_index_live(table)
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
            evicted=table.last_evicted_rows, shard_hits=shard_hits,
            shard_misses=shard_misses, breakdown=breakdown,
            staged=breakdown["staged"], begin_s=begin_s,
            end_s=time.perf_counter() - t0,
            samples_per_s=m["samples"] / m["duration_s"], metrics=m,
        ))
    return out


def hybrid_path(datasets) -> dict:
    """The full-width model on POSITIONS positions with the realized hybrid
    placement, launch counters reset just before and read just after; the
    hash placement and the hybrid one again, in turns, for the times; then
    two hybrid runs under torch.use_deterministic_algorithms over all
    HYBRID_PASSES passes (the hot block realizes in the third and changes
    in the fourth), which must be bit-equal, and the hash placement under
    it, over the first three, for the difference."""
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
                fed = prefetched_feeds()
                sk.reset_launches()
            per_pass = drive_hybrid(
                datasets[:3] if label == "hash deterministic" else datasets,
                table, trainer)
            if label == "hybrid":
                launches = dict(sk.launches)
                runs_trainer = trainer
                check_prefetched(trainer, fed, sum(r["metrics"]["steps"]
                                                   for r in per_pass))
        finally:
            torch.use_deterministic_algorithms(False)
        runs[label] = (per_pass, table)
        for p, r in enumerate(per_pass):
            m = r["metrics"]
            log(f"{label} pass {p}: census {r['census']}, n_hot {r['n_hot']}, "
                f"resident hot rows {r['resident']}, hot occurrences routed "
                f"{r['hot_occ']}; host rows in {r['promotion_rows']}, out "
                f"{r['written_back']}, hot rows moved {r['hot_moved_rows']}; "
                f"staged {r['staged']}; "
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
    if len(da) != HYBRID_PASSES or not da[-1]["hot_moved_rows"]:
        raise AssertionError("the deterministic hybrid runs did not reach "
                             "the fourth pass's hot-set change")
    log(f"hybrid deterministic reruns over {len(da)} passes: bit-equal "
        f"({sa['keys'].shape[0]} rows, auc {auc_a}, losses "
        f"{[r['metrics']['loss'] for r in da]}, hot rows moved "
        f"{[r['hot_moved_rows'] for r in da]})")
    dh = runs["hash deterministic"][0]
    diff = [abs(a["metrics"]["loss"] - b["metrics"]["loss"])
            for a, b in zip(da, dh)]
    log(f"hybrid against the hash placement, deterministic, loss "
        f"difference per pass over {len(dh)} passes: {diff}")
    return {"launches": launches, "table": table, "trainer": runs_trainer,
            "datasets": datasets, "det_passes": da, "det_state": sa,
            "per_pass": per_pass}


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
    # the data set as it is: the sharded cached phase drives the same
    # objects next, and an in-place shuffle here changed its fourth pass
    # (ROADMAP C2)
    ds = hybrid["datasets"][-1]
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
    native_index_live(table)
    plan_ms = plan_only(_group_batches(ds.batches(), POSITIONS),
                        table.plan_group, group_plans_agree)
    table.end_pass()
    sk.launches.update(saved)  # not main-path launches
    log(f"hybrid stages over {n} step groups of {POSITIONS} positions, ms per "
        "group: " + ", ".join(f"{k} {v / n * 1e3!r}" for k, v in acc.items()))
    log(f"hybrid plan alone over the same {n} groups, ms per group: native "
        f"{plan_ms[True]!r}, numpy {plan_ms[False]!r}; the plans pull the same "
        "rows")


def prefetch_agreement() -> None:
    """At a small size under deterministic algorithms: two cached
    single-chip passes and three hybrid passes on POSITIONS positions (the
    hot block realizes in the third) with the prefetch thread are bit-equal
    to the same runs fed serially, and launch the kernels as often."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    saved = dict(sk.launches)
    files = write_synth_files(
        os.path.join(WORK_DIR, "small-prefetch"), n_files=2,
        ins_per_file=512, n_sparse_slots=4, vocab_per_slot=80, dense_dim=3,
        seed=9, zipf_a=ZIPF_A,
    )
    ds = PadBoxSlotDataset(make_synth_config(4, 3, 32, 16), read_threads=2)
    ds.set_filelist(files)
    ds.load_into_memory()

    def run(positions, prefetch):
        trconf = TrainerConfig(auc_buckets=1 << 10, prefetch_batches=prefetch)
        if positions:
            tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=0,
                                      placement_update_interval=1,
                                      placement_hot_capacity=64)
            mesh = make_mesh(positions)
            table = ShardedSparseTable(tconf, mesh, seed=5)
            tr = MultiChipTrainer(CtrDnn(4, tconf.row_width, dense_dim=3,
                                         hidden=(16, 8)), tconf, mesh, trconf)
        else:
            tconf = SparseTableConfig(embedding_dim=4, hbm_cache_rows=256)
            table = SparseTable(tconf, seed=5)
            tr = Trainer(CtrDnn(4, tconf.row_width, dense_dim=3,
                                hidden=(16, 8)), tconf, trconf)
        sk.reset_launches()
        fed = prefetched_feeds()
        metrics = []
        for p in range(3 if positions else 2):
            ds.local_shuffle(seed=p)
            table.begin_pass(ds.unique_keys())
            metrics.append(tr.train_from_dataset(ds, table))
            native_index_live(table)
            table.end_pass()
        torch.cuda.synchronize()
        steps = sum(m["steps"] for m in metrics)
        if prefetch:
            check_prefetched(tr, fed, steps)
        return metrics, table.state_dict(), dict(sk.launches)

    torch.use_deterministic_algorithms(True)
    try:
        for positions in (0, POSITIONS):
            (m0, s0, l0), (m2, s2, l2) = run(positions, 0), run(positions, 2)
            if l0 != l2 or not l0["pull_rows"]:
                raise AssertionError(f"launches differ: {l0} {l2}")
            for a, b in zip(m0, m2):
                if ((a["loss"], a["auc"], a["samples"])
                        != (b["loss"], b["auc"], b["samples"])):
                    raise AssertionError(
                        f"prefetched and serial metrics differ "
                        f"({positions} positions): {a} {b}")
            if positions and not m2[-1]["hot_occurrences"]:
                raise AssertionError("the small hybrid run routed nothing hot")
            if not (np.array_equal(s0["keys"], s2["keys"])
                    and np.array_equal(s0["values"], s2["values"])):
                raise AssertionError(f"prefetched and serial tables differ "
                                     f"({positions} positions)")
            log(f"prefetch {positions or 'single-chip'}"
                f"{' positions' if positions else ''}: prefetched run "
                f"bit-equal to the serial one over {len(m0)} passes (losses "
                f"{[m['loss'] for m in m2]}), launches {l2}")
    finally:
        torch.use_deterministic_algorithms(False)
        ds.close()
        sk.launches.update(saved)  # not main-path launches


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
        table.close()
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


# --------------------------------------------------------------------------- #
# phase 5b: the sharded cached path, reshard, dense sync
# --------------------------------------------------------------------------- #
def log_sharded_pass(label: str, p: int, r: dict) -> None:
    m = r["metrics"]
    log(f"{label} pass {p}: census {r['census']}, n_hot {r['n_hot']}, hot "
        f"occurrences routed {r['hot_occ']}; shard hits {r['shard_hits']}, "
        f"misses {r['shard_misses']}; host rows in (promotion) "
        f"{r['promotion_rows']}, out (write-back) {r['written_back']}, "
        f"evicted {r['evicted']}, hot rows moved {r['hot_moved_rows']}; "
        f"begin_pass {r['begin_s']!r} s, end_pass {r['end_s']!r} s; "
        f"{r['samples_per_s']!r} samples/s; loss {m['loss']!r} auc "
        f"{m['auc']!r} steps {m['steps']}")
    log(f"  {label} pass {p} begin_pass breakdown (staged {r['staged']}): "
        f"{fmt_breakdown(r['breakdown'])}")


def sharded_cached_path(hybrid: dict) -> dict:
    """The hybrid path's world at the reference's defaults: the per-shard
    caches on (CACHE_ROWS split over POSITIONS shards), the same
    HYBRID_PASSES Zipf passes, overlapped and staged, the card
    synchronized between the begin_pass phases; launch counters reset just
    before and read just after: all six kernels must launch, the cache's
    three on this path too.  Then the HYBRID_PASSES passes again under
    torch.use_deterministic_algorithms, whose final state_dict must be
    bit-equal to the uncached hybrid run's (hybrid_path), losses and AUC
    too.  Returns the deterministic world, which the reshard phase
    continues."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    datasets = hybrid["datasets"]
    runs = {}
    for label, det in (("sharded cached", False),
                       ("sharded cached deterministic", True)):
        torch.use_deterministic_algorithms(det)
        try:
            table, trainer = make_hybrid_world("cuda", cache_rows=CACHE_ROWS)
            table.boundary_timing = True
            if not det:
                fed = prefetched_feeds()
                sk.reset_launches()
            per_pass = drive_hybrid(datasets, table, trainer)
            if not det:
                launches = dict(sk.launches)
                check_prefetched(trainer, fed, sum(r["metrics"]["steps"]
                                                   for r in per_pass))
        finally:
            torch.use_deterministic_algorithms(False)
        runs[label] = (per_pass, table, trainer)
        for p, r in enumerate(per_pass):
            log_sharded_pass(label, p, r)
    per_pass, table, _ = runs["sharded cached"]
    steps = sum(r["metrics"]["steps"] for r in per_pass)
    log(f"sharded cached path launches {launches} over {steps} step groups "
        f"of {POSITIONS} positions")
    for name in sk.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "sharded cached path")
    if not any(sum(r["shard_hits"]) and r["evicted"] for r in per_pass):
        raise AssertionError("no sharded cached pass had both hits and "
                             "evictions")
    if not (table.hot_resident_keys().shape[0]
            and all(r["hot_occ"] > 0 for r in per_pass[-2:])):
        raise AssertionError("the sharded cached path's hot block did not "
                             "realize and route")
    if not all(math.isfinite(r["metrics"]["loss"]) for r in per_pass):
        raise AssertionError("non-finite loss on the sharded cached path")
    union = np.unique(np.concatenate([ds.unique_keys() for ds in datasets]))
    state = table.state_dict()  # lands the hot block and drains the caches
    if (not np.array_equal(state["keys"], union)
            or not np.isfinite(state["values"]).all()):
        raise AssertionError("the sharded cached table lost keys or holds "
                             "non-finite rows")
    table.close()
    det_pass, det_table, det_trainer = runs["sharded cached deterministic"]
    sd, su = det_table.state_dict(), hybrid["det_state"]
    metrics = [(r["metrics"]["loss"], r["metrics"]["auc"]) for r in det_pass]
    want = [(r["metrics"]["loss"], r["metrics"]["auc"])
            for r in hybrid["det_passes"]]
    if (metrics != want or not np.array_equal(sd["keys"], su["keys"])
            or not np.array_equal(sd["values"], su["values"])):
        raise AssertionError(f"deterministic sharded cached and uncached "
                             f"hybrid runs differ: {metrics} vs {want}")
    log(f"sharded cached vs uncached hybrid, deterministic over "
        f"{len(det_pass)} passes: bit-equal ({sd['keys'].shape[0]} rows, "
        f"losses {[m for m, _ in metrics]})")
    unc = [r["metrics"]["loss"] for r in hybrid["per_pass"]]
    log(f"sharded cached vs uncached hybrid, without deterministic "
        f"algorithms, losses per pass: {[r['metrics']['loss'] for r in per_pass]}"
        f" vs {unc}")
    cpu_agreement(datasets, det_pass, sd, det_table.hot_resident_keys())
    for what, key in (("begin_pass s", "begin_s"), ("end_pass s", "end_s"),
                      ("samples/s", "samples_per_s")):
        log(f"sharded cached boundary: {what} {[r[key] for r in per_pass]}")
    return {"launches": launches, "table": det_table, "trainer": det_trainer,
            "datasets": datasets}


def cpu_agreement(datasets, card_pass, card_state, card_hot) -> None:
    """The sharded cached path at full width on the CPU over the
    deterministic card run's HYBRID_PASSES passes (the hot block realizes
    in the third and changes in the fourth), from the same seeds: each
    shard's hits
    and misses and the hot set equal to the card's, losses within 1e-4
    relative, AUC within 1e-3 and every table row within 1e-4 (the
    tolerances of small_agreement: the two devices sum the tower's
    products in different orders, each step's float32 difference is a few
    ulps and Adam and AdaGrad carry it only a few steps' worth)."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    t0 = time.perf_counter()
    table, trainer = make_hybrid_world("cpu", cache_rows=CACHE_ROWS)
    cpu_pass = drive_hybrid(datasets, table, trainer)
    state, hot = table.state_dict(), table.hot_resident_keys()
    table.close()
    secs = time.perf_counter() - t0
    sk.launches.update(saved)  # the CPU runs the twins; nothing launched
    for p, (g, c) in enumerate(zip(card_pass, cpu_pass)):
        if (g["shard_hits"], g["shard_misses"]) != (c["shard_hits"],
                                                     c["shard_misses"]):
            raise AssertionError(
                f"card/CPU sharded cached pass {p}: shard hits "
                f"{g['shard_hits']} vs {c['shard_hits']}, misses "
                f"{g['shard_misses']} vs {c['shard_misses']}")
        gm, cm = g["metrics"], c["metrics"]
        if not (math.isfinite(cm["loss"]) and math.isclose(
                gm["loss"], cm["loss"], rel_tol=1e-4)
                and abs(gm["auc"] - cm["auc"]) <= 1e-3):
            raise AssertionError(
                f"card/CPU sharded cached pass {p}: loss {gm['loss']} vs "
                f"{cm['loss']}, auc {gm['auc']} vs {cm['auc']}")
    if not (hot.shape[0] and np.array_equal(hot, card_hot)):
        raise AssertionError("card/CPU sharded cached runs realized "
                             "different hot sets")
    if not np.array_equal(state["keys"], card_state["keys"]):
        raise AssertionError("card/CPU sharded cached tables hold different "
                             "keys")
    err = float(np.abs(state["values"] - card_state["values"]).max())
    if err > 1e-4:
        raise AssertionError(f"card/CPU sharded cached table rows differ by "
                             f"{err}")
    torch.cuda.synchronize()
    log(f"sharded cached path at full width, card vs CPU over "
        f"{len(cpu_pass)} passes: shard hits equal "
        f"{[c['shard_hits'] for c in cpu_pass]}, {hot.shape[0]} hot keys "
        f"equal, losses {[g['metrics']['loss'] for g in card_pass]} vs "
        f"{[c['metrics']['loss'] for c in cpu_pass]}, table max abs diff "
        f"{err!r} (CPU run {secs!r} s)")


def reshard_check(sharded: dict) -> None:
    """Under deterministic algorithms, the trained deterministic sharded
    cached table of POSITIONS shards reshards live to 2 at the pass
    boundary and trains the first RESHARD_BATCHES batches of the fourth
    Zipf set on 2 positions; a table rebuilt at 2 shards from its
    state_dict trains the same batches from the same dense state.  Both
    must be bit-equal (state, loss, AUC).  Then 2 -> POSITIONS the same
    way over the first set's.  No kernel builds after a cutover.  Prints
    the rows moved and the reshard seconds."""
    import copy
    import itertools

    import numpy as np
    import torch

    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ops import cuda_build
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_mesh,
    )

    saved = dict(sk.launches)
    live, trainer = sharded["table"], sharded["trainer"]
    datasets = sharded["datasets"]
    tconf = live.conf
    built = sorted(cuda_build.build_log)

    def trainer_on(mesh, dense):
        model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE,
                       hidden=HIDDEN, seed=0, device="cuda")
        tr = MultiChipTrainer(model, tconf, mesh, trainer.conf)
        tr.load_dense_state(*copy.deepcopy(dense))
        return tr

    torch.use_deterministic_algorithms(True)
    try:
        for n_new, full in ((2, datasets[3]), (POSITIONS, datasets[0])):
            ds = _Batches(itertools.islice(full.batches(), RESHARD_BATCHES))
            n_old = live.n_shards
            mesh = make_mesh(n_new, device="cuda")
            dense = copy.deepcopy(trainer.dense_state())
            rebuilt = ShardedSparseTable(tconf, mesh, seed=0)
            rebuilt.load_state_dict(live.state_dict())
            (rb,) = drive_hybrid([ds], rebuilt, trainer_on(mesh, dense))
            moved = live.reshard(mesh)
            secs = live.last_reshard_s
            if moved <= 0 or live.n_shards != n_new:
                raise AssertionError(f"reshard {n_old} -> {n_new} moved "
                                     f"{moved} rows")
            trainer = trainer_on(mesh, dense)
            (lv,) = drive_hybrid([ds], live, trainer)
            log_sharded_pass(f"reshard {n_old}->{n_new} live", 0, lv)
            sa, sb = live.state_dict(), rebuilt.state_dict()
            if ((lv["metrics"]["loss"], lv["metrics"]["auc"])
                    != (rb["metrics"]["loss"], rb["metrics"]["auc"])
                    or not np.array_equal(sa["keys"], sb["keys"])
                    or not np.array_equal(sa["values"], sb["values"])):
                raise AssertionError(f"live reshard {n_old} -> {n_new} and "
                                     "the rebuilt table trained differently")
            rebuilt.close()
            log(f"reshard {n_old} -> {n_new}: {moved} rows moved in "
                f"{secs!r} s; the next pass on {n_new} positions bit-equal "
                f"to a table rebuilt from state_dict ({sa['keys'].shape[0]} "
                f"rows, loss {lv['metrics']['loss']!r})")
    finally:
        torch.use_deterministic_algorithms(False)
        sk.launches.update(saved)  # not main-path launches
    if sorted(cuda_build.build_log) != built:
        raise AssertionError("a kernel was built after a reshard cutover")
    live.close()


def dense_sync_agreement() -> None:
    """The multi-chip trainer's "kstep" (sync_weight_step 4) and "async"
    dense sync at small size (4 positions, a narrow tower, the per-shard
    caches on), two passes each on the card and on the CPU from the same
    initial weights: finite losses, agreement at small_agreement's
    tolerances.  "async" pulls only at the pass ends here
    (sync_weight_step above the pass's 8 step groups): a mid-pass pull
    reads whatever the update thread has applied by then, so only a
    pass-end pull, after the drain, is the same on both devices."""
    import numpy as np

    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config, write_synth_files
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    files = write_synth_files(
        os.path.join(WORK_DIR, "small-dense-sync"), n_files=2,
        ins_per_file=256, n_sparse_slots=4, vocab_per_slot=50, dense_dim=3,
        seed=6, zipf_a=ZIPF_A,
    )
    for mode, sws in (("kstep", 4), ("async", 1000)):
        results = {}
        for device in ("cuda", "cpu"):
            table, trainer = make_hybrid_world(
                device, n_slots=4, dense=3, emb=4, hidden=(16, 8),
                hot_capacity=64, cache_rows=256, sync_dense_mode=mode,
                sync_weight_step=sws, auc_buckets=1 << 12)
            ds = PadBoxSlotDataset(make_synth_config(4, 3, 16, 16),
                                   read_threads=2)
            ds.set_filelist(files)
            ds.load_into_memory()
            metrics = []
            for _ in range(2):
                table.begin_pass(ds.unique_keys())
                metrics.append(trainer.train_from_dataset(ds, table))
                table.end_pass()
            results[device] = (metrics, table.state_dict(),
                               trainer.dense_state()[0])
            trainer.close()
            table.close()
            ds.close()
        (mg, sg, pg), (mc, sc, pc) = results["cuda"], results["cpu"]
        for a, b in zip(mg, mc):
            if not (math.isfinite(a["loss"]) and math.isclose(
                    a["loss"], b["loss"], rel_tol=1e-4)):
                raise AssertionError(f"{mode}: card/CPU loss differ: "
                                     f"{a['loss']} {b['loss']}")
            if abs(a["auc"] - b["auc"]) > 1e-3:
                raise AssertionError(f"{mode}: card/CPU auc differ: "
                                     f"{a['auc']} {b['auc']}")
        err = float(np.abs(sg["values"] - sc["values"]).max())
        dense_err = max(float((pg[k].cpu() - pc[k]).abs().max()) for k in pg)
        if (not np.array_equal(sg["keys"], sc["keys"]) or err > 1e-4
                or dense_err > 1e-4):
            raise AssertionError(f"{mode}: card/CPU tables or towers differ "
                                 f"(rows {err}, tower {dense_err})")
        log(f"dense sync {mode} (sync_weight_step {sws}) card vs CPU: losses "
            f"{[m['loss'] for m in mg]} vs {[m['loss'] for m in mc]}, table "
            f"max abs diff {err!r}, tower {dense_err!r}")
    sk.launches.update(saved)  # not main-path launches


def dense_sync_full(datasets) -> None:
    """The three dense-sync modes at the hybrid world's full width with
    the per-shard caches on (sync_weight_step 4), two passes each over the
    first two Zipf sets, one after another for an in-call comparison of
    samples/s: finite losses; "kstep"'s position copies and their Adam
    states equal after its last sync, with every copy's step count equal
    to the steps taken; "async"'s gradients all applied after the
    pass-end drain, and the device tower equal to the host master."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    sws = 4
    rates = {}
    for mode in ("step", "kstep", "async"):
        table, trainer = make_hybrid_world("cuda", cache_rows=CACHE_ROWS,
                                           sync_dense_mode=mode,
                                           sync_weight_step=sws)
        per_pass = drive_hybrid(datasets, table, trainer)
        for p, r in enumerate(per_pass):
            log_sharded_pass(f"dense sync {mode}", p, r)
        if not all(math.isfinite(r["metrics"]["loss"]) for r in per_pass):
            raise AssertionError(f"non-finite loss in {mode} dense sync")
        steps = trainer.global_step
        if mode == "kstep":
            if steps % sws:
                raise AssertionError(f"kstep ended {steps} steps in, between "
                                     "syncs")
            first, opt0 = trainer.models[0], trainer.optimizers[0]
            for m, opt in zip(trainer.models[1:], trainer.optimizers[1:]):
                for p0, p in zip(first.parameters(), m.parameters()):
                    s0, st = opt0.state[p0], opt.state[p]
                    if not (torch.equal(p0, p)
                            and torch.equal(s0["exp_avg"], st["exp_avg"])
                            and torch.equal(s0["exp_avg_sq"],
                                            st["exp_avg_sq"])
                            and float(st["step"]) == steps):
                        raise AssertionError("kstep copies differ after a "
                                             "sync")
        if mode == "async":
            ad = trainer.async_dense
            if not ad.pushes == ad.applied == steps:
                raise AssertionError(f"async: {ad.pushes} pushes, "
                                     f"{ad.applied} applied, {steps} steps")
            master = ad.pull()
            for name, p in trainer.model.named_parameters():
                if not torch.equal(p.cpu(), torch.from_numpy(master[name])):
                    raise AssertionError(f"async: device {name} differs from "
                                         "the host master after the pass end")
        rates[mode] = [r["samples_per_s"] for r in per_pass]
        trainer.close()
        table.close()
    sk.launches.update(saved)  # not main-path launches
    log(f"dense sync at full width (sync_weight_step {sws}, {steps} steps "
        f"over {len(datasets)} passes): samples/s per pass " + "; ".join(
            f"{mode} {r}" for mode, r in rates.items()))


# --------------------------------------------------------------------------- #
# phase 7: the trainer's step policies
# --------------------------------------------------------------------------- #
class _Batches:
    """A fixed list of batches behind the dataset interface (their keys
    are the census)."""

    def __init__(self, batches):
        import numpy as np

        self._batches = list(batches)
        self._census = np.unique(np.concatenate(
            [b.keys[: b.n_keys] for b in self._batches]))

    def batches(self, drop_last: bool = False):
        return iter(self._batches)

    def unique_keys(self):
        return self._census


def _sync_equal(label, a_state, b_state, a_metrics=(), b_metrics=()):
    """Raise unless two runs' state_dicts and metric tuples are bit-equal."""
    import numpy as np

    if (list(a_metrics) != list(b_metrics)
            or not np.array_equal(a_state["keys"], b_state["keys"])
            or not np.array_equal(a_state["values"], b_state["values"])):
        diff = (float(np.abs(a_state["values"] - b_state["values"]).max())
                if a_state["values"].shape == b_state["values"].shape
                else "shapes differ")
        raise AssertionError(f"{label}: not bit-equal (metrics {a_metrics} "
                             f"vs {b_metrics}, rows max abs diff {diff})")


def _group_ms(ds, k: int) -> list:
    """The first STEP_MS_BATCHES batches of the uncached slice world, every
    feed on the card beforehand: seconds of each group of ``k`` steps
    through ``Trainer._run_group``, to a synchronize (with k > 1: the
    warm-up group, the capture and its first replay, then the replays)."""
    import itertools

    import torch

    from paddlebox_tpu_torch.train.trainer import host_feed

    _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN, "cuda",
                                   KEY_CAPACITY,
                                   trainer_kw=dict(scan_steps=k))
    batches = _Batches(itertools.islice(ds.batches(), STEP_MS_BATCHES))
    table.begin_pass(batches.unique_keys())
    feeds = [trainer._to_device(host_feed(b, table.plan_batch(b)))
             for b in batches.batches()]
    auc, gn = trainer.init_auc(), torch.zeros(2, device="cuda")
    torch.cuda.synchronize()
    out = []
    for i in range(0, len(feeds) // k * k, k):
        t0 = time.perf_counter()
        trainer._run_group(table, feeds[i:i + k], auc, gn)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    table.end_pass()
    table.close()
    return out


def graph_steps(ds, zipf_sets) -> dict:
    """TrainerConfig(scan_steps=GRAPH_K) on the uncached slice world at full
    width: each pass captures the k-step body once as a CUDA graph (after
    an eager warm-up group) and replays it.  Under deterministic
    algorithms the graph run over the first GRAPH_PASSES Zipf sets (32
    steps a pass: a warm-up group and three replays) must be bit-equal to
    the eager run's (state, losses, AUC, grad_norm), with one capture a
    pass and the expected replays; launch counters reset just before the
    graph run and read just after (wrapper calls: eager steps and
    captures; replays run the captured launches again).  Then, without
    deterministic algorithms, one pass of the uncached set each in turns
    eager, graph, graph, eager: samples/s and the host seconds the
    consumer thread spends in the step (dispatch or replay) a step; and
    the synchronized ms per step of each."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    det = {}
    torch.use_deterministic_algorithms(True)
    try:
        for label, k in (("eager", 1), ("graph", GRAPH_K)):
            _, table, trainer = make_world(
                N_SLOTS, DENSE, BATCH, EMB, HIDDEN, "cuda", KEY_CAPACITY,
                trainer_kw=dict(scan_steps=k))
            if k > 1:
                fed = prefetched_feeds()
                sk.reset_launches()
            per_pass = drive_passes(zipf_sets, table, trainer)
            per_pass = [r["metrics"] for r in per_pass]
            torch.cuda.synchronize()
            if k > 1:
                launches = dict(sk.launches)
                groups = sum(m["steps"] // k + m["steps"] % k
                             for m in per_pass)
                check_prefetched_groups(trainer, fed, groups)
            det[label] = (per_pass, table.state_dict(), trainer)
            table.close()
    finally:
        torch.use_deterministic_algorithms(False)
    (pe, se, _), (pg, sg, tg) = det["eager"], det["graph"]
    steps = [m["steps"] for m in pg]
    full = sum(n // GRAPH_K for n in steps)
    if tg.graph_captures != GRAPH_PASSES or tg.graph_replays != full - GRAPH_PASSES:
        raise AssertionError(
            f"graph run: {tg.graph_captures} captures and {tg.graph_replays} "
            f"replays over {GRAPH_PASSES} passes of {steps} steps")
    for name in ("pull_rows", "scatter_add_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the graph path")
    _sync_equal("graph against eager steps, deterministic", sg, se,
                [(m["loss"], m["auc"], m["grad_norm"]) for m in pg],
                [(m["loss"], m["auc"], m["grad_norm"]) for m in pe])
    log(f"graph_steps deterministic: scan_steps {GRAPH_K} over {GRAPH_PASSES} "
        f"passes of {steps} steps bit-equal to eager steps (losses "
        f"{[m['loss'] for m in pg]}); {tg.graph_captures} captures, "
        f"{tg.graph_replays} replays x {GRAPH_K} steps; wrapper launches "
        f"{launches} (eager warm-up and tail steps and the captures; the "
        f"replays launch the captured kernels again)")

    def timed(trainer):
        """Host seconds the consumer spends in _run_group."""
        spent = [0.0]
        inner = trainer._run_group

        def run(*args):
            t0 = time.perf_counter()
            try:
                return inner(*args)
            finally:
                spent[0] += time.perf_counter() - t0
        trainer._run_group = run
        return spent

    turns = []
    for label, k in (("eager", 1), ("graph", GRAPH_K), ("graph", GRAPH_K),
                     ("eager", 1)):
        _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                       "cuda", KEY_CAPACITY,
                                       trainer_kw=dict(scan_steps=k))
        spent = timed(trainer)
        (m,) = run_passes(ds, table, trainer, 1)
        table.close()
        turns.append((label, m["samples"] / m["duration_s"],
                      spent[0] / m["steps"] * 1e3))
    log("graph_steps turns (prefetched passes, no deterministic algorithms): "
        + "; ".join(f"{label} {sps!r} samples/s, step dispatch {ms!r} ms/step"
                    for label, sps, ms in turns))
    eager = _group_ms(ds, 1)
    graph = _group_ms(ds, GRAPH_K)
    e_ms = float(np.median(eager[2:])) * 1e3
    g_ms = float(np.median(graph[2:])) * 1e3 / GRAPH_K
    log(f"graph_steps synchronized step, ms per step: eager {e_ms!r} (median "
        f"of {len(eager) - 2} steps), graph replay {g_ms!r} (median of "
        f"{len(graph) - 2} replays of {GRAPH_K}); warm-up group "
        f"{graph[0] * 1e3!r} ms, capture and first replay "
        f"{graph[1] * 1e3!r} ms")
    return {"launches": launches, "turns": turns}


def check_prefetched_groups(trainer, before: float, groups: int) -> None:
    """Every group of the run since ``before`` (a group of scan_steps feeds,
    or one feed of the tail) came from the producer thread."""
    fed = prefetched_feeds() - before
    if trainer.conf.prefetch_batches != 2 or fed != groups:
        raise AssertionError(f"the producer fed {fed} of {groups} groups")


def _card_and_cpu(batches, label, **trainer_kw) -> tuple:
    """The same batches, one pass from the same seeds, on the card and on
    the CPU: (card metrics, CPU metrics, card state, CPU state)."""
    import numpy as np

    census = _Batches(batches).unique_keys()
    out = {}
    for device in ("cuda", "cpu"):
        _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                       device, KEY_CAPACITY,
                                       trainer_kw=trainer_kw)
        table.begin_pass(census)
        m = trainer.train_steps(table, batches)
        table.end_pass()
        out[device] = (m, table.state_dict())
        table.close()
    (mg, sg), (mc, sc) = out["cuda"], out["cpu"]
    if not (math.isfinite(mg["loss"]) and np.array_equal(sg["keys"], sc["keys"])):
        raise AssertionError(f"{label}: non-finite card loss or other keys")
    return mg, mc, sg, sc


def step_policies(ds) -> None:
    """The step policies at full width on the uncached slice world, over
    the first POLICY_BATCHES batches of its pass, launch counters reset
    just before the skip_batch drive and read just after:
      * skip_batch under deterministic algorithms: a train.nan-poisoned
        batch (in a replayed group) leaves the state of the same run
        without that batch, eagerly and under the graph, bit for bit, and
        the graph run equals the eager one;
      * rollback (under the graph): a poisoned second pass raises
        PassRolledBack, and the table and the dense state equal the first
        pass's checkpoint bit for bit;
      * evaluate leaves the table and the parameters bit-unchanged;
      * a bf16 and an fp16 tower agree with the CPU within the bounds of
        the reference's test_bf16_training_parity (AUC 0.03, loss 0.05),
        and SGD agrees with the CPU within small_agreement's tolerances."""
    import itertools

    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.train import AutoCheckpointer
    from paddlebox_tpu_torch.train.trainer import (
        PassRolledBack,
        opt_state_tensors,
    )
    from paddlebox_tpu_torch.utils import faults
    from paddlebox_tpu_torch.utils.monitor import stats

    batches = list(itertools.islice(ds.batches(), POLICY_BATCHES))
    census = _Batches(batches).unique_keys()
    bad = POLICY_BATCHES - 4  # in the group replayed right after capture
    without = batches[:bad] + batches[bad + 1:]

    def world(**kw):
        _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                       "cuda", KEY_CAPACITY, trainer_kw=kw)
        return table, trainer

    def run(table, trainer, feed, plan=None):
        table.begin_pass(census)
        if plan is None:
            m = trainer.train_steps(table, feed)
        else:
            with faults.fault_plan(plan):
                m = trainer.train_steps(table, feed)
        table.end_pass()
        torch.cuda.synchronize()
        return m, table.state_dict()

    saved = dict(sk.launches)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        sk.reset_launches()
        for label, k in (("eager", 1), ("graph", GRAPH_K)):
            skipped = stats.get("train.nan_skipped_steps")
            table, trainer = world(scan_steps=k, nan_policy="skip_batch")
            runs[label] = run(table, trainer, batches,
                              {"train.nan": f"at:{bad}"})
            if stats.get("train.nan_skipped_steps") - skipped != 1:
                raise AssertionError(f"skip_batch {label}: no step skipped")
            table.close()
            table, trainer = world(scan_steps=k)
            runs[label + " without"] = run(table, trainer, without)
            table.close()
        launches = dict(sk.launches)
    finally:
        torch.use_deterministic_algorithms(False)
    for name in ("pull_rows", "scatter_add_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "step-policy path")
    key = lambda m: (m["loss"], m["auc"], m["steps"], m["count"])
    for label in ("eager", "graph"):
        (ma, sa), (mb, sb) = runs[label], runs[label + " without"]
        _sync_equal(f"skip_batch {label} against the run without the batch",
                    sa, sb, key(ma), key(mb))
    _sync_equal("skip_batch graph against eager", runs["graph"][1],
                runs["eager"][1], key(runs["graph"][0]),
                key(runs["eager"][0]))
    log(f"step_policies skip_batch (deterministic, batch {bad} of "
        f"{POLICY_BATCHES} poisoned): eager and graph runs bit-equal to the "
        f"runs without it and to each other (loss "
        f"{runs['graph'][0]['loss']!r}, {runs['graph'][0]['steps']} steps); "
        f"launches {launches}")

    # rollback, then evaluate, on one world under the graph
    table, trainer = world(scan_steps=GRAPH_K, nan_policy="rollback")
    acp = AutoCheckpointer(os.path.join(WORK_DIR, "acp"), job_id="smoke")
    trainer.checkpointer = acp
    run(table, trainer, batches)
    acp.after_pass(0, table, trainer)
    state0 = table.state_dict()
    dense0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt0 = [t.clone() for t in opt_state_tensors(trainer.optimizer)]
    table.begin_pass(census)
    try:
        with faults.fault_plan({"train.nan": f"at:{bad}"}):
            trainer.train_steps(table, batches)
        raise AssertionError("rollback: the poisoned pass did not roll back")
    except PassRolledBack as e:
        status = e.status
    if table._in_pass or status["next_pass"] != 1:
        raise AssertionError(f"rollback left the pass open or status {status}")
    _sync_equal("rollback against the first pass's checkpoint",
                table.state_dict(), state0)
    for k, v in trainer.model.state_dict().items():
        if not torch.equal(v, dense0[k]):
            raise AssertionError(f"rollback: parameter {k} differs")
    for a, b in zip(opt_state_tensors(trainer.optimizer), opt0):
        if not torch.equal(a.to(b.device), b):
            raise AssertionError("rollback: optimizer state differs")
    table.begin_pass(census)
    live = table.pass_state_dict()
    m_eval = trainer.evaluate(_Batches(batches), table)
    _sync_equal("evaluate", table.pass_state_dict(), live)
    table.end_pass()
    for k, v in trainer.model.state_dict().items():
        if not torch.equal(v, dense0[k]):
            raise AssertionError(f"evaluate changed parameter {k}")
    table.close()
    sk.launches.update(saved)  # the rest are comparison runs
    log(f"step_policies rollback (graph): PassRolledBack to tag "
        f"{status['tag']!r}, table and dense state bit-equal to the "
        f"checkpoint; evaluate: auc {m_eval['auc']!r} over {m_eval['count']} "
        f"instances, table and parameters unchanged")

    short = batches[:POLICY_CPU_BATCHES]
    f32 = _card_and_cpu(short, "float32")
    for name in ("bfloat16", "float16"):
        mg, mc, _, _ = _card_and_cpu(short, name, compute_dtype=name)
        for other, what in ((mc, "CPU " + name), (f32[0], "card float32")):
            if (abs(mg["loss"] - other["loss"]) >= 0.05
                    or abs(mg["auc"] - other["auc"]) >= 0.03):
                raise AssertionError(
                    f"{name} tower on the card: loss {mg['loss']} auc "
                    f"{mg['auc']} against {what} {other['loss']} "
                    f"{other['auc']}")
        log(f"step_policies {name} tower over {len(short)} steps: card loss "
            f"{mg['loss']!r} auc {mg['auc']!r}; CPU loss {mc['loss']!r} auc "
            f"{mc['auc']!r}; card float32 loss {f32[0]['loss']!r}")
    mg, mc, sg, sc = _card_and_cpu(short, "sgd", dense_optimizer="sgd")
    err = float(np.abs(sg["values"] - sc["values"]).max())
    if (not math.isclose(mg["loss"], mc["loss"], rel_tol=1e-4)
            or abs(mg["auc"] - mc["auc"]) > 1e-3 or err > 1e-4):
        raise AssertionError(f"sgd card/CPU: loss {mg['loss']} vs "
                             f"{mc['loss']}, rows differ by {err}")
    log(f"step_policies sgd over {len(short)} steps: card loss "
        f"{mg['loss']!r} vs CPU {mc['loss']!r}, grad_norm {mg['grad_norm']!r}"
        f" vs {mc['grad_norm']!r}, rows max abs diff {err!r}")


def slot_policy(hybrid: dict) -> None:
    """The hybrid world (POSITIONS positions, the realized hot block) with
    a slot mask (slots 12-15 out) and a per-slot LR map (slots 0-3 at
    0.0005, 4-7 at 0.1) over the first SLOT_BATCHES batches of the first
    three Zipf sets (the hot block realizes in the third pass, so
    hot_cold_select runs under the policy), the card under deterministic
    algorithms (run-to-run atomics differ by more than the tolerance over
    three passes), launch counters reset just before and read just after.
    Excluded slots' rows keep zero counters, their initial embeddings and
    g2sum; the card agrees with the same run on the CPU at
    cpu_agreement's tolerances, hot set included."""
    import itertools

    import numpy as np
    import torch

    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.sparse.table import _key_uniform

    datasets = [_Batches(itertools.islice(ds.batches(), SLOT_BATCHES))
                for ds in hybrid["datasets"][:3]]
    mask = tuple(range(N_SLOTS - 4))
    lrs = tuple((s, 0.0005) for s in range(4)) + tuple(
        (s, 0.1) for s in range(4, 8))
    out = {}
    for device in ("cuda", "cpu"):
        saved = dict(sk.launches)
        table, trainer = make_hybrid_world(
            device, table_kw=dict(slot_learning_rates=lrs), slot_mask=mask)
        sk.reset_launches()
        torch.use_deterministic_algorithms(device == "cuda")
        try:
            per_pass = drive_hybrid(datasets, table, trainer)
        finally:
            torch.use_deterministic_algorithms(False)
        launches = dict(sk.launches)
        sk.launches.update(saved)
        out[device] = (per_pass, table.state_dict(),
                       table.hot_resident_keys(), launches)
        table.close()
    (pg, sg, hg, launches), (pc, sc, hc, _) = out["cuda"], out["cpu"]
    for name in ("pull_rows", "scatter_add_rows", "hot_cold_select"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the slot "
                                 "policy path")
    if not (hg.shape[0] and np.array_equal(hg, hc) and pg[-1]["hot_occ"] > 0):
        raise AssertionError("slot policy: the hot block did not realize "
                             "alike on the card and the CPU")
    slot = (sg["keys"].astype(np.int64) - 1) // VOCAB
    out_slots = slot >= N_SLOTS - 4
    init = _key_uniform(sg["keys"][out_slots], seed=0, n_cols=EMB,
                        rng_range=SparseTableConfig().initial_range)
    vals = sg["values"][out_slots]  # [show, clk, embed..., g2sum]
    if (vals[:, :2].any() or vals[:, -1].any()
            or not np.array_equal(vals[:, 2:2 + EMB], init)):
        raise AssertionError("slot policy: an excluded slot's row moved")
    for p, (g, c) in enumerate(zip(pg, pc)):
        gm, cm = g["metrics"], c["metrics"]
        if not (math.isclose(gm["loss"], cm["loss"], rel_tol=1e-4)
                and abs(gm["auc"] - cm["auc"]) <= 1e-3):
            raise AssertionError(f"slot policy card/CPU pass {p}: loss "
                                 f"{gm['loss']} vs {cm['loss']}")
    err = float(np.abs(sg["values"] - sc["values"]).max())
    if not np.array_equal(sg["keys"], sc["keys"]) or err > 1e-4:
        raise AssertionError(f"slot policy card/CPU rows differ by {err}")
    log(f"slot_policy over {len(pg)} passes: launches {launches}; "
        f"{int(out_slots.sum())} rows of the excluded slots untouched; card "
        f"losses {[r['metrics']['loss'] for r in pg]} vs CPU "
        f"{[r['metrics']['loss'] for r in pc]}, {hg.shape[0]} hot keys "
        f"equal, rows max abs diff {err!r}")


# --------------------------------------------------------------------------- #
# the data half: logkey/ins_id parsing, preload, the shuffle group, metric
# groups, field dumps, graph steps with a group, PV merge and the disk spill
# --------------------------------------------------------------------------- #
# the data half's PV batches: at most PV_BATCH page-views a batch (capped by
# BATCH instances); the CPU agreement reruns its first DH_CPU_BATCHES
# batches; the step and batch-assembly times take DH_MS_BATCHES batches
PV_BATCH, DH_CPU_BATCHES, DH_MS_BATCHES = 1024, 8, 24
# the dumped pass's deterministic rerun covers its first DH_RERUN_BATCHES;
# the 4-position pass with the group trains the first DH_HYBRID_BATCHES (8
# step groups)
DH_RERUN_BATCHES, DH_HYBRID_BATCHES = 16, 32
DH_FIELDS = ("cmatch", "rank", "task_labels")


def data_conf(**kw):
    """The data half's feed: the slice's width, the ins_id and logkey
    prefixes, one task label, PV merge with rank_offset."""
    from paddlebox_tpu_torch.data.synth import make_synth_config

    return make_synth_config(
        n_sparse_slots=N_SLOTS, dense_dim=DENSE, batch_size=BATCH,
        max_feasigns_per_ins=64, batch_key_capacity=KEY_CAPACITY,
        parse_ins_id=True, parse_logkey=True, n_task_labels=1,
        enable_pv_merge=True, pv_batch_size=PV_BATCH,
        rank_offset="rank_offset", **kw)


def data_group():
    from paddlebox_tpu_torch.metrics import MetricGroup, MetricSpec

    return MetricGroup([MetricSpec("all"),
                        MetricSpec("cm222", cmatch_values=(222,)),
                        MetricSpec("rank1", rank_values=(1,)),
                        MetricSpec("none", cmatch_values=(999,))])


def data_world(device, group=True, **trainer_kw):
    """The slice's model on the default table (HBM cache on, overlapped
    boundary), with the 4-spec metric group."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    tconf = SparseTableConfig(embedding_dim=EMB)
    table = SparseTable(tconf, seed=0, device=device)
    model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE, hidden=HIDDEN,
                   seed=0, device=device)
    trainer = Trainer(model, tconf, TrainerConfig(**trainer_kw), device=device,
                      metric_group=data_group() if group else None)
    return table, trainer


def data_pass(ds, det: bool, warm_boundary: bool = False,
              **trainer_kw) -> tuple:
    """One pass of a fresh data_world over ``ds`` on the card: (metrics,
    state_dict, trainer).  ``warm_boundary``: then one more begin_pass and
    end_pass of the same census, untrained: a cached boundary that finds
    the cache warm (hits searched and filled, victims admitted)."""
    import torch

    table, trainer = data_world("cuda", **trainer_kw)
    torch.use_deterministic_algorithms(det)
    try:
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table)
        torch.cuda.synchronize()
        table.end_pass()
        if warm_boundary:
            table.begin_pass(ds.unique_keys())
            if not table.last_cache_hits:
                raise AssertionError("the second boundary found no hit")
            table.end_pass()
    finally:
        torch.use_deterministic_algorithms(False)
    state = table.state_dict()
    table.close()
    return m, state, trainer


def check_group_metrics(label: str, m: dict) -> None:
    """``all`` is the primary stream bit for bit; ``none`` counts
    nothing; the filtered streams count strict subsets."""
    if not (m["all/auc"] == m["auc"] and m["all/count"] == m["count"]
            and m["none/count"] == 0.0
            and 0 < m["cm222/count"] < m["count"]
            and 0 < m["rank1/count"] < m["count"]):
        raise AssertionError(f"{label}: metric group {m}")


def _metric_tuple(m: dict) -> tuple:
    return tuple(m[k] for k in ("loss", "auc", "count", "all/auc", "cm222/auc",
                                "rank1/auc", "cm222/count", "grad_norm"))


def _block_meta_equal(a, b) -> bool:
    import numpy as np

    return a.ins_ids == b.ins_ids and all(
        getattr(a, f).dtype == getattr(b, f).dtype
        and np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("keys", "key_offsets", "dense", "labels", "search_ids",
                  "ranks", "cmatches", "task_labels"))


def data_load(files) -> tuple:
    """Preload into memory through the native parser (seconds), and the
    first file with the Python parser, bit-equal."""
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.slot_parser import SlotParser

    ds = PadBoxSlotDataset(data_conf(), read_threads=len(files))
    ds.set_filelist(files)
    t0 = time.perf_counter()
    ds.preload_into_memory()
    ds.wait_preload_done()
    load_s = time.perf_counter() - t0
    if ds.parser._native is None:
        raise AssertionError("the data half loaded without the native parser")
    os.environ["PADDLEBOX_TORCH_USE_NATIVE_PARSER"] = "0"
    try:
        py = SlotParser(data_conf())
        py_block = py.parse_file(files[0])
    finally:
        del os.environ["PADDLEBOX_TORCH_USE_NATIVE_PARSER"]
    native_block = ds.parser.parse_file(files[0])
    if py._native is not None or not _block_meta_equal(native_block, py_block):
        raise AssertionError("native and Python parsers gave different "
                             "logkey blocks")
    return ds, load_s


class _TimedShuffler:
    """A shuffler that adds the seconds its exchange took to ``spent``."""

    def __init__(self, inner, spent: list):
        self.inner, self.spent = inner, spent

    def exchange(self, block):
        t0 = time.perf_counter()
        try:
            return self.inner.exchange(block)
        finally:
            self.spent.append(time.perf_counter() - t0)


def data_shuffle(files, whole) -> tuple:
    """Four datasets of disjoint file pairs exchange their records through
    an InProcessShuffleGroup while they preload: each record lands where
    route_ids says, and the union is the input.  Returns (seconds of the
    group load, the slowest worker's exchange seconds)."""
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.shuffle import InProcessShuffleGroup, route_ids

    group = InProcessShuffleGroup(4)
    spent: list = []
    dss = []
    t0 = time.perf_counter()
    for w in range(4):
        d = PadBoxSlotDataset(data_conf(), read_threads=2)
        d.set_filelist(files[2 * w:2 * w + 2])
        d.shuffler = _TimedShuffler(group.shuffler(w), spent)
        d.preload_into_memory()
        dss.append(d)
    for d in dss:
        d.wait_preload_done()
    group_s = time.perf_counter() - t0
    dest = dict(zip(whole.ins_ids, route_ids(whole, 4).tolist()))
    seen = []
    for w, d in enumerate(dss):
        ids = d._block.ins_ids
        if any(dest[i] != w for i in ids):
            raise AssertionError(f"shuffle worker {w} holds foreign records")
        seen += ids
        d.close()
    if sorted(seen) != sorted(whole.ins_ids):
        raise AssertionError("the shuffle group lost or duplicated records")
    return group_s, max(spent), [len(d._block.ins_ids) for d in dss]


def _data_step_ms(ds) -> dict:
    """Median synchronized ms of one eager step (Trainer._run_group) over
    DH_MS_BATCHES batches, every feed on the card beforehand, in turns
    without and with the metric group's update (one world, the same
    feeds)."""
    import itertools

    import numpy as np
    import torch

    from paddlebox_tpu_torch.train.trainer import host_feed

    table, trainer = data_world("cuda")
    batches = _Batches(itertools.islice(ds.batches(), DH_MS_BATCHES))
    table.begin_pass(batches.unique_keys())
    feeds = [trainer._to_device(host_feed(b, table.plan_batch(b), None,
                                          trainer.metric_group))
             for b in batches.batches()]
    auc, gn = trainer.init_auc(), torch.zeros(2, device=trainer.device)
    gstate = trainer.metric_group.init_state(trainer.device)
    torch.cuda.synchronize()
    out = {}
    for label, group in (("no group", None), ("group", gstate),
                         ("no group 2", None), ("group 2", gstate)):
        times = []
        for f in feeds:
            t0 = time.perf_counter()
            trainer._run_group(table, [f], auc, gn, group)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[label] = float(np.median(times[2:])) * 1e3
    table.end_pass()
    table.close()
    return out


def _batch_ms(ds) -> tuple:
    """Median ms of BatchBuilder.build of DH_MS_BATCHES batches of the
    logkey block, with its ins_id, logkey and task columns and without
    them."""
    import dataclasses

    import numpy as np

    from paddlebox_tpu_torch.data.feed import BatchBuilder

    block = ds._block
    bare = dataclasses.replace(block, ins_ids=None, search_ids=None,
                               ranks=None, cmatches=None, task_labels=None)
    builder = BatchBuilder(ds.conf)
    out = {}
    for label, b in (("fields", block), ("bare", bare), ("fields2", block),
                     ("bare2", bare)):
        times = []
        for i in range(DH_MS_BATCHES):
            ids = np.arange(i * BATCH, (i + 1) * BATCH)
            t0 = time.perf_counter()
            builder.build(b, ids)
            times.append(time.perf_counter() - t0)
        out[label] = float(np.median(times)) * 1e3
    return out


def data_half(files, plain_load_s: float) -> None:
    """The data half at the slice's width on the default table (HBM cache
    on, overlapped boundary), over N_FILES x INS_PER_FILE instances with
    the ins_id and logkey prefixes and a task label:
      * load: preload_into_memory through the native parser (seconds beside
        the uncached set's load without the prefixes), the first file with
        the Python parser bit-equal;
      * shuffle: four datasets of disjoint file pairs through an
        InProcessShuffleGroup: placement by route_ids, the union the input;
      * one pass with the 4-spec metric group (all, cm222, rank1, none) under
        deterministic algorithms; then the same pass with a field dump of
        cmatch, rank and task_labels (scan_steps GRAPH_K set, single steps
        run): one line per instance, the training bit-equal to the
        undumped pass, and a deterministic rerun of its first
        DH_RERUN_BATCHES batches dumps the same first lines;
      * the same pass with scan_steps GRAPH_K (a CUDA graph holding the
        group's masks), bit-equal to the eager pass;
      * the disk spill: preload_into_disk, a pass bit-equal to the
        in-memory one, the spill files gone after release_memory;
      * PV merge: preprocess_instance and a pass of PV batches (pv_batch_size
        PV_BATCH), then one more cached boundary that finds the cache warm;
        the rank_offset the feed carried to the card equals the same
        batches built on a second dataset on the host, and a loop over
        their page-views;
      * the 4-position hybrid world, one pass with the group over the first
        DH_HYBRID_BATCHES batches: ``all`` is the primary stream;
      * the first DH_CPU_BATCHES batches with the group on the card and on
        the CPU, at cpu_agreement's tolerances.
    Launch counters reset before the first card pass and read after the
    hybrid pass: pull_rows and scatter_add_rows launch every eager step,
    gather_slots, scatter_rows and sorted_search at the cached
    boundaries, hot_cold_select on the hybrid pass.  Also the step's
    synchronized ms with and without the group and the batch-assembly ms
    with and without the new columns."""
    import itertools

    import numpy as np

    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.train import trainer as trainer_mod

    marks = [("start", time.perf_counter())]

    def mark(label):
        marks.append((label, time.perf_counter()))

    ds, load_s = data_load(files)
    n_ins = ds.get_memory_data_size()
    log(f"data_half load: {n_ins} instances with ins_id, logkey and a task "
        f"label, preload_into_memory (native parser) {load_s!r} s; the "
        f"uncached set without the prefixes {plain_load_s!r} s; Python "
        f"parser bit-equal on {files[0]}")
    group_s, exchange_s, sizes = data_shuffle(files, ds._block)
    log(f"data_half shuffle: 4 datasets of 2 files each exchanged by "
        f"search_id, group preload {group_s!r} s, exchange {exchange_s!r} s "
        f"(slowest worker); worker sizes {sizes}, placement and union "
        f"checked")
    mark("load, shuffle")
    batch_ms = _batch_ms(ds)
    log(f"data_half batch assembly, ms a batch (median of {DH_MS_BATCHES}, "
        f"two turns): " + ", ".join(f"{k} {v!r}" for k, v in batch_ms.items()))

    sk.reset_launches()
    m_eager, s_eager, _ = data_pass(ds, det=True)
    check_group_metrics("group pass", m_eager)
    dump_dir = os.path.join(WORK_DIR, "dumps")
    dumps = []
    # the pass, then a rerun over its first DH_RERUN_BATCHES batches
    for i, source in enumerate((ds, _Batches(itertools.islice(
            ds.batches(), DH_RERUN_BATCHES)))):
        path = os.path.join(dump_dir, str(i))
        # scan_steps is set: a dumped pass runs one step at a time anyway
        m, s, tr = data_pass(source, det=True, need_dump_field=True,
                             dump_fields_path=path, dump_fields=DH_FIELDS,
                             scan_steps=GRAPH_K)
        if tr.graph_captures:
            raise AssertionError("a dumped pass ran grouped steps")
        with open(os.path.join(path, "dump-0.txt")) as f:
            dumps.append(f.read())
        if i == 0:
            m_dump = m
            _sync_equal("the dumped pass against the undumped pass", s,
                        s_eager, [_metric_tuple(m)], [_metric_tuple(m_eager)])
    n_rerun = dumps[1].count("\n")
    if (dumps[0].count("\n") != n_ins or n_rerun != DH_RERUN_BATCHES * BATCH
            or not dumps[0].startswith(dumps[1])):
        raise AssertionError(
            f"dumps: {dumps[0].count(chr(10))} lines for {n_ins} instances; "
            f"the rerun's {n_rerun} lines are not the pass's first ones")
    first = dumps[0].split("\n", 1)[0].split("\t")
    if not (first[0] == ds._block.ins_ids[0] and first[3].startswith("cmatch:")
            and first[5].startswith("task_labels:")):
        raise AssertionError(f"dump line {first}")
    mark("group and dumped passes")
    m_graph, s_graph, tr_graph = data_pass(ds, det=True, scan_steps=GRAPH_K)
    _sync_equal("graph steps with the group against eager", s_graph, s_eager,
                [_metric_tuple(m_graph)], [_metric_tuple(m_eager)])
    if tr_graph.graph_captures != 1 or tr_graph.graph_replays < 1:
        raise AssertionError(f"graph pass: {tr_graph.graph_captures} captures")
    mark("graph pass")
    spill_dir = os.path.join(WORK_DIR, "spill")
    disk = PadBoxSlotDataset(data_conf(), read_threads=len(files))
    disk.set_filelist(files)
    t0 = time.perf_counter()
    disk.preload_into_disk(spill_dir)
    disk.wait_preload_done()
    spill_s = time.perf_counter() - t0
    m_disk, s_disk, _ = data_pass(disk, det=True)
    _sync_equal("spilled pass against the in-memory pass", s_disk, s_eager,
                [_metric_tuple(m_disk)], [_metric_tuple(m_eager)])
    disk.release_memory()
    if os.listdir(spill_dir):
        raise AssertionError("spill files left after release_memory")
    disk.close()

    mark("spill")
    # PV merge: record the rank_offset each staged feed carried to the card
    carried = []
    stage = trainer_mod.stage_feed

    def recording_stage(host, device):
        dev, ready = stage(host, device)
        if "rank_offset" in dev:
            carried.append(dev["rank_offset"])
        return dev, ready

    ds.preprocess_instance()
    ds.local_shuffle(seed=1)
    trainer_mod.stage_feed = recording_stage
    try:
        # a boundary after the pass searches the warm cache
        m_pv, _, _ = data_pass(ds, det=False, warm_boundary=True)
    finally:
        trainer_mod.stage_feed = stage
    check_group_metrics("PV pass", m_pv)
    host = PadBoxSlotDataset(data_conf(), read_threads=len(files))
    host.set_filelist(files)
    host.load_into_memory()
    host.preprocess_instance()
    host.local_shuffle(seed=1)
    host_batches = list(host.batches())
    if len(carried) != len(host_batches) or m_pv["count"] != n_ins:
        raise AssertionError(f"PV pass: {len(carried)} feeds with rank_offset "
                             f"for {len(host_batches)} batches")
    for b, dev in zip(host_batches, carried):
        if not np.array_equal(dev.cpu().numpy(), b.rank_offset):
            raise AssertionError("a PV feed's rank_offset differs on the card")
    ranked = _pv_loop_check(host, host_batches[:2])
    n_pvs = ds.get_pv_data_size()
    ds.postprocess_instance()
    host.close()

    mark("PV passes")
    table, trainer = make_hybrid_world("cuda", metric_group=data_group())
    (hyb,) = drive_hybrid(
        [_Batches(itertools.islice(ds.batches(), DH_HYBRID_BATCHES))], table,
        trainer)
    table.close()
    launches = dict(sk.launches)
    check_group_metrics("hybrid pass", hyb["metrics"])
    eager_steps = (m_eager["steps"] + m_dump["steps"] + DH_RERUN_BATCHES
                   + m_disk["steps"] + m_pv["steps"])
    if launches["pull_rows"] < eager_steps or \
            launches["scatter_add_rows"] < eager_steps:
        raise AssertionError(f"fewer launches than the {eager_steps} eager "
                             f"steps: {launches}")
    for name in sk.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the data "
                                 "half's paths")
    mark("hybrid pass")
    step_ms = _data_step_ms(ds)
    mark("step ms")
    cpu = data_cpu_agreement(ds)
    mark("CPU agreement")

    sps = lambda m: m["samples"] / m["duration_s"]
    log(f"data_half passes (deterministic, {m_eager['steps']} steps): group "
        f"pass loss {m_eager['loss']!r} auc {m_eager['auc']!r}, cm222 "
        f"{m_eager['cm222/auc']!r} ({m_eager['cm222/count']!r}), rank1 "
        f"{m_eager['rank1/auc']!r} ({m_eager['rank1/count']!r}); bit-equal: "
        f"the dumped pass, the graph pass ({tr_graph.graph_replays} "
        f"replays), the spilled pass")
    log(f"data_half samples/s (deterministic): undumped {sps(m_eager)!r}, "
        f"dumped {sps(m_dump)!r} ({n_ins} lines; a rerun of its first "
        f"{n_rerun} lines equal), graph {sps(m_graph)!r}, spilled "
        f"{sps(m_disk)!r} "
        f"(preload_into_disk {spill_s!r} s); PV pass {sps(m_pv)!r} over "
        f"{n_pvs} page-views in {m_pv['steps']} batches, {ranked} ranked ads "
        f"checked by loop; hybrid pass {hyb['samples_per_s']!r}, all/auc "
        f"{hyb['metrics']['all/auc']!r}")
    log("data_half step, synchronized ms (median of "
        f"{DH_MS_BATCHES - 2}): " + ", ".join(f"{k} {v!r}"
                                              for k, v in step_ms.items()))
    log(f"data_half launches: {launches}; CPU agreement: {cpu}")
    log("data_half seconds: " + ", ".join(
        f"{label} {t - t0!r}" for (_, t0), (label, t) in zip(marks, marks[1:])))
    ds.close()


def _pv_loop_check(ds, batches) -> int:
    """rank_offset of ``batches`` against a plain loop over each batch's
    page-views (an ad sees every ranked ad of its PV, itself included);
    returns the ranked ads checked."""
    import numpy as np

    conf = ds.conf
    block = ds._block
    sid_of = dict(zip(block.ins_ids, block.search_ids.tolist()))
    ranked = 0
    for b in batches:
        n = b.n_real_ins
        sids = [sid_of[i] for i in b.ins_ids]
        want = np.full_like(b.rank_offset, -1)
        ok = [(0 < r <= conf.max_rank) and c in conf.rank_cmatch_filter
              for r, c in zip(b.ranks[:n].tolist(), b.cmatches[:n].tolist())]
        members: dict = {}  # page-view -> its ranked rows, in batch order
        for k in range(n):
            if ok[k]:
                members.setdefault(sids[k], []).append(k)
        for j in range(n):
            want[j, 0] = b.ranks[j] if ok[j] else -1
            if not ok[j]:
                continue
            ranked += 1
            for k in members[sids[j]]:
                m = b.ranks[k] - 1
                want[j, 2 * m + 1] = b.ranks[k]
                want[j, 2 * m + 2] = k
        if not np.array_equal(want, b.rank_offset):
            raise AssertionError("rank_offset differs from the page-view loop")
    return ranked


def data_cpu_agreement(ds) -> str:
    """The first DH_CPU_BATCHES batches with the group, card against CPU
    from the same seeds: loss within 1e-4 relative and every AUC within
    1e-3 (cpu_agreement's tolerances), counts equal."""
    import itertools

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    batches = _Batches(itertools.islice(ds.batches(), DH_CPU_BATCHES))
    out = {}
    saved = dict(sk.launches)
    for device in ("cuda", "cpu"):
        table, trainer = data_world(device)
        table.begin_pass(batches.unique_keys())
        out[device] = trainer.train_steps(table, batches.batches())
        table.end_pass()
        table.close()
    sk.launches.update(saved)  # the CPU runs the twins
    g, c = out["cuda"], out["cpu"]
    for name in ("", "all/", "cm222/", "rank1/"):
        if g[f"{name}count"] != c[f"{name}count"] or abs(
                g[f"{name}auc"] - c[f"{name}auc"]) > 1e-3:
            raise AssertionError(f"data half card/CPU {name}auc "
                                 f"{g[name + 'auc']} vs {c[name + 'auc']}")
    if not math.isclose(g["loss"], c["loss"], rel_tol=1e-4):
        raise AssertionError(f"data half card/CPU loss {g['loss']} vs "
                             f"{c['loss']}")
    return (f"loss {g['loss']!r} vs {c['loss']!r}, auc {g['auc']!r} vs "
            f"{c['auc']!r}, cm222/auc {g['cm222/auc']!r} vs "
            f"{c['cm222/auc']!r}")


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
    # end_pass reads the hit and admitted rows of the pass's working set
    # (_rows_at(full, upd_pos)), a [stage rows, W+1] tensor
    full = torch.randn((table._stage_cap(census.shape[0]), W1), device="cuda",
                       generator=gen)
    upd_pos = torch.from_numpy(
        np.concatenate([plan.hit_pos, upd.admit_pos])).cuda()
    dense = rows[: hits.shape[0]]
    hay, n_real = cache._dev_index
    q = torch.from_numpy(np.ascontiguousarray(census).view(np.int64)).cuda()
    hay_f, q_f = hay ^ sk._SIGN, q ^ sk._SIGN
    q_shuf = q[torch.randperm(q.shape[0], device="cuda", generator=gen)]
    big_t, big_keys = big_haystack(hay[:n_real].cpu().numpy().view(np.uint64),
                                   np.random.default_rng(5), "cuda")
    h, k, nq, c = hits.shape[0], slots.shape[0], q.shape[0], hay.shape[0]
    log(f"cache kernel shapes: {h} hit slots, {k} hit + admit slots "
        f"({upd.victim_slots.shape[0]} victims), {nq} census keys searched in "
        f"{c} ({n_real} real); end_pass reads {upd_pos.shape[0]} of "
        f"{full.shape[0]} working-set rows")
    return {
        # hits are unique slots: each distinct row is read once
        "gather_slots": dict(
            fn=lambda: sk.gather_slots(rows, hits),
            plain=lambda: sk.gather_slots_plain(rows, hits),
            library=lambda: torch.index_select(rows, 0, hits),
            bytes=h * 4 + 2 * h * W1 * 4, ops=0,
            # each distinct sector of the named rows read whole once
            floor_bytes=h * 4 + 32 * touched_sectors(rows, hits) + h * W1 * 4,
            variants={
                "end_pass shape (_rows_at(full, upd_pos))":
                    lambda: sk.gather_slots(full, upd_pos),
                "the same rows' bytes without the slots (a copy of "
                f"{h} contiguous rows)": lambda: dense.clone(),
            },
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
            variants={
                "the census shuffled": lambda: sk.sorted_search(hay, n_real,
                                                                q_shuf),
                f"a haystack of {big_t.shape[0]} keys "
                f"({big_keys.shape[0]} real)":
                    lambda: sk.sorted_search(big_t, big_keys.shape[0], q),
                "the queries' and positions' bytes without the search (the "
                "queries cast to int32)": lambda: q.to(torch.int32),
            },
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
        f"flush): {cold_ms(lambda: one.fill_(1.0), flush)!r} ms; of the "
        f"L2-warm method: {device_ms(lambda: one.fill_(1.0))!r} ms")
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
                f"{cold_ms(fn, flush)!r} ms; L2 warm {device_ms(fn)!r} ms")
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
    from paddlebox_tpu_torch import _native
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
        # the host libraries build with g++ beside the nvcc builds
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            host = [ex.submit(_native.get_lib), ex.submit(_native.get_plan_lib)]
            built = cuda_build.build(sk.KERNELS)
            cuda_s = time.perf_counter() - t0
            host_libs = [h.result() for h in host]
        log(f"build: {cuda_s!r} s for {sorted(built)}")
        for name in built:
            ptxas = [line for line in cuda_build.build_log[name]["log"].splitlines()
                     if "registers" in line or "spill" in line]
            log(f"  {name}: " + " | ".join(ptxas))
        log(f"host libraries: {_native.compiler_version()}; " + ", ".join(
            f"{name} {entry['seconds']!r} s"
            for name, entry in sorted(_native.build_log.items())))
        if any(lib is None for lib in host_libs):
            raise AssertionError("a host library did not build: " + "; ".join(
                f"{k}: {v['log']}" for k, v in _native.build_log.items()))

        t0 = time.perf_counter()
        files, cached_files, logkey_files = write_data()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = load(files, N_FILES)
        load_s = time.perf_counter() - t0
        n_census = ds.unique_keys().shape[0]
        t0 = time.perf_counter()
        cached_ds = [load(fs, CACHED_FILES) for fs in cached_files]
        cached_load_s = time.perf_counter() - t0
        censuses = [d.unique_keys() for d in cached_ds]
        log(f"data: {ds.get_memory_data_size()} instances, {n_census} census "
            f"keys; Zipf sets {[d.get_memory_data_size() for d in cached_ds]} "
            f"instances, censuses {[c.shape[0] for c in censuses]}; written "
            f"in {write_s!r} s")
        py_load_s = python_parse_check(files, ds)
        log(f"load (native parser): {load_s!r} s for the uncached set, "
            f"{cached_load_s!r} s for the Zipf sets; the uncached set with "
            f"the Python parser {py_load_s!r} s, bit-equal blocks")

        def phase(fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            log(f"phase {fn.__name__}: {time.perf_counter() - t!r} s")
            return out

        cuda = torch.device("cuda")
        P = pass_capacity(n_census)
        errs = phase(check_parity, P, cuda)
        errs.update(phase(check_cache_parity, censuses[0], cuda))
        phase(check_shard_cache_parity, censuses[0], cuda)
        errs.update(phase(check_hybrid_parity, cuda))
        res = phase(slice_pass, ds)
        phase(slice_serial_turn, ds, res["per_pass"])
        phase(stage_breakdown, ds, res["table"], res["trainer"], profile)
        phase(feed_turns, ds, res["table"], res["trainer"])
        phase(small_agreement)
        phase(prefetch_agreement)
        cached = phase(cached_path, cached_ds[:CACHED_PASSES])
        phase(lifecycle_check, censuses[:CACHED_PASSES])
        phase(persistence_check, cached_ds[:CACHED_PASSES])
        hybrid = phase(hybrid_path, cached_ds[:HYBRID_PASSES])
        phase(hybrid_stages, hybrid)
        phase(small_hybrid_agreement)
        sharded = phase(sharded_cached_path, hybrid)
        phase(reshard_check, sharded)
        phase(dense_sync_agreement)
        phase(dense_sync_full, cached_ds[:2])
        phase(graph_steps, ds, cached_ds[:GRAPH_PASSES])
        phase(step_policies, ds)
        phase(slot_policy, hybrid)
        phase(data_half, logkey_files, load_s)
        rows = phase(kernel_times, res, ds, cached,
                     censuses[CACHED_PASSES - 1], hybrid, errs)
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
