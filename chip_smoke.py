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
               host libraries from _native/ with g++ and the data files
               (writer processes); print the g++ version, the build times
               and each kernel's registers and spills.
     load    — load the data sets through the native parser (seconds
               printed), and the uncached set's first file once more with
               the Python parser: both times, and the blocks must be
               bit-equal.
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
               breakdown; then the same
               batches planned alone with the native and the numpy planner,
               ms per step of each, and every native plan must agree with
               the numpy one under the reference's order-free equivalence.
     feed    — two more passes of the trained table, fed serially and
               prefetched: samples/s of each.
     prefetch — at a small size under deterministic algorithms, a cached
               single-chip run and a 4-position hybrid run with the prefetch
               thread must be bit-equal to the same runs fed serially.
     criteo  — the Criteo CTR-DNN recipe (BASELINE.json's first
               configuration) at its published widths: 26 hashed
               categorical slots, 13 log1p counts, embedding_dim 8, tower
               512-256-128, batch 2048 (up to 53 248 keys a batch), the
               default HBM cache.  A synthetic Criteo TSV of CRITEO_LINES
               lines (vocab CRITEO_VOCAB a column) is written and converted
               with convert_criteo_files in a process of its own beside the
               build; the shards load with criteo_feed_config through the
               native parser.  CRITEO_PASSES passes on the card, the launch
               counters reset just before and read just after (every kernel
               of the cached path must launch), then the same passes on the
               CPU from the same seeds, the dense side under SGD: losses
               within 1e-4 relative, AUC within 1e-3, equal keys and every
               table row within 1e-4 (small_agreement's bounds), the
               feature count equal to the census.  Write, convert and load
               seconds, begin_pass / end_pass seconds and samples/s a pass,
               the launches, beside the card's name and power limit.
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
               and agree with the same passes on the CPU; that run writes
               an events file whose pass_end records must carry the
               cache, placement and census metrics.
     reshard — under deterministic algorithms, that table resharded live
               from POSITIONS to 2 shard positions at the pass boundary
               and trained RESHARD_BATCHES more batches, then back to
               POSITIONS: each pass bit-equal to a table rebuilt from
               state_dict at the new count, no kernel built after a
               cutover; rows moved and seconds printed.
     multiprocess — the sharded world as a job of processes, each rank
               this script run as its own rank program (``--rank``)
               through paddlebox_tpu_torch.launch: (a) 2 ranks x 2
               positions on the one card over gloo, all four passes under
               deterministic algorithms bit-equal to the sharded phase's
               deterministic one-process run (loss, AUC, counts, both
               ranks' dense state, the union of their stores), all six
               kernels launched in each rank; (d) then, in the same job, a
               pass under a MP_DEADLINE_S liveness deadline whose first
               step rank 1 freezes: both ranks must exit with the
               DistributedStallError naming rank 1 in stage 'step' within
               twice the deadline; (e) rank 0's log carries the merged
               fleet view at each pass end; (f) in arm (a)'s job, each
               rank loads half of the data half's logkey files through a
               TcpShuffler on loopback (ports published through the job's
               store): the union of the two blocks is the input record for
               record, and each block is bit-equal to an
               InProcessShuffleGroup worker's of the same mode and seed;
               exchange bytes and seconds; (g) then the trained table
               resharded live across the two ranks, POSITIONS -> 2 -> POSITIONS,
               a pass of RESHARD_BATCHES after each cutover: the pass
               metrics and the union of the ranks' stores bit-equal to
               reshard's one-process run; rows moved, KvChannel bytes and
               last_reshard_s; (b) 1 rank x 4 positions on
               NCCL through the process-group path, started beside (a)
               and training after it, MP_NCCL_PASSES passes bit-equal; (c)
               NCCL across cards where there are 2 (else one line says it
               was not run).  Samples/s against the one-process run, ms
               and bytes a step of each collective kind, the plan
               channel's gather ms and the plan and feed stages per rank,
               beside the card's name and power limit.
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
  8. zoo     — the ranking model zoo (model_zoo) at the slice's width with
               bench.py's model widths: the row kernels bit-exact against
               their twins at the new row widths 11, 13 and 18 (the cache
               kernels at 12, 14 and 19) and pull_rows / scatter_add_rows
               timed at widths 10, 11 and 13; DeepFM, WideDeep, XDeepFM,
               DCN and CtrDnn's expand_dim and slot_embed_dims options
               two passes over the first ZOO_ARM_BATCHES batches of the
               first two Zipf sets, MMoE, RankCtrDnn (PV-merged) and the
               conv CtrDnn (counter_label_tasks on a cvm_offset 3 table:
               its conv counters equal a host count of the task labels)
               two passes over the first ZOO_ARM_BATCHES batches of the
               first ZOO_LOGKEY_FILES logkey files, on the default table;
               MMoE and RankCtrDnn on the hybrid world over three passes of
               ZOO_MC_BATCHES batches; launch counters reset just before these
               arms and read just after (all six kernels must launch);
               every arm card against CPU, and every single-chip arm's
               scan_steps GRAPH_K graph bit-equal to eager steps under
               deterministic algorithms.  Samples/s, loss, AUC and the
               per-task AUCs of every pass.
  8b. axes   — this slice's models and parallel axes (parallel_axes) at
               the slice's width: TwoTower under RetrievalTrainer, eager
               and as a CUDA graph (timed over a Zipf set, then over two
               under deterministic algorithms, bit-equal), and evaluate;
               LongSeqCtrDnn on a
               behaviour-sequence set with full attention and on 4 seq
               positions with ring and Ulysses attention; PipelinedCtrDnn
               on 4 pipe positions (f32 and bf16) beside CtrDnn; MMoE on 4
               expert positions beside the serial bank; MMoE and the ring
               LongSeqCtrDnn on composed 4 x 2 meshes of the hybrid world
               over three passes of ZOO_MC_BATCHES batches beside data-only
               runs (counters bit-equal,
               loss within 5e-3, AUC within 2e-2); launch counters reset
               before these arms and read after (all six kernels must
               launch); then each sharded model's forward against its
               serial twin, every arm's first batches card against CPU and
               sharded against serial, the row kernels at the sequence
               set's key capacity, PipelineTrainer's gradient against the
               sequential oracle's, the aux tables card against host, and
               synchronized ms a step of the three attentions.
  9. times   — the CUDA kernels one call of each wrapper launches (from
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
  9b. serving — the serving plane (serving): the slice pass's trained
               table (1 570 824 keys) and tower exported in fp32, int8 and
               fp8 with a second shape bucket; the launch counters reset
               just before every batch of one pass goes through the card
               Predictor and read just after (sorted_search and
               gather_slots must launch); both kernels bit-exact against
               their twins at the serving shapes; predict against the
               trainer's forward and the CPU Predictor, each quantized
               artifact against the fp32 program fed its dequantized rows;
               a ScoringServer's /score equal to predict for one and for 8
               concurrent clients; an ANN index of parallel_axes' TwoTower
               table behind /retrieve.  Export seconds and bytes, load
               seconds, predict ms by part, requests/s with p50 and p99,
               queries/s.
 9c. fleet  — the serving fleet (fleet_spawn before the scenarios phase,
               so the replicas start beside it, then fleet): ``python -m
               paddlebox_tpu_torch.serve --replicas FLEET_REPLICAS`` on
               the card over the serving phase's fp32 slice artifact, each
               replica's start time; the router's /score replies to the
               serving phase's requests of SERVE_INS lines within
               SERVE_RTOL / SERVE_ATOL of the card Predictor's scores, from
               both replicas; requests/s, p50 and p99 through the router
               and straight to a replica at 1 and 8 clients, beside the
               serving phase's direct server; a replica SIGKILLed while
               FLEET_CLIENTS clients send: no request fails, the
               supervisor restarts the victim and the router fails over
               and readmits it; a SIGTERM stops the fleet and its
               replicas.  Beside it an in-process supervisor of one
               replica under deterministic algorithms: the autoscaler's
               scale_up (during the chaos), replies from both replicas
               bit-equal to the card Predictor's under deterministic
               algorithms, one drained scale_down.
 9d. scenarios — at the slice's width on the card (scenarios): (a) a
               MultiScenarioTrainer of a CtrDnn ranker (bench widths) and
               TwoTower retrieval (parallel_axes' widths) over one default
               table, 2 passes of SCEN_BATCHES batches a scenario (every
               step launches pull_rows and scatter_add_rows), and card
               against CPU over 1 batch a scenario; (b) the day loop's
               TwoPhaseTrainer (join over half the slots, then update) over
               2 passes, scan_steps GRAPH_K as a CUDA graph a phase
               bit-equal to eager steps under deterministic algorithms,
               card against CPU over 1 batch, and once with mesh= on
               POSITIONS positions; (c) AucRunner over 2 slot groups on a
               Zipf set's first file, the update tower and table trained a
               pass, per-group AUC and delta card against CPU.
 9e. online — the online loop (online) on the slice world with the
               default cache: (a) under deterministic algorithms the
               mini-pass replay of the first 2 windows (8 batches each, cut
               by count) equals one pass over the same records bit for bit
               (state dict, delta, AUC); then a writer thread lands the
               slice pass's records as shards in a stream directory, a
               TailingFileSource and the mini-pass scheduler cut windows of
               8 batches, a StreamingTrainer trains them on the card, and a
               DeadlinePublishPolicy publishes to a local root (a warm fp32
               base, then sparse row deltas; the hot pattern's and a last
               one after the drain with their re-exported programs); a card
               ScoringServer's Syncer hot-applies each one, its applied_seq
               closing the freshness loop; the launch counters reset just
               before the loop and read after.  (b) after the drain, the
               final publish and sync, the served rows (host copy and card)
               equal the table's bit for bit, and a pass of batches scores
               as a Predictor exported from the final table within 1e-5
               relative + 1e-6; (c) with the counters reset, serving
               launches sorted_search and gather_slots once a batch, both
               bit-exact against their twins at the haystack after the last
               delta; (d) the hot probe's served score rises after windows
               of the hot pattern labelled 1 and falls after windows
               labelled 0 (bounds ONLINE_RISE, ONLINE_DROP); (e) a corrupted
               delta takes the full reload while 4 clients score, none
               failing; (f) every window launches pull_rows and
               scatter_add_rows.  Records/s, seconds a window and its
               boundary, stream.freshness_seconds p50 and p99, publish_delta
               s and bytes, the Syncer's apply split into fetch, merge,
               upload and swap, and predict ms after a delta, each beside
               the card's name and power limit.
 10. telemetry — the telemetry plane on the default table (telemetry_path):
               two traced passes with an events path and a /metrics
               listener (trace spans, a scrape during the second pass,
               one pass_end record a pass, no health alert, no compile
               event in the second pass), bit-equal to the same passes
               without telemetry (their step groups CUDA graphs, one
               train.scan compile a pass); a profiled pass whose
               torch.profiler trace names the pull_rows and
               scatter_add_rows kernels, and the device's busy share in
               it and in a prefetched default pass; samples/s of default
               and telemetry passes in turns; tools/pbox_doctor.py on the
               phase's trace, event and flight files.
               It runs last: a torch.profiler window opened after its
               device traces listed no CUDA kernel among its events.
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
# batches and one partial per pass), 2 passes (3 until the serving phase
# came; the second pass is the first that consumes a stage).
N_FILES, INS_PER_FILE, PASSES = 8, 25_000, 2

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
# Depth cut since the serving phase: the hash placement beside the hybrid
# one (timed, and deterministic for the loss difference) over the first
# HASH_PASSES Zipf sets (4 and 3 before; 2 before the fleet and scenarios
# phases)
HASH_PASSES = 1

# The step policies: scan_steps GRAPH_K (a CUDA graph of 8 steps) on the
# uncached slice world, against eager steps over GRAPH_PASSES Zipf sets,
# timed in turns over the uncached set, and synchronized over its first
# STEP_MS_BATCHES; the NaN policies and evaluate over its first
# POLICY_BATCHES batches (two groups of 8: the warm-up and the captured
# one), the compute dtypes and SGD card against CPU over
# POLICY_CPU_BATCHES; the slot policy over the first SLOT_BATCHES batches
# of three Zipf sets (2 step groups of the 4 positions a pass).
# (GRAPH_PASSES 1 since the fleet and scenarios phases, 2 before)
GRAPH_K, GRAPH_PASSES, STEP_MS_BATCHES = 8, 1, 24
# Depth cuts since the multiprocess phase: the stage breakdown, the feed
# turns and graph_steps' eager and graph turns over the first
# TURN_BATCHES batches of the uncached set (all 98 before it, 49 before
# the online phase); since the online phase graph_steps' synchronized ms
# a step over STEP_MS_BATCHES (48 before); since the fleet and scenarios
# phases 24 (32 before)
TURN_BATCHES = 24
POLICY_BATCHES, POLICY_CPU_BATCHES, SLOT_BATCHES = 16, 2, 8
# Depth cut since the online phase: the sharded cached path against the
# CPU over the first CPU_AGREE_BATCHES batches of each Zipf set (2 step
# groups a pass; the whole sets before)
CPU_AGREE_BATCHES = 2 * POSITIONS
# Depth cut to keep the run's phases near 350 s since the data half: the
# passes after a live reshard train the first RESHARD_BATCHES batches of
# their Zipf set (of 32)
RESHARD_BATCHES = 16

# The Criteo phase: the recipe of examples/train_criteo_torch.py (and
# BASELINE.json's first configuration) on a synthetic Criteo TSV of
# CRITEO_LINES lines, CRITEO_VOCAB tokens a categorical column (about 1.2
# million census keys): 32 steps of 2048 a pass, CRITEO_PASSES passes (the
# second the cache's warm boundary); the dense side under SGD at
# ZOO_CPU_SGD_LR for the card against the CPU.
CRITEO_LINES, CRITEO_VOCAB, CRITEO_PASSES, CRITEO_SEED = 65_536, 100_000, 2, 17

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
    out_dir, ins, seed, zipf_a, logkey, seq_keys = args
    import numpy as np

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
    if seq_keys:
        # slot0 (after "1 <click>") becomes a behaviour sequence of 1 to
        # seq_keys keys of its own vocabulary; the click keeps the signal
        # of the other slots
        rng = np.random.default_rng(seed)
        with open(path) as f:
            lines = f.read().splitlines()
        with open(path, "w") as f:
            for line in lines:
                tok = line.split(" ")
                m = int(rng.integers(1, seq_keys + 1))
                tok[2:3 + int(tok[2])] = [str(m), *map(
                    str, rng.integers(1, VOCAB + 1, size=m).tolist())]
                f.write(" ".join(tok) + "\n")
    return path


def write_data() -> tuple:
    """Synthetic files, one writer process per file (spawned, so no child
    inherits a CUDA context): the uncached path's N_FILES, CACHED_FILES per
    Zipf file set, the data half's DH_FILES with the ins_id and logkey
    prefixes and a task label, and the sequence arm's SEQ_FILES whose slot0
    holds sequences of up to SEQ_T keys.  Returns (files, [files of each set], logkey
    files, sequence files)."""
    jobs = [(os.path.join(WORK_DIR, f"w{i}"), INS_PER_FILE, 7 + i, 0.0, False,
             0) for i in range(N_FILES)]
    for p in range(ZIPF_SETS):
        jobs += [(os.path.join(WORK_DIR, f"z{p}-{i}"), CACHED_INS_PER_FILE,
                  100 + CACHED_FILES * p + i, ZIPF_A, False, 0)
                 for i in range(CACHED_FILES)]
    jobs += [(os.path.join(WORK_DIR, f"l{i}"), INS_PER_FILE, 300 + i, 0.0,
              True, 0) for i in range(DH_FILES)]
    jobs += [(os.path.join(WORK_DIR, f"s{i}"), SEQ_INS_PER_FILE, 400 + i, 0.0,
              False, SEQ_T) for i in range(SEQ_FILES)]
    ctx = multiprocessing.get_context("spawn")
    workers = min(len(jobs), os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        paths = list(ex.map(_write_part, jobs))
    per_pass = [paths[N_FILES + CACHED_FILES * p:
                      N_FILES + CACHED_FILES * (p + 1)]
                for p in range(ZIPF_SETS)]
    logkey_end = N_FILES + CACHED_FILES * ZIPF_SETS + DH_FILES
    return (paths[:N_FILES], per_pass, paths[logkey_end - DH_FILES:logkey_end],
            paths[logkey_end:])


def _criteo_part(out_dir: str) -> tuple:
    """The Criteo TSV written and converted (a process of its own):
    (shards, write seconds, convert seconds)."""
    from paddlebox_tpu_torch.data.criteo import (
        convert_criteo_files,
        write_criteo_format_sample,
    )

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    tsv = write_criteo_format_sample(
        os.path.join(out_dir, "sample.tsv"), n_lines=CRITEO_LINES,
        seed=CRITEO_SEED, vocab_per_cat=CRITEO_VOCAB)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = convert_criteo_files([tsv], os.path.join(out_dir, "slots"),
                                  batch_size=BATCH)
    return shards, write_s, time.perf_counter() - t0


def write_criteo() -> tuple:
    """_criteo_part in a spawned process (no CUDA context to inherit)."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as ex:
        return ex.submit(_criteo_part,
                         os.path.join(WORK_DIR, "criteo")).result()


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
    # depth cut since the fleet and scenarios phases: the serial turn over
    # the first pass (PASSES before)
    serial = run_passes(ds, table, trainer, 1)
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


def criteo(crit: tuple, card: str) -> None:
    """The Criteo CTR-DNN recipe at its published widths on the card and
    on the CPU (see the module docstring): CRITEO_PASSES passes each,
    counters reset just before the card's and read just after; held card
    against CPU at small_agreement's bounds."""
    import numpy as np

    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.data.criteo import (
        CRITEO_N_CAT,
        CRITEO_N_DENSE,
        criteo_feed_config,
    )
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    shards, write_s, convert_s = crit
    conf = criteo_feed_config(BATCH)
    t0 = time.perf_counter()
    ds = PadBoxSlotDataset(conf, read_threads=4)
    ds.set_filelist(shards)
    ds.load_into_memory()
    load_s = time.perf_counter() - t0
    if ds.parser._native is None:
        raise AssertionError("the Criteo shards loaded without the native "
                             "parser")
    census = ds.unique_keys()
    n = ds.get_memory_data_size()
    steps = -(-n // BATCH)
    if conf.batch_key_capacity != BATCH * CRITEO_N_CAT or steps != 32:
        raise AssertionError(f"Criteo feed: {conf.batch_key_capacity} keys "
                             f"a batch, {steps} steps a pass")
    log(f"criteo data: {n} lines in {len(shards)} shard(s), {census.shape[0]} "
        f"census keys; written in {write_s!r} s and converted in "
        f"{convert_s!r} s (a process beside the build), loaded in {load_s!r} "
        f"s (native parser)")
    saved = dict(sk.launches)
    runs = {}
    for device in ("cuda", "cpu"):
        tconf = SparseTableConfig(embedding_dim=EMB)
        if tconf.hbm_cache_rows != CACHE_ROWS:
            raise AssertionError(f"default cache {tconf.hbm_cache_rows} rows")
        table = SparseTable(tconf, seed=0, device=device)
        model = CtrDnn(CRITEO_N_CAT, tconf.row_width, dense_dim=CRITEO_N_DENSE,
                       hidden=HIDDEN, seed=0, device=device)
        trainer = Trainer(model, tconf, TrainerConfig(
            auc_buckets=1 << 16, dense_optimizer="sgd",
            dense_lr=ZOO_CPU_SGD_LR), device=device)
        fed = prefetched_feeds()
        sk.reset_launches()
        t0 = time.perf_counter()
        per_pass = run_passes(ds, table, trainer, CRITEO_PASSES)
        secs = time.perf_counter() - t0
        launches = dict(sk.launches)
        check_prefetched(trainer, fed, sum(m["steps"] for m in per_pass))
        staged_as_expected(table, per_pass)
        if table.missing_key_count or table.n_features != census.shape[0]:
            raise AssertionError(
                f"criteo on {device}: the table holds {table.n_features} of "
                f"{census.shape[0]} census keys, {table.missing_key_count} "
                "missing")
        state = table.state_dict()
        table.close()
        if not np.isfinite(state["values"]).all():
            raise AssertionError(f"criteo on {device}: non-finite rows")
        for p, m in enumerate(per_pass):
            if not (math.isfinite(m["loss"]) and 0.0 < m["auc"] < 1.0
                    and m["count"] == n and m["steps"] == steps):
                raise AssertionError(f"criteo on {device} pass {p}: {m}")
            log(f"criteo {device} pass {p}: loss {m['loss']!r} auc "
                f"{m['auc']!r} steps {m['steps']}; begin_pass "
                f"{m['begin_s']!r} s, end_pass {m['end_s']!r} s, "
                f"{m['samples'] / m['duration_s']!r} samples/s; begin_pass "
                f"breakdown (staged {m['breakdown']['staged']}): "
                f"{fmt_breakdown(m['breakdown'])}")
        log(f"criteo {device}: {CRITEO_PASSES} passes in {secs!r} s"
            + (f"; launches {launches}" if device == "cuda" else ""))
        runs[device] = (per_pass, state, launches)
    sk.launches.update(saved)  # a path of its own, not the main path's
    ds.close()
    (pg, sg, launches), (pc, sc, _) = runs["cuda"], runs["cpu"]
    for name in ("pull_rows", "scatter_add_rows", "gather_slots",
                 "scatter_rows", "sorted_search"):
        if launches[name] <= 0:
            raise AssertionError(f"criteo: kernel {name} never launched")
    for p, (a, b) in enumerate(zip(pg, pc)):
        if not (math.isclose(a["loss"], b["loss"], rel_tol=1e-4)
                and abs(a["auc"] - b["auc"]) <= 1e-3):
            raise AssertionError(
                f"criteo card/CPU pass {p}: loss {a['loss']} vs {b['loss']}, "
                f"auc {a['auc']} vs {b['auc']}")
    if not np.array_equal(sg["keys"], sc["keys"]):
        raise AssertionError("criteo card/CPU tables hold different keys")
    err = float(np.abs(sg["values"] - sc["values"]).max())
    if err > 1e-4:
        raise AssertionError(f"criteo card/CPU table rows differ by {err}")
    log(f"criteo card vs CPU: losses {[m['loss'] for m in pg]} vs "
        f"{[m['loss'] for m in pc]}, AUC {[m['auc'] for m in pg]} vs "
        f"{[m['auc'] for m in pc]}, {sg['keys'].shape[0]} keys equal, table "
        f"max abs diff {err!r}; {card}")


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


def stage_breakdown(ds, table, trainer) -> None:
    """One more pass, its first TURN_BATCHES batches driven stage by stage
    with a synchronize after each, so the host stages and the device step
    can be told apart (the device's busy share and its time by kernel come
    from telemetry_path's device traces)."""
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
    batches = itertools_head_iter(ds.batches(), TURN_BATCHES)
    n = 0
    while True:
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
    native_index_live(table)
    plan_ms = plan_only(itertools_head_iter(ds.batches(), TURN_BATCHES),
                        table.plan_batch, plans_agree)
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
    """The trained uncached table, one more pass of the first TURN_BATCHES
    batches each fed serially and with the prefetch thread, in turns 0, 2:
    unsynchronized samples/s of each, as slice_pass reports them."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    rates = []
    for turn, depth in enumerate((0, 2)):
        trainer.conf.prefetch_batches = depth
        ds.local_shuffle(seed=PASSES + 1 + turn)
        head = _Batches(itertools_head_iter(ds.batches(), TURN_BATCHES))
        table.begin_pass(head.unique_keys())
        m = trainer.train_from_dataset(head, table)
        torch.cuda.synchronize()
        table.end_pass()
        rates.append(m["samples"] / m["duration_s"])
    trainer.conf.prefetch_batches = 2
    sk.launches.update(saved)  # not main-path launches
    log(f"feed turns, samples/s of {TURN_BATCHES} uncached batches each: "
        f"serial {rates[0]!r}, prefetch 2 {rates[1]!r}")


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
    begin_pass breakdown, the metrics and the dense state's digest."""
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
            dense_digest=_dense_digest(trainer.model),
        ))
    return out


def hybrid_path(datasets) -> dict:
    """The full-width model on POSITIONS positions with the realized hybrid
    placement, launch counters reset just before and read just after; the
    hash placement once, for the times (a second pair of turns, hash and
    hybrid again, was cut to make room for telemetry_path); then
    two hybrid runs under torch.use_deterministic_algorithms over all
    HYBRID_PASSES passes (the hot block realizes in the third and changes
    in the fourth), which must be bit-equal (losses, AUC, the dense state
    a pass and the table), and the hash placement under it, over the
    first HASH_PASSES, for the difference."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    runs = {}
    for label, placement, det in (("hybrid", "loopback", False),
                                  ("hash", "hash", False),
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
                datasets[:HASH_PASSES] if label.startswith("hash")
                else datasets, table, trainer)
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
    key = lambda r: (r["metrics"]["loss"], r["metrics"]["auc"],
                     r["dense_digest"])
    got_a, got_b = [key(r) for r in da], [key(r) for r in db]
    if (got_a != got_b or not np.array_equal(sa["keys"], sb["keys"])
            or not np.array_equal(sa["values"], sb["values"])):
        raise AssertionError(f"deterministic hybrid reruns differ: {got_a} "
                             f"vs {got_b}")
    auc_a = [r["metrics"]["auc"] for r in da]
    if len(da) != HYBRID_PASSES or not da[-1]["hot_moved_rows"]:
        raise AssertionError("the deterministic hybrid runs did not reach "
                             "the fourth pass's hot-set change")
    log(f"hybrid deterministic reruns over {len(da)} passes: bit-equal "
        f"({sa['keys'].shape[0]} rows, auc {auc_a}, losses "
        f"{[r['metrics']['loss'] for r in da]}, dense state a pass, hot rows "
        f"moved {[r['hot_moved_rows'] for r in da]})")
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

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.config import TelemetryConfig

    datasets = hybrid["datasets"]
    runs = {}
    events_path = os.path.join(WORK_DIR, "sharded-events.jsonl")
    for label, det in (("sharded cached", False),
                       ("sharded cached deterministic", True)):
        torch.use_deterministic_algorithms(det)
        try:
            # the deterministic arm writes its pass_end records
            kw = ({"telemetry": TelemetryConfig(events_path=events_path)}
                  if det else {})
            table, trainer = make_hybrid_world("cuda", cache_rows=CACHE_ROWS,
                                               **kw)
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
            telemetry.close_event_log()
        runs[label] = (per_pass, table, trainer)
        for p, r in enumerate(per_pass):
            log_sharded_pass(label, p, r)
    recs = [json.loads(ln) for ln in open(events_path)
            if '"pass_end"' in ln]
    want = {"gauges": ("cache.hit_rate", "placement.hot_keys",
                       "placement.hot_resident_rows", "train.grad_norm"),
            "counters": ("pass.host_row_bytes_in", "pass.host_row_bytes_out"),
            "histograms": ("trainer.stage_seconds{stage=plan}",
                           "census.cold_keys")}
    lacking = [(p, kind, n) for p, r in enumerate(recs)
               for kind, names in want.items() for n in names
               if n not in r["telemetry"][kind]]
    if len(recs) != len(datasets) or lacking:
        raise AssertionError(f"sharded pass_end records: {len(recs)}, "
                             f"lacking {lacking}")
    log("sharded cached deterministic pass_end records: hit rates "
        f"{[r['telemetry']['gauges']['cache.hit_rate'] for r in recs]}, "
        "hot keys "
        f"{[r['telemetry']['gauges']['placement.hot_keys'] for r in recs]}, "
        "promoted bytes "
        f"{[r['telemetry']['counters']['pass.host_row_bytes_in'] for r in recs]}")
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
    cpu_agreement(datasets)
    for what, key in (("begin_pass s", "begin_s"), ("end_pass s", "end_s"),
                      ("samples/s", "samples_per_s")):
        log(f"sharded cached boundary: {what} {[r[key] for r in per_pass]}")
    # the one-process reference of the multiprocess phase, taken before the
    # reshard phase trains this world on
    one_process = {"passes": det_pass, "state": sd, "dense": {
        k: v.detach().cpu().numpy().copy()
        for k, v in det_trainer.model.state_dict().items()}}
    return {"launches": launches, "table": det_table, "trainer": det_trainer,
            "datasets": datasets, "one_process": one_process}


def cpu_agreement(datasets) -> None:
    """The sharded cached path at full width on the card under
    deterministic algorithms and on the CPU, from the same seeds, over the
    first CPU_AGREE_BATCHES batches of each of the HYBRID_PASSES Zipf sets
    (the hot block realizes in the third pass and changes in the fourth;
    depth cut since the online phase: the whole sets before, against the
    sharded phase's deterministic run): each shard's hits and misses and
    the hot set equal, losses within 1e-4 relative, AUC within 1e-3 and
    every table row within 1e-4 (the tolerances of small_agreement: the
    two devices sum the tower's products in different orders, each step's
    float32 difference is a few ulps and Adam and AdaGrad carry it only a
    few steps' worth)."""
    import itertools

    import numpy as np
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    heads = [_Batches(itertools.islice(ds.batches(), CPU_AGREE_BATCHES))
             for ds in datasets]
    torch.use_deterministic_algorithms(True)
    try:
        table, trainer = make_hybrid_world("cuda", cache_rows=CACHE_ROWS)
        card_pass = drive_hybrid(heads, table, trainer)
        card_state = table.state_dict()
        card_hot = table.hot_resident_keys()
        table.close()
    finally:
        torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    table, trainer = make_hybrid_world("cpu", cache_rows=CACHE_ROWS)
    cpu_pass = drive_hybrid(heads, table, trainer)
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


def _rs_metrics(m: dict) -> list:
    return [m["loss"], m["auc"], m["count"], m["steps"]]


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
    # the one-process run of the multiprocess phase's arm (b): per reshard
    # the live pass's metrics and the table's state after it
    sharded["reshard_runs"] = runs = []
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
            runs.append({"moved": moved, "metrics": _rs_metrics(lv["metrics"]),
                         "state": sa})
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


# --------------------------------------------------------------------------- #
# multiprocess: the job of ranks (launch.py) on the card, each rank this
# script run as its own rank program (``--rank``)
# --------------------------------------------------------------------------- #
# arm (a): 2 ranks of 2 positions on the one card over gloo, all the hybrid
# passes, then in the same job arm (d): one more pass under a MP_DEADLINE_S
# liveness deadline over the first MP_STALL_BATCHES batches of the first
# set, whose first step rank 1 freezes; arm (b): 1 rank of 4 positions
# through the process-group path on NCCL, over the first MP_NCCL_PASSES
# (depth cut since the fleet and scenarios phases: arm (b) over 1 pass, 2
# before)
MP_RANKS, MP_NCCL_PASSES, MP_DEADLINE_S, MP_STALL_BATCHES = 2, 1, 5.0, 8
# the time limit of one launched job (its ranks' start, build check, data
# load and passes)
MP_JOB_TIMEOUT_S = 300.0


def _dense_digest(model) -> str:
    """sha256 of the model's dense state, in name order."""
    import hashlib

    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_groups(ds, rank: int, n_local: int) -> list:
    """The global groups of POSITIONS batches (the ragged tail padded, as
    the one-process trainer pads it), sliced to this rank's positions."""
    import itertools

    from paddlebox_tpu_torch.data.feed import empty_like

    out = []
    it = iter(ds.batches(drop_last=False))
    while True:
        group = list(itertools.islice(it, POSITIONS))
        if not group:
            return out
        if len(group) < POSITIONS:
            group += [empty_like(group[0])] * (POSITIONS - len(group))
        out.append(group[rank * n_local:(rank + 1) * n_local])


def _rank_setup():
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    logging_setup()


def logging_setup() -> None:
    import logging

    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(name)s: %(message)s")


def rank_train(out_dir: str, spec: dict) -> None:
    """A rank of arms (a) to (c): the sharded phase's world (make_hybrid_world
    with the per-shard caches) over spec["passes"] file sets, each rank
    feeding its positions' slice of every global group; launch counters
    reset just before the passes and read just after.  Writes
    rank<r>.json (per pass the metrics, the cache hits and the dense
    digest; the launches, the collectives, the plan channel's gathers and
    the plan and feed stages) and rank<r>.npz (its store and dense
    state)."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.parallel import collectives
    from paddlebox_tpu_torch.parallel.mesh import initialize_distributed

    times = {"start": time.time()}
    job = initialize_distributed()
    times["joined"] = time.time()
    datasets = [load(fs, CACHED_FILES) for fs in spec["passes"]]
    table, trainer = make_hybrid_world("cuda", cache_rows=CACHE_ROWS)
    times["ready"] = time.time()
    if spec.get("go_file"):
        # started beside an earlier job: train once it has ended
        end = time.monotonic() + MP_JOB_TIMEOUT_S
        while not os.path.exists(spec["go_file"]):
            if time.monotonic() > end:
                raise TimeoutError("no go from the parent")
            time.sleep(0.05)
        times["go"] = time.time()
    if trainer.group is not job or table.n_local != POSITIONS // job.world:
        raise AssertionError("the world is not laid out over the job")
    passes, auc = [], None
    sk.reset_launches()
    collectives.reset_stats()
    telemetry.registry.reset()
    for ds in datasets:
        groups = _rank_groups(ds, job.rank, table.n_local)
        census = np.unique(np.concatenate(
            [b.keys[: b.n_keys] for g in groups for b in g]))
        t0 = time.perf_counter()
        table.begin_pass(census)
        torch.cuda.synchronize()
        begin_s = time.perf_counter() - t0
        hits = int(sum(table.last_shard_hits))
        m = trainer.train_groups(table, iter(groups), auc_state=auc)
        auc = trainer.last_metric_state
        torch.cuda.synchronize()
        table.end_pass()
        passes.append({
            "loss": m["loss"], "auc": m["auc"], "count": m["count"],
            "steps": m["steps"], "samples": m["samples"],
            "samples_per_s": m["samples"] / m["duration_s"],
            "hot_occ": m["hot_occurrences"], "hits": hits,
            "hot": int(table.hot_resident_keys().shape[0]),
            "begin_s": begin_s, "dense_digest": _dense_digest(trainer.model),
        })
    times["trained"] = time.time()
    launches = dict(sk.launches)
    hist = telemetry.registry.get("hostplane.gather_seconds")
    plan_gather = hist.summary(channel="plan") if hist is not None else {}
    stages = telemetry.registry.get("trainer.stage_seconds")
    state = table.state_dict()
    np.savez(os.path.join(out_dir, f"rank{job.rank}.npz"),
             keys=state["keys"], values=state["values"],
             **{f"dense/{k}": v.cpu().numpy()
                for k, v in trainer.model.state_dict().items()})
    times["written"] = time.time()
    with open(os.path.join(out_dir, f"rank{job.rank}.json"), "w") as f:
        json.dump({
            "passes": passes, "launches": launches,
            "collectives": collectives.stats(), "plan_gather": plan_gather,
            "stages": {s: stages.summary(stage=s) for s in ("plan", "feed")},
            "backend": job.backend, "host_staged": job.host_staged,
            "times": times,
        }, f)
    if spec.get("shuffle"):
        rank_shuffle(out_dir, spec["shuffle"], job)
    if spec.get("reshard"):
        trainer = rank_reshard(out_dir, table, trainer, datasets, job)
    if spec.get("stall"):
        rank_stall(out_dir, table, trainer, datasets[0])


def rank_shuffle(out_dir: str, files: list, job) -> None:
    """Arm (f) in a rank of arm (a)'s job: this rank's half of ``files``
    (the data half's logkey set) loads through a TcpShuffler on loopback,
    by search_id; the ranks publish their listeners' ports through the
    job's store (a KvChannel gather) first.  Then global_shuffle.  Writes
    shuffle<r>.bin (the exchanged block) and shuffle<r>.json (bytes and
    seconds)."""
    import numpy as np

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.data.archive import block_to_bytes
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.shuffle import TcpShuffler
    from paddlebox_tpu_torch.parallel.host_plane import KvChannel

    mine = files[job.rank::job.world]
    sh = TcpShuffler([("127.0.0.1", 0)] * job.world, job.rank,
                     mode="search_id", seed=0)
    sh.start()
    ports = KvChannel("shuffle-endpoints").allgather(
        np.array([sh.bound_port()], np.int64))
    sh.endpoints = [("127.0.0.1", int(p)) for p in ports[:, 0]]
    ds = PadBoxSlotDataset(data_conf(), read_threads=len(mine))
    ds.set_filelist(mine)
    ds.shuffler = sh
    t0 = time.perf_counter()
    try:
        ds.preload_into_memory()
        ds.wait_preload_done()
    finally:
        sh.close()
    load_s = time.perf_counter() - t0
    ds.global_shuffle(seed=0)
    with open(os.path.join(out_dir, f"shuffle{job.rank}.bin"), "wb") as f:
        f.write(block_to_bytes(ds._block))
    bh = telemetry.registry.get("shuffle.exchange_bytes")
    sec = telemetry.registry.get("shuffle.exchange_seconds")
    w = str(job.rank)
    with open(os.path.join(out_dir, f"shuffle{job.rank}.json"), "w") as f:
        json.dump({"load_s": load_s, "n_ins": ds._block.n_ins,
                   "raw_bytes": bh.summary(worker=w, kind="raw")["sum"],
                   "wire_bytes": bh.summary(worker=w, kind="encoded")["sum"],
                   "exchange_s": sec.summary(worker=w)["sum"]}, f)
    ds.close()


def rank_reshard(out_dir: str, table, trainer, datasets: list, job):
    """Arm (g) in a rank of arm (a)'s job, under deterministic algorithms:
    reshard_check's schedule across the ranks: the trained table resharded
    live from POSITIONS to 2 positions (one a rank), the first
    RESHARD_BATCHES batches of the fourth set trained, then back to
    POSITIONS over the first set's, each pass on a new trainer continuing
    the dense state.  Writes reshard<r>.json (per reshard the local rows
    moved, the seconds, the channel bytes, the metrics) and
    reshard<r>-<i>.npz (the store after each pass); returns the last
    trainer."""
    import copy
    import itertools

    import numpy as np

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import MultiChipTrainer, make_mesh

    tconf = table.conf
    out = []
    for i, (n_new, full) in enumerate(((2, datasets[3]),
                                       (POSITIONS, datasets[0]))):
        mesh = make_mesh(n_new, device="cuda")
        dense = copy.deepcopy(trainer.dense_state())
        bh = telemetry.registry.get("hostplane.gather_bytes")
        before = (bh.summary(channel="reshard", kind="encoded")["sum"]
                  if bh else 0.0)
        moved = table.reshard(mesh)
        bh = telemetry.registry.get("hostplane.gather_bytes")
        sent = bh.summary(channel="reshard", kind="encoded")["sum"] - before
        model = CtrDnn(N_SLOTS, tconf.row_width, dense_dim=DENSE,
                       hidden=HIDDEN, seed=0, device="cuda")
        trainer = MultiChipTrainer(model, tconf, mesh, trainer.conf)
        trainer.load_dense_state(*dense)
        batches = list(itertools.islice(full.batches(), RESHARD_BATCHES))
        groups = []
        for g in range(0, len(batches), n_new):
            groups.append(batches[g:g + n_new][
                job.rank * mesh.n_local:(job.rank + 1) * mesh.n_local])
        census = np.unique(np.concatenate(
            [b.keys[: b.n_keys] for g in groups for b in g]))
        table.begin_pass(census)
        m = trainer.train_groups(table, iter(groups))
        table.end_pass()
        state = table.state_dict()
        np.savez(os.path.join(out_dir, f"reshard{job.rank}-{i}.npz"),
                 keys=state["keys"], values=state["values"])
        out.append({"n_new": n_new, "moved": moved,
                    "seconds": table.last_reshard_s, "channel_bytes": sent,
                    "metrics": _rs_metrics(m)})
    with open(os.path.join(out_dir, f"reshard{job.rank}.json"), "w") as f:
        json.dump(out, f)
    return trainer


def rank_stall(out_dir: str, table, trainer, ds) -> None:
    """Arm (d) in a rank of arm (a)'s job: one more pass over the first
    MP_STALL_BATCHES batches of ``ds`` under a liveness watchdog with
    heartbeats on the job's store and the serial feed; rank 1 arms a hang
    at the train.step site (its first step).  Writes stall<r>.json with
    the DistributedStallError's fields and exits with code 7 on it;
    raises when the pass completes."""
    from paddlebox_tpu_torch.config import LivenessConfig
    from paddlebox_tpu_torch.parallel.watchdog import DistributedStallError
    from paddlebox_tpu_torch.utils import faults

    rank = trainer.group.rank
    batches = _Batches(itertools_head(ds.batches(), MP_STALL_BATCHES))
    trainer.conf.liveness = LivenessConfig(
        deadline_s=MP_DEADLINE_S, heartbeat_interval_s=MP_DEADLINE_S / 6,
        poll_interval_s=0.2, hard_exit_grace_s=30.0)
    trainer.conf.prefetch_batches = 0
    table.begin_pass(batches.unique_keys())
    if rank == 1:
        faults.install(faults.FaultPlan({"train.step": "hang:first:1"}))
    t_start = time.time()
    try:
        trainer.train_groups(table, iter(_rank_groups(batches, rank,
                                                      table.n_local)))
    except DistributedStallError as e:
        with open(os.path.join(out_dir, f"stall{rank}.json"), "w") as f:
            json.dump({"culprit": e.culprit, "stage": e.stage,
                       "kind": e.kind, "t_start": t_start,
                       "t_abort": time.time()}, f)
        print(f"STALL-ABORT rank={rank}: {e}", flush=True)
        os._exit(7)  # the peer's half of a collective may be pending
    raise AssertionError("the frozen rank's pass completed")


def itertools_head(it, n: int) -> list:
    return list(itertools_head_iter(it, n))


def itertools_head_iter(it, n: int):
    import itertools

    return itertools.islice(it, n)


def rank_main(argv: list) -> int:
    """``chip_smoke.py --rank <out_dir> <spec.json>``: one rank of the
    multiprocess phase's jobs, started by launch.py."""
    out_dir, spec_path = argv
    _rank_setup()
    with open(spec_path) as f:
        spec = json.load(f)
    rank_train(out_dir, spec)
    return 0


def _start_job(label: str, spec: dict, nproc: int, backend: str):
    """_run_job on a thread: (thread, a list the result lands in)."""
    import threading

    box: list = []
    t = threading.Thread(target=lambda: box.append(
        _run_job(label, spec, nproc, backend)), daemon=True)
    t.start()
    return t, box


def _run_job(label: str, spec: dict, nproc: int, backend: str):
    """Launch one job of this script's rank program; (rc, out_dir,
    seconds, rank logs, the launch's wall-clock start)."""
    from paddlebox_tpu_torch.launch import launch

    out = os.path.join(WORK_DIR, f"mp-{label}")
    os.makedirs(out, exist_ok=True)
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t_wall = time.time()
    t0 = time.perf_counter()
    rc = launch([os.path.abspath(__file__), "--rank", out, spec_path],
                nproc=nproc, positions_per_proc=POSITIONS // nproc,
                device="cuda", backend=backend,
                log_dir=os.path.join(out, "logs"),
                job_timeout_s=MP_JOB_TIMEOUT_S)
    secs = time.perf_counter() - t0
    logs = [open(os.path.join(out, "logs", f"rank{r}.log")).read()
            for r in range(nproc)]
    return rc, out, secs, logs, t_wall


def _job_failed(label, rc, logs) -> AssertionError:
    tails = "\n".join(f"--- rank {r} ---\n{t[-3000:]}"
                      for r, t in enumerate(logs))
    return AssertionError(f"multiprocess {label}: launch rc {rc}\n{tails}")


def _check_train_job(label: str, out: str, nproc: int, ref: dict,
                     n_passes: int, full: bool) -> list:
    """Each rank's passes bit-equal to the one-process deterministic run
    (metrics and dense digest per pass; with ``full`` also its final dense
    state and the union of the ranks' stores); returns the ranks'
    reports."""
    import numpy as np

    ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
             for r in range(nproc)]
    want = [(r["metrics"]["loss"], r["metrics"]["auc"], r["metrics"]["count"],
             r["metrics"]["steps"], r["dense_digest"])
            for r in ref["passes"][:n_passes]]
    for r, rep in enumerate(ranks):
        got = [(p["loss"], p["auc"], p["count"], p["steps"],
                p["dense_digest"]) for p in rep["passes"]]
        if got != want:
            raise AssertionError(f"multiprocess {label}: rank {r}'s passes "
                                 f"differ from one process: {got} vs {want}")
    if full:
        zs = [np.load(os.path.join(out, f"rank{r}.npz"))
              for r in range(nproc)]
        for r, z in enumerate(zs):
            for k, v in ref["dense"].items():
                if not np.array_equal(z[f"dense/{k}"], v):
                    raise AssertionError(f"multiprocess {label}: rank {r}'s "
                                         f"dense {k} differs")
        keys = np.concatenate([z["keys"] for z in zs])
        vals = np.concatenate([z["values"] for z in zs])
        order = np.argsort(keys)
        if (np.unique(keys).shape[0] != keys.shape[0]
                or not np.array_equal(keys[order], ref["state"]["keys"])
                or not np.array_equal(vals[order], ref["state"]["values"])):
            raise AssertionError(f"multiprocess {label}: the union of the "
                                 "ranks' stores differs from one process's")
    return ranks


def _report_train_job(label: str, ranks: list, ref: dict, card: str,
                      t_wall: float) -> None:
    """The arm's numbers beside the card's name and power limit."""
    for r, rep in enumerate(ranks):
        steps = sum(p["steps"] for p in rep["passes"])
        log(f"multiprocess {label} rank {r}: s after the launch: " + ", ".join(
            f"{k} {v - t_wall!r}" for k, v in rep["times"].items()))
        log(f"multiprocess {label} rank {r} ({card}): samples/s per pass "
            f"{[p['samples_per_s'] for p in rep['passes']]} against one "
            f"process's {[p['samples_per_s'] for p in ref['passes']]}; "
            f"cache hits {[p['hits'] for p in rep['passes']]}, hot rows "
            f"{[p['hot'] for p in rep['passes']]}, hot occurrences "
            f"{[p['hot_occ'] for p in rep['passes']]}; begin_pass s "
            f"{[p['begin_s'] for p in rep['passes']]}")
        coll = rep["collectives"]
        log(f"multiprocess {label} rank {r} ({card}): {rep['backend']} "
            f"collectives over {steps} steps: " + "; ".join(
                f"{k} {v['calls'] / steps!r} calls, "
                f"{1e3 * v['seconds'] / steps!r} ms, "
                f"{v['bytes'] / steps!r} B sent, "
                f"{v['host_bytes'] / steps!r} B through host memory a step"
                for k, v in sorted(coll.items())))
        total = sum(v["bytes"] for v in coll.values())
        pg = rep["plan_gather"]
        log(f"multiprocess {label} rank {r} ({card}): "
            f"{total / steps!r} B a step through the process group; plan "
            f"channel gathers {pg.get('count')}, "
            f"{1e3 * pg.get('sum', 0.0) / max(pg.get('count') or 1, 1)!r} "
            f"ms each; stages " + ", ".join(
                f"{s} {1e3 * st['sum'] / max(st['count'], 1)!r} ms x "
                f"{st['count']}" for s, st in rep["stages"].items()))


def multiprocess(sharded: dict, files: list, logkey_files: list) -> None:
    """The multi-process plane on the card (module docstring, phase
    multiprocess): arm (a) gloo 2 x 2 on one card and, in the same job,
    arm (f) the TCP shuffle of ``logkey_files``, arm (g) the live reshard
    across the ranks and arm (d) liveness; arm (e) the fleet view of arm
    (a); arm (b) NCCL at world 1; arm (c) NCCL across cards (needs 2
    cards).  Every job's ranks are this script's rank program."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    card = card_line()
    ref = sharded["one_process"]
    # (b)'s rank starts now, loads and builds its world, and trains once
    # (a) has ended: its start-up hides behind (a)'s run
    go_file = os.path.join(WORK_DIR, "mp-go")
    b_thread, b_box = _start_job(
        "nccl1", {"passes": files[:MP_NCCL_PASSES], "go_file": go_file}, 1,
        "nccl")
    # (a) two ranks on one card: gloo (NCCL refuses two ranks on one card),
    # then (d) in the same job: rank 1 freezes its first step
    try:
        rc, out, secs, logs, t_wall = _run_job(
            "gloo", {"passes": files, "stall": True, "reshard": True,
                     "shuffle": logkey_files}, MP_RANKS, "gloo")
    finally:
        open(go_file, "w").close()
    if rc != 7:
        b_thread.join(MP_JOB_TIMEOUT_S)
        raise _job_failed("arms (a) and (d)", rc, logs)
    ranks = _check_train_job("arm (a)", out, MP_RANKS, ref, len(files), True)
    for r, rep in enumerate(ranks):
        if not rep["host_staged"]:
            raise AssertionError("arm (a) did not stage through host memory")
        lacking = [k for k in sk.KERNELS if rep["launches"].get(k, 0) <= 0]
        if lacking:
            raise AssertionError(f"arm (a) rank {r} never launched {lacking}")
        log(f"multiprocess arm (a) rank {r} launches {rep['launches']}")
    if not (any(p["hits"] for p in ranks[0]["passes"])
            and ranks[0]["passes"][-1]["hot_occ"] > 0):
        raise AssertionError("arm (a): no cache hit or no hot occurrence")
    log(f"multiprocess arm (a): {MP_RANKS} ranks x {POSITIONS // MP_RANKS} "
        f"positions on one card over gloo, {len(files)} passes bit-equal to "
        f"one process of {POSITIONS} positions under deterministic "
        f"algorithms (loss, AUC, counts, dense state of both ranks, the "
        f"union of their stores); job with arm (d) {secs!r} s")
    _report_train_job("arm (a)", ranks, ref, card, t_wall)
    # (d) liveness: both ranks exit with the error naming rank 1 and its
    # stage within twice the deadline of the pass's start
    got = [json.load(open(os.path.join(out, f"stall{r}.json")))
           if os.path.exists(os.path.join(out, f"stall{r}.json")) else None
           for r in range(MP_RANKS)]
    ok = all(
        g is not None and g["culprit"] == 1 and g["stage"] == "step"
        and g["t_abort"] - g["t_start"] < 2 * MP_DEADLINE_S for g in got)
    if not ok or not all("STALL-ABORT" in t for t in logs):
        raise _job_failed(f"arm (d) (results {got})", rc, logs)
    log(f"multiprocess arm (d): rank 1 hung at train.step; both ranks exited "
        f"with DistributedStallError naming rank 1 in stage 'step' "
        f"({[g['kind'] for g in got]}), "
        f"{[g['t_abort'] - g['t_start'] for g in got]} s after their pass "
        f"began (deadline {MP_DEADLINE_S} s)")
    # (e) the fleet view: rank 0 printed the merged view at every pass end
    # (arm (a)'s passes and arm (g)'s two)
    views = [ln for ln in logs[0].splitlines()
             if ln.startswith("[fleet pass step=")]
    if len(views) != len(files) + 2 or not all(
            f"world={MP_RANKS}" in v for v in views):
        raise AssertionError(f"arm (e): rank 0 logged {len(views)} fleet "
                             f"views for {len(files) + 2} passes")
    log(f"multiprocess arm (e): rank 0's fleet view at each pass end, the "
        f"last: {views[-1][:600]}")
    mp_shuffle_check(out, logkey_files, card)
    mp_reshard_check(out, sharded["reshard_runs"], card)
    # (b) NCCL at world 1: the process-group path, one rank of 4 positions
    b_thread.join(MP_JOB_TIMEOUT_S)
    if not b_box:
        raise AssertionError("arm (b)'s job did not end")
    rc, out, secs, logs, t_wall = b_box[0]
    if rc != 0:
        raise _job_failed("arm (b)", rc, logs)
    (rep,) = _check_train_job("arm (b)", out, 1, ref, MP_NCCL_PASSES, False)
    log(f"multiprocess arm (b): 1 rank x {POSITIONS} positions through the "
        f"process-group path on NCCL, {MP_NCCL_PASSES} passes bit-equal to "
        f"the in-process run (metrics and dense state a pass); job {secs!r} "
        "s, started beside arm (a)'s")
    log(f"multiprocess arm (b) launches {rep['launches']}")
    _report_train_job("arm (b)", [rep], ref, card, t_wall)
    # (c) NCCL across cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        rc, out, secs, logs, t_wall = _run_job(
            "nccl2", {"passes": files}, MP_RANKS, "nccl")
        if rc != 0:
            raise _job_failed("arm (c)", rc, logs)
        ranks = _check_train_job("arm (c)", out, MP_RANKS, ref, len(files),
                                 True)
        log(f"multiprocess arm (c): {MP_RANKS} ranks on their own cards over "
            f"NCCL bit-equal to one process; job {secs!r} s")
        _report_train_job("arm (c)", ranks, ref, card, t_wall)
    else:
        log(f"multiprocess arm (c): not run: NCCL across cards needs 2 cards "
            f"and this machine has {n_cards}; unverified")


def mp_shuffle_check(out: str, files: list, card: str) -> None:
    """Arm (f): the two ranks' shuffled blocks hold every input record once
    (by ins_id), each where route_ids sends it, and each rank's block is
    bit-equal, record for record, to what an InProcessShuffleGroup of the
    same mode and seed gives that worker (the TCP block puts a worker's own
    part first, the group's in sender order: compared in ins_id order)."""
    import numpy as np

    from paddlebox_tpu_torch.data.archive import block_from_bytes
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.shuffle import InProcessShuffleGroup, route_ids

    got = [block_from_bytes(open(os.path.join(out, f"shuffle{r}.bin"),
                                 "rb").read()) for r in range(MP_RANKS)]
    stats = [json.load(open(os.path.join(out, f"shuffle{r}.json")))
             for r in range(MP_RANKS)]
    group = InProcessShuffleGroup(MP_RANKS, mode="search_id", seed=0)
    dss = []
    for w in range(MP_RANKS):
        d = PadBoxSlotDataset(data_conf(), read_threads=2)
        d.set_filelist(files[w::MP_RANKS])
        d.shuffler = group.shuffler(w)
        d.preload_into_memory()
        dss.append(d)
    for d in dss:
        d.wait_preload_done()
    whole = load_logkey(files)
    dest = dict(zip(whole.ins_ids, route_ids(whole, MP_RANKS).tolist()))
    seen = []
    for w, (g, d) in enumerate(zip(got, dss)):
        want = d._block
        og, ow = np.argsort(g.ins_ids), np.argsort(want.ins_ids)
        if not _block_meta_equal(g.select(og), want.select(ow)):
            raise AssertionError(f"multiprocess arm (f): rank {w}'s TCP "
                                 "block differs from the in-process group's")
        if any(dest[i] != w for i in g.ins_ids):
            raise AssertionError(f"multiprocess arm (f): rank {w} holds "
                                 "records routed elsewhere")
        seen += g.ins_ids
        d.close()
    if sorted(seen) != sorted(whole.ins_ids):
        raise AssertionError("multiprocess arm (f): the shuffle lost or "
                             "duplicated records")
    log(f"multiprocess arm (f): {len(files)} logkey files, half a rank, "
        f"through TcpShufflers on loopback by search_id: blocks of "
        f"{[s['n_ins'] for s in stats]} records, bit-equal to the "
        f"in-process group's, their union the input; exchange bytes raw "
        f"{[s['raw_bytes'] for s in stats]} / on the wire "
        f"{[s['wire_bytes'] for s in stats]}, exchange s "
        f"{[s['exchange_s'] for s in stats]}, load with the exchange s "
        f"{[s['load_s'] for s in stats]} [{card}]")


def load_logkey(files):
    """The data half's records of ``files`` in one block (its load)."""
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset

    d = PadBoxSlotDataset(data_conf(), read_threads=len(files))
    d.set_filelist(files)
    d.load_into_memory()
    block = d._block
    d.close()
    return block


def mp_reshard_check(out: str, runs: list, card: str) -> None:
    """Arm (g): at each of reshard_check's two reshards across the ranks,
    both ranks' pass metrics equal the one-process live reshard's, the
    union of their stores is its store bit for bit, and their rows moved
    add up to its."""
    import numpy as np

    reps = [json.load(open(os.path.join(out, f"reshard{r}.json")))
            for r in range(MP_RANKS)]
    for i, want in enumerate(runs):
        for r, rep in enumerate(reps):
            if rep[i]["metrics"] != want["metrics"]:
                raise AssertionError(
                    f"multiprocess arm (g) reshard {i}: rank {r}'s pass "
                    f"{rep[i]['metrics']} vs one process {want['metrics']}")
        if sum(rep[i]["moved"] for rep in reps) != want["moved"]:
            raise AssertionError(f"multiprocess arm (g) reshard {i}: rows "
                                 "moved differ from one process's")
        zs = [np.load(os.path.join(out, f"reshard{r}-{i}.npz"))
              for r in range(MP_RANKS)]
        keys = np.concatenate([z["keys"] for z in zs])
        vals = np.concatenate([z["values"] for z in zs])
        order = np.argsort(keys)
        if (np.unique(keys).shape[0] != keys.shape[0]
                or not np.array_equal(keys[order], want["state"]["keys"])
                or not np.array_equal(vals[order], want["state"]["values"])):
            raise AssertionError(f"multiprocess arm (g) reshard {i}: the "
                                 "union of the ranks' stores differs")
        log(f"multiprocess arm (g) reshard {POSITIONS if i else 2} <- "
            f"{2 if i else POSITIONS} positions across {MP_RANKS} ranks: "
            f"rows moved {[rep[i]['moved'] for rep in reps]} (one process "
            f"{want['moved']}), KvChannel bytes sent "
            f"{[rep[i]['channel_bytes'] for rep in reps]}, last_reshard_s "
            f"{[rep[i]['seconds'] for rep in reps]}; the next pass's metrics "
            f"and the union of the stores ({keys.shape[0]} rows) bit-equal "
            f"to one process [{card}]")


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
    the per-shard caches on (sync_weight_step 4), one pass each over the
    first Zipf set (two before the fleet and scenarios phases), one after
    another for an in-call comparison of
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

    def get_memory_data_size(self) -> int:
        return sum(int(b.n_real_ins) for b in self._batches)


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


def timed_groups(table, trainer, batches, k: int = 1) -> list:
    """Seconds of each group of ``k`` steps through ``Trainer._run_group``
    over ``batches``, to a synchronize, every feed on the card beforehand
    (with k > 1: the warm-up group, the capture and its first replay, then
    the replays), in a pass of its own; the table is closed after."""
    import torch

    from paddlebox_tpu_torch.train.trainer import host_feed

    batches = _Batches(batches)
    table.begin_pass(batches.unique_keys())
    feeds = [trainer._to_device(host_feed(b, table.plan_batch(b)))
             for b in batches.batches()]
    auc, gn = trainer.init_auc(), torch.zeros(2, device=trainer.device)
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


def _group_ms(ds, k: int) -> list:
    """timed_groups over the first STEP_MS_BATCHES batches of the uncached
    slice world."""
    import itertools

    _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN, "cuda",
                                   KEY_CAPACITY,
                                   trainer_kw=dict(scan_steps=k))
    return timed_groups(table, trainer,
                        itertools.islice(ds.batches(), STEP_MS_BATCHES), k)


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
    deterministic algorithms, one pass of the uncached set's first
    TURN_BATCHES batches each in turns eager, graph, graph, eager:
    samples/s and the host seconds the consumer thread spends in the step
    (dispatch or replay) a step; and the synchronized ms per step of
    each."""
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
    head = _Batches(itertools_head_iter(ds.batches(), TURN_BATCHES))
    for label, k in (("eager", 1), ("graph", GRAPH_K), ("graph", GRAPH_K),
                     ("eager", 1)):
        _, table, trainer = make_world(N_SLOTS, DENSE, BATCH, EMB, HIDDEN,
                                       "cuda", KEY_CAPACITY,
                                       trainer_kw=dict(scan_steps=k))
        spent = timed(trainer)
        table.begin_pass(head.unique_keys())
        m = trainer.train_from_dataset(head, table)
        torch.cuda.synchronize()
        table.end_pass()
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
# Depth cut since the serving phase: the data half (and every later user
# of the logkey set) over DH_FILES files of INS_PER_FILE instances (N_FILES
# before); the shuffle group's 4 datasets take DH_FILES // 4 files each
DH_FILES = 4


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
    """Four datasets of disjoint file runs (len(files) // 4 each) exchange
    their records through an InProcessShuffleGroup while they preload: each
    record lands where route_ids says, and the union is the input.
    Returns (seconds of the group load, the slowest worker's exchange
    seconds)."""
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.shuffle import InProcessShuffleGroup, route_ids

    group = InProcessShuffleGroup(4)
    spent: list = []
    dss = []
    t0 = time.perf_counter()
    per = len(files) // 4
    for w in range(4):
        d = PadBoxSlotDataset(data_conf(), read_threads=per)
        d.set_filelist(files[per * w:per * (w + 1)])
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
    on, overlapped boundary), over DH_FILES x INS_PER_FILE instances with
    the ins_id and logkey prefixes and a task label:
      * load: preload_into_memory through the native parser (seconds beside
        the uncached set's load without the prefixes), the first file with
        the Python parser bit-equal;
      * shuffle: four datasets of disjoint files through an
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
    log(f"data_half shuffle: 4 datasets of {len(files) // 4} file(s) each "
        f"exchanged by "
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
# phase 8: the model zoo
# --------------------------------------------------------------------------- #
# bench.py's make_model defaults (BASELINE.md configs 1-5) and RankCtrDnn's;
# name -> (class, constructor kwargs, data: "zipf" sets or the "logkey"
# set, PV-merged for RankCtrDnn)
ZOO_MODELS = {
    "deepfm": ("DeepFM", dict(hidden=(400, 400, 400)), "zipf"),
    "wide_deep": ("WideDeep", dict(hidden=(512, 256, 128)), "zipf"),
    "xdeepfm": ("XDeepFM", dict(hidden=(256, 128), cin_layers=(32, 32)),
                "zipf"),
    "dcn": ("DCN", dict(hidden=(256, 128), n_cross=3), "zipf"),
    "mmoe": ("MMoE", dict(n_tasks=2, n_experts=4, expert_hidden=(128,),
                          expert_dim=64, tower_hidden=(32,)), "logkey"),
    "rank_ctr": ("RankCtrDnn", dict(max_rank=3, att_out_dim=64,
                                    hidden=(512, 256, 128)), "pv"),
}
# CtrDnn's options: name -> (CtrDnn kwargs, SparseTableConfig kwargs,
# TrainerConfig kwargs, data); rows of 11 (conv, cvm_offset 3) and 18
# floats (expand_dim 8); 4 slots at embedx dim 4 of 8
ZOO_VARIANTS = {
    "ctr_conv": (dict(layout="conv", cvm_offset=3), dict(cvm_offset=3),
                 dict(counter_label_tasks=(1,)), "logkey"),
    "ctr_expand": (dict(expand_dim=8), dict(expand_dim=8), {}, "zipf"),
    "ctr_slot_dims": (dict(slot_embed_dims=tuple((s, 4) for s in range(4))),
                      {}, {}, "zipf"),
}
ZOO_MULTICHIP = ("mmoe", "rank_ctr")
# depth cuts to keep the whole run near its earlier length: the logkey
# arms over the first ZOO_LOGKEY_FILES of the data half's files (50 000
# instances; 4 files before the serving phase), the graph against eager
# steps over the first ZOO_GRAPH_BATCHES batches of an arm's data (a
# warm-up group, a capture and two replays of GRAPH_K), the card against
# the CPU over the first ZOO_CPU_BATCHES batches (groups of POSITIONS
# batches on the multi-chip arms), and the multi-chip arms, and the
# composed MMoE arms of parallel_axes, over the first ZOO_MC_BATCHES
# batches a pass (4 step groups; 8 before the serving phase)
ZOO_LOGKEY_FILES = 2
# Depth cuts since the online phase: the graph against eager steps over 2
# step groups (a warm-up group, then a capture and its replay; 3 before),
# the card against the CPU over 1 batch (a group of POSITIONS on the
# multi-chip arms; 2 before), the multi-chip and composed arms over 8
# batches a pass (2 step groups; 16 before), each single-chip arm's
# passes over the first ZOO_ARM_BATCHES batches of its set (all of them
# before: 32 Zipf, 25 logkey)
ZOO_GRAPH_BATCHES, ZOO_CPU_BATCHES, ZOO_MC_BATCHES = 2 * GRAPH_K, 1, 8
ZOO_ARM_BATCHES = 16
# Depth cut since the fleet and scenarios phases: the zoo's and the axes'
# multi-chip and composed arms over MC_ARM_PASSES passes (HYBRID_PASSES
# before); the hot block realizes at the third begin_pass, so the last pass
# still routes hot occurrences
MC_ARM_PASSES = 3
# the card against the CPU trains the dense side with SGD at this rate:
# Adam divides each gradient by its own magnitude, so a gradient that
# cancels to near zero (DeepFM's 400-wide layers) moves its parameter by
# up to the learning rate on one device and not on the other (2.4e-4 at
# the default 1e-3); SGD keeps the parameters' difference proportional to
# the gradients'
ZOO_CPU_SGD_LR = 0.1


def zoo_parity(device) -> dict:
    """The row kernels against their twins at the zoo's new row widths: 11
    (conv, cvm_offset 3), 13 (pcoc, pclk_num 1) and 18 (expand_dim 8),
    and the cache kernels at those widths + 1, bit-exact at the main
    path's sizes and a ragged one (pull_rows' and scatter_add_rows' odd
    widths take the scalar path); then pull_rows and scatter_add_rows
    timed at widths 10, 11 and 13 (L2 cold, the main path's sizes).
    Returns {width: (pull ms, scatter ms)}."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    gen = torch.Generator(device=device).manual_seed(14)
    P, C = 1 << 21, CACHE_ROWS
    for w in (11, 13, 18):
        values = torch.randn((P, w), device=device, generator=gen)
        for k in (KEY_CAPACITY, 12_345):
            idx = torch.randint(0, P, (k,), device=device, generator=gen,
                                dtype=torch.int32)
            if not torch.equal(sk.pull_rows(values, idx),
                               sk.pull_rows_plain(values, idx)):
                raise AssertionError(f"pull_rows differs from its twin at "
                                     f"W={w}, K={k}")
            # unique targets + zero-delta dead-row repeats, as the push
            idx = torch.randperm(P - 1, device=device,
                                 generator=gen)[:k].to(torch.int32)
            idx[k - k // 8:] = P - 1
            delta = torch.randn((k, w), device=device, generator=gen)
            delta[k - k // 8:] = 0.0
            if not torch.equal(
                    sk.scatter_add_rows(values.clone(), idx, delta),
                    sk.scatter_add_rows_plain(values.clone(), idx, delta)):
                raise AssertionError(f"scatter_add_rows differs from its "
                                     f"twin at W={w}, U={k}")
        rows = torch.randn((C, w + 1), device=device, generator=gen)
        for k in (C, 12_345):
            slots = torch.randint(-1, C, (k,), device=device, generator=gen,
                                  dtype=torch.int32)
            if not torch.equal(sk.gather_slots(rows, slots),
                               sk.gather_slots_plain(rows, slots)):
                raise AssertionError(f"gather_slots differs from its twin at "
                                     f"W={w + 1}, K={k}")
            new = torch.randn((k, w + 1), device=device, generator=gen)
            if not torch.equal(sk.scatter_rows(rows.clone(), slots, new),
                               sk.scatter_rows_plain(rows.clone(), slots,
                                                     new)):
                raise AssertionError(f"scatter_rows differs from its twin at "
                                     f"W={w + 1}, K={k}")
    times = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    for w in (10, 11, 13):
        values = torch.randn((P, w), device=device, generator=gen)
        idx = torch.randint(0, P, (KEY_CAPACITY,), device=device,
                            generator=gen, dtype=torch.int32)
        uniq = torch.randperm(P - 1, device=device,
                              generator=gen)[:KEY_CAPACITY].to(torch.int32)
        delta = torch.randn((KEY_CAPACITY, w), device=device, generator=gen)
        times[w] = (cold_ms(lambda: sk.pull_rows(values, idx), flush),
                    cold_ms(lambda: sk.scatter_add_rows(values, uniq, delta),
                            flush))
    del flush
    sk.launches.update(saved)  # parity and timing calls: not the main path
    log("zoo parity: pull_rows and scatter_add_rows bit-exact at W=11, 13, "
        f"18 (K=U={KEY_CAPACITY}, 12345; a {P}-row table), gather_slots and "
        f"scatter_rows at W=12, 14, 19 (K={C}, 12345, negative and duplicate "
        "slots)")
    log("zoo kernel times (L2 cold, K=U=131072 on a 2^21-row table), ms: "
        + "; ".join(f"W={w}: pull_rows {p!r}, scatter_add_rows {s!r}"
                    for w, (p, s) in times.items()))
    return times


def zoo_data(files) -> tuple:
    """The logkey set's first ZOO_LOGKEY_FILES files loaded twice through
    the native parser: plain batches (one task label) and PV-merged
    batches (rank_offset)."""
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset

    files = files[:ZOO_LOGKEY_FILES]
    out = []
    for pv in (False, True):
        ds = PadBoxSlotDataset(data_conf(), read_threads=len(files))
        ds.set_filelist(files)
        ds.load_into_memory()
        if ds.parser._native is None:
            raise AssertionError("the zoo loaded without the native parser")
        if pv:
            ds.preprocess_instance()
        out.append(ds)
    return tuple(out)


def zoo_model(name: str, width: int, device, **over):
    """A zoo or parallel-axes entry's model at the slice's width (weights
    from seed 0); a model axis the entry names gets AXIS_POSITIONS
    positions; ``over`` overrides constructor arguments."""
    from paddlebox_tpu_torch import models
    from paddlebox_tpu_torch.parallel import make_mesh

    if name in ZOO_VARIANTS:
        cls, kw = "CtrDnn", dict(ZOO_VARIANTS[name][0], hidden=HIDDEN)
    else:
        cls, kw, _ = {**ZOO_MODELS, **AXES_MODELS}[name]
    kw = dict(kw, **over)
    for k in ("mesh", "seq_mesh", "expert_mesh"):
        if kw.get(k) in MODEL_AXES:
            kw[k] = make_mesh(AXIS_POSITIONS, device=device, axis_name=kw[k])
    lead = (kw.pop("mesh"),) if "mesh" in kw else ()  # PipelinedCtrDnn's
    return getattr(models, cls)(*lead, N_SLOTS, width, dense_dim=DENSE,
                                seed=0, device=device, **kw)


def zoo_world(name: str, device, cache_rows=None, **trainer_kw):
    """An entry's single-chip table (the default cached table unless
    ``cache_rows`` says otherwise) and trainer (RetrievalTrainer for
    TwoTower)."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.scenarios import RetrievalTrainer
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import Trainer

    tkw, trkw = {}, {}
    if name in ZOO_VARIANTS:
        tkw, trkw = ZOO_VARIANTS[name][1], ZOO_VARIANTS[name][2]
    if cache_rows is not None:
        tkw = dict(tkw, hbm_cache_rows=cache_rows)
    tconf = SparseTableConfig(embedding_dim=EMB, **tkw)
    table = SparseTable(tconf, seed=0, device=device)
    model = zoo_model(name, tconf.row_width, device)
    cls = RetrievalTrainer if getattr(model, "retrieval", False) else Trainer
    return table, cls(model, tconf, TrainerConfig(**trkw, **trainer_kw),
                      device=device)


def zoo_mc_world(name: str, device, composed: bool = False, **trainer_kw):
    """An entry on the hybrid world: POSITIONS shard positions, the
    realized loopback placement, hot capacity HOT_CAPACITY, cache off; with
    ``composed``, on make_composed_mesh(POSITIONS, 2, axis) with the
    model's inner axis "inherit" (COMPOSED)."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.parallel import (
        MultiChipTrainer,
        ShardedSparseTable,
        make_composed_mesh,
        make_mesh,
    )

    tconf = SparseTableConfig(
        embedding_dim=EMB, hbm_cache_rows=0, placement="loopback",
        placement_realize=True, placement_update_interval=1,
        placement_hot_capacity=HOT_CAPACITY)
    over = {}
    if composed:
        axis, over = COMPOSED[name]
        mesh = make_composed_mesh(POSITIONS, 2, axis, device=device)
    else:
        mesh = make_mesh(POSITIONS, device=device)
    table = ShardedSparseTable(tconf, mesh, seed=0)
    model = zoo_model(name, tconf.row_width, device, **over)
    return table, MultiChipTrainer(model, tconf, mesh,
                                   TrainerConfig(**trainer_kw))


def zoo_sets(name: str, data: dict) -> list:
    """The passes' datasets of a single-chip arm: ``data`` maps an entry's
    data kind ("zipf", "logkey", "pv", "seq") to them."""
    kind = (ZOO_VARIANTS[name][3] if name in ZOO_VARIANTS
            else {**ZOO_MODELS, **AXES_MODELS}[name][2])
    return data[kind]


def _zoo_metrics(m: dict) -> str:
    tasks = {k: m[k] for k in sorted(m) if k.startswith("task")
             and k.endswith("/auc")}
    return (f"loss {m['loss']!r} auc {m['auc']!r}"
            + (f" {tasks}" if tasks else ""))


def _check_zoo_pass(label: str, m: dict, n_tasks: int) -> None:
    if not (math.isfinite(m["loss"]) and 0.0 < m["auc"] < 1.0
            and m["count"] > 0):
        raise AssertionError(f"{label}: bad pass metrics {m}")
    for t in range(n_tasks if n_tasks > 1 else 0):
        if not 0.0 < m[f"task{t}/auc"] < 1.0:
            raise AssertionError(f"{label}: bad task{t} AUC {m}")
    if n_tasks > 1 and m["task0/auc"] != m["auc"]:
        raise AssertionError(f"{label}: task0 is not the primary stream")


def conv_counts(ds, passes: int) -> dict:
    """Host count of the conv counter: for every key, the task labels
    (column 1) of the instances of its occurrences, over ``passes`` passes
    of ``ds``."""
    import numpy as np

    keys, labels = [], []
    for b in ds.batches():
        n = b.n_keys
        keys.append(b.keys[:n])
        labels.append(b.task_labels[b.key_segments[:n] // N_SLOTS, 1])
    uniq, inv = np.unique(np.concatenate(keys), return_inverse=True)
    return uniq, np.bincount(inv, np.concatenate(labels)) * passes


def zoo_single(data: dict, names=(*ZOO_MODELS, *ZOO_VARIANTS),
               label: str = "zoo") -> dict:
    """Each named single-chip arm on the default cached table over its
    sets (zoo_sets; drive_passes: the next census staged, the boundaries
    timed); by default the six models and CtrDnn's conv
    (counter_label_tasks on a cvm_offset 3 table; its conv counters must
    equal a host count of the task labels), expand_dim and slot_embed_dims
    options."""
    import numpy as np

    out = {}
    for name in names:
        t0 = time.perf_counter()
        table, trainer = zoo_world(name, "cuda")
        sets = zoo_sets(name, data)
        per_pass = drive_passes(sets, table, trainer)
        n_tasks = trainer.n_tasks
        for p, r in enumerate(per_pass):
            _check_zoo_pass(f"{label} {name} pass {p}", r["metrics"], n_tasks)
            if r["metrics"]["count"] != sets[p].get_memory_data_size():
                raise AssertionError(f"{label} {name} pass {p}: counted "
                                     f"{r['metrics']['count']} instances")
        state = table.state_dict()
        if not np.isfinite(state["values"]).all():
            raise AssertionError(f"{label} {name}: non-finite table rows")
        if name == "ctr_conv":
            keys, want = conv_counts(sets[0], len(sets))
            got = dict(zip(state["keys"].tolist(),
                           state["values"][:, 2].tolist()))
            if [got.get(k, -1.0) for k in keys.tolist()] != want.tolist():
                raise AssertionError("zoo ctr_conv: conv counters differ from "
                                     "the host count of the task labels")
            log(f"zoo ctr_conv: {keys.shape[0]} keys' conv counters equal the "
                f"host count of the task labels ({int(want.sum())} in all)")
        table.close()
        out[name] = per_pass
        log(f"{label} {name} (single chip, W={table.conf.row_width}): "
            + "; ".join(f"pass {p} {r['samples_per_s']!r} samples/s, "
                        f"{r['metrics']['duration_s']!r} s, "
                        + _zoo_metrics(r["metrics"])
                        for p, r in enumerate(per_pass))
            + f"; arm {time.perf_counter() - t0!r} s")
    return out


def zoo_multichip(sources: dict, composed: bool = False,
                  label: str = "zoo") -> dict:
    """Each entry of ``sources`` (name -> (dataset, batches)) on the
    hybrid world (zoo_mc_world; ``composed``: on its composed mesh),
    MC_ARM_PASSES passes over the first batches of its set, the streams
    continued: the hot block realizes at the third begin_pass and routes
    through hot_cold_select.  Returns name -> (per pass, table state)."""
    import itertools

    out = {}
    for name, (src, n) in sources.items():
        t0 = time.perf_counter()
        data = _Batches(itertools.islice(src.batches(), n))
        table, trainer = zoo_mc_world(name, "cuda", composed=composed)
        per_pass = drive_hybrid([data] * MC_ARM_PASSES, table, trainer)
        out[name] = (per_pass, table.state_dict())
        table.close()
        for p, r in enumerate(per_pass):
            _check_zoo_pass(f"{label} {name} multi-chip pass {p}",
                            r["metrics"], trainer.n_tasks)
        if not per_pass[-1]["hot_occ"] > 0:
            raise AssertionError(f"{label} {name} multi-chip: no hot "
                                 "occurrence routed")
        log(f"{label} {name} (multi-chip, {trainer.mesh.shape}): "
            + "; ".join(f"pass {p} {r['samples_per_s']!r} samples/s, "
                        f"hot {r['resident']}, hot occurrences "
                        f"{r['hot_occ']}, " + _zoo_metrics(r["metrics"])
                        for p, r in enumerate(per_pass))
            + f"; arm {time.perf_counter() - t0!r} s")
    return out


def _dense_params(model) -> list:
    """A model's dense parameters, a pipelined tower unpacked into
    CtrDnn's layers (so the two compare)."""
    if hasattr(model, "unpack_tower"):
        model = model.unpack_tower()
    return [p.detach().cpu() for p in model.parameters()]


def _dense_diff(a, b) -> float:
    return max(float((p - q).abs().max())
               for p, q in zip(_dense_params(a), _dense_params(b)))


def trained_runs(names, sets, devices=("cuda", "cpu"), multi=False,
                 cache_rows=0) -> dict:
    """Each (name, device) trained over ``sets`` (one pass each, from the
    same seeds; ``multi`` on the hybrid world), the dense side by SGD at
    ZOO_CPU_SGD_LR: {(name, device): (last metrics, state, model)}.  Runs
    on the CPU take the plain twins, so no launch is counted."""
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    sgd = dict(dense_optimizer="sgd", dense_lr=ZOO_CPU_SGD_LR)
    out = {}
    for name in names:
        for device in devices:
            table, trainer = (zoo_mc_world(name, device, **sgd) if multi else
                              zoo_world(name, device, cache_rows=cache_rows,
                                        **sgd))
            m = None
            for data in sets:
                table.begin_pass(data.unique_keys())
                m = trainer.train_from_dataset(data, table)
                table.end_pass()
            out[(name, device)] = (m, table.state_dict(), trainer.model)
            table.close()
    sk.launches.update(saved)
    return out


def agree(label: str, a: tuple, b: tuple, tol: float = 1e-4,
          g2sum_rtol=None) -> str:
    """Two trained runs' (metrics, state, model) within small_agreement's
    bounds: loss ``tol`` relative, AUC 1e-3, every table row and dense
    parameter ``tol``; with ``g2sum_rtol`` the rows' g2sum column within
    that relative bound instead.  Returns the report."""
    import numpy as np

    (ma, sa, da), (mb, sb, db) = a, b
    va, vb = sa["values"], sb["values"]
    g2 = 0.0
    if g2sum_rtol is not None:
        g2 = float((np.abs(va[:, -1] - vb[:, -1])
                    / np.maximum(np.abs(vb[:, -1]), 1.0)).max())
        va, vb = va[:, :-1], vb[:, :-1]
    rows = (float(np.abs(va - vb).max())
            if np.array_equal(sa["keys"], sb["keys"]) else math.inf)
    dense = _dense_diff(da, db)
    if not (math.isfinite(ma["loss"])
            and math.isclose(ma["loss"], mb["loss"], rel_tol=tol)
            and abs(ma["auc"] - mb["auc"]) <= 1e-3
            and rows <= tol and dense <= tol and g2 <= (g2sum_rtol or 0.0)):
        raise AssertionError(
            f"{label}: loss {ma['loss']} vs {mb['loss']}, auc {ma['auc']} vs "
            f"{mb['auc']}, rows {rows}, g2sum {g2}, dense {dense}")
    return (f"{label} rows {rows!r} dense {dense!r}"
            + (f" g2sum (relative) {g2!r}" if g2sum_rtol is not None else ""))


def zoo_cpu_agreement(data: dict) -> None:
    """Every arm's first ZOO_CPU_BATCHES batches (groups of POSITIONS on
    the multi-chip arms) trained once on the card and once on the CPU
    (the plain twins), from the same seeds, uncached (trained_runs), held
    to small_agreement's tolerances (agree)."""
    import itertools

    report = []
    arms = [(n, False) for n in [*ZOO_MODELS, *ZOO_VARIANTS]]
    arms += [(n, True) for n in ZOO_MULTICHIP]
    for name, multi in arms:
        src = zoo_sets(name, data)[0]
        n = ZOO_CPU_BATCHES * (POSITIONS if multi else 1)
        batches = _Batches(itertools.islice(src.batches(), n))
        runs = trained_runs([name], [batches], multi=multi)
        report.append(agree(f"{name}{' (multi-chip)' if multi else ''}",
                            runs[(name, "cuda")], runs[(name, "cpu")]))
    log("zoo card vs CPU, max abs diff: " + "; ".join(report))


def zoo_graph_equality(data: dict) -> None:
    """Under deterministic algorithms, each single-chip arm's first
    ZOO_GRAPH_BATCHES batches: scan_steps GRAPH_K as a CUDA graph (a
    warm-up group, a capture, a replay) against eager steps, bit-equal in
    losses, AUCs, grad_norm, dense parameters and table."""
    import itertools

    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    torch.use_deterministic_algorithms(True)
    try:
        for name in [*ZOO_MODELS, *ZOO_VARIANTS]:
            src = zoo_sets(name, data)[0]
            batches = _Batches(itertools.islice(src.batches(),
                                                ZOO_GRAPH_BATCHES))
            runs = []
            for k in (1, GRAPH_K):
                table, trainer = zoo_world(name, "cuda", scan_steps=k)
                table.begin_pass(batches.unique_keys())
                m = trainer.train_from_dataset(batches, table)
                torch.cuda.synchronize()
                table.end_pass()
                runs.append((m, table.state_dict(), trainer))
                table.close()
            (me, se, te), (mg, sg, tg) = runs
            keys = [k for k in me if k == "loss" or k.endswith("auc")
                    or k == "grad_norm"]
            if tg.graph_captures != 1 or tg.graph_replays != (
                    ZOO_GRAPH_BATCHES // GRAPH_K - 1):
                raise AssertionError(
                    f"zoo {name} graph: {tg.graph_captures} captures, "
                    f"{tg.graph_replays} replays")
            _sync_equal(f"zoo {name} graph against eager steps", sg, se,
                        [mg[k] for k in keys], [me[k] for k in keys])
            if _dense_diff(te.model, tg.model) != 0.0:
                raise AssertionError(f"zoo {name} graph: dense parameters "
                                     "differ from eager steps")
    finally:
        torch.use_deterministic_algorithms(False)
    sk.launches.update(saved)
    log(f"zoo graph: every single-chip arm's first {ZOO_GRAPH_BATCHES} "
        f"batches with scan_steps {GRAPH_K} (one capture, "
        f"{ZOO_GRAPH_BATCHES // GRAPH_K - 1} replay(s)) bit-equal to eager "
        "steps under deterministic algorithms")


def model_zoo(zipf_sets, logkey_files) -> dict:
    """The ranking model zoo at the slice's width (16 slots, 13 dense,
    batch 2048, embedding_dim 8, vocab 100 000, bench.py's model widths):
    kernel parity at the new row widths; each single-chip arm two passes
    on the default table and MMoE and RankCtrDnn on the hybrid world, the
    launch counters reset just before these arms and read just after
    (all six kernels must launch); then every arm card against CPU, and
    graph against eager steps."""
    import itertools

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    t0 = time.perf_counter()
    times = zoo_parity(__import__("torch").device("cuda"))
    logkey, pv = zoo_data(logkey_files)
    log(f"zoo data: the logkey set, {logkey.get_memory_data_size()} "
        f"instances, and PV-merged ({pv.get_pv_data_size()} page-views); "
        f"{time.perf_counter() - t0!r} s with the parity")
    head = lambda d: _Batches(itertools.islice(d.batches(), ZOO_ARM_BATCHES))
    lk, pvb = head(logkey), head(pv)
    data = {"zipf": [head(d) for d in zipf_sets[:2]], "logkey": [lk, lk],
            "pv": [pvb, pvb]}
    sk.reset_launches()
    single = zoo_single(data)
    multi = zoo_multichip({n: (zoo_sets(n, data)[0], ZOO_MC_BATCHES)
                           for n in ZOO_MULTICHIP})
    launches = dict(sk.launches)
    log(f"zoo launches (single-chip and multi-chip arms): {launches}")
    for name in sk.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the zoo's "
                                 "path")
    zoo_cpu_agreement(data)
    zoo_graph_equality(data)
    logkey.close()
    pv.close()
    return {"single": single, "multi": multi, "launches": launches,
            "times": times}


# --------------------------------------------------------------------------- #
# phase 8b: the parallel axes and retrieval
# --------------------------------------------------------------------------- #
# The sequence arm's set: SEQ_FILES x SEQ_INS_PER_FILE instances (16
# batches) whose slot0 is the behaviour sequence of 1 to SEQ_T keys (the
# model's SEQ_T positions; about a quarter of the instances reach the last
# of AXIS_POSITIONS chunks), the other slots 1 to 3 keys; the key capacity
# is the worst case, so no key is dropped
SEQ_FILES, SEQ_INS_PER_FILE, SEQ_T = 4, 8192, 64
SEQ_FEASIGNS = SEQ_T + (N_SLOTS - 1) * 3
SEQ_KEY_CAPACITY = BATCH * SEQ_FEASIGNS
# this slice's models at bench.py's widths (zoo_model's entries beside
# ZOO_MODELS): the retrieval tower's item slot is the last one; a model
# axis named by a mesh argument gets AXIS_POSITIONS positions; 8 pipeline
# microbatches
AXIS_POSITIONS, PIPE_MICROBATCHES = 4, 8
MODEL_AXES = ("seq", "expert", "pipe")
LONGSEQ_KW = dict(n_heads=4, head_dim=16, hidden=HIDDEN, max_seq_len=SEQ_T)
AXES_MODELS = {
    "retrieval": ("TwoTower", dict(item_slots=(N_SLOTS - 1,), hidden=(128, 64),
                                   temperature=0.05), "zipf"),
    "longseq_full": ("LongSeqCtrDnn", LONGSEQ_KW, "seq"),
    "longseq_ring": ("LongSeqCtrDnn", dict(LONGSEQ_KW, seq_mesh="seq",
                                           seq_impl="ring"), "seq"),
    "longseq_ulysses": ("LongSeqCtrDnn", dict(LONGSEQ_KW, seq_mesh="seq",
                                              seq_impl="ulysses"), "seq"),
    "pipelined": ("PipelinedCtrDnn", dict(mesh="pipe", hidden=HIDDEN,
                                          microbatches=PIPE_MICROBATCHES), "zipf"),
    "pipelined_bf16": ("PipelinedCtrDnn", dict(
        mesh="pipe", hidden=HIDDEN, microbatches=PIPE_MICROBATCHES,
        compute_dtype="bfloat16"), "zipf"),
    "ctr": ("CtrDnn", dict(hidden=HIDDEN), "zipf"),
    "mmoe_expert": ("MMoE", dict(ZOO_MODELS["mmoe"][1], expert_mesh="expert"),
                    "logkey"),
}
# the single-chip arms beside the retrieval arm: one pass over the sequence
# set, two over the Zipf or logkey sets
AXES_SINGLE = ("longseq_full", "longseq_ring", "longseq_ulysses", "pipelined",
               "ctr", "pipelined_bf16", "mmoe_expert", "mmoe")
# the composed arms: entry -> (inner axis of make_composed_mesh(POSITIONS,
# 2, axis), the model's "inherit" arguments)
COMPOSED = {"mmoe": ("expert", dict(expert_mesh="inherit")),
            "longseq_full": ("seq", dict(seq_mesh="inherit",
                                         seq_impl="ring"))}
# PipelineTrainer at the slice's pooled width (16 slots x 10 + 13 dense)
PIPE_D_IN, PIPE_WIDTH, PIPE_DEPTH = 173, 512, 2
# depth cuts to keep the phase within 150 s: the expert and composed MMoE
# arms over the first AXES_LOGKEY_FILES logkey files (50 000 instances),
# card against CPU over AXES_CPU_BATCHES batches, synchronized ms a step
# over AXES_MS_STEPS steps
# (AXES_CPU_BATCHES 1 since the online phase's depth cuts; 2 before)
AXES_LOGKEY_FILES, AXES_CPU_BATCHES, AXES_MS_STEPS = 2, 1, 8
# sharded against serial, one forward: the reference tests' bound; bf16
# against the bf16 CtrDnn: the reference's bf16 bound
AXES_FWD_TOL, AXES_BF16_TOL = 2e-5, 2e-2


def seq_load(files):
    """The sequence set through the native parser."""
    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.data.synth import make_synth_config

    ds = PadBoxSlotDataset(make_synth_config(
        n_sparse_slots=N_SLOTS, dense_dim=DENSE, batch_size=BATCH,
        max_feasigns_per_ins=SEQ_FEASIGNS,
        batch_key_capacity=SEQ_KEY_CAPACITY, sequence_slot="slot0",
        max_seq_len=SEQ_T), read_threads=len(files))
    ds.set_filelist(files)
    ds.load_into_memory()
    if ds.parser._native is None:
        raise AssertionError("the sequence set loaded without the native "
                             "parser")
    return ds


def seq_spans(label: str, batches, p: int) -> int:
    """Instances of ``batches`` whose behaviour sequence reaches the last
    of ``p`` chunks of SEQ_T positions (the feed left-aligns seq_pos, so
    every chunk then holds real keys and every ring tick folds a live
    block); raises if there is none."""
    n = sum(int((b.seq_pos[:, SEQ_T - SEQ_T // p] < b.keys.shape[0]).sum())
            for b in batches)
    if not n:
        raise AssertionError(f"{label}: no sequence reaches the last of {p} "
                             "chunks")
    return n


def _logits_on(table, models, batch) -> list:
    """Each model's logits on one batch, the rows pulled once from an open
    pass of ``table`` (no launch counted)."""
    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.sparse.table import pull_rows
    from paddlebox_tpu_torch.train.trainer import host_feed, model_extras

    saved = dict(sk.launches)
    dev = {k: torch.from_numpy(v).cuda()
           for k, v in host_feed(batch, table.plan_batch(batch)).items()}
    rows = pull_rows(table.values, dev["idx"])
    with torch.no_grad():
        out = [m(rows, dev["key_segments"], dev["dense"], BATCH,
                 **model_extras(m, dev)) for m in models]
    sk.launches.update(saved)
    return out


def _max_rel(a, b) -> float:
    """max |a - b| / (1 + |b|)."""
    return float(((a - b).abs() / (1.0 + b.abs())).max())


# the retrieval loss scales the row gradients by 1/temperature (20), so
# their accumulated squares, the rows' g2sum column, by 400: that column
# within this relative bound against the CPU
RETRIEVAL_G2SUM_RTOL = 1e-3


def _step_ms(name: str, batches) -> float:
    """Median synchronized ms of one eager step of an arm's single-chip
    world over ``batches`` (their feeds on the card beforehand; the first
    step a warm-up), launches not counted."""
    import statistics

    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    saved = dict(sk.launches)
    seconds = timed_groups(*zoo_world(name, "cuda", cache_rows=0), batches)
    sk.launches.update(saved)
    return statistics.median(seconds[1:]) * 1e3


def _pass_line(label: str, per_pass: list) -> str:
    return (f"{label}: " + "; ".join(
        f"pass {p} {r['samples_per_s']!r} samples/s, "
        f"{r['metrics']['duration_s']!r} s, " + _zoo_metrics(r["metrics"])
        for p, r in enumerate(per_pass)))


def retrieval_arm(zipf_sets) -> dict:
    """TwoTower under RetrievalTrainer on the default table ([2048, 2048]
    similarities): eager steps and scan_steps GRAPH_K as a CUDA graph,
    timed at the defaults over the first Zipf set (32 steps; both sets
    until the online phase's depth cuts); the same two runs over the first
    ZOO_ARM_BATCHES batches of the first two sets under deterministic
    algorithms, bit-equal; then evaluate in a pass of its own."""
    import itertools

    import torch

    # the deterministic runs over the first ZOO_ARM_BATCHES batches of each
    # set (depth cut since the online phase; all 32 before)
    sets = [_Batches(itertools.islice(d.batches(), ZOO_ARM_BATCHES))
            for d in zipf_sets[:2]]
    out, runs = {}, {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        try:
            for k in (1, GRAPH_K):
                table, trainer = zoo_world("retrieval", "cuda", scan_steps=k)
                per_pass = drive_passes(sets if det else zipf_sets[:1],
                                        table, trainer)
                for p, r in enumerate(per_pass):
                    _check_zoo_pass(f"retrieval k={k} pass {p}",
                                    r["metrics"], 1)
                if det:
                    runs[k] = (per_pass, table.state_dict(), trainer)
                else:
                    out[k] = per_pass
                if det and k == 1:
                    table.begin_pass(sets[0].unique_keys())
                    ev = trainer.evaluate(sets[0], table)
                    table.end_pass()
                if det or k != 1:
                    table.close()
                else:
                    out["table"] = table  # the serving phase's ANN index
        finally:
            torch.use_deterministic_algorithms(False)
    (pe, se, te), (pg, sg, tg) = runs[1], runs[GRAPH_K]
    keys = ("loss", "auc", "grad_norm")
    _sync_equal("retrieval graph against eager steps", sg, se,
                [r["metrics"][k] for r in pg for k in keys],
                [r["metrics"][k] for r in pe for k in keys])
    if _dense_diff(te.model, tg.model) != 0.0 or tg.graph_captures != 2:
        raise AssertionError(f"retrieval graph: dense parameters differ or "
                             f"{tg.graph_captures} captures")
    if not (ev["count"] == sets[0].get_memory_data_size()
            and 0.0 < ev["auc"] < 1.0):
        raise AssertionError(f"retrieval evaluate: {ev}")
    log(_pass_line("axes retrieval, eager", out[1]))
    log(_pass_line(f"axes retrieval, scan_steps {GRAPH_K} graph",
                   out[GRAPH_K]))
    log(_pass_line("axes retrieval, eager, deterministic", pe))
    log(_pass_line(f"axes retrieval, scan_steps {GRAPH_K} graph, "
                   "deterministic", pg) + "; bit-equal to eager")
    log(f"axes retrieval evaluate: auc {ev['auc']!r} over {ev['count']} "
        "instances")
    return {"eager": out[1], "graph": out[GRAPH_K], "table": out["table"]}


def composed_arm(logkey, seq_ds) -> dict:
    """MMoE on make_composed_mesh(POSITIONS, 2, "expert") and the ring
    LongSeqCtrDnn on make_composed_mesh(POSITIONS, 2, "seq") on the hybrid
    world (zoo_multichip), beside the same runs on make_mesh(POSITIONS):
    show and click counters bit-equal, loss within rel 5e-3 and AUC
    within 2e-2 (the reference test's bounds)."""
    import itertools

    import numpy as np

    sources = {"mmoe": (logkey, ZOO_MC_BATCHES),
               "longseq_full": (seq_ds, ZOO_MC_BATCHES)}
    seq_spans("axes composed longseq_full",
              itertools.islice(seq_ds.batches(), 16), 2)
    runs = {c: zoo_multichip(sources, c, "axes composed" if c else "axes")
            for c in (True, False)}
    for name in sources:
        (pc, sc), (pd, sd) = runs[True][name], runs[False][name]
        mc, md = pc[-1]["metrics"], pd[-1]["metrics"]
        counters = (np.array_equal(sc["keys"], sd["keys"]) and np.array_equal(
            sc["values"][:, :2], sd["values"][:, :2]))
        if not (counters and mc["steps"] == md["steps"]
                and math.isclose(mc["loss"], md["loss"], rel_tol=5e-3)
                and abs(mc["auc"] - md["auc"]) <= 2e-2):
            raise AssertionError(
                f"axes composed {name}: loss {mc['loss']} vs {md['loss']}, "
                f"auc {mc['auc']} vs {md['auc']}, counters equal {counters}")
        log(f"axes composed {name} against data-only: counters bit-equal, "
            f"loss {mc['loss']!r} vs {md['loss']!r}, auc {mc['auc']!r} vs "
            f"{md['auc']!r}, rows max abs diff "
            f"{float(np.abs(sc['values'] - sd['values']).max())!r}")
    return runs


def axes_checks(zipf_sets, logkey, seq_ds) -> None:
    """The arms' checks, no launch counted: one batch's logits of the
    sharded models against their serial twins (AXES_FWD_TOL; the bf16
    pipelined tower against the bf16 CtrDnn, AXES_BF16_TOL); the first
    AXES_CPU_BATCHES batches trained (SGD) by each sharded model against
    its serial twin on the card and by every arm's model on the card
    against the CPU, the retrieval arm over two passes on the default
    cached table; the row kernels bit-exact against their twins at the
    sequence arm's key capacity; PipelineTrainer's gradient against the
    sequential oracle's; the aux tables on the card against the host."""
    import itertools

    import torch

    from paddlebox_tpu_torch.config import SparseTableConfig
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.sparse.table import SparseTable

    saved = dict(sk.launches)
    first = lambda ds, n=AXES_CPU_BATCHES: _Batches(
        itertools.islice(ds.batches(), n))
    zipf0, zipf1 = first(zipf_sets[0]), first(zipf_sets[1])
    seq2, log2 = first(seq_ds), first(logkey)
    # the forward's batch reaches every ring tick with live blocks
    spans = seq_spans("axes forward", [next(seq2.batches())], AXIS_POSITIONS)
    # one forward each: sharded against serial
    table = SparseTable(SparseTableConfig(embedding_dim=EMB, hbm_cache_rows=0),
                        seed=0, device="cuda")
    w = table.conf.row_width
    report = []
    for src, names, tol in (
            (seq2, ["longseq_full", "longseq_ring", "longseq_ulysses"],
             AXES_FWD_TOL),
            (zipf0, ["ctr", "pipelined"], AXES_FWD_TOL),
            (log2, ["mmoe", "mmoe_expert"], AXES_FWD_TOL)):
        batch = next(src.batches())
        table.begin_pass(src.unique_keys())
        models = [zoo_model(n, w, "cuda") for n in names]
        logits = _logits_on(table, models, batch)
        table.end_pass()
        for n, lg in zip(names[1:], logits[1:]):
            err = _max_rel(lg, logits[0])
            if not err <= tol:
                raise AssertionError(f"axes {n} forward: {err} from "
                                     f"{names[0]}")
            report.append(f"{n} {err!r}")
    table.begin_pass(zipf0.unique_keys())
    bf = [zoo_model(n, w, "cuda", compute_dtype="bfloat16")
          for n in ("ctr", "pipelined")]
    lc, lp = _logits_on(table, bf, next(zipf0.batches()))
    table.end_pass()
    table.close()
    err = _max_rel(lp, lc)
    if not (lp.dtype == torch.float32 and err <= AXES_BF16_TOL):
        raise AssertionError(f"axes pipelined bf16 forward: {err}")
    log(f"axes forward, sharded against serial ({spans} of the sequence "
        f"batch's instances reach all {AXIS_POSITIONS} chunks), max |d| / "
        "(1 + |x|): " + "; ".join(report) + f"; pipelined bf16 against bf16 CtrDnn {err!r}")
    # trained: sharded against serial on the card, card against CPU
    report = []
    for names, sets, cache in (
            (["longseq_full", "longseq_ring", "longseq_ulysses"], [seq2], 0),
            (["ctr", "pipelined"], [zipf0], 0),
            (["mmoe", "mmoe_expert"], [log2], 0),
            (["retrieval"], [zipf0, zipf1], None)):
        runs = trained_runs(names, sets, cache_rows=cache)
        for n in names:
            report.append(agree(
                f"{n} card/CPU", runs[(n, "cuda")], runs[(n, "cpu")],
                g2sum_rtol=RETRIEVAL_G2SUM_RTOL if n == "retrieval" else None))
        for n in names[1:]:
            report.append(agree(f"{n}/{names[0]}", runs[(n, "cuda")],
                                runs[(names[0], "cuda")]))
    log("axes trained agreement, max abs diff: " + "; ".join(report))
    # the row kernels at the sequence arm's capacity
    gen = torch.Generator(device="cuda").manual_seed(15)
    values = torch.randn((1 << 21, 10), device="cuda", generator=gen)
    idx = torch.randint(0, 1 << 21, (SEQ_KEY_CAPACITY,), device="cuda",
                        generator=gen, dtype=torch.int32)
    uniq = torch.randperm((1 << 21) - 1, device="cuda",
                          generator=gen)[:SEQ_KEY_CAPACITY].to(torch.int32)
    delta = torch.randn((SEQ_KEY_CAPACITY, 10), device="cuda", generator=gen)
    if not (torch.equal(sk.pull_rows(values, idx),
                        sk.pull_rows_plain(values, idx))
            and torch.equal(sk.scatter_add_rows(values.clone(), uniq, delta),
                            sk.scatter_add_rows_plain(values.clone(), uniq,
                                                      delta))):
        raise AssertionError("a row kernel differs from its twin at the "
                             "sequence arm's key capacity")
    del values, delta
    # PipelineTrainer: the pipeline's gradient is the sequential oracle's
    pipeline_trainer_check()
    aux_tables_check()
    sk.launches.update(saved)


def pipeline_trainer_check() -> None:
    """PipelineTrainer at d_in PIPE_D_IN, width PIPE_WIDTH, PIPE_DEPTH
    layers a stage, AXIS_POSITIONS stages and PIPE_MICROBATCHES
    microbatches of BATCH / PIPE_MICROBATCHES: the gradient through the
    schedule against the sequential oracle's (reference_forward_loss), an
    SGD step applying exactly it, and ms per Adam step."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.parallel import PipelineTrainer, make_mesh
    from paddlebox_tpu_torch.parallel import pipeline as pipe

    rng = np.random.default_rng(16)
    mb = BATCH // PIPE_MICROBATCHES
    x = rng.normal(size=(PIPE_MICROBATCHES, mb, PIPE_D_IN)).astype(np.float32)
    y = (x.mean(-1) > 0).astype(np.float32)
    mask = np.ones_like(y)
    mesh = make_mesh(AXIS_POSITIONS, device="cuda", axis_name="pipe")
    params = pipe.init_pipeline_params(PIPE_D_IN, PIPE_WIDTH, PIPE_DEPTH,
                                       AXIS_POSITIONS, seed=2, device="cuda")
    dev = [torch.from_numpy(a).cuda() for a in (x, y, mask)]
    grads = []
    for fn in (lambda p: pipe.pipeline_forward_loss(p, *dev)[0],
               lambda p: pipe.reference_forward_loss(p, *dev)):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        fn(p).backward()
        grads.append({k: v.grad for k, v in p.items()})
    errs = {k: float((grads[0][k] - grads[1][k]).abs().max()
                     / grads[1][k].abs().max().clamp(min=1e-30))
            for k in params}
    lr = 0.1
    tr = PipelineTrainer(mesh, PIPE_D_IN, PIPE_WIDTH, PIPE_DEPTH,
                         params=params, optimizer=lambda ps: (
                             torch.optim.SGD(ps, lr=lr)))
    tr.train_step(x, y, mask)
    step = max(float(((params[k] - tr.params[k].detach())
                      - lr * grads[1][k]).abs().max()) for k in params)
    if not (max(errs.values()) <= 1e-4 and step <= 1e-5):
        raise AssertionError(f"PipelineTrainer: gradient against the oracle "
                             f"{errs}, SGD step off by {step}")
    tr = PipelineTrainer(mesh, PIPE_D_IN, PIPE_WIDTH, PIPE_DEPTH, seed=3)
    losses = [tr.train_step(x, y, mask) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        losses.append(tr.train_step(x, y, mask))
    step_ms = (time.perf_counter() - t0) * 100.0
    if not losses[-1] < losses[0]:
        raise AssertionError(f"PipelineTrainer did not learn: {losses}")
    log(f"axes PipelineTrainer ({AXIS_POSITIONS} stages, d_in {PIPE_D_IN}, "
        f"width {PIPE_WIDTH}, depth {PIPE_DEPTH} a stage, M "
        f"{PIPE_MICROBATCHES}): gradient against the sequential oracle, max "
        f"|d| / max |g| {max(errs.values())!r}; SGD step off by {step!r}; "
        f"Adam {step_ms!r} ms a step (host-synchronized by the loss "
        f"readback), loss {losses[0]!r} -> {losses[-1]!r}")


def aux_tables_check() -> None:
    """ReplicaCache.pull and InputTable rows on the card against the
    host."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.sparse.aux_tables import InputTable, ReplicaCache

    rng = np.random.default_rng(17)
    matrix = rng.normal(size=(4096, 8)).astype(np.float32)
    cache = ReplicaCache(matrix, device="cuda")
    ids = rng.integers(-5, 4200, size=BATCH)
    want = np.concatenate([np.zeros((1, 8), np.float32), matrix])[
        np.where((ids >= 0) & (ids <= 4096), ids, 0)]
    got = cache.pull(ids)
    table = InputTable(dim=8, device="cuda")
    for i in range(100):
        table.add_row(f"ad-{i}", matrix[i])
    keys = [f"ad-{i}" for i in rng.integers(0, 150, size=BATCH)]
    idx = torch.from_numpy(table.lookup_idx(keys)).cuda()
    rows = table.rows_device().index_select(0, idx)
    if not (got.device.type == "cuda"
            and np.array_equal(got.cpu().numpy(), want)
            and np.array_equal(rows.cpu().numpy(), table.lookup_rows(keys))):
        raise AssertionError("the aux tables on the card differ from the "
                             "host")
    log(f"axes aux tables: ReplicaCache.pull of {BATCH} ids (bad ids read "
        f"row 0) and {BATCH} InputTable rows on the card equal the host's")


def parallel_axes(zipf_sets, logkey_files, seq_files) -> dict:
    """This slice's models and parallel axes at the slice's width (16
    slots, 13 dense, batch 2048, embedding_dim 8, vocab 100 000): the
    retrieval, sequence, pipeline, expert and composed arms with the
    launch counters reset just before them and read just after (all six
    kernels must launch), then their checks (axes_checks) and the full,
    ring and Ulysses attention arms' synchronized ms a step."""
    import itertools

    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    t0 = time.perf_counter()
    seq_ds = seq_load(seq_files)
    logkey = PadBoxSlotDataset(data_conf(), read_threads=AXES_LOGKEY_FILES)
    logkey.set_filelist(logkey_files[:AXES_LOGKEY_FILES])
    logkey.load_into_memory()
    log(f"axes data: the sequence set, {seq_ds.get_memory_data_size()} "
        f"instances, {seq_ds.unique_keys().shape[0]} census keys; the logkey "
        f"set's first {AXES_LOGKEY_FILES} files, "
        f"{logkey.get_memory_data_size()} instances; "
        f"{time.perf_counter() - t0!r} s")
    spans = seq_spans("axes sequence set", seq_ds.batches(), AXIS_POSITIONS)
    # depth cut since the online phase: the single-chip arms' Zipf and
    # logkey passes over their first ZOO_ARM_BATCHES batches (all before)
    head = lambda d: _Batches(itertools.islice(d.batches(), ZOO_ARM_BATCHES))
    lk = head(logkey)
    data = {"zipf": [head(d) for d in zipf_sets[:2]], "logkey": [lk, lk],
            "seq": [seq_ds]}
    sk.reset_launches()
    out = {"retrieval": retrieval_arm(zipf_sets),
           "single": zoo_single(data, AXES_SINGLE, "axes"),
           "composed": composed_arm(logkey, seq_ds)}
    launches = dict(sk.launches)
    if seq_ds.builder.dropped_keys:
        raise AssertionError(f"the sequence set dropped "
                             f"{seq_ds.builder.dropped_keys} keys")
    log(f"axes sequence set: sequences of 1 to {SEQ_T} positions, {spans} "
        f"of {seq_ds.get_memory_data_size()} instances reach all "
        f"{AXIS_POSITIONS} chunks, 0 keys dropped")
    log(f"axes launches (every arm): {launches}")
    for name in sk.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "parallel axes' path")
    axes_checks(zipf_sets, logkey, seq_ds)
    ms = {name: _step_ms(name, itertools.islice(seq_ds.batches(),
                                                AXES_MS_STEPS))
          for name in ("longseq_full", "longseq_ring", "longseq_ulysses")}
    log("axes synchronized ms a step (sequence set, median of "
        f"{AXES_MS_STEPS - 1}): " + "; ".join(f"{n} {v!r}"
                                              for n, v in ms.items()))
    seq_ds.close()
    logkey.close()
    out.update(launches=launches, step_ms=ms)
    return out


# --------------------------------------------------------------------------- #
# phase 8c: the serving plane
# --------------------------------------------------------------------------- #
# the export's second shape bucket: one /score request of SERVE_INS
# instances (16 slots of up to 3 keys: at most 3 072 keys); the load test's
# requests (depth cut since the criteo phase: 120, 240 before), clients and
# queries
SERVE_INS = 64
SERVE_BUCKET = (SERVE_INS, 4096)
SERVE_DTYPES = ("fp32", "int8", "fp8")
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_BATCHES = 8, 120, 2
RETRIEVE_QUERIES, RETRIEVE_REQUESTS, RETRIEVE_K = 16, 200, 10
# scores of one instance through two float32 towers that sum in another
# order (the card's index_add, the CPU's): the reference tests' bound
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6


def _predict_parts(pred, batch) -> tuple:
    """Synchronized ms of one predict's parts: host prepare and key upload,
    the resolve (sorted_search + gather_slots), the program with its host
    inputs' upload and the scores' readback."""
    import torch

    t0 = time.perf_counter()
    b, _, K, program, host = pred.prepare(batch)
    q = pred.upload_keys(batch.keys, int(batch.n_keys))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    args = pred.resolve(q, K)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        program(*args, *[torch.from_numpy(a).cuda() for a in host])[:b].cpu()
    t3 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def _post(port: int, path: str, body: bytes) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        data = json.loads(r.read())
        dt = time.perf_counter() - t0
    finally:
        conn.close()
    if r.status != 200:
        raise AssertionError(f"POST {path}: {r.status} {data}")
    return data, dt


def _load_test(port: int, bodies: list, clients: int) -> tuple:
    """``bodies`` posted to /score by ``clients`` threads (each its share,
    in turn): (responses, latencies s, wall s)."""
    import threading

    out, lat, errors = [None] * len(bodies), [0.0] * len(bodies), []

    def run(c):
        try:
            for i in range(c, len(bodies), clients):
                out[i], lat[i] = _post(port, "/score", bodies[i])
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, lat, time.perf_counter() - t0


def _rate_line(label: str, n: int, lat: list, wall: float) -> str:
    import numpy as np

    return (f"{label}: {n / wall!r} requests/s, p50 "
            f"{float(np.percentile(lat, 50)) * 1e3!r} ms, p99 "
            f"{float(np.percentile(lat, 99)) * 1e3!r} ms over {n}")


def serving(res, ds, axes) -> dict:
    """The serving plane at the slice's width: the slice pass's trained
    uncached table (1 570 824 keys) and tower exported in fp32, int8 and
    fp8 with a second bucket SERVE_BUCKET; the launch counters reset, every
    batch of one pass scored by the card Predictor (sorted_search and
    gather_slots must launch) and read; both kernels bit-exact against
    their twins at the serving shapes; predict against the trainer's
    forward and the CPU Predictor, each quantized artifact against the
    fp32 program fed its dequantized rows, on SERVE_BATCHES batches; a
    ScoringServer's /score equal to predict for one client and for
    SERVE_CLIENTS (max_batch 8); an ANN index of the parallel_axes
    TwoTower table behind /retrieve.  Prints export seconds and bytes,
    load seconds, predict ms by part, requests/s with p50 and p99, and
    queries/s."""
    import itertools

    import numpy as np
    import torch

    from paddlebox_tpu_torch.inference import (
        Predictor,
        ScoringServer,
        export_ann_index,
        export_model,
        quant,
    )
    from paddlebox_tpu_torch.ops import sparse_kernels as sk

    table, model = res["table"], res["trainer"].model
    dirs, preds = {}, {}
    for dtype in SERVE_DTYPES:
        d = dirs[dtype] = os.path.join(WORK_DIR, f"serve-{dtype}")
        t0 = time.perf_counter()
        export_model(model, table, d, batch_size=BATCH,
                     key_capacity=KEY_CAPACITY, dense_dim=DENSE,
                     embedding_dtype=dtype, batch_buckets=[SERVE_BUCKET],
                     feed_conf=ds.conf)
        export_s = time.perf_counter() - t0
        sizes = {f: os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(d) for f in fs}
        t0 = time.perf_counter()
        preds[dtype] = Predictor.load(d)
        torch.cuda.synchronize()
        log(f"serve export {dtype}: {export_s!r} s, {sum(sizes.values())} "
            f"bytes (sparse {sum(v for k, v in sizes.items() if k.endswith('.npy'))}, "
            f"programs {sum(v for k, v in sizes.items() if k.endswith('.pt2'))}); "
            f"Predictor.load {time.perf_counter() - t0!r} s, "
            f"{preds[dtype].n_features} keys")
    pred = preds["fp32"]
    if pred.n_features != table.n_features:
        raise AssertionError(f"artifact holds {pred.n_features} keys")

    # the main path: every batch of one pass through the card Predictor
    ds.local_shuffle(seed=0)
    sk.reset_launches()
    t0 = time.perf_counter()
    n_ins = n_batches = 0
    for batch in ds.batches(drop_last=False):
        p = pred.predict(batch)
        if p.shape != (batch.n_real_ins,) or not np.isfinite(p).all():
            raise AssertionError(f"serve predict: {p.shape}, finite "
                                 f"{np.isfinite(p).all()}")
        n_ins += p.shape[0]
        n_batches += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.launches)
    log(f"serve pass: {n_batches} batches, {n_ins} instances in {wall!r} s "
        f"({n_ins / wall!r} instances/s); launches {launches}")
    if launches["sorted_search"] != n_batches or launches[
            "gather_slots"] != n_batches:
        raise AssertionError("serve: sorted_search and gather_slots must "
                             "launch once a batch")
    batches = list(itertools.islice(ds.batches(), SERVE_BATCHES))
    parts = np.array([_predict_parts(pred, b) for b in batches * 5])
    med = [float(x) for x in np.median(parts, axis=0)]
    log(f"serve predict ms (median of {len(parts)}, {batches[0].n_keys} "
        f"keys a batch): prepare + key upload {med[0]!r}, resolve "
        f"{med[1]!r}, program {med[2]!r}, total {sum(med)!r}")

    # the two kernels at the serving shapes: the first batch's keys filled
    # to the key capacity with unseen ones, above 2^63 among them
    saved = dict(sk.launches)
    rng = np.random.default_rng(21)
    b0 = batches[0]
    qk = rng.integers(0, 2**64 - 1, size=KEY_CAPACITY, dtype=np.uint64)
    qk[: b0.n_keys] = b0.keys[: b0.n_keys]
    q = torch.from_numpy(qk.view(np.int64)).cuda()
    slots = sk.sorted_search(pred._hay, pred._n_real, q)
    want = sk.sorted_search_plain(pred._hay.cpu(), pred._n_real, q.cpu())
    err = {"sorted_search": int((slots.cpu() != want).sum())}
    for label, t in [("rows", pred._dev[0])] + [
            (f"{d} {n}", x) for d in ("int8", "fp8")
            for n, x in zip(("head", "codes", "scales"), preds[d]._dev)]:
        # bit for bit: the codes' float32 view may hold NaN patterns
        got = sk.gather_slots(t, slots).cpu().view(torch.int32)
        plain = sk.gather_slots_plain(t.cpu(), want).view(torch.int32)
        err[f"gather_slots {label}"] = int((got != plain).sum())
    sk.launches.update(saved)
    log(f"serve kernels at the serving shapes (haystack "
        f"{pred._hay.shape[0]}, {pred._n_real} real; {KEY_CAPACITY} queries, "
        f"{int((want < 0).sum())} unseen; tables [{pred._n_real}, W] of W "
        f"10, 3, 2, 1): elements that differ from the twin {err}")
    if any(err.values()):
        raise AssertionError(f"serve kernels differ from their twins: {err}")

    # predict against the trainer's forward, the CPU Predictor, and each
    # quantized artifact against the fp32 program fed its dequantized rows
    table.begin_pass(ds.unique_keys())
    try:
        fwd = [torch.sigmoid(_logits_on(table, [model], b)[0]).cpu().numpy()
               for b in batches]
    finally:
        table.abort_pass()
    cpu = Predictor.load(dirs["fp32"], device="cpu")
    rel = {"trainer forward": 0.0, "CPU Predictor": 0.0, "int8": 0.0,
           "fp8": 0.0}
    deq = {d: Predictor(pred.meta, preds[d]._keys, quant.dequantize_rows(
        preds[d]._head, preds[d]._q, preds[d]._scales), dirs["fp32"],
        pred._buckets, programs=pred._programs) for d in ("int8", "fp8")}
    for i, b in enumerate(batches):
        got = pred.predict(b)
        n = got.shape[0]
        for label, want in (("trainer forward", fwd[i][:n]),
                            ("CPU Predictor", cpu.predict(b))):
            np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                       atol=SERVE_ATOL, err_msg=label)
            rel[label] = max(rel[label], float(np.abs(got - want).max()))
        for d in ("int8", "fp8"):
            qgot, qwant = preds[d].predict(b), deq[d].predict(b)
            np.testing.assert_allclose(qgot, qwant, rtol=SERVE_RTOL,
                                       atol=SERVE_ATOL, err_msg=d)
            rel[d] = max(rel[d], float(np.abs(qgot - qwant).max()))
        log(f"serve batch {i}: fp32 against int8 / fp8 scores, max abs "
            f"{float(np.abs(got - preds['int8'].predict(b)).max())!r} / "
            f"{float(np.abs(got - preds['fp8'].predict(b)).max())!r}")
    log(f"serve agreement (max abs over {SERVE_BATCHES} batches, bound "
        f"{SERVE_RTOL} relative + {SERVE_ATOL}): {rel}")

    # /score: one client, then SERVE_CLIENTS with micro-batching
    with open(ds.filelist[0]) as f:
        lines = list(itertools.islice(f, SERVE_INS * SERVE_REQUESTS))
    bodies = ["".join(lines[i:i + SERVE_INS]).encode()
              for i in range(0, len(lines), SERVE_INS)]
    server = ScoringServer(max_batch=8, batch_linger_ms=2.0)
    server.register("ctr", dirs["fp32"])
    want = [server.score_lines(body) for body in bodies]
    port = server.start(port=0)
    # the fleet phase's inputs: the fp32 artifact, these requests and this
    # direct server's rates
    fleet_in = {"art": dirs["fp32"], "bodies": bodies, "rates": {}}
    try:
        _load_test(port, bodies[:8], 1)  # warm-up
        for clients in (1, SERVE_CLIENTS):
            out, lat, wall = _load_test(port, bodies, clients)
            for o, w in zip(out, want):
                np.testing.assert_allclose(o["scores"], w, rtol=SERVE_RTOL,
                                           atol=SERVE_ATOL)
            fleet_in["rates"][clients] = _rate_line(
                f"serve /score, {clients} client(s), {SERVE_INS} instances "
                "a request", len(bodies), lat, wall)
            log(fleet_in["rates"][clients] + "; equal to predict")
    finally:
        server.stop()

    # /retrieve over the TwoTower item slot of the parallel_axes table
    rtable = axes["retrieval"]["table"]
    lo, hi = (N_SLOTS - 1) * VOCAB + 1, N_SLOTS * VOCAB
    t0 = time.perf_counter()
    index = export_ann_index(os.path.join(WORK_DIR, "serve-ann"), rtable,
                             item_key_lo=lo, item_key_hi=hi)
    rtable.close()
    log(f"serve ANN index: {index.n_items} items of dim "
        f"{index.emb.shape[1]} in {time.perf_counter() - t0!r} s")
    server = ScoringServer()
    server.register_predictor("items", index, None)
    port = server.start(port=0)
    try:
        qs = [rng.normal(size=(RETRIEVE_QUERIES, index.emb.shape[1]))
              .astype(np.float32) for _ in range(RETRIEVE_REQUESTS)]
        for tier in ("exact", "int8"):
            lat, t0 = [], time.perf_counter()
            for qm in qs:
                data, dt = _post(port, "/retrieve", json.dumps(
                    {"queries": qm.tolist(), "k": RETRIEVE_K,
                     "tier": tier}).encode())
                lat.append(dt)
            wall = time.perf_counter() - t0
            keys, scores = index.search(qs[-1], RETRIEVE_K, tier)
            if [r["keys"] for r in data["results"]] != keys.tolist():
                raise AssertionError(f"/retrieve {tier} keys differ")
            np.testing.assert_allclose(
                [r["scores"] for r in data["results"]], scores, rtol=1e-6)
            log(f"serve /retrieve {tier}: "
                f"{RETRIEVE_QUERIES * len(qs) / wall!r} queries/s "
                f"({RETRIEVE_QUERIES} a request, k {RETRIEVE_K}), p50 "
                f"{float(np.percentile(lat, 50)) * 1e3!r} ms, p99 "
                f"{float(np.percentile(lat, 99)) * 1e3!r} ms")
        qa = np.concatenate(qs[:8])
        ek, _ = index.search(qa, RETRIEVE_K, "exact")
        ik, _ = index.search(qa, RETRIEVE_K, "int8")
        recall = float(np.mean([len(set(a) & set(b)) / RETRIEVE_K
                                for a, b in zip(ek, ik)]))
        log(f"serve ANN int8 recall@{RETRIEVE_K} against exact: {recall!r}")
        if recall < 0.95:
            raise AssertionError(f"int8 recall@10 {recall} < 0.95")
    finally:
        server.stop()
    return fleet_in


# --------------------------------------------------------------------------- #
# phase 8d: the serving fleet
# --------------------------------------------------------------------------- #
# FLEET_REPLICAS replicas of ``python -m paddlebox_tpu_torch.serve`` on the
# card behind the router; the chaos run's clients; the waits; the timed
# requests (the first of the serving phase's; depth cut since the criteo
# phase: 64, 120 before)
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_WAIT_S = 2, 8, 180.0
FLEET_REQUESTS = 64


def _healthz(addr: str) -> bool:
    import http.client

    host, _, port = addr.rpartition(":")
    try:
        conn = http.client.HTTPConnection(host, int(port), timeout=2)
        try:
            conn.request("GET", "/healthz")
            return conn.getresponse().status == 200
        finally:
            conn.close()
    except OSError:
        return False


def _get_json(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _watch_up(targets) -> tuple:
    """({name: seconds from its t0 to its first /healthz 200}, the thread
    that fills it): ``targets`` is a dict {name: (address, t0)}, or a
    callable that returns one (it may block until the addresses are
    known).  The thread polls while the caller does other work, and ends
    once every target is up or after FLEET_WAIT_S."""
    import threading

    out: dict = {}

    def run():
        end = time.monotonic() + FLEET_WAIT_S
        todo = targets() if callable(targets) else targets
        while len(out) < len(todo) and time.monotonic() < end:
            for name, (addr, t0) in todo.items():
                if name not in out and _healthz(addr):
                    out[name] = time.monotonic() - t0
            time.sleep(0.05)

    th = threading.Thread(target=run, daemon=True, name="fleet-up")
    th.start()
    return out, th


def _up(watch: tuple, n: int, what: str, tails) -> dict:
    out, th = watch
    th.join(FLEET_WAIT_S + 10)
    if len(out) < n:
        raise AssertionError(f"fleet: {what}: only {out} up after "
                             f"{FLEET_WAIT_S} s\n{tails()}")
    return out


def _failovers(port: int) -> float:
    """The router's fleet.failovers count, from its /metrics."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.split("{")[0].split(" ")[0].endswith(
                   "fleet_failovers_total"))


def _children(pid: int) -> set:
    """The live (not zombie) child processes of ``pid``, from /proc."""
    out = set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, IndexError):
            continue
        if int(ppid) == pid and state != "Z":
            out.add(int(d))
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


# a replica of the in-process fleet: the serve module run as ``python -m``
# runs it (runpy), under deterministic algorithms, so its scores are
# bit-equal to a Predictor's in this process under them (the pooling's
# index_add otherwise adds in a varying order)
_DET_SERVE = ("import runpy, sys, torch; "
              "torch.use_deterministic_algorithms(True); "
              "sys.argv[0] = 'paddlebox_tpu_torch.serve'; "
              "runpy.run_module('paddlebox_tpu_torch.serve', "
              "run_name='__main__', alter_sys=True)")


def fleet_spawn(fleet_in: dict) -> dict:
    """Start the fleet phase's processes, so the replicas start (import,
    CUDA, artifact load) while the scenarios phase runs:

      * the fleet itself, ``python -m paddlebox_tpu_torch.serve --artifact
        ctr=<the serving phase's fp32 slice artifact> --replicas
        FLEET_REPLICAS --router-port 0``: a process whose supervisor starts
        the replicas on the card behind its router; a thread reads its
        output for the router's line;
      * an in-process ReplicaSupervisor of one replica under deterministic
        algorithms behind a FleetRouter, for the autoscaler's steps and
        the bit-equality with a Predictor.

    The handles go to _FLEETS, which main stops whatever happens."""
    import re
    import threading

    from paddlebox_tpu_torch import serve
    from paddlebox_tpu_torch.serving_fleet import FleetRouter, ReplicaSupervisor

    logs = os.path.join(WORK_DIR, "fleet-logs")
    det_logs = os.path.join(WORK_DIR, "fleet-det-logs")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.serve", "--artifact",
         f"ctr={fleet_in['art']}", "--replicas", str(FLEET_REPLICAS),
         "--router-port", "0", "--log-dir", logs],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    _FLEETS.append(proc)
    lines: list = []
    found: dict = {}
    ready = threading.Event()
    pat = re.compile(r"fleet router on http://[^ ]*:(\d+)/score "
                     r"\(\d+ replicas: ([^),]+(?:, [^),]+)*)")

    def read():
        for line in proc.stdout:
            lines.append(line)
            m = pat.search(line)
            if m and not ready.is_set():
                found["port"] = int(m.group(1))
                found["addrs"] = [a for a in m.group(2).split(", ")
                                  if a != "autoscaling"]
                ready.set()
        ready.set()  # the fleet exited: the waiters see no port

    threading.Thread(target=read, daemon=True, name="fleet-out").start()

    def targets():
        ready.wait(FLEET_WAIT_S)
        return {i: (a, t0) for i, a in enumerate(found.get("addrs", []))}

    args = serve._build_parser().parse_args(
        ["--artifact", f"ctr={fleet_in['art']}", "--replicas", "1",
         "--log-dir", det_logs])
    sup = ReplicaSupervisor(
        1, lambda rid, p: [sys.executable, "-c", _DET_SERVE,
                           *serve._replica_argv(args, rid, p)[3:]],
        log_dir=det_logs)
    sup.start()
    router = FleetRouter(sup.endpoints())
    _FLEETS.append((router, sup))
    return {"proc": proc, "lines": lines, "found": found, "ready": ready,
            "logs": logs, "det_logs": det_logs, "up": _watch_up(targets),
            "sup": sup, "router": router, "det_port": router.start(port=0),
            "det_up": _watch_up({0: (f"{sup.host}:{sup.replicas[0].port}",
                                     sup.replicas[0].started_at)})}


# the fleets main must stop: serve processes and (router, supervisor) pairs
_FLEETS: list = []


def _await_serving(n: int, what: str, view) -> None:
    """Until ``view()`` (a router's fleet view, or its /healthz) counts n
    serving replicas."""
    end = time.monotonic() + FLEET_WAIT_S
    while view()["n_serving"] != n:
        if time.monotonic() > end:
            raise AssertionError(f"fleet: {what}: {view()}")
        time.sleep(0.1)


def _fleet_clients(port: int, bodies: list) -> tuple:
    """FLEET_CLIENTS threads posting ``bodies`` to /score until stopped:
    (stop event, threads, failures, [requests that succeeded])."""
    import threading

    stop, bad, n_ok = threading.Event(), [], [0]

    def client(c):
        i = c
        while not stop.is_set():
            try:
                data, _ = _post(port, "/score", bodies[i % len(bodies)])
                if len(data["scores"]) != SERVE_INS:
                    bad.append("short reply")
                n_ok[0] += 1
            except Exception as e:  # counted: none may fail
                bad.append(repr(e)[:200])
            i += FLEET_CLIENTS

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    return stop, threads, bad, n_ok


def fleet(fleet_in: dict, started: dict, card: str) -> None:
    """The serving fleet on the card, started by fleet_spawn before the
    scenarios phase.

    The fleet, ``python -m paddlebox_tpu_torch.serve --replicas``: each
    replica's start (the fleet's spawn to the replica's first /healthz
    200, beside the scenarios phase); the router's /score replies to the
    serving phase's requests of SERVE_INS lines, from both replicas,
    within SERVE_RTOL / SERVE_ATOL of the card Predictor's scores (the
    replicas run as a user runs them, without deterministic algorithms);
    requests/s, p50 and p99 through the router and straight to one
    replica at 1 and SERVE_CLIENTS clients (the router's hop), beside the
    serving phase's direct server; FLEET_CLIENTS clients send while a
    replica (a child of the fleet process) is SIGKILLed: no request
    fails, the supervisor restarts it and the router fails over and
    readmits it; then a SIGTERM stops the fleet and no replica outlives
    it.

    The in-process fleet (deterministic replicas), meanwhile: the
    autoscaler's scale_up starts a second replica while the chaos runs;
    the replies from both are bit-equal to the card Predictor's under
    deterministic algorithms; then one drained scale_down."""
    import signal

    import numpy as np
    import torch

    from paddlebox_tpu_torch.inference import ScoringServer
    from paddlebox_tpu_torch.serving_fleet import (
        AutoscalerConfig,
        FleetAutoscaler,
    )

    bodies = fleet_in["bodies"]
    proc, sup, router = started["proc"], started["sup"], started["router"]
    det_port = started["det_port"]
    t_ph, marks = time.monotonic(), []

    def mark(label):
        marks.append(f"{label} {time.monotonic() - t_ph:.2f}")

    one = ScoringServer()
    one.register("ctr", fleet_in["art"])
    want = [one.score_lines(b) for b in bodies[:FLEET_REQUESTS]]
    torch.use_deterministic_algorithms(True)
    try:
        det_want = [one.score_lines(b) for b in bodies[:16]]
    finally:
        torch.use_deterministic_algorithms(False)
    mark("predictor")

    def tails() -> str:
        out = ["--- serve --replicas output ---\n"
               + "".join(started["lines"])[-2000:]]
        for d in (started["logs"], started["det_logs"]):
            if os.path.isdir(d):
                out += [f"--- {f} ---\n" + open(os.path.join(d, f),
                        errors="replace").read()[-2000:]
                        for f in sorted(os.listdir(d))]
        return "\n".join(out)

    def close(got, ref, what):
        for o, w in zip(got, ref):
            np.testing.assert_allclose(o["scores"], w, rtol=SERVE_RTOL,
                                       atol=SERVE_ATOL, err_msg=what)

    def replies(port, n, ref, exact):
        """n requests one at a time: (their replicas, each equal to ref)."""
        import http.client

        served = set()
        for body, w in zip(bodies[:n], ref):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/score", body=body)
            r = conn.getresponse()
            data = json.loads(r.read())
            served.add(r.getheader("X-PBox-Replica"))
            conn.close()
            if r.status != 200:
                raise AssertionError(f"fleet: {r.status} {data}")
            if exact and data["scores"] != w:
                raise AssertionError("fleet: a routed reply differs from "
                                     "the card Predictor's scores")
            if not exact:
                close([data], [w], "fleet: a routed reply")
        return served

    try:
        try:
            if not started["ready"].wait(FLEET_WAIT_S) or \
                    "port" not in started["found"]:
                raise AssertionError("fleet: no router line")
            port, addrs = started["found"]["port"], started["found"]["addrs"]
            up = _up(started["up"], FLEET_REPLICAS, "the start", tails)
            _await_serving(FLEET_REPLICAS, "the start",
                           lambda: _get_json(port, "/healthz"))
            _up(started["det_up"], 1, "the in-process replica", tails)
        except (AssertionError, OSError) as e:
            raise AssertionError(f"{e}\n{tails()}")
        starts = [up[i] for i in range(FLEET_REPLICAS)]
        mark("up")
        log(f"fleet: python -m paddlebox_tpu_torch.serve --replicas "
            f"{FLEET_REPLICAS} on the card, router on {port}, replicas "
            f"{addrs}, each up (the fleet's spawn to the replica's first "
            f"/healthz 200: the fleet's import, the replica's import, CUDA "
            f"start, artifact load; beside the scenarios phase) in {starts} "
            f"s [{card}]")
        served = replies(port, 16, want, exact=False)
        if len(served) != FLEET_REPLICAS:
            raise AssertionError(f"fleet: replies came from {served}")
        log(f"fleet: 16 requests of {SERVE_INS} lines through the router "
            f"within rtol {SERVE_RTOL} / atol {SERVE_ATOL} of the card "
            f"Predictor's scores, from replicas {sorted(served)}")
        p0 = int(addrs[0].rpartition(":")[2])
        for p in (port, p0):
            _load_test(p, bodies[:8], 1)  # warm-up
        timed = bodies[:FLEET_REQUESTS]
        for clients in (1, SERVE_CLIENTS):
            for label, p in (("through the router", port),
                             ("straight to replica 0", p0)):
                out, lat, wall = _load_test(p, timed, clients)
                close(out, want, f"fleet /score {label}")
                log(_rate_line(f"fleet /score {label}, {clients} "
                               f"client(s), {SERVE_INS} instances a request",
                               len(timed), lat, wall) + f" [{card}]")
            log(f"fleet: the serving phase's direct server (no fleet): "
                f"{fleet_in['rates'][clients]}")
        mark("rates")
        # chaos: SIGKILL a replica of the fleet under FLEET_CLIENTS clients
        # while the in-process autoscaler adds a replica
        pids = _children(proc.pid)
        if len(pids) != FLEET_REPLICAS:
            raise AssertionError(f"fleet: replica processes {pids}")
        scaler = FleetAutoscaler(sup, router, AutoscalerConfig(
            min_replicas=1, max_replicas=2, drain_timeout_s=30.0))
        f0 = _failovers(port)
        stop, threads, bad, n_ok = _fleet_clients(port, bodies)
        try:
            time.sleep(0.5)
            t_kill = time.monotonic()
            victim = min(pids)
            os.kill(victim, signal.SIGKILL)
            addr = scaler.scale_up()
            new = sup.replicas[-1]
            det_up = _watch_up({1: (addr, new.started_at)})
            end = time.monotonic() + FLEET_WAIT_S
            while True:
                now = _children(proc.pid)
                if len(now) == FLEET_REPLICAS and victim not in now and \
                        all(_healthz(a) for a in addrs) and _get_json(
                            port, "/healthz")["n_serving"] == FLEET_REPLICAS:
                    break
                if time.monotonic() > end or proc.poll() is not None:
                    raise AssertionError(f"fleet: replica {victim} not "
                                         f"restarted\n{tails()}")
                time.sleep(0.05)
            back_s = time.monotonic() - t_kill
            new_s = _up(det_up, 1, "the scale-up", tails)[1]
            time.sleep(0.5)  # traffic over the whole fleet again
        finally:
            stop.set()
            for t in threads:
                t.join(60)
        if bad or n_ok[0] == 0:
            raise AssertionError(f"fleet chaos: {len(bad)} failed requests "
                                 f"of {n_ok[0] + len(bad)}: {bad[:3]}")
        log(f"fleet chaos: replica pid {victim} SIGKILLed under "
            f"{FLEET_CLIENTS} clients: {n_ok[0]} requests, 0 failed, "
            f"{_failovers(port) - f0} failovers; the fleet of "
            f"{FLEET_REPLICAS} serving again {back_s!r} s after the kill "
            f"[{card}]")
        mark("chaos")
        pids = _children(proc.pid)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(30)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"fleet: SIGTERM did not stop the fleet\n"
                                 f"{tails()}")
        end = time.monotonic() + 20
        while any(_pid_alive(p) for p in pids) and time.monotonic() < end:
            time.sleep(0.05)
        if rc != 0 or any(_pid_alive(p) for p in pids):
            raise AssertionError(f"fleet: after SIGTERM rc {rc}, replicas "
                                 f"alive {[p for p in pids if _pid_alive(p)]}")
        mark("sigterm")
        log(f"fleet: SIGTERM stopped the fleet (rc 0) and its replicas "
            f"{sorted(pids)}")
        # the in-process fleet: deterministic replies, then a scale-down
        def det_view():
            router.probe_once()
            return router.fleet_view()

        _await_serving(2, "the scale-up", det_view)
        served = replies(det_port, 16, det_want, exact=True)
        if len(served) != 2:
            raise AssertionError(f"fleet: replies came from {served}")
        log(f"fleet: autoscaler scale_up started replica {addr} (its spawn "
            f"to its first /healthz 200 in {new_s!r} s, beside the chaos); "
            f"16 requests through the in-process router bit-equal to the "
            f"card Predictor's scores under deterministic algorithms, from "
            f"replicas {sorted(served)} [{card}]")
        t0 = time.perf_counter()
        victim_id = scaler.scale_down()
        drain_s = time.perf_counter() - t0
        _await_serving(1, "the scale-down", det_view)
        if not sup.replicas[victim_id].retired or \
                sup.replicas[victim_id].alive():
            raise AssertionError("fleet: the scaled-down replica lives on")
        if replies(det_port, 2, det_want, exact=True) != {
                sup.endpoints()[0]}:
            raise AssertionError("fleet: a reply after the scale-down came "
                                 "from elsewhere")
        log(f"fleet: scale_down drained and retired replica {victim_id} in "
            f"{drain_s!r} s; 1 serving, replies still bit-equal")
        mark("scale_down")
    finally:
        _stop_fleets()
    if any(r.alive() for r in sup.replicas):
        raise AssertionError("fleet: a replica outlived the supervisor")
    mark("stopped")
    log(f"fleet: seconds into the phase at the end of each step: "
        f"{', '.join(marks)} [{card}]")


def _stop_fleets() -> None:
    while _FLEETS:
        f = _FLEETS.pop()
        if isinstance(f, subprocess.Popen):
            if f.poll() is None:
                f.terminate()  # the fleet stops its replicas
                try:
                    f.wait(30)
                except subprocess.TimeoutExpired:
                    f.kill()
                    f.wait()
        else:
            router, sup = f
            router.stop()
            sup.stop()


# --------------------------------------------------------------------------- #
# phase 8e: scenarios and runners
# --------------------------------------------------------------------------- #
# the multi-scenario and two-phase passes over the first SCEN_BATCHES
# batches of a Zipf set a scenario (two step groups of GRAPH_K); the AUC
# runner over the first file of a Zipf set (8 batches) and these groups
SCEN_BATCHES = 2 * GRAPH_K
AUC_GROUPS = {"g_slot0": ["slot0"],
              "g_first_half": [f"slot{i}" for i in range(N_SLOTS // 2)]}


def _scenario_world(device, sgd=False):
    """The MultiScenarioTrainer of the phase: a CtrDnn ranker at the bench
    widths and TwoTower retrieval at parallel_axes' over one slice-width
    table (the default cached table)."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.scenarios import MultiScenarioTrainer, ScenarioSpec
    from paddlebox_tpu_torch.sparse.table import SparseTable

    tconf = SparseTableConfig(embedding_dim=EMB)
    trkw = dict(dense_optimizer="sgd", dense_lr=ZOO_CPU_SGD_LR) if sgd else {}
    specs = [ScenarioSpec("ranker", zoo_model("ctr", tconf.row_width, device),
                          trainer_conf=TrainerConfig(**trkw)),
             ScenarioSpec("retrieval",
                          zoo_model("retrieval", tconf.row_width, device),
                          kind="retrieval", trainer_conf=TrainerConfig(**trkw))]
    return (SparseTable(tconf, seed=0, device=device),
            MultiScenarioTrainer(tconf, specs, device=device))


def _two_phase_world(device, mesh=False, sgd=False, **trkw):
    """The day loop's TwoPhaseTrainer: join over the first half of the
    slots, then update over all, two bench-width CtrDnn towers over one
    table (``mesh``: POSITIONS positions of the card, the sharded table)."""
    from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.parallel import ShardedSparseTable, make_mesh
    from paddlebox_tpu_torch.sparse.table import SparseTable
    from paddlebox_tpu_torch.train import PhaseSpec, TwoPhaseTrainer

    tconf = SparseTableConfig(embedding_dim=EMB)
    if sgd:
        trkw = dict(trkw, dense_optimizer="sgd", dense_lr=ZOO_CPU_SGD_LR)
    phases = [PhaseSpec("join", CtrDnn(N_SLOTS, tconf.row_width,
                                       dense_dim=DENSE, hidden=HIDDEN, seed=0,
                                       device=device),
                        slots=tuple(range(N_SLOTS // 2))),
              PhaseSpec("update", CtrDnn(N_SLOTS, tconf.row_width,
                                         dense_dim=DENSE, hidden=HIDDEN,
                                         seed=1, device=device))]
    if mesh:
        m = make_mesh(POSITIONS, device=device)
        return (ShardedSparseTable(tconf, m, seed=0),
                TwoPhaseTrainer(phases, tconf, TrainerConfig(**trkw), mesh=m))
    return (SparseTable(tconf, seed=0, device=device),
            TwoPhaseTrainer(phases, tconf, TrainerConfig(**trkw),
                            device=device))


def _phase_passes(tp, table, sets) -> list:
    out = []
    for data in sets:
        table.begin_pass(data.unique_keys())
        out.append(tp.train_pass(data, table))
        table.end_pass()
    return out


def _scen_agree(label, a, b, g2sum_rtol=None) -> str:
    """Per scenario or phase, agree()'s bounds on the shared table and that
    scenario's tower (``g2sum_rtol`` as agree's)."""
    (ma, sa, ta), (mb, sb, tb) = a, b
    return "; ".join(agree(f"{label} {n}", (ma[n], sa, ta[n].model),
                           (mb[n], sb, tb[n].model), g2sum_rtol=g2sum_rtol)
                     for n in ma)


def scenarios(zipf_sets, cached_files, card: str) -> None:
    """The multi-scenario trainer, the two-phase trainer and the AUC runner
    at the slice's width on the card (module docstring, phase scenarios)."""
    import itertools

    import torch

    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.train.auc_runner import AucRunner

    def head(d, n, skip=0):
        return _Batches(itertools.islice(d.batches(), skip, skip + n))

    # (a) two scenarios over one table, 2 passes: the ranker on the first
    # SCEN_BATCHES batches of a Zipf set, retrieval on the next
    sets = [{"ranker": head(d, SCEN_BATCHES),
             "retrieval": head(d, SCEN_BATCHES, SCEN_BATCHES)}
            for d in zipf_sets[:2]]
    table, mst = _scenario_world("cuda")
    before = dict(sk.launches)
    t0 = time.perf_counter()
    per_pass = [mst.train_pass(s, table) for s in sets]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: sk.launches[k] - before[k] for k in sk.launches}
    steps = sum(m["steps"] for r in per_pass for m in r.values())
    if not (launches["pull_rows"] == launches["scatter_add_rows"] == steps
            == 2 * 2 * SCEN_BATCHES):
        raise AssertionError(f"scenarios: {steps} steps, launches {launches}")
    for r in per_pass:
        for n, m in r.items():
            if not (math.isfinite(m["loss"]) and 0.0 < m["auc"] < 1.0):
                raise AssertionError(f"scenarios {n}: {m}")
    table.close()
    log(f"scenarios: ranker (CtrDnn {HIDDEN}) and retrieval (TwoTower) "
        f"interleaved over one table, 2 passes of {SCEN_BATCHES} batches "
        f"each, {secs!r} s, {2 * 2 * SCEN_BATCHES * BATCH / secs!r} "
        f"samples/s; per pass " + "; ".join(
            ", ".join(f"{n} loss {m['loss']!r} auc {m['auc']!r}"
                      for n, m in r.items()) for r in per_pass)
        + f"; launches {launches} [{card}]")
    saved = dict(sk.launches)
    one = {"ranker": head(zipf_sets[0], 1),
           "retrieval": head(zipf_sets[0], 1, 1)}
    runs = {}
    for device in ("cuda", "cpu"):
        table, mst = _scenario_world(device, sgd=True)
        m = mst.train_pass(one, table)
        runs[device] = (m, table.state_dict(), mst.trainers)
        table.close()
    # the retrieval scenario's pushes share the table's g2sum column:
    # parallel_axes' retrieval bound on it
    log("scenarios card vs CPU (1 batch a scenario), max abs diff: "
        + _scen_agree("scenarios", runs["cuda"], runs["cpu"],
                      g2sum_rtol=RETRIEVAL_G2SUM_RTOL))

    # (b) the day loop's two phases, 2 passes; scan_steps GRAPH_K (a CUDA
    # graph a phase) bit-equal to eager steps under deterministic algorithms
    sets = [head(d, SCEN_BATCHES) for d in zipf_sets[:2]]
    det = {}
    torch.use_deterministic_algorithms(True)
    try:
        for k in (1, GRAPH_K):
            table, tp = _two_phase_world("cuda", scan_steps=k)
            t0 = time.perf_counter()
            out = _phase_passes(tp, table, sets)
            torch.cuda.synchronize()
            det[k] = (out, table.state_dict(), time.perf_counter() - t0,
                      {n: tr.graph_captures for n, tr in tp.trainers.items()})
            tp.close()
            table.close()
    finally:
        torch.use_deterministic_algorithms(False)
    (eo, es, esec, _), (go, gs, gsec, caps) = det[1], det[GRAPH_K]
    keys = ("loss", "auc", "count")
    _sync_equal("two-phase graph against eager steps", gs, es,
                [r[n][k] for r in go for n in r for k in keys],
                [r[n][k] for r in eo for n in r for k in keys])
    if caps != {"join": 2, "update": 2}:
        raise AssertionError(f"two-phase graph captures {caps}")
    log(f"two-phase (join slots 0-{N_SLOTS // 2 - 1}, then update): 2 passes "
        f"of {SCEN_BATCHES} batches, eager {esec!r} s, scan_steps {GRAPH_K} "
        f"{gsec!r} s (captures a phase {caps}), bit-equal under "
        f"deterministic algorithms; per pass " + "; ".join(
            ", ".join(f"{n} loss {m['loss']!r} auc {m['auc']!r}"
                      for n, m in r.items()) for r in eo) + f" [{card}]")
    runs = {}
    for device in ("cuda", "cpu"):
        table, tp = _two_phase_world(device, sgd=True)
        (m,) = _phase_passes(tp, table, [head(zipf_sets[0], 1)])
        runs[device] = (m, table.state_dict(), tp.trainers)
        table.close()
    log("two-phase card vs CPU (1 batch), max abs diff: "
        + _scen_agree("two-phase", runs["cuda"], runs["cpu"]))
    table, tp = _two_phase_world("cuda", mesh=True)
    before = dict(sk.launches)
    (m,) = _phase_passes(tp, table, [head(zipf_sets[0], SCEN_BATCHES)])
    launches = {k: sk.launches[k] - before[k] for k in sk.launches}
    tp.close()
    table.close()
    for n, r in m.items():
        if not (math.isfinite(r["loss"]) and r["count"] == SCEN_BATCHES * BATCH):
            raise AssertionError(f"two-phase on the mesh, {n}: {r}")
    if launches["pull_rows"] <= 0 or launches["scatter_add_rows"] <= 0:
        raise AssertionError(f"two-phase on the mesh: launches {launches}")
    log(f"two-phase with mesh= ({POSITIONS} positions of the card): "
        + ", ".join(f"{n} loss {r['loss']!r} auc {r['auc']!r}"
                    for n, r in m.items()) + f"; launches {launches}")
    sk.launches.update(saved)

    # (c) the AUC runner: the trained update tower and table, on the card
    # and (their copies) on the CPU, over the first file of a Zipf set
    ds = load(cached_files[0][:1], 1)
    table, tp = _two_phase_world("cuda")
    _phase_passes(tp, table, [ds])
    tr = tp.trainers["update"]
    cpu_table, cpu_tp = _two_phase_world("cpu")
    cpu_table.load_state_dict(table.state_dict())
    cpu_tr = cpu_tp.trainers["update"]
    cpu_tr.model.load_state_dict({k: v.cpu() for k, v in
                                  tr.model.state_dict().items()})
    out = {}
    for dev, t, tb in (("cuda", tr, table), ("cpu", cpu_tr, cpu_table)):
        t0 = time.perf_counter()
        out[dev] = AucRunner(t, tb, seed=3).run(ds, AUC_GROUPS)
        out[dev]["seconds"] = time.perf_counter() - t0
        tb.close()
    ds.close()
    g, c = out["cuda"], out["cpu"]
    for name in ("baseline", *AUC_GROUPS):
        if abs(g[name]["auc"] - c[name]["auc"]) > 1e-3 or (
                name != "baseline"
                and abs(g[name]["delta"] - c[name]["delta"]) > 2e-3):
            raise AssertionError(f"auc runner {name}: card {g[name]} vs CPU "
                                 f"{c[name]}")
    log(f"auc runner over {g['baseline']['count']} instances: baseline auc "
        f"{g['baseline']['auc']!r}; " + ", ".join(
            f"{n} auc {g[n]['auc']!r} delta {g[n]['delta']!r} (CPU "
            f"{c[n]['delta']!r})" for n in AUC_GROUPS)
        + f"; card {g['seconds']!r} s, CPU {c['seconds']!r} s [{card}]")


# --------------------------------------------------------------------------- #
# phase 9c: the online loop
# --------------------------------------------------------------------------- #
# Windows of ONLINE_WINDOW records (8 full batches), cut by count; the
# writer lands shards of ONLINE_SHARD records (a tmp file renamed, as a
# feed lands them); (a) replays the first ONLINE_REPLAY_WINDOWS windows
# against one pass; the deadline publisher's freshness budget; (d) streams
# ONLINE_HOT_WINDOWS windows of the hot pattern (key ONLINE_HOT_KEY + s in
# slot s, outside the vocab, and one noise key a slot) labelled 1, then as
# many labelled 0, and the served score of the hot probe must rise by
# ONLINE_RISE over its score before them, then fall by ONLINE_DROP.  Depth
# cuts, each keeping its check: the replay over 2 windows and the hot
# pattern over at least 1 window a label (3 and 2 in this PR's first
# runs), the programs re-exported only on the hot pattern's deltas and on
# a last delta after the drain (the others carry rows only, the
# reference's default)
ONLINE_WINDOW, ONLINE_SHARD, ONLINE_REPLAY_WINDOWS = 8 * BATCH, 4096, 2
# Depth cut since the fleet and scenarios phases: after the hot pattern
# the stream carries ONLINE_TAIL_WINDOWS more windows of the slice records
# as rows-only deltas before the drain (the rest of the slice records
# before)
ONLINE_TAIL_WINDOWS = 2
ONLINE_STALENESS_S, ONLINE_HOT_WINDOWS, ONLINE_HOT_KEY = 8.0, 1, 10**9
ONLINE_RISE, ONLINE_DROP = 0.1, 0.2
# the longest wait for a window's rows to be served, and for the drain
ONLINE_WAIT_S = 120.0


class _ShardWriter:
    """The feed: a daemon thread lands the lines it is given in shard
    files under ``root``, each written to a ``.tmp`` name and renamed.
    ``written`` counts the records landed."""

    def __init__(self, root: str):
        import queue
        import threading

        self.root = root
        os.makedirs(root, exist_ok=True)
        self._q = queue.Queue()
        self.written = 0
        self.queued = 0
        self.first_write = None
        self._n = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="online-writer")
        self._thread.start()

    def feed(self, lines: list) -> None:
        for i in range(0, len(lines), ONLINE_SHARD):
            shard = lines[i:i + ONLINE_SHARD]
            self.queued += len(shard)
            self._q.put(shard)

    def _run(self) -> None:
        while True:
            shard = self._q.get()
            if shard is None:
                return
            path = os.path.join(self.root, f"part-{self._n:06d}")
            self._n += 1
            with open(path + ".tmp", "w") as f:
                f.write("\n".join(shard) + "\n")
            if self.first_write is None:
                self.first_write = time.perf_counter()
            os.rename(path + ".tmp", path)
            self.written += len(shard)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=60)


def _wait(cond, what: str, timeout: float = ONLINE_WAIT_S,
          tick=None) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"online: {what} within {timeout} s")
        if tick is not None:
            tick()
        time.sleep(0.02)


def online_replay(lines: list) -> None:
    """(a) Under deterministic algorithms the mini-pass replay of the
    first ONLINE_REPLAY_WINDOWS windows equals one pass over the same
    records bit for bit: the state dict, the delta and the AUC."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.data.dataset import PadBoxSlotDataset
    from paddlebox_tpu_torch.streaming import (
        IterableSource,
        MiniPassScheduler,
        StreamingTrainer,
    )

    n = ONLINE_REPLAY_WINDOWS * ONLINE_WINDOW
    d = os.path.join(WORK_DIR, "online-replay")
    os.makedirs(d)
    with open(os.path.join(d, "part-000"), "w") as f:
        f.write("\n".join(lines[:n]) + "\n")
    torch.use_deterministic_algorithms(True)
    try:
        conf, table, trainer = make_world(
            N_SLOTS, DENSE, BATCH, EMB, HIDDEN, "cuda",
            key_capacity=KEY_CAPACITY, cache_rows=CACHE_ROWS, seed=5)
        ds = PadBoxSlotDataset(conf, read_threads=1)
        ds.set_filelist([os.path.join(d, "part-000")])
        ds.load_into_memory()
        t0 = time.perf_counter()
        table.begin_pass(ds.unique_keys())
        m = trainer.train_from_dataset(ds, table)
        table.end_pass()
        one_s = time.perf_counter() - t0
        want, want_delta = table.state_dict(), table.pop_delta()
        table.close()
        ds.close()
        conf, table, trainer = make_world(
            N_SLOTS, DENSE, BATCH, EMB, HIDDEN, "cuda",
            key_capacity=KEY_CAPACITY, cache_rows=CACHE_ROWS, seed=5)
        src = IterableSource(lines[:n]).start()
        sched = MiniPassScheduler(src, conf, window_records=ONLINE_WINDOW,
                                  window_seconds=0.0).start()
        t0 = time.perf_counter()
        summary = StreamingTrainer(trainer, table, sched).run()
        stream_s = time.perf_counter() - t0
        got, got_delta = table.state_dict(), table.pop_delta()
        table.close()
    finally:
        torch.use_deterministic_algorithms(False)
    same = (np.array_equal(got["keys"], want["keys"])
            and np.array_equal(got["values"], want["values"])
            and np.array_equal(got_delta["keys"], want_delta["keys"])
            and np.array_equal(got_delta["values"], want_delta["values"])
            and summary["auc"] == m["auc"]
            and summary["windows"] == ONLINE_REPLAY_WINDOWS)
    log(f"online (a): {summary['windows']} windows of {ONLINE_WINDOW} "
        f"records ({stream_s!r} s) "
        f"against one pass over the same {n} ({one_s!r} s): state dict of "
        f"{got['keys'].shape[0]} rows, delta of {got_delta['keys'].shape[0]} "
        f"and AUC {summary['auc']!r} bit-equal: {same}")
    if not same:
        raise AssertionError("online (a): the mini-pass replay differs from "
                             "one pass")


def _hot_lines(rng, label: int, n: int) -> list:
    from paddlebox_tpu_torch.data.synth import stream_line

    hot = [ONLINE_HOT_KEY + s for s in range(N_SLOTS)]
    return [stream_line(rng, label, n_sparse_slots=N_SLOTS, dense_dim=DENSE,
                        hot_keys=hot, vocab_per_slot=VOCAB)[:-1]
            for _ in range(n)]


def _uniform_line(rng) -> str:
    from paddlebox_tpu_torch.data.synth import stream_line

    return stream_line(rng, int(rng.integers(0, 2)), n_sparse_slots=N_SLOTS,
                       dense_dim=DENSE, vocab_per_slot=VOCAB)[:-1]


def online(files: list, ds, card: str) -> None:
    """The online loop at the slice's width: (a) online_replay; then the
    slice pass's records land as shards in a stream directory, a
    TailingFileSource and the mini-pass scheduler cut windows of 8
    batches, a StreamingTrainer trains them on the card (HBM cache at its
    default) and a DeadlinePublishPolicy publishes to a local root, a base
    in fp32 first, then sparse row deltas, the hot pattern's and a last one
    after the drain with their re-exported programs; a card
    ScoringServer's Syncer hot-applies them, its ``applied_seq`` closing
    the freshness loop.  Checks (b) to (f) as the module docstring says;
    prints records/s, seconds a window, stream.freshness_seconds, the
    publishes, the applies split, predict ms after a delta."""
    import itertools
    import threading

    import numpy as np
    import torch

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.data.feed import BatchBuilder
    from paddlebox_tpu_torch.data.slot_parser import SlotParser
    from paddlebox_tpu_torch.inference import (
        Predictor,
        ScoringServer,
        export_model,
    )
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.serving_sync import Publisher, Syncer
    from paddlebox_tpu_torch.streaming import (
        DeadlinePublishPolicy,
        MiniPassScheduler,
        StreamingTrainer,
        TailingFileSource,
    )
    from paddlebox_tpu_torch.streaming import freshness
    from paddlebox_tpu_torch.streaming.minipass import (
        MiniPassWindow,
        WindowDataset,
    )

    lines = []
    for path in files:
        with open(path) as f:
            lines += f.read().splitlines()
    online_replay(lines)

    rng = np.random.default_rng(31)
    work = os.path.join(WORK_DIR, "online")
    conf, table, trainer = make_world(
        N_SLOTS, DENSE, BATCH, EMB, HIDDEN, "cuda",
        key_capacity=KEY_CAPACITY, cache_rows=CACHE_ROWS, seed=6)
    model = trainer.model
    # a warm pass of 2 batches of uniform records anchors the chain
    warm = [ln for ln in itertools.islice(lines, 2 * BATCH)]
    block = SlotParser(conf).parse_lines(warm)
    w0 = MiniPassWindow(0, block, np.unique(block.keys), len(warm),
                        time.time(), time.time(), "warm", time.time())
    table.begin_pass(w0.census)
    trainer.train_from_dataset(WindowDataset(w0, BatchBuilder(conf)), table)
    table.end_pass()
    lines = lines[2 * BATCH:]
    pub = Publisher(os.path.join(work, "publish"),
                    staging_dir=os.path.join(work, "staging"))
    t0 = time.perf_counter()
    base = pub.publish_base("base", model, None, table, batch_size=BATCH,
                            key_capacity=KEY_CAPACITY, dense_dim=DENSE,
                            feed_conf=conf, lineage="warm")
    log(f"online base: {base.n_rows} rows, {base.n_bytes} bytes in "
        f"{time.perf_counter() - t0!r} s")
    published = []  # (records trained at the publish, entry, seconds)
    delta = pub.publish_delta

    def timed_delta(*a, **kw):
        t = time.perf_counter()
        e = delta(*a, **kw)
        if e is not None:
            published.append((runner.records_trained, e,
                              time.perf_counter() - t))
        return e

    pub.publish_delta = timed_delta

    server = ScoringServer(device="cuda")
    syncer = Syncer(pub.root, server, "live",
                    cache_dir=os.path.join(work, "cache"),
                    poll_interval_s=0.05)
    applies = []
    apply_delta = syncer._apply_delta

    def split_apply(entry):
        apply_delta(entry)
        applies.append(dict(syncer.last_apply))

    syncer._apply_delta = split_apply
    syncer.poll_once()
    syncer.start()
    port = server.start(port=0)
    probe = ("1 0 " + " ".join(
        f"2 {ONLINE_HOT_KEY + s} {s * VOCAB + 7}" for s in range(N_SLOTS))
        + f" {DENSE} " + " ".join(["0.0"] * DENSE) + "\n").encode()

    def score() -> float:
        return _post(port, "/score/live", probe)[0]["scores"][0]

    source = TailingFileSource(os.path.join(work, "stream"),
                               poll_interval_s=0.02,
                               buffer_records=2 * ONLINE_WINDOW)
    sched = MiniPassScheduler(source, conf, window_records=ONLINE_WINDOW,
                              window_seconds=0.0)
    # windows stay at 8 batches: a publish that eats its share of the
    # budget counts as a miss, but cannot widen them
    policy = DeadlinePublishPolicy(pub, ONLINE_STALENESS_S, scheduler=sched,
                                   max_window_records=ONLINE_WINDOW)
    runner = StreamingTrainer(trainer, table, sched, policy=policy,
                              model=model,
                              served_seq_fn=lambda: syncer.applied_seq)
    windows, bad_windows, begins = [], [], []
    train_window = runner._train_window

    def checked_window(window, wd):
        before = dict(sk.launches)
        t = time.perf_counter()
        train_window(window, wd)
        windows.append(time.perf_counter() - t)
        begins.append(dict(table.last_begin_breakdown))
        after = dict(sk.launches)
        if not all(after[k] > before[k]
                   for k in ("pull_rows", "scatter_add_rows")):
            bad_windows.append(window.index)

    runner._train_window = checked_window
    fresh_vals = []
    fresh_hist = freshness._FRESHNESS
    observe = fresh_hist.observe

    def noted(v, **kw):
        fresh_vals.append(float(v))
        observe(v, **kw)

    fresh_hist.observe = noted
    writer = _ShardWriter(os.path.join(work, "stream"))
    sk.reset_launches()
    source.start()
    sched.start()
    run_out, run_err = {}, []

    def run():
        try:
            run_out.update(runner.run())
        except BaseException as e:  # re-raised below
            run_err.append(e)

    thread = threading.Thread(target=run, daemon=True, name="online-run")
    thread.start()
    filler = iter(lines[5 * ONLINE_WINDOW:])

    def alive():
        if run_err:
            raise AssertionError(f"online: the runner died: {run_err[0]!r}")

    hot_windows = {1: ONLINE_HOT_WINDOWS, 0: ONLINE_HOT_WINDOWS}

    def fill(label=None):
        # deadline publishes happen at window boundaries: one more window
        # whenever less than one is pending, of the hot pattern with
        # ``label``, else of the slice records (then uniform stream lines)
        alive()
        if writer.queued - runner.records_trained < ONLINE_WINDOW:
            if label is not None:
                writer.feed(_hot_lines(rng, label, ONLINE_WINDOW))
                hot_windows[label] += 1
                return
            more = list(itertools.islice(filler, ONLINE_WINDOW))
            more += [_uniform_line(rng)
                     for _ in range(ONLINE_WINDOW - len(more))]
            writer.feed(more)

    def served_through(n_records: int) -> bool:
        # a delta with programs published once n_records were trained is
        # live
        return any(r >= n_records and e.has_programs
                   and syncer.applied_seq >= e.seq for r, e, _ in published)

    try:
        # the bulk: the first 5 windows of the slice records
        writer.feed(lines[:5 * ONLINE_WINDOW])
        bulk = 5 * ONLINE_WINDOW
        _wait(lambda: runner.records_trained >= bulk, "the bulk trained",
              tick=alive)
        bulk_s = time.perf_counter() - writer.first_write
        # from here on the deltas carry the re-exported programs, so the
        # served tower follows the trained one
        policy.publish_programs = True
        _wait(lambda: served_through(bulk), "the bulk served", tick=fill)
        s0 = score()
        # (d): the hot pattern labelled 1, then 0, streamed until a delta
        # with programs trained on it is live (as the reference's pin
        # streams it): the served tower is then the one trained on the
        # pattern, whose counters no uniform record resembles
        marks = []
        for label in (1, 0):
            writer.feed(_hot_lines(rng, label,
                                   ONLINE_HOT_WINDOWS * ONLINE_WINDOW))
            target = writer.queued
            _wait(lambda: served_through(target),
                  f"the hot label {label} windows served",
                  tick=lambda: fill(label))
            marks.append(score())
        high, low = marks
        # the rest of the slice records as rows-only deltas, then the
        # drain; a last delta then carries the final programs
        policy.publish_programs = False
        writer.feed(list(itertools.islice(
            filler, ONLINE_TAIL_WINDOWS * ONLINE_WINDOW)))
        _wait(lambda: writer.written == writer.queued, "the stream landed",
              tick=alive)
        runner.stop()  # the source's last sweep reads all; a drain window
        thread.join(timeout=ONLINE_WAIT_S)
        if thread.is_alive() or run_err:
            raise AssertionError(f"online: the runner did not drain: "
                                 f"{run_err}")
        loop_launches = dict(sk.launches)
        timed_delta("programs", table, model)
        last = pub.entries()[-1].seq
        _wait(lambda: syncer.applied_seq >= last, "the last delta applied")
        writer.close()
        n_rec = run_out["records"]
        log(f"online stream: {n_rec} records in {run_out['windows']} windows "
            f"of {sched.window_records}; the first {bulk} at "
            f"{bulk / bulk_s!r} records/s through the stream (landed to "
            f"trained); seconds a window (train, boundary and any publish) "
            f"p50 {float(np.percentile(windows, 50))!r}, p90 "
            f"{float(np.percentile(windows, 90))!r}; {run_out} [{card}]")
        log(f"online window boundaries: {sum(b['staged'] for b in begins)} "
            f"of {len(begins)} begin_pass consumed their stage; median s: "
            + ", ".join(f"{k} {float(np.median([b[k] for b in begins]))!r}"
                        for k in ("stage_wait_s", "patch_s", "resolve_s",
                                  "h2d_s", "cache_fill_s")))
        log(f"online stream.freshness_seconds (event to served, "
            f"{len(fresh_vals)} publishes confirmed, budget "
            f"{ONLINE_STALENESS_S} s): p50 "
            f"{float(np.percentile(fresh_vals, 50))!r}, p99 "
            f"{float(np.percentile(fresh_vals, 99))!r}; the histogram's "
            f"{fresh_hist.summary()} [{card}]")
        dl = [(e, s) for _, e, s in published]
        log(f"online publish_delta: {len(dl)} deltas, s "
            f"{[round(s, 4) for _, s in dl]}, bytes "
            f"{[e.n_bytes for e, _ in dl]}, rows {[e.n_rows for e, _ in dl]}, "
            f"with programs {sum(e.has_programs for e, _ in dl)} [{card}]")
        parts = {k: [a[k] for a in applies if a.get("kind") == "delta"]
                 for k in ("fetch_s", "merge_s", "upload_s", "swap_s")}
        log("online Syncer apply s a delta (median, max): " + ", ".join(
            f"{k} {float(np.median(v))!r} / {max(v)!r}"
            for k, v in parts.items()) + f" over {len(parts['merge_s'])} "
            f"deltas [{card}]")
        log(f"online launches over the live loop: {loop_launches}; windows "
            f"without pull_rows or scatter_add_rows {bad_windows}")
        # (f)
        if bad_windows or len(windows) != run_out["windows"]:
            raise AssertionError(f"online (f): windows {bad_windows} did not "
                                 "launch pull_rows and scatter_add_rows")
        for k in ("pull_rows", "scatter_add_rows", "gather_slots",
                  "scatter_rows", "sorted_search"):
            if loop_launches[k] <= 0:
                raise AssertionError(f"online: {k} never launched")
        # (d)
        log(f"online (d): hot probe served score {s0!r} before, {high!r} "
            f"after {hot_windows[1]} windows labelled 1, {low!r} after "
            f"{hot_windows[0]} labelled 0 (bounds: rise >= {ONLINE_RISE}, "
            f"fall >= {ONLINE_DROP})")
        if not (high - s0 >= ONLINE_RISE and high - low >= ONLINE_DROP):
            raise AssertionError("online (d): the served score did not move "
                                 "with the flipped labels")

        # (b): the served rows are the drained table's, bit for bit
        live = server._models["live"].predictor
        state = table.state_dict()
        w = table.conf.row_width
        rows_equal = (np.array_equal(live._keys, state["keys"])
                      and np.array_equal(live._values,
                                         state["values"][:, :w])
                      and np.array_equal(live._dev[0].cpu().numpy(),
                                         state["values"][:, :w]))
        fresh_dir = os.path.join(work, "fresh")
        export_model(model, table, fresh_dir, batch_size=BATCH,
                     key_capacity=KEY_CAPACITY, dense_dim=DENSE,
                     feed_conf=conf)
        fresh = Predictor.load(fresh_dir, device="cuda")
        sk.reset_launches()  # (c): serving after the last delta
        n_batches, worst, exact = 0, 0.0, True
        for b in ds.batches(drop_last=False):
            got = live.predict(b)
            n_batches += 1
            saved = dict(sk.launches)
            want = fresh.predict(b)
            sk.launches.update(saved)
            np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                       atol=SERVE_ATOL)
            worst = max(worst, float(np.abs(got - want).max()))
            exact = exact and np.array_equal(got, want)
        serve_launches = dict(sk.launches)
        log(f"online (b): served snapshot {live.n_features} keys, rows "
            f"(host and card) bit-equal to the drained table's: "
            f"{rows_equal}; a pass of {n_batches} batches scored as a "
            f"Predictor exported from the final table: max abs "
            f"{worst!r}, bit-equal {exact}")
        if not rows_equal:
            raise AssertionError("online (b): served rows differ from the "
                                 "table's")
        # (c)
        saved = dict(sk.launches)
        b0 = next(iter(ds.batches()))
        qk = rng.integers(0, 2**64 - 1, size=KEY_CAPACITY, dtype=np.uint64)
        qk[: b0.n_keys] = b0.keys[: b0.n_keys]
        q = torch.from_numpy(qk.view(np.int64)).cuda()
        slots = sk.sorted_search(live._hay, live._n_real, q)
        want = sk.sorted_search_plain(live._hay.cpu(), live._n_real, q.cpu())
        err = {"sorted_search": int((slots.cpu() != want).sum())}
        got_rows = sk.gather_slots(live._dev[0], slots).cpu()
        plain = sk.gather_slots_plain(live._dev[0].cpu(), want)
        err["gather_slots"] = int((got_rows.view(torch.int32)
                                   != plain.view(torch.int32)).sum())
        sk.launches.update(saved)
        pm = np.array([_predict_parts(live, b)
                       for b in itertools.islice(ds.batches(), 2)] * 5)
        med = [float(x) for x in np.median(pm, axis=0)]
        log(f"online (c): serving launches after the last delta "
            f"{serve_launches}; at the haystack after it ({live._hay.shape[0]}"
            f", {live._n_real} real; {KEY_CAPACITY} queries, "
            f"{int((want < 0).sum())} unseen) elements that differ from the "
            f"twins {err}; predict ms after a delta (median of {len(pm)}): "
            f"prepare + key upload {med[0]!r}, resolve {med[1]!r}, program "
            f"{med[2]!r}, total {sum(med)!r} [{card}]")
        if serve_launches["sorted_search"] != n_batches or \
                serve_launches["gather_slots"] != n_batches or any(
                    err.values()):
            raise AssertionError(f"online (c): {serve_launches}, {err}")

        # (e): a corrupted delta takes the full reload; no /score fails
        syncer.stop()
        bad = pub.publish_delta("corrupt", table)
        path = os.path.join(pub.root, bad.dir, "sparse_delta.npz")
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(data))
        body = "\n".join(lines[:SERVE_INS]).encode() + b"\n"
        failures, n_req, stop = [], [0], threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    out, _ = _post(port, "/score/live", body)
                    if len(out["scores"]) != SERVE_INS:
                        failures.append(out)
                    n_req[0] += 1
                except Exception as e:  # any failure counts
                    failures.append(e)

        clients = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(4)]
        reloads = telemetry.counter("sync.full_reload_fallback")
        before = reloads.value()
        for c in clients:
            c.start()
        t0 = time.perf_counter()
        try:
            syncer.poll_once()
        finally:
            stop.set()
            for c in clients:
                c.join(timeout=60)
        reload_s = time.perf_counter() - t0
        log(f"online (e): corrupted delta seq {bad.seq}: full reloads "
            f"{reloads.value() - before}, {reload_s!r} s; served tag "
            f"{syncer.registry.current_version('live').tag}; {n_req[0]} "
            f"/score requests of {SERVE_INS} meanwhile, {len(failures)} "
            f"failed [{card}]")
        if reloads.value() != before + 1 or failures or not n_req[0]:
            raise AssertionError(f"online (e): {failures[:3]}")
    finally:
        syncer.stop()
        server.stop()
        runner.stop()
        thread.join(timeout=ONLINE_WAIT_S)
        writer.close()
        fresh_hist.observe = observe
        table.close()


# --------------------------------------------------------------------------- #
# phase 9: the telemetry plane
# --------------------------------------------------------------------------- #
def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _device_busy(trace_file: str) -> tuple:
    """(busy share, window s, device events) of a torch.profiler Chrome
    trace: the union of the device's kernel, copy and memset intervals
    over the window from the trace's first to its last event."""
    doc = json.load(open(trace_file))
    evs = [e for e in doc["traceEvents"]
           if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in evs
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in evs)
    t1 = max(e["ts"] + e["dur"] for e in evs)
    busy, end = 0.0, t0
    for e in sorted(dev, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            end = hi
    return busy / (t1 - t0), (t1 - t0) / 1e6, dev


def _device_trace_file(d: str) -> str:
    (f,) = [x for x in os.listdir(d) if x.startswith("device-trace-")]
    return os.path.join(d, f)


def _scraper(port: int, texts: list, stop) -> None:
    """Scrape /metrics every 50 ms until ``stop`` is set: (time, text)."""
    import urllib.request

    while not stop.is_set():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            texts.append((time.perf_counter(), r.read().decode()))
        stop.wait(0.05)


def telemetry_path(zipf_sets) -> None:
    """The telemetry plane on the default table (HBM cache on, overlapped)
    at the slice's width, two passes over two Zipf sets:
      1. telemetry on (TelemetryConfig with a trace dir, an events path
         and a free metrics port; scan_steps GRAPH_K set, single steps
         run): a host trace a pass in which ``pass`` encloses plan, feed
         and step; a /metrics scrape during the second pass showing the
         stage histograms, the hit rate, the boundary gap and the merge
         histogram; one ``pass_end`` record a pass and no health alert; no
         compile event in the second pass, and no kernel build twice in
         the process.  Launch counters reset before and read after.
      2. the same passes without telemetry (prefetched, the step group a
         CUDA graph: one ``train.scan`` compile a pass) bit-equal to the
         traced ones under deterministic algorithms.
      3. a pass with profile=True and TrainerConfig.trace_dir: the
         profile metrics, and a torch.profiler trace that names the
         pull_rows and scatter_add_rows kernels; the device's busy share.
      4. the device's busy share in a torch.profiler window over a
         prefetched default pass.
      5. samples/s of a default pass and of a pass with the full
         TelemetryConfig, in turns default, telemetry, telemetry, default.
      6. tools/pbox_doctor.py on the phase's trace, event and flight files.
    The health monitor starts afresh: its baselines belong to one run, and
    the earlier phases ran other models."""
    import threading

    import torch

    from paddlebox_tpu_torch import telemetry
    from paddlebox_tpu_torch.config import TelemetryConfig
    from paddlebox_tpu_torch.ops import sparse_kernels as sk
    from paddlebox_tpu_torch.utils.profiler import device_trace

    run_dir = os.path.join(WORK_DIR, "telemetry")
    os.makedirs(run_dir)
    sets = zipf_sets[:2]
    censuses = [d.unique_keys() for d in sets]
    # the event log and the exporter are process singletons: an earlier
    # phase's trainer (reshard_check continues the sharded arm's, which
    # logs its passes) may still hold them
    telemetry.close_event_log()
    telemetry.stop_exporter()
    telemetry.disable_tracing()
    telemetry.health.reset_for_tests()
    telemetry.set_process_name("trainer")

    def passes(det: bool, on_pass=None, **trainer_kw) -> tuple:
        """Two passes of a fresh default world: (metrics, state_dict, the
        compile events of each pass by stage)."""
        table, trainer = data_world("cuda", group=False, **trainer_kw)
        out, compiled, auc = [], [], None
        torch.use_deterministic_algorithms(det)
        try:
            for i, ds in enumerate(sets):
                before = telemetry.compiles_by_stage()
                table.begin_pass(censuses[i])
                if on_pass is not None:
                    on_pass(i, "start")
                m = trainer.train_from_dataset(ds, table, auc_state=auc)
                torch.cuda.synchronize()
                if on_pass is not None:
                    on_pass(i, "end")
                auc = trainer.last_metric_state
                table.end_pass()
                after = telemetry.compiles_by_stage()
                compiled.append({k: after[k] - before.get(k, 0)
                                 for k in after if after[k] != before.get(k)})
                out.append(m)
        finally:
            torch.use_deterministic_algorithms(False)
        state = table.state_dict()
        table.close()
        return out, state, compiled

    def metric_tuple(ms):
        return [(m["loss"], m["auc"], m["count"], m["grad_norm"],
                 m["weight_norm"]) for m in ms]

    # 1. telemetry on
    port = _free_port()
    events_path = os.path.join(run_dir, "events.jsonl")
    texts, stop, window = [], threading.Event(), {}
    scraper = threading.Thread(target=_scraper, args=(port, texts, stop),
                               daemon=True)

    def on_pass(i, when):
        window[i, when] = time.perf_counter()
        if (i, when) == (0, "start"):
            scraper.start()  # the exporter listens from the first pass on

    saved = dict(sk.launches)
    sk.reset_launches()
    try:
        on, on_state, on_compiled = passes(
            True, on_pass, scan_steps=GRAPH_K,
            telemetry=TelemetryConfig(trace_dir=run_dir,
                                      events_path=events_path,
                                      metrics_port=port))
    finally:
        stop.set()
        if scraper.is_alive():
            scraper.join(10)
        telemetry.disable_tracing()
        telemetry.close_event_log()
        telemetry.stop_exporter()
    launches = dict(sk.launches)
    sk.launches.update(saved)
    log(f"telemetry on: launches {launches}; compile events by pass "
        f"{on_compiled}; in the process {telemetry.compiles_by_stage()}")
    for name in ("pull_rows", "scatter_add_rows", "gather_slots",
                 "scatter_rows", "sorted_search"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "telemetry path")
    if on_compiled[1]:
        raise AssertionError(f"the traced second pass compiled "
                             f"{on_compiled[1]}")
    twice = {k: v for k, v in telemetry.compiles_by_stage().items()
             if k.startswith("pallas.") and v > 1}
    if twice:
        raise AssertionError(f"kernels built or loaded twice: {twice}")
    for k in range(2):
        trace_file = os.path.join(run_dir, f"host-trace-r0-pass{k}.json")
        evs = [e for e in json.load(open(trace_file))["traceEvents"]
               if e.get("ph") == "X"]
        (root,) = [e for e in evs if e["name"] == "pass"]
        inside = {e["name"] for e in evs
                  if e.get("args", {}).get("parent") == "pass"
                  and root["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= root["ts"] + root["dur"]}
        if not {"plan", "feed", "step"} <= inside:
            raise AssertionError(f"pass {k}'s trace: pass encloses {inside}")
    during = [t for at, t in texts
              if window[1, "start"] <= at <= window[1, "end"]]
    want = ("trainer_stage_seconds_bucket", "cache_hit_rate ",
            "pass_boundary_gap_seconds_count", "store_merge_seconds_count")
    lacking = [w for w in want if not during or w not in during[-1]]
    if lacking:
        raise AssertionError(f"{len(during)} scrapes during the second pass"
                             f"; the last lacks {lacking}")
    recs = [json.loads(ln) for ln in open(events_path)]
    kinds = [r["event"] for r in recs]
    if kinds != ["pass_end", "pass_end"]:
        raise AssertionError(f"event records {kinds}: want one pass_end a "
                             "pass and no health alert")
    log(f"telemetry on: {len(texts)} scrapes, {len(during)} during the "
        f"second pass ({len(during[-1])} bytes); pass_end records "
        f"{[sorted(r['telemetry']['histograms'])[:4] for r in recs]}...; "
        f"losses {[m['loss'] for m in on]}")

    # 2. the same passes without telemetry, step groups as CUDA graphs
    off, off_state, off_compiled = passes(True, scan_steps=GRAPH_K)
    _sync_equal("telemetry on against off", on_state, off_state,
                metric_tuple(on), metric_tuple(off))
    if any(c != {"train.scan": 1} for c in off_compiled):
        raise AssertionError(f"untraced passes compiled {off_compiled}: "
                             "want one train.scan capture a pass")
    log(f"telemetry off (graph steps): bit-equal to on, compile events by "
        f"pass {off_compiled}")

    # 3. a profiled pass with a torch.profiler device trace
    prof_dir = os.path.join(WORK_DIR, "telemetry-profile")
    table, trainer = data_world("cuda", group=False, profile=True,
                                trace_dir=prof_dir)
    table.begin_pass(censuses[0])
    m = trainer.train_from_dataset(sets[0], table)
    table.end_pass()
    table.close()
    telemetry.disable_tracing()
    prof = m["profile"]
    # the quantiles read the process's stage histogram (the reference's
    # semantics), which the earlier passes of this process fed too
    log("profiled pass: " + ", ".join(
        f"{s} {prof[s + '_ms_per_step']!r} ms a step (over the process: "
        f"p50 {q['p50_ms']!r}, p99 {q['p99_ms']!r})"
        for s, q in prof["stage_quantiles"].items()))
    busy, win, dev = _device_busy(_device_trace_file(prof_dir))
    names = {e["name"] for e in dev if e.get("cat") == "kernel"}
    for kernel in ("pull_rows", "scatter_add"):
        if not any(kernel in n for n in names):
            raise AssertionError(f"the device trace names no {kernel} "
                                 f"kernel: {sorted(names)[:20]}")
    log(f"profiled pass device trace: busy {busy!r} of a {win!r} s window "
        f"({len(dev)} device events); kernels of pull_rows.cu and "
        f"scatter_add_rows.cu named")

    # 4. the idle share at the defaults
    idle_dir = os.path.join(WORK_DIR, "telemetry-default")
    table, trainer = data_world("cuda", group=False)
    table.begin_pass(censuses[0])
    with device_trace(idle_dir):
        m = trainer.train_from_dataset(sets[0], table)
    table.end_pass()
    table.close()
    busy, win, dev = _device_busy(_device_trace_file(idle_dir))
    log(f"default pass (prefetched) device trace: busy {busy!r} of a "
        f"{win!r} s window, idle {1 - busy!r}; {m['samples'] / m['duration_s']!r}"
        " samples/s under the profiler")
    by_name: dict = {}
    for e in dev:
        n, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, us + e["dur"])
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {us / 1e3:.3f} ms device, {n} calls: {name[:120]}")

    # 5. the cost of the defaults and of the full telemetry, in turns
    turns = []
    for label in ("default", "telemetry", "telemetry", "default"):
        kw = {}
        if label == "telemetry":
            d = os.path.join(WORK_DIR, f"telemetry-turn{len(turns)}")
            kw["telemetry"] = TelemetryConfig(
                trace_dir=d, events_path=os.path.join(d, "events.jsonl"),
                metrics_port=_free_port())
        table, trainer = data_world("cuda", group=False, **kw)
        table.begin_pass(censuses[0])
        try:
            m = trainer.train_from_dataset(sets[0], table)
        finally:
            telemetry.disable_tracing()
            telemetry.close_event_log()
            telemetry.stop_exporter()
        table.end_pass()
        table.close()
        turns.append((label, m["samples"] / m["duration_s"]))
    log(f"samples/s in turns: {turns}")

    # 6. the doctor reads the phase's files
    dump = telemetry.dump_flight("telemetry_path", {"passes": 2},
                                 dump_dir=run_dir)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "pbox_doctor.py"),
         run_dir, "--json"], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"pbox_doctor exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    srcs = {r["src"] for r in report["timeline"]}
    if not ({"trace", "dump"} <= srcs and report["sources"]["dumps"] >= 1):
        raise AssertionError(f"the doctor's timeline holds {srcs}, sources "
                             f"{report['sources']}")
    log(f"pbox_doctor on {run_dir}: exit 0, sources {report['sources']}, "
        f"{len(report['timeline'])} timeline rows; flight dump "
        f"{os.path.basename(dump)}")


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


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        # a rank of the multiprocess phase's jobs (launch.py starts it)
        return rank_main(sys.argv[2:])
    import torch

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
        # the data files are written (writer processes) while the host
        # libraries build with g++ beside the nvcc builds
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            data = ex.submit(write_data)
            crit_f = ex.submit(write_criteo)
            host = [ex.submit(_native.get_lib), ex.submit(_native.get_plan_lib)]
            built = cuda_build.build(sk.KERNELS)
            cuda_s = time.perf_counter() - t0
            host_libs = [h.result() for h in host]
            files, cached_files, logkey_files, seq_files = data.result()
            crit = crit_f.result()
            write_s = time.perf_counter() - t0
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
            f"beside the build in {write_s!r} s")
        # depth cut since the online phase: the Python parser on the first
        # file (the whole uncached set before)
        py_load_s = python_parse_check(files[:1], load(files[:1], 1))
        log(f"load (native parser): {load_s!r} s for the uncached set, "
            f"{cached_load_s!r} s for the Zipf sets; its first file with "
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
        phase(stage_breakdown, ds, res["table"], res["trainer"])
        phase(feed_turns, ds, res["table"], res["trainer"])
        phase(small_agreement)
        phase(prefetch_agreement)
        phase(criteo, crit, card)
        cached = phase(cached_path, cached_ds[:CACHED_PASSES])
        phase(lifecycle_check, censuses[:CACHED_PASSES])
        phase(persistence_check, cached_ds[:CACHED_PASSES])
        hybrid = phase(hybrid_path, cached_ds[:HYBRID_PASSES])
        phase(hybrid_stages, hybrid)
        phase(small_hybrid_agreement)
        sharded = phase(sharded_cached_path, hybrid)
        phase(reshard_check, sharded)
        phase(multiprocess, sharded, cached_files[:HYBRID_PASSES],
              logkey_files[:DH_FILES])
        phase(dense_sync_agreement)
        # depth cut since the fleet and scenarios phases: one Zipf set (2)
        phase(dense_sync_full, cached_ds[:1])
        phase(graph_steps, ds, cached_ds[:GRAPH_PASSES])
        phase(step_policies, ds)
        phase(slot_policy, hybrid)
        phase(data_half, logkey_files, load_s)
        phase(model_zoo, cached_ds, logkey_files)
        axes = phase(parallel_axes, cached_ds, logkey_files, seq_files)
        rows = phase(kernel_times, res, ds, cached,
                     censuses[CACHED_PASSES - 1], hybrid, errs)
        fleet_in = phase(serving, res, ds, axes)
        started = phase(fleet_spawn, fleet_in)
        phase(scenarios, cached_ds, cached_files, card)
        phase(fleet, fleet_in, started, card)
        phase(online, files, ds, card)
        # last: after its device traces, a torch.profiler window of this
        # process listed no CUDA kernel among its events (kernel_times
        # reads the kernels of each wrapper call from such windows)
        phase(telemetry_path, cached_ds)
        ds.close()
        for d in cached_ds:
            d.close()
    finally:
        _stop_fleets()
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
