"""Configuration for the PyTorch port: the dataclasses and the flag shim.

A copy of the fields of ``paddlebox_tpu/config.py`` that the ported paths
read (its note on overrides holds here too: an active LivenessConfig's
``hostplane_timeout_s`` outranks ``TrainerConfig.host_plane_timeout_s``);
every other feature of the reference is absent here (ROADMAP.md,
Queue A, names the slice that brings it).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence


# --------------------------------------------------------------------------- #
# Flag shim.  Same typed-default mechanism as the reference, but read from
# PADDLEBOX_TORCH_<NAME>: both packages run in one process in the parity
# tests, and the reference's tests leave their own flags set in the
# environment, so the two shims must not steer each other.
# --------------------------------------------------------------------------- #
class _Flags:
    _PREFIX = "PADDLEBOX_TORCH_"
    _DEFAULTS = {
        # reader threads of PadBoxSlotDataset (reference:
        # FLAGS_padbox_dataset_shuffle_thread_num)
        "dataset_shuffle_thread_num": 10,
        # dense-tower compute dtype: "float32", "bfloat16" or "float16"
        # (models/layers.py:resolve_compute_dtype)
        "compute_dtype": "float32",
        # the native C++ slot parser (_native/slot_parser.cpp) when it
        # builds; the Python parser otherwise (reference default: on)
        "use_native_parser": True,
        # the native C++ batch planner (dedup and census resolve,
        # _native/plan_resolve.cpp) when it builds; numpy otherwise
        # (reference default: on)
        "use_native_planner": True,
        # kill switch of the HBM hot-row cache, process-wide, whatever
        # SparseTableConfig.hbm_cache_rows says (reference: flags.hbm_cache)
        "hbm_cache": True,
        # sparsity-aware placement of the sharded table, used when
        # SparseTableConfig.placement is "": "hybrid" (the planner picks a
        # replicated-hot set from census skew), "hash" (flat key % n) or
        # "loopback" (hybrid, and the census and hot-row payloads go through
        # their encode -> decode wire round trip in one process)
        "placement": "hybrid",
        # process-wide kill switch of the realized hot block: 0 keeps the
        # planner and the census wire but places every row by hash
        "placement_realize": True,
        # host-plane wire codec of the census and the KvChannel payloads:
        # "varint" (sorted-delta / zigzag-delta LEB128), "raw" (framed,
        # uncompressed) or "legacy" (unframed bytes; the census keeps
        # varint).  Must match on every rank
        "hostplane_codec": "varint",
        # process-wide kill switch of the overlapped pass boundary: 0 runs
        # the serial lifecycle whatever
        # SparseTableConfig.overlap_pass_boundary says (reference default:
        # on)
        "overlap_pass_boundary": True,
        # process-wide kill switch of the durable log: 0 leaves
        # SparseTableConfig.store_log_dir unused (reference default: on)
        "durable_store": True,
        # utils/retry.py's default policy: attempts per call, and the
        # backoff's first and largest delay in seconds
        "retry_max_attempts": 3,
        "retry_base_delay_s": 1.0,
        "retry_max_delay_s": 5.0,
        # chaos plan of utils/faults.py: "site=spec;site=spec", and its seed
        "fault_plan": "",
        "fault_seed": 0,
        # telemetry (telemetry/): a non-zero metrics port starts the
        # process's /metrics listener on 127.0.0.1; trace_dir enables host
        # span tracing (a Chrome-trace JSON a pass); events_path appends a
        # rank-tagged JSONL record a pass
        "metrics_port": 0,
        "trace_dir": "",
        "events_path": "",
        # the JSONL event file rotates past this many MB (0 = never)
        "events_max_mb": 64.0,
        # where flight-recorder dumps land ("" = the events_path directory,
        # else no dumps; the in-memory ring records regardless), and the
        # ring's bound
        "flight_dir": "",
        "flight_ring": 512,
        # run-health plane (telemetry/health.py): the kill switch, the EWMA
        # smoothing factor, the windows a baseline rule observes before it
        # may fire, and the bound of the recent-alert ring
        "health_enabled": True,
        "health_ewma_alpha": 0.3,
        "health_warmup": 3,
        "health_max_alerts": 256,
        # the multi-process job (launch.py sets these for every rank;
        # parallel/mesh.py:initialize_distributed reads them): the TCPStore
        # address "host:port", the process count and this process's rank,
        # which is also the event log's and flight recorder's rank
        "coordinator_address": "",
        "num_processes": 0,
        "process_id": 0,
        # 1 when the launcher itself serves the job's TCPStore (every rank
        # connects as a client), 0 when rank 0 serves it
        "store_hosted": False,
        # the data plane's process-group backend: "nccl" (each rank owns a
        # card), "gloo" (CPU ranks, or ranks sharing one card) or "" (gloo
        # on the CPU, nccl on the card)
        "backend": "",
        # a launched rank's device, "cuda" or "cpu" ("" = "cuda"), and
        # the card index on it (-1 = the current card)
        "device": "",
        "local_device": -1,
        # data positions of each process (launch.py --positions-per-proc)
        "positions_per_proc": 0,
        # distributed liveness (parallel/watchdog.py): the stall deadline
        # of any stage (feed, step, a host-plane gather), the heartbeat
        # and detector cadences
        "liveness_deadline_s": 3600.0,
        "liveness_heartbeat_s": 15.0,
        "liveness_poll_s": 1.0,
        # how long one host-plane KvChannel gather waits for its peers
        "hostplane_timeout_s": 3600.0,
        # admission control of every ScoringServer (inference/server.py):
        # requests waiting for a scoring slot before new arrivals shed with
        # 429, and scoring calls in flight at once
        "serve_max_queue": 64,
        "serve_max_concurrency": 1,
        # default request deadline in ms: an arrival whose estimated queue
        # wait exceeds it sheds with 429 + Retry-After (0 = no deadline;
        # clients override it with X-Request-Deadline-Ms)
        "request_deadline_ms": 0,
        # the largest /score or /retrieve body; a larger one answers 413
        # unread
        "serve_max_body_bytes": 8 << 20,
        # continuous micro-batching: up to this many admitted /score
        # requests coalesce into one device call (1 = one at a time), and
        # the longest a forming batch waits to fill, in ms
        "serve_max_batch": 8,
        "serve_batch_linger_ms": 2.0,
        # the serving artifact's embedding payload (inference/export.py):
        # "fp32", "int8" or "fp8" (per-row scales, dequantized on the card
        # inside the serving program)
        "embedding_dtype": "fp32",
        # the remote filesystem (utils/fs.py HadoopFS): the hadoop command,
        # and the job confs fs.default.name and hadoop.job.ugi
        "hadoop_bin": "hadoop",
        "fs_name": "",
        "fs_ugi": "",
        # online model delivery (serving_sync/): the publish root a trainer
        # ships base and delta model units to ("" = no publishing;
        # launch.py --publish-root sets it for every rank), and the serving
        # side's donefile poll interval and fetch cache directory
        "publish_root": "",
        "sync_interval_s": 10.0,
        "sync_cache_dir": "",
        # online training (streaming/): the root a StreamingTrainer tails
        # ("" = none; launch.py --stream-root), the freshness budget in
        # seconds that triggers publish_delta, and the mini-pass window
        # size in records
        "stream_root": "",
        "max_staleness_s": 10.0,
        "stream_window_records": 1024,
    }

    def __getattr__(self, name: str):
        if name not in self._DEFAULTS:
            raise AttributeError(f"unknown flag {name!r}")
        default = self._DEFAULTS[name]
        env = os.environ.get(self._PREFIX + name.upper())
        if env is None:
            return default
        if isinstance(default, bool):
            return env.lower() in ("1", "true", "yes", "on")
        return type(default)(env)


flags = _Flags()


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """One feature slot: uint64 feature signs (sparse) or a fixed-shape
    float vector (dense)."""

    name: str
    type: str = "uint64"  # "uint64" (sparse) | "float" (dense)
    is_dense: bool = False
    is_used: bool = True
    shape: Sequence[int] = (1,)

    def __post_init__(self):
        if self.type not in ("uint64", "float"):
            raise ValueError(f"slot {self.name}: bad type {self.type}")
        if self.is_dense and self.type != "float":
            raise ValueError(f"dense slot {self.name} must be float")
        if self.type == "float" and not self.is_dense:
            raise ValueError(
                f"float slot {self.name} must be is_dense=True "
                "(variable-count float slots are unsupported)"
            )


@dataclasses.dataclass
class DataFeedConfig:
    """Reader configuration (DataFeedDesc equivalent)."""

    slots: Sequence[SlotConfig] = ()
    batch_size: int = 64
    # a shell command each file is piped through before parsing
    pipe_command: str = ""
    # PV merge: at most this many page-views in one batch
    pv_batch_size: int = 32
    enable_pv_merge: bool = False
    # name of the rank-offset tensor; its [B, rank_offset_cols] matrix
    # holds each ad's rank and its page-view peers' ranks and rows
    rank_offset: str = ""
    rank_offset_cols: int = 7  # max_rank 3 -> 7 columns
    # cmatch codes whose instances take part in PV ranking; None = all.
    # The default is the reference kernel's hard-coded ad channels
    rank_cmatch_filter: Optional[Sequence[int]] = (222, 223)
    # the line prefixes: "<ins_id>" and "<search_id>:<rank>:<cmatch>"
    parse_ins_id: bool = False
    parse_logkey: bool = False
    label_slot: str = "click"
    # extra per-task label slots (a batch's task_labels column 1..)
    task_label_slots: Sequence[str] = ()
    # a sparse slot whose keys the batch also exposes in order:
    # HostBatch.seq_pos [B, max_seq_len] (padding = the key capacity)
    sequence_slot: str = ""
    max_seq_len: int = 64
    # "raise": a malformed line aborts the read; "skip": drop and count it
    malformed_policy: str = "raise"
    quarantine_abort_frac: float = 0.01
    max_feasigns_per_ins: int = 256
    # total key capacity of one batch; None -> batch_size * max_feasigns_per_ins
    batch_key_capacity: Optional[int] = None

    def sparse_slots(self) -> list[SlotConfig]:
        """Used uint64 slots, in file order."""
        return [
            s
            for s in self.slots
            if s.is_used and s.type == "uint64" and s.name != self.label_slot
        ]

    def dense_slots(self) -> list[SlotConfig]:
        """Used dense float slots excluding the label and task-label slots,
        in file order (the RecordBlock's dense columns)."""
        excluded = {self.label_slot, *self.task_label_slots}
        return [
            s
            for s in self.slots
            if s.is_used and s.is_dense and s.name not in excluded
        ]

    def dense_width(self) -> int:
        return sum(int(math.prod(s.shape)) for s in self.dense_slots())

    @property
    def max_rank(self) -> int:
        return (self.rank_offset_cols - 1) // 2

    def to_dict(self) -> dict:
        """JSON-ready form, version-stamped, tuples as lists (the
        reference's feed.json); from_dict is the exact inverse."""
        d = dataclasses.asdict(self)
        d["slots"] = [{**sd, "shape": list(sd["shape"])} for sd in d["slots"]]
        for k, v in list(d.items()):
            if isinstance(v, tuple):
                d[k] = list(v)
        d["feed_format_version"] = 1
        return d

    @staticmethod
    def from_dict(d: dict) -> "DataFeedConfig":
        """Inverse of to_dict.  Keys this version does not know (a newer
        writer's fields) are dropped with a warning; tuple fields come back
        as tuples, read from the dataclass defaults."""
        import warnings

        d = dict(d)
        ver = d.pop("feed_format_version", 1)
        if ver > 1:
            warnings.warn(
                f"feed.json format version {ver} is newer than this reader "
                "understands (1): existing fields may have changed meaning",
                RuntimeWarning, stacklevel=2,
            )
        known = {f.name: f for f in dataclasses.fields(DataFeedConfig)}
        for k in [k for k in d if k not in known]:
            warnings.warn(f"feed.json key {k!r} unknown to this version — "
                          "ignored", RuntimeWarning, stacklevel=2)
            d.pop(k)
        slot_known = {f.name for f in dataclasses.fields(SlotConfig)}
        slots = []
        for sd in d.get("slots", []):
            for k in [k for k in sd if k not in slot_known]:
                warnings.warn(f"feed.json slot key {k!r} unknown — ignored",
                              RuntimeWarning, stacklevel=2)
            sd = {k: v for k, v in sd.items() if k in slot_known}
            slots.append(SlotConfig(**{**sd, "shape": tuple(sd["shape"])}))
        d["slots"] = slots
        for name, f in known.items():
            if name != "slots" and name in d and isinstance(
                    f.default, tuple) and isinstance(d[name], list):
                d[name] = tuple(d[name])
        return DataFeedConfig(**d)

    def __post_init__(self):
        if self.malformed_policy not in ("raise", "skip"):
            raise ValueError(
                f"malformed_policy must be 'raise' or 'skip', "
                f"got {self.malformed_policy!r}"
            )
        if not 0.0 <= self.quarantine_abort_frac <= 1.0:
            raise ValueError(
                "quarantine_abort_frac must be in [0, 1], "
                f"got {self.quarantine_abort_frac}"
            )
        seen = set()
        for s in self.slots:
            if s.name in seen:
                raise ValueError(f"duplicate slot name {s.name!r}")
            seen.add(s.name)
            if s.name == self.label_slot and s.type != "float":
                raise ValueError(
                    f"label slot {s.name!r} must be a float slot, "
                    f"got type={s.type!r}"
                )
        if self.slots and self.label_slot not in seen:
            raise ValueError(
                f"label slot {self.label_slot!r} is not among the configured "
                "slots; every instance must carry a label"
            )
        if len(set(self.task_label_slots)) != len(self.task_label_slots):
            raise ValueError("task_label_slots contains duplicates")
        by_name = {s.name: s for s in self.slots}
        for t in self.task_label_slots:
            if self.slots and t not in seen:
                raise ValueError(f"task label slot {t!r} is not configured")
            if self.slots and by_name[t].type != "float":
                raise ValueError(
                    f"task label slot {t!r} must be a float slot, "
                    f"got type={by_name[t].type!r}"
                )
            if t == self.label_slot:
                raise ValueError(
                    "task_label_slots must not repeat the primary label slot "
                    "(task 0 is the primary label implicitly)"
                )


@dataclasses.dataclass
class SparseTableConfig:
    """Sparse table: rows ``[show, clk, embed...]`` plus a scalar g2sum,
    trained by sparse adagrad (sparse/optimizer.py)."""

    embedding_dim: int = 8
    expand_dim: int = 0
    learning_rate: float = 0.05
    slot_learning_rates: Sequence = ()
    initial_g2sum: float = 3.0
    initial_range: float = 0.02
    create_threshold: float = 0.0
    grad_clip: float = 10.0
    cvm_offset: int = 2
    pull_embedx_scale: float = 1.0
    store_buckets: int = 256
    # device rows reserved past the pass working set so every padding or
    # missing plan slot pushes into its own row (see SparseTable.plan_keys)
    plan_scratch_rows: int = 1 << 15
    # host-store disk tier (sparse/store.py): with a directory, at most
    # store_max_resident buckets stay in RAM and the rest spill there as
    # CRC-checked files
    store_spill_dir: str = ""
    store_max_resident: int = 64
    # durable log (sparse/logstore.py): every pass-boundary merge writes
    # through to crash-consistent segment files and commits a manifest
    # generation; a table built on the directory recovers the last
    # committed state.  "" = off; PADDLEBOX_TORCH_DURABLE_STORE=0 is the
    # process-wide kill switch
    store_log_dir: str = ""
    # power-of-two bucket count of the log, and the per-bucket segment
    # count past which a background compaction folds a bucket to one
    # segment
    store_log_buckets: int = 8
    store_compact_threshold: int = 8
    # shrink(): per-day show/clk decay, and rows whose show falls below
    # delete_threshold are evicted
    delete_threshold: float = 0.0
    show_decay_rate: float = 0.98
    # The overlapped pass boundary (sparse/table.py): end_pass copies the
    # working set to the host and merges it into the store on a background
    # thread (an overlay keeps reads current; barriers wait for it), and
    # prepare_pass stages the next pass's resolve and host buffer while the
    # current pass trains.  Bit-exact against False, the serial lifecycle;
    # PADDLEBOX_TORCH_OVERLAP_PASS_BOUNDARY=0 forces serial process-wide.
    overlap_pass_boundary: bool = True
    # host-store bucket parallelism: lookup, update and decay_evict fan
    # their per-bucket work over this many threads (<= 1 = serial)
    store_threads: int = 4
    # Persistent HBM hot-row cache (sparse/engine/hbm_cache.py): slots kept
    # on the device across passes, so begin_pass fetches only the census
    # misses from the host store.  0 disables it, as does
    # PADDLEBOX_TORCH_HBM_CACHE=0 process-wide.  The cached lifecycle is
    # bit-exact with the uncached one.
    hbm_cache_rows: int = 1 << 16
    # per-pass frequency decay of the cache's LFU-with-aging policy
    hbm_cache_aging: float = 0.8
    # Sparsity-aware placement of the sharded table
    # (parallel/sharded_table.py, sparse/placement.py): the planner ranks
    # keys by aged census frequency; its hot set rides the census wire as
    # membership bits and, with placement_realize, lives as a replicated
    # [H, W+1] block on every shard position, so a hot lookup is a local
    # gather.  "" resolves PADDLEBOX_TORCH_PLACEMENT ("hybrid"); "hash"
    # turns the planner off.  The single-chip SparseTable ignores these.
    placement: str = ""
    # top-k bound of the hot set, and the padded capacity H of the block
    placement_hot_capacity: int = 4096
    # per-pass decay of the planner's aged frequencies
    placement_aging: float = 0.8
    # the hot set changes at most once per this many passes
    placement_update_interval: int = 2
    # materialize the hot set on the device (bit-exact against "hash");
    # PADDLEBOX_TORCH_PLACEMENT_REALIZE=0 is the process-wide kill switch
    placement_realize: bool = True

    @property
    def row_width(self) -> int:
        """Width of a pulled value row: [show, clk, embed...]."""
        return self.cvm_offset + self.embedding_dim + self.expand_dim


@dataclasses.dataclass(frozen=True)
class LivenessConfig:
    """Deadlines and cadences of the distributed-liveness layer
    (reference: config.py LivenessConfig; parallel/watchdog.py).

    deadline_s: a process (local check) or a peer (heartbeat check) with
    no stage progress for this long is declared stalled.
    heartbeat_interval_s / poll_interval_s: the heartbeat publisher's and
    the detector's cadence.  hostplane_timeout_s: the KvChannel wait bound
    while this config's watchdog is active.  shuffle_timeout_s: read by
    the shuffle transport of ROADMAP item 8b, kept for the reference's
    surface.  rollback_on_abort: on a stall abort the single-chip trainer
    restores its checkpointer's last pass (PassRolledBack).
    hard_exit_grace_s: multi-process only, a process that has not unwound
    this long after an abort exits with code 124 (<= 0 disables)."""

    enabled: bool = True
    deadline_s: float = 3600.0
    heartbeat_interval_s: float = 15.0
    poll_interval_s: float = 1.0
    hostplane_timeout_s: float = 3600.0
    shuffle_timeout_s: float = 120.0
    rollback_on_abort: bool = False
    hard_exit_grace_s: float = 60.0

    @staticmethod
    def from_flags() -> "LivenessConfig":
        return LivenessConfig(
            deadline_s=flags.liveness_deadline_s,
            heartbeat_interval_s=flags.liveness_heartbeat_s,
            poll_interval_s=flags.liveness_poll_s,
            hostplane_timeout_s=flags.hostplane_timeout_s,
        )

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if self.heartbeat_interval_s <= 0 or self.poll_interval_s <= 0:
            raise ValueError("heartbeat/poll intervals must be positive")
        if self.heartbeat_interval_s >= self.deadline_s:
            raise ValueError(
                f"heartbeat_interval_s ({self.heartbeat_interval_s}) must be "
                f"< deadline_s ({self.deadline_s}) or every peer always "
                "looks stale"
            )


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Observability knobs for one process (reference: config.py
    TelemetryConfig).

    metrics_port: serve Prometheus text on ``127.0.0.1:<port>/metrics``
    (0 = off).  trace_dir: write a host span trace (Chrome-trace JSON) a
    pass here ("" = off).  events_path: append rank-tagged JSONL records
    here ("" = off).  fleet_snapshot: in a multi-process job, gather every
    rank's metric snapshot at each pass end of the multi-chip trainer and
    print one merged fleet view on rank 0 (telemetry/fleet.py); one
    process has nothing to gather.
    """

    metrics_port: int = 0
    trace_dir: str = ""
    events_path: str = ""
    fleet_snapshot: bool = True

    @staticmethod
    def from_flags() -> "TelemetryConfig":
        return TelemetryConfig(
            metrics_port=flags.metrics_port,
            trace_dir=flags.trace_dir,
            events_path=flags.events_path,
        )

    def __post_init__(self):
        if self.metrics_port < 0 or self.metrics_port > 65535:
            raise ValueError(
                f"metrics_port must be in [0, 65535], got {self.metrics_port}"
            )


# --------------------------------------------------------------------------- #
# Online training (reference: config.py StreamingConfig), the policy of
# streaming/: how records arrive (the tailed root, the buffer bound), how
# mini-pass windows are cut (record count and/or wall-clock age), and the
# freshness budget the deadline publisher holds.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class StreamingConfig:
    """Knobs of the streaming plane (source -> mini-pass -> deadline
    publish).

    max_staleness_s is the freshness budget from end to end: the deadline
    publisher aims to have every event's effect published (and, with a
    serving confirmation wired, served) within this many seconds of the
    event entering the stream; misses are counted
    (``stream.deadline_misses``).
    """

    # the tailed root ("" = the caller supplies a source)
    stream_root: str = ""
    # freshness budget (s): publish_delta fires on this deadline
    max_staleness_s: float = 10.0
    # window size in records (widened under publish backpressure, up to
    # max_window_records)
    window_records: int = 1024
    # also cut a non-empty window once its first record is this old (s);
    # 0 = by record count only
    window_seconds: float = 1.0
    # the bounded source buffer: past it the producer blocks, nothing drops
    buffer_records: int = 1 << 16
    # the tail source's poll interval (s)
    tail_poll_interval_s: float = 0.05
    # windows cut and censused ahead of training
    max_pending_windows: int = 2
    # backpressure: the window's growth factor when a publish lags or
    # fails, and its cap
    widen_factor: float = 2.0
    max_window_records: int = 1 << 20
    # share of the staleness budget spent accumulating before the
    # publisher triggers (the rest is headroom for publish and sync)
    trigger_fraction: float = 0.5
    # an AutoCheckpointer pass record every N windows (0 = at shutdown only)
    checkpoint_every_windows: int = 0

    @staticmethod
    def from_flags() -> "StreamingConfig":
        return StreamingConfig(
            stream_root=flags.stream_root,
            max_staleness_s=flags.max_staleness_s,
            window_records=flags.stream_window_records,
        )

    def __post_init__(self):
        if self.max_staleness_s <= 0:
            raise ValueError("max_staleness_s must be positive")
        if self.window_records < 1:
            raise ValueError("window_records must be >= 1")
        if self.window_seconds < 0:
            raise ValueError("window_seconds must be >= 0")
        if not 0 < self.trigger_fraction <= 1.0:
            raise ValueError("trigger_fraction must be in (0, 1]")
        if self.widen_factor < 1.0:
            raise ValueError("widen_factor must be >= 1")
        if self.max_window_records < self.window_records:
            raise ValueError("max_window_records must be >= window_records")
        if self.max_pending_windows < 1:
            raise ValueError("max_pending_windows must be >= 1")


# --------------------------------------------------------------------------- #
# Per-scenario serving policy (reference: config.py ScenarioServingConfig).
# One scenario = one served model name, with its own artifact dtype,
# micro-batch linger, request deadline and freshness budget.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ScenarioServingConfig:
    """Serving knobs of one scenario's model name.

    * ``embedding_dtype`` — the artifact dtype the scenario publishes;
    * ``batch_linger_ms`` — the coalescer linger of this model's
      micro-batches (None = the server-wide default);
    * ``deadline_ms`` — this model's default request deadline (the
      X-Request-Deadline-Ms header outranks it; None/0 = server default);
    * ``max_staleness_s`` — the freshness budget of the streaming plane.

    Attach the request-path knobs with ``ScoringServer.set_serving_policy``.
    """

    name: str
    embedding_dtype: str = "fp32"
    batch_linger_ms: Optional[float] = None
    deadline_ms: Optional[float] = None
    max_staleness_s: Optional[float] = None

    def __post_init__(self):
        if self.embedding_dtype not in ("fp32", "int8", "fp8"):
            raise ValueError(
                f"embedding_dtype must be fp32|int8|fp8, got "
                f"{self.embedding_dtype!r}"
            )
        if self.batch_linger_ms is not None and self.batch_linger_ms < 0:
            raise ValueError("batch_linger_ms must be >= 0")
        if self.deadline_ms is not None and self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0")
        if self.max_staleness_s is not None and self.max_staleness_s <= 0:
            raise ValueError("max_staleness_s must be positive")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ScenarioServingConfig":
        known = {f.name for f in dataclasses.fields(ScenarioServingConfig)}
        return ScenarioServingConfig(
            **{k: v for k, v in d.items() if k in known}
        )


@dataclasses.dataclass
class TrainerConfig:
    # dense sync of the multi-chip trainer: "step" sums the positions'
    # gradients every step; "kstep" updates each position's own dense copy
    # and averages the copies every sync_weight_step steps; "async" sums
    # the gradients like "step" but hands them, one step late, to a host
    # table whose thread applies the optimizer (parallel/async_dense.py),
    # and pulls the parameters back every sync_weight_step steps and at
    # the pass end
    sync_dense_mode: str = "step"
    sync_weight_step: int = 1
    dense_lr: float = 1e-3
    dense_optimizer: str = "adam"
    auc_buckets: int = 1 << 20
    # dumps (train/dump.py): with need_dump_field and a dump_fields_path,
    # every pass writes one text line per instance to
    # <dump_fields_path>/dump-<global step>.txt, with the extra columns
    # dump_fields names ("task_labels", "cmatch", "rank", "dense"); with
    # need_dump_param, the pass end writes the dense parameters (filtered
    # by the name substrings of dump_param) and the table's rows to
    # <dump_fields_path>/param-<global step>.{dense,sparse}.npz
    dump_fields: Sequence[str] = ()
    dump_fields_path: str = ""
    dump_param: Sequence[str] = ()
    need_dump_field: bool = False
    need_dump_param: bool = False
    # task-label columns (col 0 = the primary label) that feed the extra
    # counters of a cvm_offset > 2 table: counter 2+i of each pushed key
    # adds task_labels[:, counter_label_tasks[i]] of the key's instance (the
    # conv layout's conversion counter is (1,)); the single-chip Trainer
    # reads it, and needs len(counter_label_tasks) == cvm_offset - 2
    counter_label_tasks: Sequence[int] = ()
    compute_dtype: str = ""  # "" -> flags.compute_dtype
    check_nan_inf: bool = False
    nan_policy: str = "raise"
    # feed double buffering: a producer thread plans the next batches' keys
    # and copies their feed to the device (pinned host memory, a side
    # stream) while the current step computes, at most this many ahead.
    # 0 (or less) = the serial feed.
    prefetch_batches: int = 2
    # multi-step dispatch of the single-chip Trainer: this many steps run
    # as one group, which the card captures once a pass as a CUDA graph and
    # replays (the reference's lax.scan of k steps); the CPU runs the same
    # group body eagerly.  A tail shorter than k runs single steps.  1 =
    # one step at a time.  With check_nan_inf the host reads the group's
    # flags once a replay, and ticks after a non-finite one leave every
    # state untouched.  A pass that dumps fields runs one step at a time.
    scan_steps: int = 1
    # multi-process planning-plane patience: how long one host-plane
    # KvChannel gather waits for a straggling peer; an active
    # LivenessConfig's hostplane_timeout_s supersedes it
    host_plane_timeout_s: float = 3600.0
    # distributed liveness (parallel/watchdog.py): None = no watchdog; a
    # LivenessConfig gives heartbeats, local and peer stall detection
    # naming the culprit, and the coordinated abort
    liveness: Optional[LivenessConfig] = None
    # telemetry policy (telemetry/): None = the PADDLEBOX_TORCH_METRICS_PORT,
    # _TRACE_DIR and _EVENTS_PATH flags (TelemetryConfig.from_flags())
    telemetry: Optional[TelemetryConfig] = None
    # per-stage host timing with a synchronized step (a slower diagnostic
    # mode: the feed runs serially and the steps one at a time)
    profile: bool = False
    # a torch.profiler device trace of each pass lands here ("" = off); it
    # also enables the host span trace, written to the same directory
    trace_dir: str = ""

    def __post_init__(self):
        if self.sync_dense_mode not in ("step", "kstep", "async"):
            raise ValueError(
                f"unknown sync_dense_mode {self.sync_dense_mode!r}"
            )
        if self.dense_optimizer not in ("adam", "sgd"):
            raise ValueError(
                f"unknown dense optimizer {self.dense_optimizer!r}"
            )
        if self.nan_policy not in ("raise", "skip_batch", "rollback"):
            raise ValueError(
                f"unknown nan_policy {self.nan_policy!r} "
                "(want raise | skip_batch | rollback)"
            )
