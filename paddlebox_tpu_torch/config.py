"""Configuration for the PyTorch port: the dataclasses and the flag shim.

A copy of the fields of ``paddlebox_tpu/config.py`` that the ported paths
read.  Every other feature of the reference is either absent here or, where
its field exists, raises ``NotImplementedError`` naming the later slice of
the port (ROADMAP.md, Queue A) that brings it.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error every unsupported option raises: names the later slice."""
    return NotImplementedError(
        f"{what} is not ported to paddlebox_tpu_torch yet ({where}; "
        "see ROADMAP.md Queue A)"
    )


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
        # census wire codec: "varint" (sorted-delta LEB128), "raw" (8-byte
        # keys) or "legacy" (the same as varint in one process)
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

    def __post_init__(self):
        if self.expand_dim:
            raise not_ported("expand_dim", "model zoo, item 5")


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
        if self.counter_label_tasks:
            raise not_ported("counter_label_tasks", "model zoo, item 5")
