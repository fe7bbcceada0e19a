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
        # dense-tower compute dtype; this slice runs float32 only
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
    pipe_command: str = ""
    enable_pv_merge: bool = False
    rank_offset: str = ""
    parse_ins_id: bool = False
    parse_logkey: bool = False
    label_slot: str = "click"
    task_label_slots: Sequence[str] = ()
    sequence_slot: str = ""
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
        """Used dense float slots excluding the label slot, in file order."""
        return [
            s
            for s in self.slots
            if s.is_used and s.is_dense and s.name != self.label_slot
        ]

    def dense_width(self) -> int:
        return sum(int(math.prod(s.shape)) for s in self.dense_slots())

    def __post_init__(self):
        if self.pipe_command:
            raise not_ported("pipe_command", "data cut-outs, item 3")
        if self.enable_pv_merge or self.rank_offset:
            raise not_ported("PV merge / rank_offset", "data cut-outs, item 3")
        if self.parse_ins_id or self.parse_logkey:
            raise not_ported("ins_id / logkey parsing", "data cut-outs, item 3")
        if self.task_label_slots:
            raise not_ported("multi-task labels", "data cut-outs, item 3")
        if self.sequence_slot:
            raise not_ported("sequence_slot / seq_pos", "data cut-outs, item 3")
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
        if self.slot_learning_rates:
            raise not_ported("slot_learning_rates", "trainer cut-outs, item 3")


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
    counter_label_tasks: Sequence[int] = ()
    compute_dtype: str = ""  # "" -> flags.compute_dtype
    check_nan_inf: bool = False
    nan_policy: str = "raise"
    # feed double buffering: a producer thread plans the next batches' keys
    # and copies their feed to the device (pinned host memory, a side
    # stream) while the current step computes, at most this many ahead.
    # 0 (or less) = the serial feed.
    prefetch_batches: int = 2

    def __post_init__(self):
        if self.sync_dense_mode not in ("step", "kstep", "async"):
            raise ValueError(
                f"unknown sync_dense_mode {self.sync_dense_mode!r}"
            )
        if self.dense_optimizer == "sgd":
            raise not_ported("dense_optimizer='sgd'", "trainer cut-outs, item 3")
        if self.dense_optimizer != "adam":
            raise ValueError(
                f"unknown dense optimizer {self.dense_optimizer!r}"
            )
        if self.nan_policy not in ("raise", "skip_batch", "rollback"):
            raise ValueError(
                f"unknown nan_policy {self.nan_policy!r} "
                "(want raise | skip_batch | rollback)"
            )
        if self.nan_policy != "raise":
            raise not_ported(
                f"nan_policy={self.nan_policy!r}", "trainer cut-outs, item 3"
            )
        if self.counter_label_tasks:
            raise not_ported("counter_label_tasks", "model zoo, item 5")
