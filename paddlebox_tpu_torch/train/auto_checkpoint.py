"""Auto-checkpoint: job-scoped, pass-granular train status and resume
(reference: paddlebox_tpu/train/auto_checkpoint.py).

Per completed pass, ``after_pass`` persists atomically:
  * the sparse delta (or a full base every ``base_every`` passes),
  * the dense model and optimizer state (``trainer.dense_state()``),
  * the live metric state (an AucState), so pass-spanning AUC streams
    survive,
  * a status line: job id, next pass index, file cursor, global step.

``resume`` restores everything and tells the driver loop where to pick up.
Replay is deterministic: the table seed rides the checkpoint meta (the init
of unseen features reproduces), the dense state restores bit for bit, and
the dataset pipeline is deterministic given the same filelist.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Optional

from paddlebox_tpu_torch.checkpoint import (
    CheckpointCorrupt,
    CheckpointManager,
    IncrementalCheckpointManager,
    load_pytree,
    save_pytree,
)
from paddlebox_tpu_torch.utils.monitor import stats

logger = logging.getLogger(__name__)


class AutoCheckpointer:
    """Directory layout::

        root/
          <CheckpointManager base-/delta- dirs + donefile.txt>
          status-<job_id>.json   atomic (tmp + rename) per-pass train status
          mstate-<job_id>.npz    metric-state snapshot for the status pass
    """

    def __init__(
        self,
        root: str,
        job_id: str = "default",
        base_every: int = 8,
        shard: int = 0,
        n_shards: int = 1,
        incremental: bool = False,
    ):
        self.root = root
        self.job_id = job_id
        self.base_every = max(int(base_every), 1)
        if incremental:
            # log-structured checkpoints: deltas append one manifest
            # generation to the durable log instead of writing a dir per
            # pass, and restore materializes a generation (cost = base +
            # trailing-delta bytes, bounded by compaction).  Single-shard
            # only — sharded jobs keep the classic per-shard manager.
            if n_shards > 1:
                raise ValueError(
                    "incremental checkpoints are single-shard; use the "
                    "classic CheckpointManager for sharded jobs"
                )
            self.ckpt = IncrementalCheckpointManager(root)
        else:
            self.ckpt = CheckpointManager(root, shard=shard, n_shards=n_shards)
        os.makedirs(root, exist_ok=True)

    def _status_path(self) -> str:
        return os.path.join(self.root, f"status-{self.job_id}.json")

    def _mstate_path(self) -> str:
        return os.path.join(self.root, f"mstate-{self.job_id}.npz")

    # -- write ------------------------------------------------------------- #
    def after_pass(
        self,
        pass_index: int,
        table,
        trainer,
        file_cursor: int = 0,
        metric_state: Optional[Any] = None,
        extra: Optional[dict] = None,
    ) -> None:
        """Record pass ``pass_index`` as completed (call after end_pass).

        The checkpoint lands BEFORE the status file: a crash between the two
        re-runs the pass (idempotent — resume restores the pre-status
        checkpoint chain), never skips it.
        """
        params, opt_state = trainer.dense_state()
        tag = f"{self.job_id}-p{pass_index:06d}"
        # global_step rides the checkpoint meta (not just the status file)
        # so a FALLBACK resume to an older tag can still restore the step
        # counter that belongs to that pass
        meta = {"pass_index": pass_index, "file_cursor": file_cursor,
                "global_step": int(getattr(trainer, "global_step", 0)),
                **(extra or {})}
        if pass_index % self.base_every == 0:
            self.ckpt.save_base(tag, table, params, opt_state, meta=meta)
        else:
            self.ckpt.save_delta(tag, table, params, opt_state, meta=meta)
        if metric_state is not None:
            save_pytree(self._mstate_path(), metric_state)
        status = {
            "job_id": self.job_id,
            "next_pass": pass_index + 1,
            "file_cursor": file_cursor,
            "global_step": int(getattr(trainer, "global_step", 0)),
            "tag": tag,
        }
        tmp = self._status_path() + f".tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(status, fh)
        os.replace(tmp, self._status_path())

    # -- read -------------------------------------------------------------- #
    def status(self) -> Optional[dict]:
        p = self._status_path()
        if not os.path.exists(p):
            return None
        with open(p) as fh:
            return json.load(fh)

    def resume(
        self, table, trainer, metric_template: Optional[Any] = None
    ):
        """Restore table + dense + (optionally) metric state from the last
        recorded pass.  Returns (status dict, metric_state or None), or
        (None, None) for a fresh job (reference: TrainEpochRange restores
        epoch_no and checkpoint_epoch_no for the job id).

        When the newest checkpoint is corrupt/truncated (integrity manifest
        mismatch), resume walks the donefile chain back to the newest tag
        that still fully verifies and restores THAT pass instead: the
        returned status carries the older next_pass/file_cursor (rebuilt
        from the checkpoint's own meta) plus ``"fallback": True``, and the
        metric-state snapshot — which belongs to the newer, lost pass — is
        dropped.  The driver replays from there; with a deterministic
        pipeline the replay reproduces the lost passes exactly."""
        status = self.status()
        if status is None:
            return None, None
        params_t, opt_t = trainer.dense_state()
        tag = status["tag"]
        valid_tag = self.ckpt.find_valid_tag(upto=tag)
        if valid_tag is None:
            raise CheckpointCorrupt(
                f"no valid checkpoint chain under {self.root} for job "
                f"{self.job_id!r} (status tag {tag!r})"
            )
        params, opt_state, meta = self.ckpt.load(
            table, params_t, opt_t, upto=valid_tag
        )
        trainer.load_dense_state(params, opt_state)
        if valid_tag != tag:
            stats.add("ckpt.resume_fallback")
            logger.warning(
                "checkpoint tag %r failed verification; falling back to "
                "newest valid tag %r (replaying pass %s onward)",
                tag, valid_tag, meta.get("pass_index", "?"),
            )
            status = {
                "job_id": self.job_id,
                "next_pass": int(meta.get("pass_index", -1)) + 1,
                "file_cursor": int(meta.get("file_cursor", 0)),
                "global_step": int(meta.get("global_step", 0)),
                "tag": valid_tag,
                "fallback": True,
            }
            trainer.global_step = status["global_step"]
            return status, None
        trainer.global_step = int(status.get("global_step", 0))
        mstate = None
        if metric_template is not None and os.path.exists(self._mstate_path()):
            mstate = load_pytree(self._mstate_path(), metric_template)
        return status, mstate
