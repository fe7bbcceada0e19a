"""Join/update two-phase training: the reference's production pass
schedule (reference: paddlebox_tpu/train/two_phase.py).

The reference trains every pass TWICE over the same in-memory data: first
the "join" program (the towers and slots that join the ad/user
statistics), then, after a global phase flip, the "update" program (the
remaining slots).  Phase state lives on the BoxWrapper singleton
(``phase_`` / ``FlipPhase``, box_wrapper.h:627-630), the data feed serves
PV-merged batches only in the join phase (data_feed.cc:1663-1666), and
every metric is registered with a ``metric_phase`` so only matching streams
accumulate during a phase (boxps_worker.cc:530-540).

Here phases are explicit specs, not singleton state.  Each phase owns a
full trainer (its own dense tower, optimizer and metric streams: "a
different program per phase") with a slot participation mask restricting
which sparse slots the phase trains; the sparse table is SHARED, so a
pass's join updates are visible to its update phase, as the reference's
shared PS core makes them.  Metric streams stay per phase by construction.
On the card a phase trainer with ``scan_steps`` captures its own CUDA graph
of its own slot mask; a graph is bound to the pass's table tensors, which
every begin_pass reallocates, so no graph replays across passes or phases.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.train.trainer import Trainer


@dataclasses.dataclass
class PhaseSpec:
    """One training phase of a pass.

    name:  stream key ("join"/"update" canonically; any label works).
    model: the phase's dense program (own params/optimizer).
    slots: participating sparse-slot indices; None = all slots.  Excluded
           slots are absent from the phase's program: zero pooled features,
           zero gradients, zero counter increments.
    use_pv: the phase consumes PV-merged batches (rank_offset models);
           mirrors the reference serving PV channels only in join phase.
    """

    name: str
    model: Any
    slots: Optional[Sequence[int]] = None
    use_pv: bool = False


class TwoPhaseTrainer:
    """Trains each pass once per phase, in spec order, over the same data.

    Canonical use is two phases (join then update, matching the reference's
    ``phase_ = 1`` start and flip-to-0, box_wrapper.h:671); any number of
    phases works (the reference's AucRunner generalizes phase_num the same
    way, box_wrapper.h:698).
    """

    def __init__(
        self,
        phases: Sequence[PhaseSpec],
        table_conf: SparseTableConfig,
        trainer_conf: Optional[TrainerConfig] = None,
        mesh=None,
        device="cuda",
    ):
        """mesh: a data mesh (parallel.make_mesh) runs every phase as a
        MultiChipTrainer over it (the reference's join/update schedule is
        its production multi-GPU shape); pass a ``ShardedSparseTable`` built
        on the same mesh to the train calls.  None = single chip on
        ``device``.  Each phase's model holds its own weights (the
        reference's ``seed + i`` initialized them)."""
        if not phases:
            raise ValueError("need at least one PhaseSpec")
        names = [p.name for p in phases]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate phase names: {names}")
        self.specs = list(phases)
        if mesh is None:
            make = lambda spec: Trainer(
                spec.model, table_conf, trainer_conf, device=device,
                slot_mask=spec.slots,
            )
        else:
            from paddlebox_tpu_torch.parallel.trainer import MultiChipTrainer

            make = lambda spec: MultiChipTrainer(
                spec.model, table_conf, mesh, trainer_conf,
                slot_mask=spec.slots,
            )
        self.trainers = {spec.name: make(spec) for spec in phases}
        # numeric phase for API parity: index into the training order;
        # starts at 0 (the first spec — canonically "join", which the
        # reference encodes as phase id 1 trained first)
        self._phase = 0

    # -- phase state (reference: Phase/PhaseNum/FlipPhase/SetPhase) -------- #
    @property
    def phase(self) -> int:
        return self._phase

    @property
    def phase_name(self) -> str:
        return self.specs[self._phase].name

    @property
    def phase_num(self) -> int:
        return len(self.specs)

    def flip_phase(self) -> None:
        self._phase = (self._phase + 1) % len(self.specs)

    def set_phase(self, phase: int) -> None:
        if not 0 <= phase < len(self.specs):
            raise ValueError(f"phase {phase} out of range")
        self._phase = phase

    # -- training ---------------------------------------------------------- #
    def train_phase(self, dataset, table, **kw) -> dict:
        """Train ONLY the current phase over the pass (manual driving, the
        ``train_from_dataset`` + ``flip_phase()`` loop a user would write
        against the reference).

        PV gating mirrors the reference's per-phase channel switch
        (data_feed.cc:1663-1666: join phases read the PV channels, update
        phases the flat instance channels): a ``use_pv`` phase requires the
        dataset preprocessed into PV mode; a flat phase on a PV-merged
        dataset temporarily drops to instance mode and restores after."""
        spec = self.specs[self._phase]
        tr = self.trainers[spec.name]
        pv_capable = hasattr(dataset, "pv_mode")
        if spec.use_pv and not (pv_capable and dataset.pv_mode):
            raise RuntimeError(
                f"phase {spec.name!r} wants PV batches: call "
                "dataset.preprocess_instance() first"
            )
        kw.setdefault("auc_state", tr.last_metric_state or None)
        restore_pv = (not spec.use_pv) and pv_capable and dataset.pv_mode
        if restore_pv:
            # snapshot/restore the PV grouping rather than recomputing it:
            # re-running preprocess_instance() would reset the PV
            # permutation and discard any shuffle order the user set up
            pv_state = dataset.pv_state()
            dataset.postprocess_instance()
        try:
            return tr.train_from_dataset(dataset, table, **kw)
        finally:
            if restore_pv:
                dataset.restore_pv_state(pv_state)

    def train_pass(self, dataset, table, drop_last: bool = False) -> dict:
        """Train every phase over the same pass, flipping between: the full
        per-pass schedule.  Returns {phase_name: metrics}.  Metric streams
        carry across passes per phase (exact streaming AUC)."""
        self.set_phase(0)
        out = {}
        for _ in range(len(self.specs)):
            out[self.phase_name] = self.train_phase(
                dataset, table, drop_last=drop_last
            )
            self.flip_phase()
        return out

    # -- metrics (reference: GetMetricNameList(metric_phase)) -------------- #
    def metrics(self, phase: Optional[str] = None) -> dict:
        """Latest metric state per phase name (all phases when None)."""
        if phase is not None:
            return {phase: self.trainers[phase].last_metric_state}
        return {
            name: tr.last_metric_state for name, tr in self.trainers.items()
        }

    def dense_states(self) -> dict:
        return {name: tr.dense_state() for name, tr in self.trainers.items()}

    def close(self) -> None:
        """Close every phase trainer (joins the async dense update
        threads and re-raises a dead thread's error: required under
        ``sync_dense_mode="async"``, harmless otherwise)."""
        errs = []
        for tr in self.trainers.values():
            try:
                tr.close()
            except Exception as e:  # close the rest before re-raising
                errs.append(e)
        if errs:
            raise errs[0]
