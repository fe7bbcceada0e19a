"""MultiScenarioTrainer: interleaved passes of N towers over ONE table
(reference: paddlebox_tpu/scenarios/multi.py).

Each scenario is a (model, slot policy, trainer config) triple: a CTR
tower over one slot subset, a CVR tower with its own create threshold, a
two-tower retrieval objective, all pulling from and pushing to the SAME
sparse table.  One shared pass a round: the census is the UNION of every
scenario's keys (so the cache and placement machinery see the true working
set), the scenarios' batches interleave round-robin inside the pass in spec
order, and the shared ``values`` / ``g2sum`` tensors take every scenario's
step in that order, in place.  Planning and feeding run serially on the
caller's thread, one batch at a time in the interleave order (no prefetch
producer): the table's push order is the reference's, so a run is
bit-deterministic and holds against the reference's.

Slot policy per scenario:

  * ``slot_mask``: participating slots (the Trainer's slot gating: an
    excluded slot pools zero, receives no gradient, bumps no counter);
  * per-slot embedding widths ride the MODEL (``slot_embed_dims`` on
    CtrDnn);
  * ``create_threshold``: a pull-time admission override: the scenario's
    step reads embeddings only for rows whose show count cleared ITS
    threshold, while the table keeps one physical row a key.

Scenario is a telemetry label: per-scenario AUC and loss gauges, step and
sample counters, a ``scenario_pass`` event a scenario a pass, and the pass
span carries the scenario count.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from paddlebox_tpu_torch import telemetry
from paddlebox_tpu_torch.config import SparseTableConfig, TrainerConfig
from paddlebox_tpu_torch.metrics.auc import compute_metrics
from paddlebox_tpu_torch.scenarios.retrieval import RetrievalTrainer
from paddlebox_tpu_torch.train.trainer import (
    NonFiniteBatchError,
    Trainer,
    check_model_inputs,
    host_feed,
)
from paddlebox_tpu_torch.utils.monitor import stats

_SCENARIO_STEPS = telemetry.counter(
    "scenario.steps", help="interleaved train steps by scenario"
)
_SCENARIO_SAMPLES = telemetry.counter(
    "scenario.samples", help="trained instances by scenario"
)
_SCENARIO_AUC = telemetry.gauge(
    "scenario.auc", help="per-pass AUC by scenario"
)
_SCENARIO_LOSS = telemetry.gauge(
    "scenario.loss", help="per-pass mean loss by scenario"
)

_KINDS = ("ranking", "retrieval")


@dataclasses.dataclass
class ScenarioSpec:
    """One scenario: a dense tower and its slot, admission and trainer
    policy.  The model holds its own weights (the reference's ``seed``
    initialized them)."""

    name: str
    model: Any
    kind: str = "ranking"  # "ranking" (pointwise logloss) | "retrieval"
    slot_mask: Optional[tuple] = None  # participating slots (None = all)
    create_threshold: Optional[float] = None  # pull-time admission override
    trainer_conf: Optional[TrainerConfig] = None


class MultiScenarioTrainer:
    """Owns one Trainer a scenario; drives them through shared passes on
    ``device`` (the card by default; "cpu" for the CPU)."""

    def __init__(self, table_conf: SparseTableConfig, specs, device="cuda"):
        specs = list(specs)
        if not specs:
            raise ValueError("need at least one ScenarioSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate scenario names in {names}")
        self.table_conf = table_conf
        self.specs = {s.name: s for s in specs}
        self._order = tuple(names)  # interleave order = spec order
        self.trainers: dict = {}
        for spec in specs:
            if spec.kind not in _KINDS:
                raise ValueError(
                    f"scenario {spec.name!r}: unknown kind {spec.kind!r} "
                    f"(want one of {_KINDS})"
                )
            tconf = table_conf
            if spec.create_threshold is not None:
                # a pull-time parameter: safe to vary over the shared rows
                # (row width and layout are the table's)
                tconf = dataclasses.replace(
                    table_conf, create_threshold=spec.create_threshold
                )
            cls = RetrievalTrainer if spec.kind == "retrieval" else Trainer
            self.trainers[spec.name] = cls(
                spec.model, tconf, spec.trainer_conf, device=device,
                slot_mask=spec.slot_mask,
            )
        self._pass_idx = 0
        self.last_metrics: Optional[dict] = None

    def scenario_names(self) -> tuple:
        return self._order

    def union_census(self, datasets: dict) -> np.ndarray:
        """The shared pass's census: the union of every scenario's working
        set."""
        parts = [np.asarray(datasets[name].unique_keys(), dtype=np.uint64)
                 for name in self._order]
        return np.unique(np.concatenate(parts))

    def train_pass(self, datasets: dict, table,
                   drop_last: bool = False) -> dict:
        """One interleaved pass: begin_pass(union census), one batch a
        scenario round-robin until every dataset drains, end_pass.  Returns
        ``{scenario: metrics}`` (AUC, loss, steps, samples).  ``datasets``
        maps every scenario's name to its dataset."""
        missing = [n for n in self._order if n not in datasets]
        if missing:
            raise ValueError(f"no dataset for scenario(s) {missing}")
        table.begin_pass(self.union_census(datasets))
        try:
            results = self._run_interleaved(datasets, table, drop_last)
        except BaseException:
            table.abort_pass()
            raise
        table.end_pass()
        self._observe_pass(results)
        self._pass_idx += 1
        self.last_metrics = results
        return results

    def _run_interleaved(self, datasets: dict, table,
                         drop_last: bool) -> dict:
        states = {n: self.trainers[n]._metric_state(
                      self.trainers[n].last_metric_state)
                  for n in self._order}
        losses: dict = {n: [] for n in self._order}
        steps = {n: 0 for n in self._order}
        samples = {n: 0.0 for n in self._order}
        t0 = time.monotonic()
        with telemetry.span("scenarios.pass", pass_idx=self._pass_idx,
                            n_scenarios=len(self._order)):
            iters = {n: datasets[n].batches(drop_last=drop_last)
                     for n in self._order}
            alive = list(self._order)
            while alive:
                for name in list(alive):
                    try:
                        batch = next(iters[name])
                    except StopIteration:
                        alive.remove(name)
                        continue
                    tr = self.trainers[name]
                    auc, gn, group, task = states[name]
                    check_model_inputs(tr.model, batch)
                    # planned and fed here, in the interleave order: the
                    # shared table sees the reference's push order
                    host = host_feed(batch, table.plan_batch(batch),
                                     tr._slot_lr_vec, tr.metric_group,
                                     tr.conf.counter_label_tasks)
                    loss, flags = tr._run_group(table, [tr._to_device(host)],
                                                auc, gn, group, None, task)
                    if tr._check_nan and not bool(flags[0]):
                        if tr.conf.nan_policy == "skip_batch":
                            # the gated step kept the pre-batch state
                            stats.add("train.nan_skipped_steps")
                            continue
                        raise NonFiniteBatchError(
                            f"non-finite loss/grad in scenario {name!r} at "
                            f"step {tr.global_step}")
                    losses[name].append(loss)
                    steps[name] += 1
                    tr.global_step += 1
                    samples[name] += float(batch.ins_mask.sum())
        duration = time.monotonic() - t0
        results = {}
        for name in self._order:
            tr = self.trainers[name]
            auc, gn, group, task = states[name]
            m = compute_metrics(auc)
            m["loss"] = (float(torch.cat(losses[name]).double().mean())
                         if losses[name] else 0.0)
            m["steps"] = steps[name]
            m["samples"] = samples[name]
            m["duration_s"] = duration
            tr.last_auc_state = auc
            tr.last_metric_state = {"auc": auc, "gn": gn}
            if task is not None:
                tr.last_metric_state["task"] = task
            tr._pass_idx += 1
            results[name] = m
        return results

    def _observe_pass(self, results: dict) -> None:
        for name, m in results.items():
            if "auc" in m:
                _SCENARIO_AUC.set(float(m["auc"]), scenario=name)
            _SCENARIO_LOSS.set(float(m["loss"]), scenario=name)
            if m["steps"]:
                _SCENARIO_STEPS.inc(m["steps"], scenario=name)
            if m["samples"]:
                _SCENARIO_SAMPLES.inc(m["samples"], scenario=name)
            telemetry.emit_event(
                "scenario_pass", scenario=name, pass_idx=self._pass_idx,
                auc=m.get("auc"), loss=m["loss"], steps=m["steps"],
                samples=m["samples"],
            )
