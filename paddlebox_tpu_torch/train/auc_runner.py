"""AUC runner: per-slot feature-importance evaluation (reference:
paddlebox_tpu/train/auc_runner.py; its mode is the reference's
``FLAGS_padbox_auc_runner_mode``, flags.cc:495, here
PADDLEBOX_TORCH_AUC_RUNNER_MODE).

To measure how much a slot (group) matters, replace its feasign values
with random draws from the slot's empirical candidate pool
(``FeasignValuesCandidateList``, data_feed.h:1086-1275; the random
replacement ``GetRandomReplace`` / ``RecordReplace`` of box_wrapper.cc)
and measure the AUC drop on a forward-only pass.  A slot whose replacement
barely moves the AUC carries little signal.

Replacement is a pure function RecordBlock -> RecordBlock (no in-place
``RecordReplaceBack``: the original block is untouched), and evaluation
is ``Trainer.evaluate``'s forward (the pull_rows kernel on the card).
The pools, the draws and the replaced blocks are host numpy, bit-equal to
the reference's for the same seed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.data.record import RecordBlock


def key_slot_map(block: RecordBlock) -> np.ndarray:
    """[n_keys] slot index of every key occurrence (computed once per block
    and shared by pool building and replacement)."""
    lens = np.diff(block.key_offsets)
    slot_of_row = np.tile(np.arange(block.n_sparse_slots), block.n_ins)
    return np.repeat(slot_of_row, lens)


def build_candidate_pools(
    block: RecordBlock,
    max_pool: int = 100_000,
    seed: int = 0,
    key_slots: Optional[np.ndarray] = None,
) -> list[np.ndarray]:
    """Per-slot pools of observed feasign values (reservoir-capped at
    max_pool, reference FLAGS_padbox_slot_feasign_max_num analog)."""
    rng = np.random.default_rng(seed)
    if key_slots is None:
        key_slots = key_slot_map(block)
    pools = []
    for si in range(block.n_sparse_slots):
        vals = block.keys[key_slots == si]
        if vals.shape[0] > max_pool:
            vals = rng.choice(vals, size=max_pool, replace=False)
        pools.append(vals)
    return pools


def replace_slots(
    block: RecordBlock,
    slot_idxs: Sequence[int],
    pools: Sequence[np.ndarray],
    seed: int = 0,
    key_slots: Optional[np.ndarray] = None,
) -> RecordBlock:
    """New block with the given slots' values redrawn from their pools
    (counts per instance preserved; all other slots untouched)."""
    rng = np.random.default_rng(seed)
    s = block.n_sparse_slots
    keys = block.keys.copy()
    if key_slots is None:
        key_slots = key_slot_map(block)
    for si in slot_idxs:
        m = key_slots == si
        n = int(m.sum())
        if n and pools[si].shape[0]:
            keys[m] = rng.choice(pools[si], size=n, replace=True)
    return RecordBlock(
        n_ins=block.n_ins,
        n_sparse_slots=s,
        keys=keys,
        key_offsets=block.key_offsets,
        dense=block.dense,
        labels=block.labels,
        ins_ids=block.ins_ids,
        search_ids=block.search_ids,
        ranks=block.ranks,
        cmatches=block.cmatches,
        task_labels=block.task_labels,
    )


class AucRunner:
    """Drives slot-importance evaluation over a loaded dataset.

    For each slot group: swap the dataset's block for a pool-replaced copy,
    begin a pass over its keys, run Trainer.evaluate, restore.  Returns
    {group_name: {"auc": ..., "delta": baseline_auc - auc}} — bigger delta =
    more important group.
    """

    def __init__(self, trainer, table, max_pool: int = 100_000, seed: int = 0):
        self.trainer = trainer
        self.table = table
        self.max_pool = max_pool
        self.seed = seed

    def run(
        self,
        dataset,
        slot_groups: dict[str, Sequence[str]],
        baseline: Optional[dict] = None,
    ) -> dict:
        block = dataset._block
        if block is None:
            raise RuntimeError("load the dataset before running AUC runner")
        names = [s.name for s in dataset.conf.sparse_slots()]
        key_slots = key_slot_map(block)
        pools = build_candidate_pools(
            block, self.max_pool, self.seed, key_slots=key_slots
        )

        def eval_current() -> dict:
            self.table.begin_pass(dataset.unique_keys())
            try:
                return self.trainer.evaluate(dataset, self.table)
            finally:
                self.table.end_pass()

        if baseline is None:
            baseline = eval_current()
        out = {"baseline": baseline}
        for gname, slots in slot_groups.items():
            idxs = [names.index(n) for n in slots]
            dataset._block = replace_slots(
                block, idxs, pools, self.seed, key_slots=key_slots
            )
            try:
                m = eval_current()
            finally:
                dataset._block = block
            m["delta"] = baseline["auc"] - m["auc"]
            out[gname] = m
        return out
