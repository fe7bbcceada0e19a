"""Synthetic Criteo-like slot data with a learnable click signal (reference:
paddlebox_tpu/data/synth.py; the same seed writes byte-identical files).

Each feature sign carries a latent weight; the click label is
Bernoulli(sigmoid(mean of the instance's key weights)), so a model that
learns per-key embeddings beats AUC 0.5.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig


def make_synth_config(
    n_sparse_slots: int = 4,
    dense_dim: int = 4,
    batch_size: int = 64,
    max_feasigns_per_ins: int = 64,
    n_task_labels: int = 0,
    **kw,
) -> DataFeedConfig:
    slots = [SlotConfig(name="click", type="float", is_dense=True, shape=(1,))]
    slots += [
        SlotConfig(name=f"task{t}", type="float", is_dense=True, shape=(1,))
        for t in range(n_task_labels)
    ]
    slots += [SlotConfig(name=f"slot{i}", type="uint64") for i in range(n_sparse_slots)]
    if dense_dim:
        slots.append(
            SlotConfig(name="dense0", type="float", is_dense=True, shape=(dense_dim,))
        )
    return DataFeedConfig(
        slots=slots,
        batch_size=batch_size,
        label_slot="click",
        task_label_slots=tuple(f"task{t}" for t in range(n_task_labels)),
        max_feasigns_per_ins=max_feasigns_per_ins,
        **kw,
    )


def stream_line(
    rng: np.random.Generator,
    label: int,
    n_sparse_slots: int = 2,
    dense_dim: int = 2,
    hot_keys: Optional[Sequence[int]] = None,
    vocab_per_slot: int = 40,
) -> str:
    """One slot-text record of a synthetic live stream, newline-terminated
    (the reference's same rng draws give the same line).

    hot_keys: one key a slot present in every record (beside one noise key
    a slot), the signal whose label a streaming check flips to watch the
    served score move; None = noise keys only."""
    parts = [f"1 {label}"]
    for s in range(n_sparse_slots):
        noise = int(rng.integers(1, vocab_per_slot)) + s * 1000
        if hot_keys is not None:
            parts.append(f"2 {hot_keys[s]} {noise}")
        else:
            parts.append(f"2 {noise} {noise + 1}")
    if dense_dim:
        parts.append(
            f"{dense_dim} "
            + " ".join(f"{v:.3f}" for v in rng.normal(size=dense_dim))
        )
    return " ".join(parts) + "\n"


def write_synth_files(
    out_dir: str,
    n_files: int = 2,
    ins_per_file: int = 256,
    n_sparse_slots: int = 4,
    vocab_per_slot: int = 100,
    dense_dim: int = 4,
    max_keys_per_slot: int = 3,
    seed: int = 0,
    signal_scale: float = 4.0,
    with_logkey: bool = False,
    max_ads_per_pv: int = 4,
    cmatch_values: Sequence[int] = (222, 223),
    n_task_labels: int = 0,
    zipf_a: float = 0.0,
) -> list[str]:
    """Writes slot-text files ``part-NNN`` into ``out_dir``; returns their
    paths.

    with_logkey adds the ``search_id:rank:cmatch`` prefix and groups
    consecutive instances into page-views of 1..max_ads_per_pv ads sharing
    a search_id, with ranks 1..n_ads and a cmatch drawn from
    cmatch_values (the PV-merge input).  n_task_labels adds that many task
    label slots after the click, each thinned from the same latent signal.
    zipf_a > 1 draws each slot's local key ids from a (vocab-clipped)
    Zipf(a) instead of uniformly."""
    rng = np.random.default_rng(seed)
    # latent per-key weights drive the label
    key_w = rng.normal(size=(n_sparse_slots, vocab_per_slot)) * signal_scale
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    next_sid = seed * 1_000_003 + 1
    for f in range(n_files):
        path = os.path.join(out_dir, f"part-{f:03d}")
        with open(path, "w") as fh:
            written = 0
            while written < ins_per_file:
                if with_logkey:
                    n_ads = int(
                        rng.integers(1, min(max_ads_per_pv, ins_per_file - written) + 1)
                    )
                    sid = next_sid
                    next_sid += 1
                else:
                    n_ads = 1
                for ad in range(n_ads):
                    logit = 0.0
                    slot_keys: list[np.ndarray] = []
                    for s in range(n_sparse_slots):
                        n = int(rng.integers(1, max_keys_per_slot + 1))
                        if zipf_a > 1.0:
                            # hot head at low ids; clip the unbounded tail
                            local = np.minimum(
                                rng.zipf(zipf_a, size=n), vocab_per_slot
                            ) - 1
                        else:
                            local = rng.integers(0, vocab_per_slot, size=n)
                        # globally unique feasign: slot s owns [s*vocab, (s+1)*vocab)
                        slot_keys.append(local + s * vocab_per_slot + 1)
                        logit += key_w[s, local].mean()
                    logit /= n_sparse_slots
                    p = 1.0 / (1.0 + np.exp(-logit))
                    label = int(rng.random() < p)
                    parts = []
                    if with_logkey:
                        cm = int(rng.choice(list(cmatch_values)))
                        parts.append(f"{sid}:{ad + 1}:{cm}")
                    parts.append(f"1 {label}")
                    for t in range(n_task_labels):
                        # task labels share the latent signal, thinned per task
                        tl = int(rng.random() < p * (0.5 + 0.5 / (t + 1)))
                        parts.append(f"1 {tl}")
                    for ks in slot_keys:
                        parts.append(
                            f"{len(ks)} " + " ".join(str(int(k)) for k in ks)
                        )
                    if dense_dim:
                        dvals = rng.normal(size=dense_dim) * 0.1
                        parts.append(
                            f"{dense_dim} " + " ".join(f"{v:.4f}" for v in dvals)
                        )
                    fh.write(" ".join(parts) + "\n")
                    written += 1
        paths.append(path)
    return paths
