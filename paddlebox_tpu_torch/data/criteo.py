"""Criteo display-advertising format adapter (reference:
paddlebox_tpu/data/criteo.py): local writing and conversion, no download.

  * ``CriteoTSVGenerator`` parses the standard Criteo TSV line
    (``label \\t I1..I13 \\t C1..C26``, empty fields legal) into slot
    instances: 26 hashed categorical slots and one 13-wide dense slot
    (``log1p`` of the counts).
  * ``convert_criteo_files`` streams TSV files into slot-text shards that
    the dataset reads with ``criteo_feed_config``.
  * ``write_criteo_format_sample`` writes a synthetic sample in the exact
    format (hex category tokens, empty fields, heavy-tailed counts) with a
    planted learnable signal: the real format, synthetic values.
"""

from __future__ import annotations

import hashlib
import math
import os
import random
from typing import Iterable, Optional, Sequence

from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.data.data_generator import DataGenerator

CRITEO_N_DENSE = 13
CRITEO_N_CAT = 26


def criteo_feed_config(batch_size: int = 2048, **kw) -> DataFeedConfig:
    """Feed schema for converted Criteo data: click label, 26 categorical
    slots (``cat0..cat25``), one 13-wide dense slot."""
    slots = [SlotConfig(name="click", type="float", is_dense=True, shape=(1,))]
    slots += [SlotConfig(name=f"cat{i}", type="uint64")
              for i in range(CRITEO_N_CAT)]
    slots.append(SlotConfig(name="dense0", type="float", is_dense=True,
                            shape=(CRITEO_N_DENSE,)))
    kw.setdefault("batch_key_capacity", batch_size * CRITEO_N_CAT)
    return DataFeedConfig(slots=slots, batch_size=batch_size,
                          label_slot="click", **kw)


def criteo_key(slot: int, token: str) -> int:
    """Deterministic nonzero uint64 feature sign for a categorical token.

    blake2b over ``slot:token`` — stable across processes/runs (Python's
    ``hash`` is salted), slot-mixed so the same token in different
    columns stays distinct."""
    h = hashlib.blake2b(f"{slot}:{token}".encode(), digest_size=8)
    k = int.from_bytes(h.digest(), "little")
    return k or 1  # 0 is not a legal feasign


def dense_transform(raw: Optional[str]) -> float:
    """The published Criteo integer-feature recipe: log1p of the
    (clipped-at-zero) count; empty field -> 0."""
    if not raw:
        return 0.0
    try:
        v = float(raw)
    except ValueError:
        return 0.0
    if not math.isfinite(v):  # "nan"/"inf" fields must not poison the pass
        return 0.0
    return math.log1p(max(v, 0.0))


class CriteoTSVGenerator(DataGenerator):
    """DataGenerator over raw Criteo TSV lines (one instance per line)."""

    def generate_sample(self, line):
        if line is None:
            return
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 1 + CRITEO_N_DENSE + CRITEO_N_CAT:
            # ragged tail lines exist in the wild: pad to width
            parts = parts + [""] * (1 + CRITEO_N_DENSE + CRITEO_N_CAT
                                    - len(parts))
        label = 1.0 if parts[0].strip() == "1" else 0.0
        dense = [dense_transform(p) for p in parts[1:1 + CRITEO_N_DENSE]]
        ins = []
        for i in range(CRITEO_N_CAT):
            tok = parts[1 + CRITEO_N_DENSE + i].strip()
            # empty categorical -> slot emits no key (count 0), the same
            # missing-feature shape the parser/feed already handle
            ins.append((f"cat{i}", [criteo_key(i, tok)] if tok else []))
        ins.append(("click", [label]))
        ins.append(("dense0", dense))
        yield ins


def convert_criteo_files(
    inputs: Sequence[str],
    out_dir: str,
    batch_size: int = 2048,
    lines_per_shard: int = 200_000,
) -> list:
    """Stream Criteo TSVs into canonical slot-text shards under out_dir.
    Returns the shard paths; feed them to any dataset with
    ``criteo_feed_config``.  Gzipped inputs are handled (.gz suffix)."""
    import gzip

    import io

    os.makedirs(out_dir, exist_ok=True)
    conf = criteo_feed_config(batch_size)
    gen = CriteoTSVGenerator(conf)
    shards = []
    out = None
    n_in_shard = 0

    # shards open lazily on the first line actually WRITTEN: empty or
    # fully-malformed inputs produce no zero-byte part-00000 (each line is
    # staged through a string buffer so a line the generator drops never
    # forces a shard into existence)
    try:
        for src in inputs:
            opener = gzip.open if str(src).endswith(".gz") else open
            with opener(src, "rt") as f:
                for line in f:
                    buf = io.StringIO()
                    wrote = gen.write(buf, [line])
                    if not wrote:
                        continue
                    if out is not None and n_in_shard >= lines_per_shard:
                        out.close()
                        out = None
                    if out is None:
                        path = os.path.join(
                            out_dir, f"part-{len(shards):05d}"
                        )
                        shards.append(path)
                        out = open(path, "w")
                        n_in_shard = 0
                    out.write(buf.getvalue())
                    n_in_shard += wrote
    finally:
        if out is not None:
            out.close()
    return shards


def write_criteo_format_sample(
    path: str,
    n_lines: int = 4096,
    seed: int = 0,
    vocab_per_cat: int = 1000,
) -> str:
    """A spec-exact SYNTHETIC Criteo TSV: hex tokens (the real files use
    32-bit hex strings), ~4% empty categorical fields, ~25% empty ints,
    heavy-tailed counts, and a planted signal — some category values and
    one integer feature shift the click probability — so a CTR model must
    demonstrably learn (AUC) on it, not just parse it."""
    rng = random.Random(seed)
    with open(path, "w") as f:
        for _ in range(n_lines):
            # per-category token pools; low-id tokens carry signal
            toks = []
            signal = 0.0
            for i in range(CRITEO_N_CAT):
                if rng.random() < 0.04:
                    toks.append("")
                    continue
                t = rng.randrange(vocab_per_cat)
                if i < 6 and t < vocab_per_cat // 10:
                    signal += 0.5  # predictive head tokens in 6 slots
                toks.append(f"{t * 2654435761 % (1 << 32):08x}")
            ints = []
            for j in range(CRITEO_N_DENSE):
                if rng.random() < 0.25:
                    ints.append("")
                    continue
                v = int(rng.paretovariate(1.5)) - 1
                if j == 0:
                    signal += min(v, 10) * 0.08  # count feature signal
                ints.append(str(v))
            p = 1.0 / (1.0 + math.exp(-(signal - 1.6)))
            label = "1" if rng.random() < p else "0"
            f.write("\t".join([label] + ints + toks) + "\n")
    return path
