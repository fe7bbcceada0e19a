"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a configuration's schema and scale give slot-text files of the port's
format, made from the seed.

A line is the Criteo Display Advertising schema in the port's slot text:
the label slots, each categorical slot with its count and keys (one hashed
64-bit key, or none where the field is empty), then the dense slot of
``log1p`` counts::

    1 <label> 1 <key> 0 1 <key> ... <D> <v> ... <v>

Every field is built at a fixed width (keys zero-padded to 20 digits,
values as ``dd.dddd``) by digit arithmetic into one byte buffer, and an
empty field's key bytes are masked out of it, so there is no per-field
formatting.  The same seed gives the same bytes.

Each categorical column ``c`` has its own vocabulary
``vocab_per_column[c]`` and its own share of empty fields
``empty_rate_per_column[c]``; each dense column its share of empty
(zero) counts ``dense_empty_rate_per_column``.  Tokens are drawn per
column, Zipf(``zipf_alpha``) or uniform over the column's ranks; a key is
a 64-bit mix of the column and the rank.  Labels are planted: a fixed
eighth of the tokens of the first ``signal_columns`` columns and the first
count raise the click probability, and an offset found by bisection sets
the mean probability to ``positive_rate``; a configuration with more than
one label slot gets one such label a task, each from its own eighth.  The
lines are cut into ``chunks`` equal chunks, one chunk a pass, each written
as ``files_per_chunk`` files in line order.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

KEY_DIGITS = 20
VALUE_WIDTH = 7  # dd.dddd
_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


@dataclasses.dataclass
class Chunk:
    files: list  # slot-text files, in line order
    keys: np.ndarray  # uint64 [lines, S] in line order, 0 where empty
    census: np.ndarray  # sorted unique keys of the chunk

    def batch_keys(self, lo: int, hi: int) -> np.ndarray:
        """The keys of lines ``lo:hi`` in slot-text order, empties left
        out."""
        k = self.keys[lo:hi].reshape(-1)
        return k[k != 0]


@dataclasses.dataclass
class Data:
    chunks: list
    labels: np.ndarray  # float32 [lines, tasks]


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over uint64."""
    with np.errstate(over="ignore"):
        z = x + _C1
        z = (z ^ (z >> np.uint64(30))) * _C2
        z = (z ^ (z >> np.uint64(27))) * _C3
        return z ^ (z >> np.uint64(31))


def seed_rng(seed: int) -> np.random.Generator:
    """A generator for any whole number: negative seeds wrap to 64 bits."""
    return np.random.default_rng(int(seed) % (1 << 64))


def columns(mix: dict, cols: int) -> tuple:
    """(vocabularies, empty shares) of the ``cols`` categorical columns."""
    vocab = np.asarray(mix["vocab_per_column"], dtype=np.int64)
    empty = np.asarray(mix["empty_rate_per_column"], dtype=np.float64)
    if vocab.shape != (cols,) or empty.shape != (cols,):
        raise ValueError(f"the mix describes {vocab.shape[0]} columns, the "
                         f"configuration has {cols}")
    return vocab, empty


def rank_probs(mix: dict, vocab: int) -> np.ndarray:
    """The chance of each rank of one column."""
    if mix["dist"] == "uniform":
        return np.full(vocab, 1.0 / vocab)
    if mix["dist"] == "zipf":
        p = np.arange(1, vocab + 1, dtype=np.float64)
        p **= -float(mix["zipf_alpha"])
        return p / p.sum()
    raise ValueError(f"unknown token distribution {mix['dist']!r}")


def draw_ranks(rng, mix: dict, n: int, cols: int) -> np.ndarray:
    """Token ranks [n, cols], column c's in [0, vocab_per_column[c])."""
    vocab, _ = columns(mix, cols)
    u = rng.random((n, cols))
    out = np.empty((n, cols), np.int64)
    for c in range(cols):
        if mix["dist"] == "uniform":
            r = (u[:, c] * vocab[c]).astype(np.int64)
        else:
            cdf = np.cumsum(rank_probs(mix, int(vocab[c])))
            r = np.searchsorted(cdf, u[:, c] * cdf[-1])
        out[:, c] = np.minimum(r, vocab[c] - 1)
    return out


def token_keys(ranks: np.ndarray) -> np.ndarray:
    """Nonzero 64-bit keys, distinct per (column, rank)."""
    cols = np.arange(1, ranks.shape[1] + 1, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        k = mix64(cols * _C2 + ranks.astype(np.uint64))
    return np.where(k == 0, np.uint64(1), k)


def expected_census(mix: dict, lines: int, cols: int) -> float:
    """Expected distinct keys of ``lines`` lines: over the columns and
    their ranks, the chance that a rank is drawn in a present field at
    least once."""
    vocab, empty = columns(mix, cols)
    total = 0.0
    for c in range(cols):
        p = (1.0 - empty[c]) * rank_probs(mix, int(vocab[c]))
        total += float((-np.expm1(lines * np.log1p(-p))).sum())
    return total


def draw_dense(rng, mix: dict, n: int, cols: int) -> np.ndarray:
    """Counts [n, cols] as 1e-4 units of log1p(count): heavy-tailed
    (Lomax, shape ``count_shape``), empty (0) at each column's share."""
    empty = np.asarray(mix["dense_empty_rate_per_column"], dtype=np.float64)
    if empty.shape != (cols,):
        raise ValueError(f"the mix describes {empty.shape[0]} dense columns, "
                         f"the configuration has {cols}")
    counts = np.floor(rng.pareto(float(mix["count_shape"]), (n, cols)))
    counts = np.minimum(counts, 1e9)
    q = np.rint(np.log1p(counts) * 1e4).astype(np.int64)
    q[rng.random((n, cols)) < empty[None, :]] = 0
    return q


def draw_labels(rng, mix: dict, ranks: np.ndarray, present: np.ndarray,
                dense_q: np.ndarray, tasks: int) -> np.ndarray:
    """Planted labels, float32 0 or 1, [n, tasks]."""
    k = int(mix["signal_columns"])
    count0 = np.expm1(dense_q[:, 0] / 1e4)
    target = float(mix["positive_rate"])
    out = np.empty((ranks.shape[0], tasks), np.float32)
    for t in range(tasks):
        with np.errstate(over="ignore"):
            h = ((ranks[:, :k].astype(np.uint64) + np.uint64(t))
                 * np.uint64(2654435761)) >> np.uint64(7)
        hit = ((h & np.uint64(7)) == 0) & present[:, :k]
        signal = float(mix["signal_weight"]) * hit.sum(1)
        signal = signal + float(mix["count_weight"]) * np.minimum(count0, 10.0)
        lo, hi = -30.0, 30.0
        for _ in range(60):  # the offset that gives the target mean
            mid = 0.5 * (lo + hi)
            if (1.0 / (1.0 + np.exp(-(signal - mid)))).mean() > target:
                lo = mid
            else:
                hi = mid
        p = 1.0 / (1.0 + np.exp(-(signal - 0.5 * (lo + hi))))
        out[:, t] = rng.random(p.shape[0]) < p
    return out


# the four ASCII digits of 0..9999, one uint32 each
_TABLE4 = np.array([list(f"{i:04d}".encode()) for i in range(10000)],
                   dtype=np.uint8).view(np.uint32).ravel()


def digits(values: np.ndarray, width: int) -> np.ndarray:
    """Zero-padded decimal digits of non-negative ``values`` as ASCII,
    ``[*values.shape, width]`` uint8, four digits a table lookup."""
    v = values.astype(np.uint64)
    parts = []
    for _ in range(-(-width // 4)):
        parts.append(_TABLE4[(v % np.uint64(10000)).astype(np.intp)])
        v = v // np.uint64(10000)
    out = np.stack(parts[::-1], axis=-1).view(np.uint8)
    return out[..., out.shape[-1] - width:]


def render(keys: np.ndarray, dense_q: np.ndarray,
           labels: np.ndarray) -> tuple:
    """The lines as one uint8 buffer and each line's end in it: ``1
    <label> `` a task, ``1 <key> `` a present column and ``0 `` an empty
    one (key 0), then ``<D> `` and ``dd.dddd`` a value, the last one's
    space turned into the newline."""
    n, cols = keys.shape
    tasks, dense = labels.shape[1], dense_q.shape[1]
    sp = ord(" ")
    head = np.empty((n, tasks, 4), np.uint8)
    head[:] = np.frombuffer(b"1 0 ", np.uint8)
    head[:, :, 2] += labels.astype(np.uint8)
    width = KEY_DIGITS + 3
    key_f = np.empty((n, cols, width), np.uint8)
    key_f[:, :, 0], key_f[:, :, 1], key_f[:, :, -1] = ord("1"), sp, sp
    key_f[:, :, 2:-1] = digits(keys, KEY_DIGITS)
    empty = keys == 0
    key_f[empty, 0] = ord("0")
    keep_key = np.ones((n, cols, width), bool)
    keep_key[empty, 2:] = False
    count = np.empty((n, len(str(dense)) + 1), np.uint8)
    count[:] = np.frombuffer(f"{dense} ".encode(), np.uint8)
    val_f = np.empty((n, dense, VALUE_WIDTH + 1), np.uint8)
    val_f[:, :, :2] = digits(dense_q // 10000, 2)
    val_f[:, :, 2] = ord(".")
    val_f[:, :, 3:7] = digits(dense_q % 10000, 4)
    val_f[:, :, 7] = sp
    val_f[:, -1, 7] = ord("\n")
    buf = np.concatenate([head.reshape(n, -1), key_f.reshape(n, -1), count,
                          val_f.reshape(n, -1)], axis=1)
    keep = np.concatenate([np.ones((n, tasks * 4), bool),
                           keep_key.reshape(n, -1),
                           np.ones((n, count.shape[1] + val_f[0].size), bool)],
                          axis=1)
    return buf[keep], np.cumsum(keep.sum(1))


def generate(config: dict, mix: dict, seed: int, out_dir: str) -> Data:
    """Write the cell's data under ``out_dir`` and return its chunks."""
    n = int(config["pass_instances"])
    cols, dense = int(config["n_sparse_slots"]), int(config["dense_dim"])
    tasks = len(config["label_slots"])
    n_chunks, per_file = int(mix["chunks"]), int(mix["files_per_chunk"])
    if n % (n_chunks * per_file):
        raise ValueError(f"{n} lines do not split into {n_chunks} chunks of "
                         f"{per_file} files")
    rng = seed_rng(seed)
    _, empty = columns(mix, cols)
    ranks = draw_ranks(rng, mix, n, cols)
    present = rng.random((n, cols)) >= empty[None, :]
    keys = np.where(present, token_keys(ranks), np.uint64(0))
    dense_q = draw_dense(rng, mix, n, dense)
    labels = draw_labels(rng, mix, ranks, present, dense_q, tasks)
    buf, ends = render(keys, dense_q, labels)
    ends = np.concatenate([[0], ends])
    os.makedirs(out_dir, exist_ok=True)
    chunks = []
    m = n // n_chunks
    for c in range(n_chunks):
        files = []
        for f in range(per_file):
            lo = c * m + f * (m // per_file)
            path = os.path.join(out_dir, f"chunk{c}-part{f:03d}.txt")
            buf[ends[lo]:ends[lo + m // per_file]].tofile(path)
            files.append(path)
        ck = keys[c * m:(c + 1) * m]
        census = np.unique(ck)
        chunks.append(Chunk(files, ck, census[census != 0]))
    return Data(chunks, labels)


def parse_lines(path: str, skip: int, n: int, cols: int, tasks: int) -> tuple:
    """Lines ``skip:skip + n`` of a file in plain Python, each slot's keys
    by its count: (keys uint64 [K], segments int64 [K] = line * cols +
    slot, dense float32 [n, D], labels float32 [n, tasks])."""
    keys, segs, dense, labels = [], [], [], []
    with open(path) as f:
        for i, line in enumerate(f):
            if i < skip:
                continue
            if i >= skip + n:
                break
            t = line.split()
            p, row = 0, i - skip
            lab = []
            for _ in range(tasks):
                lab.append(float(t[p + 1]))
                p += 1 + int(t[p])
            for c in range(cols):
                k = int(t[p])
                keys += [int(v) for v in t[p + 1:p + 1 + k]]
                segs += [row * cols + c] * k
                p += 1 + k
            d = int(t[p])
            dense.append([float(v) for v in t[p + 1:p + 1 + d]])
            labels.append(lab)
    return (np.array(keys, dtype=np.uint64), np.array(segs, dtype=np.int64),
            np.array(dense, dtype=np.float32).reshape(-1, len(dense[0])
                                                        if dense else 0),
            np.array(labels, dtype=np.float32).reshape(-1, tasks))
