"""User-side instance formatter for slot data (reference:
paddlebox_tpu/data/data_generator.py): a subclass yields
``[(slot_name, [values]), ...]`` per instance, and the generator formats the
text lines the parser reads.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, TextIO, Tuple

from paddlebox_tpu_torch.config import DataFeedConfig

Instance = Sequence[Tuple[str, Sequence]]


def format_instance(
    conf: DataFeedConfig,
    instance: Instance,
    ins_id: Optional[str] = None,
    logkey: Optional[Tuple[int, int, int]] = None,
) -> str:
    """Format one instance as a canonical slot text line (all config slots, in
    order; missing slots emit count 0)."""
    by_name = {name: list(vals) for name, vals in instance}
    parts = []
    if conf.parse_ins_id:
        parts.append(ins_id or "0")
    if conf.parse_logkey:
        sid, rank, cmatch = logkey or (0, 0, 0)
        parts.append(f"{sid}:{rank}:{cmatch}")
    for slot in conf.slots:
        vals = by_name.get(slot.name, [])
        parts.append(str(len(vals)))
        parts.extend(str(v) for v in vals)
    return " ".join(parts)


class DataGenerator:
    """Subclass and override generate_sample(); then run_from_stdin()/write()."""

    def __init__(self, conf: DataFeedConfig):
        self.conf = conf

    def generate_sample(self, line: Optional[str]) -> Iterable[Instance]:
        raise NotImplementedError

    def write(self, out: TextIO, lines: Optional[Iterable[str]] = None) -> int:
        n = 0
        src = lines if lines is not None else [None]
        for line in src:
            for ins in self.generate_sample(line):
                out.write(format_instance(self.conf, ins) + "\n")
                n += 1
        return n
