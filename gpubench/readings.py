"""The readings a cell's correctness limits are set from: the numbers the
check compares (harness/check.py), on many seeds in one process, for the
program as the configuration states it and for the program broken in one
way, at the cell's own size and without the window.

    python3 gpubench/readings.py --workload <cell> --seeds 1,2,3 \
        [--fault bf16|half_batch|frozen_step|cold_hits] [--out readings.jsonl]

``bf16`` is the control: the port's own bfloat16 tower
(``compute_dtype``), the precision below the configuration's float32.
``half_batch`` leaves out half of every batch and takes the mean over the
rest; ``frozen_step`` returns every step's state unchanged;
``cold_hits`` fills the cache's hits with zero rows.  Each seed
prints one JSON line: the cell, the fault, the seed, the numbers and the
readings beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))


def reading(cell_name: str, seed: int, fault: str = "", device: str = "cuda",
            overrides=None) -> dict:
    """The compared numbers of one seed, the program's set-up and the
    check's two passes then the reference, as a run makes them."""
    import torch

    from harness import check, spec, traffic, world

    cell = spec.cell(spec.benchmark(), cell_name)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for key, value in (overrides or {}).items():
        (mix if key in mix else cfg)[key] = value
    tmp = tempfile.mkdtemp(prefix="gpubench-readings-")
    try:
        t0 = time.perf_counter()
        data = traffic.generate(cfg, mix, seed, tmp)
        w = world.World(cfg, data, seed, device, (fault,) if fault else ())
        prog = w.check_steps()
        prog.pop("read_s")
        w.close()
        del w.table, w.trainer, w.model, w.datasets
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ref = check.run_reference(w, prog)
        nums, extra = check.numbers(w, prog, ref)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"cell": cell_name, "fault": fault or "none", "seed": seed,
            "seconds": time.perf_counter() - t0, **nums, "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="",
                    choices=("", "bf16", "half_batch", "frozen_step",
                             "cold_hits"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        line = json.dumps(reading(args.workload, int(s), args.fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
