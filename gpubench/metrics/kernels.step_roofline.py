"""The step's two sparse kernels, ``pull_rows`` and ``scatter_add_rows``:
the sum of their bytes-once time bounds at the HBM peak over the sum of
their device time in the traced passes.

Bytes come from each launch's arguments as the benchmark works them out
from its own data (counts/sparse_kernels.py): the key buffer, the row
width, the distinct rows of each batch.  Time is the device time of the
kernels inside the ranges the trace puts around the port's two entries
(harness/trace.py); where no range holds device time, the kernels named
by SYMBOLS.  The two are summed because one alone can pass its bound
when its rows sit in the 50 MB L2."""

from counts import peaks, sparse_kernels

SYMBOLS = ("pull_rows_kernel", "pull_rows_scalar_kernel",
           "scatter_add_rows_kernel", "scatter_add_scalar_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    dev = sum(tr["ranges"].get(f"gpubench.{k}", 0.0)
              for k in ("pull_rows", "scatter_add_rows"))
    if dev <= 0.0:
        dev = sum(s for name, s in tr["kernels"].items()
                  if any(name.startswith(sym) for sym in SYMBOLS))
    if dev <= 0.0:
        return None
    cfg = ctx["config"]
    b, cap = int(cfg["batch_size"]), int(cfg["batch_key_capacity"])
    w = int(cfg["cvm_offset"]) + int(cfg["embedding_dim"])
    total = 0
    for p in tr["passes"]:
        chunk, rows, n_live = ctx["window"]["pass_info"][p]
        ck = ctx["data"].chunks[chunk]
        for lo in range(0, ck.keys.shape[0], b):
            pull, push = sparse_kernels.step_bytes(
                ck.batch_keys(lo, lo + b), cap, w, n_live, rows)
            total += pull + push
    return 100.0 * total / peaks.HBM_BYTES_PER_S / dev
