"""100 x (1 - the union of the card's kernel, copy and memset intervals
over the profiled wall time), from the benchmark's own profiler over
whole passes of the window at the program's default settings."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
