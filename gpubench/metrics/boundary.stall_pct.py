"""The share of the window's wall time inside ``begin_pass`` and
``end_pass``, each timed by the benchmark to a synchronize."""


def read(ctx):
    win = ctx["window"]
    return 100.0 * win["boundary_s"] / win["seconds"]
