"""Seconds from the harness's start to the window's: imports, CUDA start,
the kernels' load or build, data generation and load, the three check
steps and the warm-up pass (the check's own reads left out)."""


def read(ctx):
    return ctx["setup_s"]
