"""The window's delta of ``trainer.stage_seconds{stage=plan}`` (the
trainer's always-on StatsProfiler), ms a step of the window."""


def read(ctx):
    win = ctx["window"]
    seconds, count = win["stages"]["plan"]
    return 1e3 * seconds / win["steps"] if count and win["steps"] else None
