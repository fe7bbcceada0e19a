"""The window's delta of ``trainer.stage_seconds{stage=step}``: the step
thread's host time in the step (dispatch, and waits the host makes
there), not device time; ms a step of the window."""


def read(ctx):
    win = ctx["window"]
    seconds, count = win["stages"]["step"]
    return 1e3 * seconds / win["steps"] if count and win["steps"] else None
