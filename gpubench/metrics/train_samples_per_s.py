"""Instances trained in the steps of the window over its wall seconds;
the window runs whole pass cycles, so every pass boundary in it counts."""


def read(ctx):
    win = ctx["window"]
    return win["samples"] / win["seconds"]
