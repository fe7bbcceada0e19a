"""The benchmark's span around each ``next()`` of the batch iterator
handed to ``Trainer.train_steps`` (batch assembly on the producer
thread), ms a step of the window."""


def read(ctx):
    seconds, count = ctx["window"]["batch"]
    return 1e3 * seconds / count if count else None
