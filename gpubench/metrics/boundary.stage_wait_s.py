"""``table.last_begin_breakdown["stage_wait_s"]`` summed over the window's
``begin_pass`` calls, over their count: the seconds a boundary waits for
the next pass's stage."""


def read(ctx):
    begins = ctx["window"]["begins"]
    waits = [b["stage_wait_s"] for b in begins if "stage_wait_s" in b]
    return sum(waits) / len(waits) if waits else None
