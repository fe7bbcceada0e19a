"""The HBM cache's hits over hits and misses (``table.last_cache_hits`` and
``last_cache_misses``), each summed over the window's ``begin_pass``
calls: the numbers behind the ``cache.hit_rate`` gauge."""


def read(ctx):
    win = ctx["window"]
    total = win["hits"] + win["misses"]
    return 100.0 * win["hits"] / total if total else None
