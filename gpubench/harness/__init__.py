"""The benchmark's general code: it finds every configuration, traffic mix,
metric reader and limit file by the name ``BENCHMARK.json`` gives it."""
