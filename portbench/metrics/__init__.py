"""Per-metric readers, one file per metric name in ``BENCHMARK.json``."""
