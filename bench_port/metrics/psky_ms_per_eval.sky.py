"""psky_ms_per_eval in the cells that report steps_per_s (BENCHMARK.json splits a
quantity by the end-to-end metric it moves): the same reader."""
from bench_port.metrics.psky_ms_per_eval import read  # noqa: F401
