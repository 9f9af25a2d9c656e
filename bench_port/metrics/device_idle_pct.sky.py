"""device_idle_pct in the cells that report steps_per_s (BENCHMARK.json splits a
quantity by the end-to-end metric it moves): the same reader."""
from bench_port.metrics.device_idle_pct import read  # noqa: F401
