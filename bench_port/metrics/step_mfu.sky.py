"""step_mfu in the cells that report steps_per_s (BENCHMARK.json splits a
quantity by the end-to-end metric it moves): the same reader."""
from bench_port.metrics.step_mfu import read  # noqa: F401
