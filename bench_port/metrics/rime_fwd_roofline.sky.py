"""rime_fwd_roofline in the cells that report steps_per_s (BENCHMARK.json splits a
quantity by the end-to-end metric it moves): the same reader."""
from bench_port.metrics.rime_fwd_roofline import TIMES, read  # noqa: F401
