"""Device time a posterior evaluation spends that reaches none of the
program's bl.* spans (bench_port/spans.py's rule: its layer 'outside'),
over the evaluations of the profiled steps: how much the spans leave
unnamed. Layer: outside the spans."""
from bench_port import spans

spans.install()


def read(t):
    return spans.outside_ms_per_eval(t)
