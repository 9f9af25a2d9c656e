"""Device time of the sky model a posterior evaluation spends: the kernels
of the program's bl.sky spans (the sky and its response, the a_lm -> map
Ylm products among them, called from RIME.forward in models/rime.py),
all phases, over the evaluations of the profiled steps
(bench_port/spans.py's rule). Layer: sky model."""
from bench_port import spans

spans.install()


def read(t):
    return spans.device_ms_per_eval(t, ["bl.sky"])
