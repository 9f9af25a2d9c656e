"""Device time of the chi^2 a posterior evaluation spends: the kernels of
the program's bl.chisq spans (the residual, the inverse covariance and
the sum in LogProb.forward_chisq, inference/prob.py), all phases, over
the evaluations of the profiled steps (bench_port/spans.py's rule).
Layer: likelihood."""
from bench_port import spans

spans.install()


def read(t):
    return spans.device_ms_per_eval(t, ["bl.chisq"])
