"""Device time of the group -> baseline expansion a posterior evaluation
spends: the kernels of the program's bl.expand spans (the simulated
groups' visibilities gathered onto every data baseline, models/rime.py),
all phases, over the evaluations of the profiled steps
(bench_port/spans.py's rule). Layer: baseline expansion."""
from bench_port import spans

spans.install()


def read(t):
    return spans.device_ms_per_eval(t, ["bl.expand"])
