"""Device time of the gains a posterior evaluation spends: the kernels of
the program's bl.jones spans (JonesModel.forward, models/calibration.py:
the gains made and applied to every baseline), all phases, over the
evaluations of the profiled steps (bench_port/spans.py's rule). Layer:
gains."""
from bench_port import spans

spans.install()


def read(t):
    return spans.device_ms_per_eval(t, ["bl.jones"])
