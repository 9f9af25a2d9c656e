"""Device time a posterior evaluation spends outside the timed layers:
the kernels' time in the profiled steps (torch.profiler), less the
CUDA-event time those steps gave the entry functions below, over the
evaluations of the profiled steps. What is left is PyTorch's own eager
kernels: the sky and beam, the per-baseline expansion and gains, the
chi^2, the optimizer. Layer: eager passes (models/rime.py,
models/calibration.py, inference/prob.py)."""
from bench_port.metrics import rime_dtau_roofline, rime_fwd_roofline, \
    ylm_roofline

TIMES = {**rime_fwd_roofline.TIMES, **rime_dtau_roofline.TIMES,
         **ylm_roofline.TIMES}


def read(t):
    if t.prof is None or not t.prof_evals:
        return None
    timed = sum(t.timed_prof[k][1] for k in TIMES)
    return (t.prof["kernel_s"] * 1e3 - timed) / t.prof_evals
