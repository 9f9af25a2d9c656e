"""rime_dtau's share of its roofline: the sum over the window's calls of
bayeslim_tpu_torch.ops.rime_cuda.rime_dtau of each call's least time
(counting.dtau_bound_ms of its shapes: ct (R, N), ps (R, K), real or
complex), over the sum of its CUDA-event time. Layer: kernels
(csrc/rime_dtau.cu)."""
from bench_port.counting import dtau_bound_ms


def _rule(args, kwargs):
    ps, tauT = args[1], args[2]
    return dtau_bound_ms(ps.shape[0], ps.shape[1], tauT.shape[1],
                         not ps.is_complex())


TIMES = {"rime_dtau": ("bayeslim_tpu_torch.ops.rime_cuda", "rime_dtau",
                       _rule)}


def read(t):
    calls, ms, bound = t.timed["rime_dtau"]
    return 100.0 * bound / ms if calls and ms > 0 else None
