"""rime_fwd's share of its roofline: the sum over the window's calls of
bayeslim_tpu_torch.ops.rime_cuda.rime_fwd of each call's least time
(counting.kernel_bound_ms of its shapes: ps (R, K), tauT (K, N), real or
complex ps, one or two output planes), over the sum of its CUDA-event
time. Layer: kernels (csrc/rime_fwd.cu)."""
from bench_port.counting import kernel_bound_ms


def _rule(args, kwargs):
    ps, tauT = args[0], args[1]
    out_imag = kwargs.get("out_imag", args[6] if len(args) > 6 else True)
    return kernel_bound_ms(ps.shape[0], ps.shape[1], tauT.shape[1],
                           not ps.is_complex(), out_imag)


TIMES = {"rime_fwd": ("bayeslim_tpu_torch.ops.rime_cuda", "rime_fwd", _rule)}


def read(t):
    calls, ms, bound = t.timed["rime_fwd"]
    return 100.0 * bound / ms if calls and ms > 0 else None
