"""The Ylm products' share of their roofline: the sum over the window's
calls of bayeslim_tpu_torch.ops.sph_harm._ylm_mm (a_lm -> map, a (..., M,
K) against Y (K, N)) and _ylm_mm_grad (the a_lm gradient, g (M, N) against
Y) of the least time of the work an a_lm sky with real_output needs
(counting.ylm_bound_ms), over the sum of their CUDA-event time. Layer:
harmonic sky (ops/sph_harm.py)."""
from bench_port.counting import ylm_bound_ms


def _rule(args, kwargs):
    """a (..., K) or g (..., N): the rows are its leading dimensions."""
    Y = args[1]
    return ylm_bound_ms(args[0].numel() // args[0].shape[-1], Y.shape[0],
                        Y.shape[1])


TIMES = {"ylm_mm": ("bayeslim_tpu_torch.ops.sph_harm", "_ylm_mm", _rule),
         "ylm_mm_grad": ("bayeslim_tpu_torch.ops.sph_harm", "_ylm_mm_grad",
                         _rule)}


def read(t):
    calls = sum(t.timed[k][0] for k in TIMES)
    ms = sum(t.timed[k][1] for k in TIMES)
    bound = sum(t.timed[k][2] for k in TIMES)
    return 100.0 * bound / ms if calls and ms > 0 else None
