"""The whole step's share of the FP32 peak: the FP32 work the window's
posterior evaluations need (counting.eval_flops of the configuration's
sizes and trained leaves, not the calls the program makes), over the
window's seconds at counting.PEAK_FP32. Layer: whole step."""
from bench_port.counting import PEAK_FP32


def read(t):
    if not t.evals or t.window_s <= 0:
        return None
    return 100.0 * t.flops_per_eval * t.evals / (t.window_s * PEAK_FP32)
