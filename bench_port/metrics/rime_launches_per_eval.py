"""Calls of the two RIME kernels a posterior evaluation makes: the
program's counters rime_cuda.launches and rime_cuda.dtau_launches over
the window, over LogProb.closure_eval's evaluations. Layer: RIME
dispatch (ops/rime_kernel.py -> ops/rime_cuda.py)."""


def read(t):
    if not t.evals:
        return None
    return (t.launches + t.dtau_launches) / t.evals
