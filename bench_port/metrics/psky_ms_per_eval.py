"""Device time of the per-time sky and beam passes a posterior
evaluation spends: the kernels of the program's bl.psky spans (per time:
the FOV cut, the beam, the sky into model-pair space; make_psky in
models/rime.py), all phases, over the evaluations of the profiled steps
(bench_port/spans.py's rule). Layer: per-time sky and beam."""
from bench_port import spans

spans.install()


def read(t):
    return spans.device_ms_per_eval(t, ["bl.psky"])
