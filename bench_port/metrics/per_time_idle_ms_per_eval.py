"""Idle device time of the per-time loop a posterior evaluation spends:
the idle gaps of the profiled steps that bench_port/spans.py's rule puts
to the program's bl.psky or bl.rime spans (the sky and beam passes and
the RIME dispatch, once a time, in models/rime.py), all phases, over the
evaluations of the profiled steps. Layer: per-time loop."""
from bench_port import spans

spans.install()


def read(t):
    return spans.idle_ms_per_eval(t, ["bl.psky", "bl.rime"])
