"""Share of the profiled steps' wall in which no kernel ran on the
device: 1 - the union of the kernels' intervals (torch.profiler, spin
markers launched first and left out) over the wall of the steps.
Layer: device."""


def read(t):
    if t.prof is None or t.prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t.prof["busy_s"] / t.prof["wall_s"])
