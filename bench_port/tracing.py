"""
What a ``--trace 1`` run records, from the benchmark's side of the
program's entry points (no span or counter inside the program is read
but its own launch and evaluation counters):

- ``Timed``: CUDA events around every call of the entry functions that
  the cell's per-layer metrics name (a metric file's ``TIMES``: (module,
  function, work rule)). Each call's events and the bound its rule gives
  for its arguments are kept; whether the call fell in the profiled
  steps too.
- ``Profiled``: torch.profiler over a few steps inside the window. Past
  the first seconds of a process the profiler drops the first kernels
  it is started on (up to 63 seen), so MARKS spin kernels are launched
  first; the count it kept says the drop ended on them. From the trace:
  each kernel's interval, the union of the intervals over the wall of
  the profiled steps (busy and idle), the kernels that took most time,
  and the longest idle gaps, each named by the innermost host operation
  under way at the gap's middle.
"""
from __future__ import annotations

import importlib

import torch

MARKS = 1024
LABEL = "bench_port.profiled_steps"
NAME = 160          # a kernel's name in the breakdown, at most


class Timed:
    def __init__(self, specs):
        """specs: {name: (module, function, rule)}; rule(args, kwargs) ->
        the call's least time [ms]."""
        self.calls = {name: [] for name in specs}
        self.profiling = False
        self._undo = []
        for name, (mod, fn, rule) in specs.items():
            m = importlib.import_module(mod)
            orig = getattr(m, fn)
            setattr(m, fn, self._wrap(name, orig, rule))
            self._undo.append((m, fn, orig))

    def _wrap(self, name, orig, rule):
        calls = self.calls[name]

        def timed(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(*args, **kwargs)
            b.record()
            calls.append((a, b, rule(args, kwargs), self.profiling))
            return out
        return timed

    def restore(self):
        for m, fn, orig in self._undo:
            setattr(m, fn, orig)

    def totals(self, profiled_only=False):
        """{name: (calls, event ms, bound ms)}, after a synchronize."""
        out = {}
        for name, calls in self.calls.items():
            sel = [c for c in calls if c[3] or not profiled_only]
            out[name] = (len(sel), sum(a.elapsed_time(b) for a, b, _, _ in sel),
                         sum(c[2] for c in sel))
        return out


def warm_profiler():
    """One short profile at set-up, so that the profiler's own start-up
    falls outside the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(100)
        torch.cuda.synchronize()


class Profiled:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.label = None

    def start(self):
        self.prof.__enter__()
        for _ in range(MARKS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        self.label = torch.profiler.record_function(LABEL)
        self.label.__enter__()

    def stop(self):
        torch.cuda.synchronize()
        self.label.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, top=10):
        """busy and wall seconds of the profiled steps, kernel time by
        name, marks kept, the longest idle gaps by host operation."""
        from torch.autograd import DeviceType
        evs = self.prof.events()
        span = [e for e in evs if e.name == LABEL
                and e.device_type == DeviceType.CPU]
        t0, t1 = span[0].time_range.start, span[0].time_range.end
        kern, marks, by_name = [], 0, {}
        for e in evs:
            if e.device_type != DeviceType.CUDA or e.name == LABEL:
                continue
            if "spin_kernel" in e.name:
                marks += 1
                continue
            s, f = e.time_range.start, e.time_range.end
            if f <= t0 or s >= t1:
                continue
            kern.append((s, f))
            by_name[e.name] = by_name.get(e.name, 0.0) + (f - s) * 1e-6
        kern.sort()
        busy, gaps, end = 0.0, [], t0
        for s, f in kern:
            s, f = max(s, t0), min(f, t1)
            if s > end:
                gaps.append((end, s))
            busy += max(0.0, f - max(s, end))
            end = max(end, f)
        if end < t1:
            gaps.append((end, t1))
        host = [e for e in evs if e.device_type == DeviceType.CPU
                and e.name != LABEL]
        named = []
        for s, f in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (s + f) / 2
            under = [e for e in host
                     if e.time_range.start <= mid <= e.time_range.end]
            inner = min(under, key=lambda e: e.time_range.elapsed_us(),
                        default=None)
            named.append([inner.name if inner else "no host operation",
                          (f - s) * 1e-6])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        ops = [(k if len(k) <= NAME else k[:NAME - 3] + "...", v)
               for k, v in ops]
        return dict(busy_s=busy * 1e-6, wall_s=(t1 - t0) * 1e-6,
                    kernel_s=sum(by_name.values()), marks=marks,
                    device_ops=[[k, v] for k, v in ops], idle_gaps=named)
