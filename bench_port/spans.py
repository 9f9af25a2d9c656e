"""
The program's layers in a ``--trace 1`` run: the profiled steps' device
time, host time and idle time by the ``bl.*`` spans of the program
(bayeslim_tpu_torch.utils.logging.span), and by phase: ``fwd``, a
checkpoint's ``recompute`` inside the backward, and ``bwd``.

The rule, which every metric that reads the table takes as its
yardstick:

- A kernel (every device event the profiled steps' kernel time counts)
  belongs to the CPU operation that launched it: the operation whose
  correlation id is the kernel's linked correlation id in the profile
  (where PyTorch's event list dropped that operation, nested in one of
  its own name, the one it was dropped into).
- That operation's layer is the innermost ``bl.*`` range on its
  ``cpu_parent`` chain, the operation itself included.
- If an autograd node (a CPU event with a sequence number and a forward
  thread: the backward of one forward operation) comes first on the
  chain, the operation is phase ``bwd`` of the layer of the forward
  operation that made the node (the last to start of those on the
  node's forward thread with its sequence number), found by the same
  rule.
- A ``bl.*`` range with an autograd node above it on its chain is phase
  ``recompute`` of its layer (a checkpoint's forward run again inside the
  backward); every other range, phase ``fwd``.
- What reaches no layer, and the backward of a forward operation the
  profile does not hold, is ``outside``.
- Every idle gap of the profiled steps (not only the longest) is put to
  the layer and phase of the innermost (shortest) host event under way at
  the gap's middle, on any thread, by the same rule.

The table, ``{"layers": {layer: row}, "longest_gaps", "early_kernels"}``:
a row holds the device ms by phase (``fwd``, ``recompute``, ``bwd``),
``host_ms`` (the wall of the layer's ranges), ``self_ms`` (less the
``bl.*`` ranges directly inside them), ``calls`` (its ranges) and
``idle_ms``; ``longest_gaps`` the ten longest gaps as [ms, layer, phase,
innermost host event]; ``early_kernels`` the kernels put to a range that
start before the range does (0 where the host's and the device's clocks
agree).

``install()`` makes tracing.Profiled.summary return the table under one
more key, ``spans``, and print it on one line of standard error with the
summary's kernel time beside it (``kernel_ms``); the span metrics'
readers call it when they are loaded, so that the harness runs them as
it runs any metric file.
"""
from __future__ import annotations

import bisect
import json
import sys

PREFIX = "bl."
OUTSIDE = "outside"
PHASES = ("fwd", "recompute", "bwd")
TOP = 10


def _is_node(e):
    """An autograd node's event: the backward of the forward operation
    with its sequence number, on its forward thread."""
    return e.sequence_nr >= 0 and bool(getattr(e, "fwd_thread", 0))


class Layers:
    """Layer and phase of the CPU events of one profile, by the rule."""

    def __init__(self, events):
        self.forward = {}
        for e in events:
            if e.sequence_nr >= 0 and not _is_node(e):
                # an operation records the number the next node will
                # take, so every operation since the last node holds it:
                # the node's maker is the last of them to start (events
                # come sorted by start)
                self.forward[(e.thread, e.sequence_nr)] = e
        self._memo = {}

    def of(self, e):
        """(layer, phase, the bl.* range or None) of a CPU event."""
        path, res, q = [], None, e
        while q is not None:
            res = self._memo.get(id(q))
            if res is not None:
                break
            path.append(id(q))
            if q.name.startswith(PREFIX):
                above = q.cpu_parent
                phase = "fwd" if above is None or \
                    self.of(above)[1] == "fwd" else "recompute"
                res = (q.name, phase, q)
                break
            if _is_node(q):
                op = self.forward.get((q.fwd_thread, q.sequence_nr))
                res = (OUTSIDE if op is None else self.of(op)[0], "bwd",
                       None)
                break
            q = q.cpu_parent
        if res is None:
            res = (OUTSIDE, "fwd", None)
        for k in path:
            self._memo[k] = res
        return res


def _row(rows, layer):
    return rows.setdefault(layer, dict(fwd=0.0, recompute=0.0, bwd=0.0,
                                       host_ms=0.0, self_ms=0.0, calls=0,
                                       idle_ms=0.0))


def _innermost(host, mids):
    """For each time in mids, the shortest host event under way then
    (None where there is none)."""
    host = sorted(host, key=lambda e: e.time_range.start)
    out, active, j = {}, [], 0
    for mid in sorted(set(mids)):
        while j < len(host) and host[j].time_range.start <= mid:
            active.append(host[j])
            j += 1
        active = [e for e in active if e.time_range.end >= mid]
        out[mid] = min(active, key=lambda e: e.time_range.elapsed_us(),
                       default=None)
    return out


def tabulate(layers, kernels, ranges, gaps, host, top=TOP):
    """The table from kernels [(start, end, launching CPU op or None)],
    the bl.* ranges of the steps, the idle gaps [(start, end)] and the
    host events that may be under way in them (times in us)."""
    rows, early = {}, 0
    for s, f, op in kernels:
        layer, phase, rng = (OUTSIDE, "fwd", None) if op is None \
            else layers.of(op)
        _row(rows, layer)[phase] += (f - s) * 1e-3
        early += rng is not None and s < rng.time_range.start
    for r in ranges:
        ms = r.time_range.elapsed_us() * 1e-3
        row = _row(rows, r.name)
        row["calls"] += 1
        row["host_ms"] += ms
        row["self_ms"] += ms
        q = r.cpu_parent
        while q is not None and not q.name.startswith(PREFIX):
            q = q.cpu_parent
        if q is not None:
            _row(rows, q.name)["self_ms"] -= ms
    inner = _innermost(host, [(s + f) / 2 for s, f in gaps])
    named = []
    for s, f in gaps:
        e = inner[(s + f) / 2]
        layer, phase, _ = (OUTSIDE, "fwd", None) if e is None \
            else layers.of(e)
        _row(rows, layer)["idle_ms"] += (f - s) * 1e-3
        named.append([(f - s) * 1e-3, layer, phase,
                      "no host operation" if e is None else e.name])
    named.sort(key=lambda g: -g[0])
    return dict(layers=rows, longest_gaps=named[:top], early_kernels=early)


def _operations(prof, cpu):
    """correlation id -> the CPU event of that operation (None where the
    profile holds none). PyTorch's event list drops an operation nested
    in one of its own name (the dispatcher entering it again); such an
    id gives the operation it was dropped into."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    # the operations' own correlation ids; a CUDA API call made outside
    # every operation is not linked either, and its id counts the
    # device's calls, not the operations
    front = {}
    for k in res.events():
        if k.device_type() == DeviceType.CPU and \
                k.linked_correlation_id() == 0 and \
                not k.name().startswith("cu"):
            front.setdefault(k.correlation_id(),
                             (k.start_ns() - t0, k.name()))
    by_key = {(e.id, round(e.time_range.start * 1e3)): e for e in cpu}
    by_name = {}
    for e in cpu:
        by_name.setdefault(e.name, []).append(e)
    starts = {n: [e.time_range.start for e in es]
              for n, es in by_name.items()}

    def op(corr):
        hit = front.get(corr)
        if hit is None:
            return None
        ns, name = hit
        e = by_key.get((corr, ns))
        if e is None and name in by_name:
            i = bisect.bisect_right(starts[name], ns * 1e-3) - 1
            if i >= 0 and by_name[name][i].time_range.end >= ns * 1e-3:
                e = by_name[name][i]
        return e
    return op


def _launchers(prof, cpu):
    """{(correlation id, start ns) of each device event: the CPU event of
    the operation that launched it, or None}, from the raw profile's
    linked correlation ids (the FunctionEvents of some PyTorch versions
    do not keep them); times from the trace's start."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    op = _operations(prof, cpu)
    return {(k.correlation_id(), k.start_ns() - t0):
            op(k.linked_correlation_id())
            for k in res.events() if k.device_type() == DeviceType.CUDA}


def table(prof, label):
    """The table of a torch.profiler profile's steps: the CPU range named
    label, as bench_port.tracing.Profiled records it; kernels and gaps
    chosen as its summary chooses them."""
    from torch.autograd import DeviceType
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == label]
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    launcher = _launchers(prof, cpu)
    kernels = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name == label \
                or "spin_kernel" in e.name:
            continue
        s, f = e.time_range.start, e.time_range.end
        if f <= t0 or s >= t1:
            continue
        kernels.append((s, f, launcher.get((e.id, round(s * 1e3)))))
    kernels.sort(key=lambda k: k[0])
    gaps, end = [], t0
    for s, f, _ in kernels:
        s, f = max(s, t0), min(f, t1)
        if s > end:
            gaps.append((end, s))
        end = max(end, f)
    if end < t1:
        gaps.append((end, t1))
    ranges = [e for e in cpu if e.name.startswith(PREFIX)
              and t0 <= e.time_range.start <= t1]
    host = [e for e in cpu if e.name != label]
    return tabulate(Layers(cpu), kernels, ranges, gaps, host)


def install():
    """tracing.Profiled.summary returns one more key, ``spans`` (the
    table), and prints it on one line of standard error. Once a process;
    everything else it returns is as before."""
    from bench_port import tracing
    base = tracing.Profiled.summary
    if getattr(base, "with_spans", False):
        return

    def summary(self, top=10):
        out = base(self, top)
        out["spans"] = table(self.prof, tracing.LABEL)
        # beside the table, the kernel time the layers' rows sum to
        line = dict(out["spans"], kernel_ms=out["kernel_s"] * 1e3)
        print(f"spans: {json.dumps(line)}", file=sys.stderr, flush=True)
        return out
    summary.with_spans = True
    summary.__doc__ = base.__doc__
    tracing.Profiled.summary = summary


def device_ms_per_eval(t, layers):
    """Device ms of the given layers, all phases, per evaluation of the
    profiled steps; None where the run has no table or the program none
    of these spans."""
    rows = _rows(t)
    if rows is None or not any(k in rows for k in layers):
        return None
    return sum(rows[k][p] for k in layers if k in rows
               for p in PHASES) / t.prof_evals


def idle_ms_per_eval(t, layers):
    """Idle ms put to the given layers per evaluation; None as above."""
    rows = _rows(t)
    if rows is None or not any(k in rows for k in layers):
        return None
    return sum(rows[k]["idle_ms"] for k in layers if k in rows) \
        / t.prof_evals


def outside_ms_per_eval(t):
    """Device ms that reaches no bl.* layer per evaluation; None where the
    program has no span at all."""
    rows = _rows(t)
    if rows is None or not any(k.startswith(PREFIX) for k in rows):
        return None
    row = rows.get(OUTSIDE)
    return 0.0 if row is None else \
        sum(row[p] for p in PHASES) / t.prof_evals


def _rows(t):
    if t.prof is None or not t.prof_evals or "spans" not in t.prof:
        return None
    return t.prof["spans"]["layers"]
