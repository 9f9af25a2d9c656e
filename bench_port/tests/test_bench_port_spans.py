"""bench_port/spans.py's rule on a CPU profile of a small checkpointed
chain, the ATen operations standing in for kernels: forward, backward by
sequence number, recompute and outside; the table's idle gaps; the span
metrics' readers on synthetic runs, and a run with --trace 0, which
prints the end-to-end metrics alone, as before."""
import io
import json
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils.checkpoint import checkpoint

from bayeslim_tpu_torch.utils.logging import span
from bench_port import harness, run, spans, tracing
from conftest import CELLS

SEED = 2 ** 31 + 23


def _psky(x):
    with span("bl.psky"):
        return (x.sin() * x).exp()


@pytest.fixture(scope="module")
def profiled():
    """The profile of one evaluation: a checkpointed bl.psky, a bl.chisq,
    the backward inside bl.eval, and an operation outside every span."""
    x = torch.randn(64, dtype=torch.float64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.LABEL):
            with span("bl.eval"):
                y = checkpoint(_psky, x, use_reentrant=False)
                with span("bl.chisq"):
                    loss = (y * y).sum()
                torch.autograd.grad(loss, [x])
            with torch.no_grad():
                x.cos()
    return prof


@pytest.fixture(scope="module")
def chain(profiled):
    return [e for e in profiled.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def _named(events, name):
    return [e for e in events if e.name == name]


def test_rule(chain):
    layers = spans.Layers(chain)
    sin_f, sin_r = _named(chain, "aten::sin")
    assert layers.of(sin_f)[:2] == ("bl.psky", "fwd")
    assert layers.of(sin_r)[:2] == ("bl.psky", "recompute")
    # the range found is the one the operation ran in
    assert layers.of(sin_f)[2] is sin_f.cpu_parent
    # SinBackward0's cos: the backward of psky's forward sin
    (cos_b, cos_out) = _named(chain, "aten::cos")
    assert layers.of(cos_b)[:2] == ("bl.psky", "bwd")
    assert layers.of(cos_out)[:2] == ("outside", "fwd")
    # the chi^2's square and sum, and their backward
    sq = [e for e in _named(chain, "aten::mul")
          if spans.Layers(chain).of(e)[0] == "bl.chisq"]
    assert {layers.of(e)[1] for e in sq} == {"fwd", "bwd"}
    (ps_f, ps_r) = _named(chain, "bl.psky")
    assert layers.of(ps_r)[:2] == ("bl.psky", "recompute")
    assert layers.of(ps_f)[:2] == ("bl.psky", "fwd")


def test_table_of_stand_in_kernels(chain):
    """Leaf operations as kernels: every one is counted once, in the
    layer and phase of the rule; ranges and gaps fill the other columns."""
    layers = spans.Layers(chain)
    leaves = [e for e in chain if not e.cpu_children
              and not e.name.startswith("bl.") and e.name != tracing.LABEL]
    kernels = [(e.time_range.start, e.time_range.end, e) for e in leaves]
    ranges = [e for e in chain if e.name.startswith("bl.")]
    sin_f, sin_r = _named(chain, "aten::sin")
    (cos_b, _) = _named(chain, "aten::cos")
    gaps = [(e.time_range.start, e.time_range.end)
            for e in (sin_f, sin_r, cos_b)]
    tab = spans.tabulate(layers, kernels, ranges, gaps, chain)
    rows = tab["layers"]
    total = sum((f - s) * 1e-3 for s, f, _ in kernels)
    assert sum(r[p] for r in rows.values() for p in spans.PHASES) == \
        pytest.approx(total, rel=1e-12)
    ps = rows["bl.psky"]
    assert ps["fwd"] > 0 and ps["recompute"] > 0 and ps["bwd"] > 0
    assert rows["bl.chisq"]["fwd"] > 0 and rows["bl.chisq"]["bwd"] > 0
    assert rows["bl.chisq"]["recompute"] == 0
    assert rows["outside"]["fwd"] > 0
    assert ps["calls"] == 2 and rows["bl.eval"]["calls"] == 1
    ev = _named(chain, "bl.eval")[0].time_range.elapsed_us() * 1e-3
    # the ranges whose nearest bl.* range above is bl.eval: both bl.psky
    # (the recomputed one under the backward node) and bl.chisq
    inside = sum(r.time_range.elapsed_us() * 1e-3 for r in ranges
                 if r.name != "bl.eval")
    assert rows["bl.eval"]["host_ms"] == pytest.approx(ev)
    assert rows["bl.eval"]["self_ms"] == pytest.approx(ev - inside)
    # each gap lies over one leaf operation: put to its layer and phase
    # (its middle may fall in an operation inside it: the same layer)
    named = {(g[1], g[2]) for g in tab["longest_gaps"]}
    assert named == {("bl.psky", "fwd"), ("bl.psky", "recompute"),
                     ("bl.psky", "bwd")}
    assert ps["idle_ms"] == pytest.approx(sum(
        (f - s) * 1e-3 for s, f in gaps))
    assert tab["early_kernels"] == 0


def test_install_adds_spans(monkeypatch, profiled, capsys):
    """summary gains the key spans (and prints it on one line) and keeps
    the rest; installing twice wraps once. On the CPU the profile has no
    kernel: the whole window is one gap, under the last operation."""
    monkeypatch.setattr(tracing.Profiled, "summary",
                        lambda self, top=10: dict(kernel_s=0.0))
    spans.install()
    spans.install()
    out = tracing.Profiled.summary(SimpleNamespace(prof=profiled))
    assert out["kernel_s"] == 0.0 and set(out) == {"kernel_s", "spans"}
    rows = out["spans"]["layers"]
    assert rows["bl.psky"]["calls"] == 2 and rows["bl.eval"]["calls"] == 1
    assert all(r[p] == 0 for r in rows.values() for p in spans.PHASES)
    assert len(out["spans"]["longest_gaps"]) == 1
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and json.loads(err[0][len("spans: "):]) == \
        json.loads(json.dumps(dict(out["spans"], kernel_ms=0.0)))


def _run_row(**over):
    row = dict(fwd=0.0, recompute=0.0, bwd=0.0, host_ms=0.0, self_ms=0.0,
               calls=0, idle_ms=0.0)
    row.update(over)
    return row


def _metric(name):
    return harness.load_module(f"bench_port.metrics.{name}",
                               f"{harness.__file__[:-10]}metrics/{name}.py")


READERS = {"psky_ms_per_eval": 2.0 + 1.0 + 0.5,
           "psky_ms_per_eval.sky": 3.5,
           "expand_ms_per_eval": 4.0,
           "jones_ms_per_eval": 6.0,
           "chisq_ms_per_eval": 0.5,
           "sky_ms_per_eval": 10.0,
           "per_time_idle_ms_per_eval": 1.5 + 0.25,
           "unspanned_ms_per_eval": 0.75,
           "unspanned_ms_per_eval.sky": 0.75}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers(name):
    rows = {"bl.psky": _run_row(fwd=4.0, recompute=2.0, bwd=1.0,
                                idle_ms=3.0),
            "bl.rime": _run_row(fwd=8.0, idle_ms=0.5),
            "bl.expand": _run_row(fwd=6.0, bwd=2.0),
            "bl.jones": _run_row(fwd=8.0, bwd=4.0),
            "bl.chisq": _run_row(fwd=1.0),
            "bl.sky": _run_row(fwd=12.0, bwd=8.0),
            "outside": _run_row(fwd=1.0, bwd=0.5, idle_ms=9.0)}
    t = SimpleNamespace(prof={"spans": {"layers": rows}}, prof_evals=2)
    m = _metric(name)
    assert m.read(t) == pytest.approx(READERS[name])
    # no profile (an untraced or CPU run), no evaluation, no table (an
    # earlier summary), a program without spans: nothing, and no error
    assert m.read(SimpleNamespace(prof=None, prof_evals=0)) is None
    assert m.read(SimpleNamespace(prof={"spans": {"layers": rows}},
                                  prof_evals=0)) is None
    assert m.read(SimpleNamespace(prof={"busy_s": 1.0},
                                  prof_evals=2)) is None
    bare = {"outside": _run_row(fwd=5.0, idle_ms=1.0)}
    assert m.read(SimpleNamespace(prof={"spans": {"layers": bare}},
                                  prof_evals=2)) is None
    # a program with spans that reach every kernel: unspanned reads 0
    if name.startswith("unspanned"):
        full = {k: v for k, v in rows.items() if k != "outside"}
        assert m.read(SimpleNamespace(prof={"spans": {"layers": full}},
                                      prof_evals=2)) == 0.0


E2E = {"cal-lbfgs": {"setup_s", "vis_per_s", "peak_mem_gib"},
       "adam": {"setup_s", "steps_per_s", "peak_mem_gib"}}


@pytest.mark.parametrize("name, traffic", CELLS)
def test_untraced_line_unchanged(tiny_root, name, traffic):
    """--trace 0 prints the end-to-end metrics of the cell and nothing of
    the spans."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        res = harness.run_cell(tiny_root, f"tiny{name}.{traffic}", SEED,
                               0.5, 0, torch.device("cpu"), 0.0)
        assert run.report(*res) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line["metrics"]) == E2E[traffic]
    assert "spans:" not in err.getvalue()


def test_backward_goes_to_the_node_maker():
    """Operations that make no node record the number the next node will
    take: the backward goes to the operation that made it, not to an
    earlier one in another layer."""
    a, b = torch.randn(16), torch.randn(16)
    x = torch.randn(16, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("bl.psky"):
            c = (a * b).sin()           # no node: the next node's number
        with span("bl.rime"):
            z = x * c                   # the node those numbers name
        torch.autograd.grad(z.sum(), [x])
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    layers = spans.Layers(cpu)
    (mb,) = [e for e in cpu if e.name == "MulBackward0"]
    assert layers.of(mb)[:2] == ("bl.rime", "bwd")


def test_operations_by_correlation_id():
    """Every operation of the raw profile resolves to a CPU event of its
    name under way at its start; one that PyTorch's event list dropped
    (nested in one of its own name) to the one it was dropped into."""
    x = torch.randn(64, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("bl.chisq"):
            x.sum(0).abs().sum()
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    op = spans._operations(prof, cpu)
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    ids = {e.id for e in cpu}
    dropped = 0
    for k in res.events():
        e = op(k.correlation_id())
        start = (k.start_ns() - t0) * 1e-3
        assert e is not None and e.name == k.name()
        assert e.time_range.start <= start <= e.time_range.end
        dropped += k.correlation_id() not in ids
    assert dropped > 0
    assert op(10 ** 9) is None
