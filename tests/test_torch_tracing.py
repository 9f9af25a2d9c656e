"""
The port's layer spans (utils.logging.span) on the CPU, at the
benchmark's small sizes (bench_port/configs: hex-2, nside 8, 8 channels,
2 times): nothing is recorded without a profiler; under one, an
evaluation's bl.* ranges nest as the program's layers do, a trained
sky's checkpointed bl.psky runs again under a backward node, and the
loss and gradients are bit-equal with the profiler on and off;
trace_profile's Chrome trace holds the ranges.
"""
import importlib.util
import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bayeslim_tpu_torch as bt
from bayeslim_tpu_torch.utils import logging as tlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NTIME = 2
INNER = ("bl.sky", "bl.psky", "bl.rime", "bl.expand", "bl.jones",
         "bl.chisq")


def _posterior(name, seed=7):
    """The benchmark configuration's posterior at a small size, against
    zero data of unit inverse variance."""
    with open(os.path.join(ROOT, "bench_port", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(hex=2, nside=8, nfreq=8, ntime=NTIME)
    if "lmax" in cfg:
        cfg["lmax"] = 3 * cfg["nside"] - 1
    spec = importlib.util.spec_from_file_location(
        f"_tracing_{name}", os.path.join(ROOT, "bench_port", "configs",
                                         name + ".py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    dev = torch.device("cpu")
    inp = maker.inputs(cfg, seed, dev)

    def target(bls):
        d = torch.zeros(1, 1, len(bls), cfg["ntime"], cfg["nfreq"],
                        dtype=torch.complex64)
        return d, torch.ones(d.shape)
    prob, _ = maker.build(bt, cfg, inp, target, dev)
    return prob


@pytest.fixture(scope="module")
def hex_prob():
    return _posterior("hex11")


@pytest.fixture(scope="module")
def alm_prob():
    return _posterior("alm64")


def _ranges(prof):
    return [e for e in prof.events() if e.name.startswith("bl.")]


def _outer_span(e):
    """The nearest bl.* range above e on its cpu_parent chain."""
    q = e.cpu_parent
    while q is not None and not q.name.startswith("bl."):
        q = q.cpu_parent
    return q


def _under_node(e):
    """Whether an autograd node (a backward: a sequence number and a
    forward thread) is above e on its chain."""
    q = e.cpu_parent
    while q is not None:
        if q.sequence_nr >= 0 and q.fwd_thread:
            return True
        q = q.cpu_parent
    return False


@pytest.mark.parametrize("name", ["hex11", "alm64"])
def test_no_profiler_records_nothing(monkeypatch, name, request):
    """Without a profiler a whole evaluation enters no range: span hands
    out one shared null context a name."""
    prob = request.getfixturevalue("hex_prob" if name == "hex11"
                                   else "alm_prob")
    calls = []
    fast = torch._C._profiler._RecordFunctionFast
    init = torch.autograd.profiler.record_function.__init__
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda *a: calls.append(a) or fast(*a))
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        lambda self, *a, **k: calls.append(a)
                        or init(self, *a, **k))
    assert not torch.autograd._profiler_enabled()
    prob.value_and_grad()
    assert calls == []
    assert tlog.span("bl.psky") is tlog.span("bl.psky")


def test_spans_nest_as_the_layers(hex_prob):
    """One evaluation under a CPU profiler: one bl.eval, ntime bl.psky and
    bl.rime, one of each other layer, all directly inside bl.eval."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hex_prob.value_and_grad()
    rs = _ranges(prof)
    count = {n: sum(e.name == n for e in rs) for n in ("bl.eval",) + INNER}
    assert count == {"bl.eval": 1, "bl.sky": 1, "bl.psky": NTIME,
                     "bl.rime": NTIME, "bl.expand": 1, "bl.jones": 1,
                     "bl.chisq": 1}
    (ev,) = [e for e in rs if e.name == "bl.eval"]
    for e in rs:
        if e.name != "bl.eval":
            assert _outer_span(e) is ev
            assert ev.time_range.start <= e.time_range.start \
                <= e.time_range.end <= ev.time_range.end
    # the ranges of one time follow each other: psky, then its rime
    ps = sorted((e for e in rs if e.name in ("bl.psky", "bl.rime")),
                key=lambda e: e.time_range.start)
    assert [e.name for e in ps] == ["bl.psky", "bl.rime"] * NTIME


def test_recompute_under_backward_node(alm_prob):
    """A trained sky and beam: each time's checkpointed bl.psky runs once
    forward inside bl.eval and once again under a backward node; an
    optimizer step's bl.opt holds the evaluation."""
    trainer = bt.Trainer(alm_prob, lr=1e-3, verbose=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step()
    rs = _ranges(prof)
    (opt,) = [e for e in rs if e.name == "bl.opt"]
    (ev,) = [e for e in rs if e.name == "bl.eval"]
    assert _outer_span(ev) is opt
    psky = [e for e in rs if e.name == "bl.psky"]
    fwd = [e for e in psky if not _under_node(e)]
    again = [e for e in psky if _under_node(e)]
    assert len(fwd) == len(again) == NTIME
    assert all(_outer_span(e) is ev for e in fwd)
    ends = max(e.time_range.end for e in fwd)
    assert all(e.time_range.start > ends for e in again)


@pytest.mark.parametrize("name", ["hex11", "alm64"])
def test_profiled_evaluation_bit_equal(name, request):
    prob = request.getfixturevalue("hex_prob" if name == "hex11"
                                   else "alm_prob")
    v0, g0 = prob.value_and_grad()
    with profile(activities=[ProfilerActivity.CPU]):
        v1, g1 = prob.value_and_grad()
    assert torch.equal(v0, v1)
    assert list(g0) == list(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_trace_profile_holds_spans(tmp_path, hex_prob):
    d = str(tmp_path / "prof")
    with tlog.trace_profile(d):
        hex_prob.value_and_grad()
    with open(os.path.join(d, "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"bl.eval", *INNER} <= names


def test_span_decorates_at_call_time():
    """A function decorated while nothing profiles records its span under
    a later profiler, and one decorated under a profiler records none
    after it; the span's value passes through."""
    def f(x):
        return x + 1
    plain = tlog.span("bl.test")(f)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert plain(1) == 2
        inside = tlog.span("bl.test2")(f)
        assert inside(1) == 2
    assert [e.name for e in prof.events() if e.name.startswith("bl.")] \
        == ["bl.test", "bl.test2"]
    assert inside(2) == 3 and plain.__wrapped__ is f
