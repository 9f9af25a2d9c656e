"""
One run of one cell, driven by data: BENCHMARK.json's workload entry
names a configuration (configs/<name>.json with its maker
configs/<name>.py and its plain reference reference/<name>.py) and a
traffic mix (traffic/<name>.json, read by fit.py's one loop); the cell's
limits are cells/<workload>.json; each per-layer metric is
metrics/<name>.py. Adding a cell, a configuration or a metric adds
files and entries, and edits none.

The run: inputs from the seed; the target made by the reference at the
truth plus noise (left out of setup_s); the program's posterior built
and driven through the first three steps of a fit (set-up, and the
readings the reference is held to); the window; then, with the
program's state freed, the reference's compared steps in float64 and
the comparison.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_port import check, counting, fit as fitmod, tracing
from bench_port.reference import astro

# entry functions' timings: the steps of a traced run that the profiler
# sees (the first fit's, past its first step)
PROFILE_FROM, PROFILE_STEPS = 2, 5


def load_module(name, path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(root, workload):
    """Everything one workload's run reads, found by the names in
    root/BENCHMARK.json, under root/bench_port."""
    here = os.path.join(root, "bench_port")
    bench = _json(root, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg = _json(here, "configs", wl["config"] + ".json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reporting = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in reporting]
    metrics = {m["name"]: load_module(
        f"bench_port.metrics.{m['name']}",
        os.path.join(here, "metrics", m["name"] + ".py")) for m in layer}
    return SimpleNamespace(
        name=workload, cfg=cfg,
        traffic=_json(here, "traffic", wl["traffic"] + ".json"),
        limits=_json(here, "cells", workload + ".json")["limits"],
        maker=load_module(f"bench_port.configs.{wl['config']}",
                            os.path.join(here, "configs",
                                         wl["config"] + ".py")),
        reference=load_module(f"bench_port.reference.{cfg['reference']}",
                              os.path.join(here, "reference",
                                           cfg["reference"] + ".py")),
        end_to_end=e2e, per_layer=layer, metrics=metrics)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_target(c, inp, device):
    """The data: the reference's visibilities at the truth plus complex
    noise of unit variance from the inputs' generator, rounded to
    complex64 (the reference's float64 copy is the rounded one). Returns
    (target, the data on the host in the reference's order): target(bls)
    gives the program the data and the inverse covariance in the order
    of its baselines bls."""
    ref = c.reference.Model(c.cfg, inp, device)
    gen = inp["generator"]
    vis = ref.forward(inp["truth"])
    noise = torch.complex(
        torch.randn(vis.shape, generator=gen, dtype=torch.float64,
                    device=device),
        torch.randn(vis.shape, generator=gen, dtype=torch.float64,
                    device=device))
    data = (vis + math.sqrt(0.5) * noise).to(torch.complex64)
    del vis, noise
    icov = ref.icov.to(torch.float32)
    index = {bl: i for i, bl in enumerate(ref.bls)}
    del ref

    def target(bls):
        order = torch.as_tensor(
            [index[tuple(int(a) for a in bl)] for bl in bls], device=device)
        d = data.index_select(2, order).permute(2, 0, 1)[None, None] \
            .contiguous()
        w = icov.index_select(0, order)[None, None, :, None, None]
        return d, w.expand(d.shape).contiguous()
    return target, data.cpu()


def reference_check(c, inp, data, device, at=()):
    """The reference's readings, in float64 on the device."""
    ref = c.reference.Model(c.cfg, inp, device)
    ref.data = data.to(device, torch.complex128)
    return check.reference_readings(c.cfg, c.traffic, ref, inp["start"],
                                    at=at)


def run_cell(root, workload, seed, seconds, trace, device, t_start):
    """One run. Returns (the result line without 'correct' and
    'checks', the program's readings, the reference's, the numbers
    compared, their limits)."""
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.ops import rime_cuda
    cuda = device.type == "cuda"
    c = cell(root, workload)
    stamps = [("imports", time.time())]
    inp = c.maker.inputs(c.cfg, seed, device)
    stamps.append(("inputs", time.time()))
    # the reference's float64 target is the benchmark's work, not the
    # program's: its seconds are left out of setup_s
    target, data_host = make_target(c, inp, device)
    _sync(device)
    stamps.append(("reference target", time.time()))
    if cuda:
        # the reference's blocks do not count in the program's peak
        torch.cuda.reset_peak_memory_stats(device)
    prob, keys = c.maker.build(bt, c.cfg, inp, target, device)
    fit = fitmod.Fit(bt, prob, keys, c.traffic, c.cfg)
    del target
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _sync(device)
    stamps.append(("program build", time.time()))
    readings = fitmod.first_steps(fit, check.STEPS)
    fit.reset()
    fit.step()
    if trace and cuda:
        tracing.warm_profiler()
    _sync(device)
    stamps.append(("first steps", time.time()))
    prev, parts, left_out = t_start, [], 0.0
    for name, t in stamps:
        parts.append(f"{name} {t - prev:.3f} s")
        if name == "reference target":
            left_out = t - prev
        prev = t
    setup_s = time.time() - t_start - left_out
    print(f"set-up {setup_s:.3f} s (the reference target left out): "
          + ", ".join(parts), file=sys.stderr, flush=True)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    specs = {}
    for m in c.metrics.values():
        specs.update(getattr(m, "TIMES", {}))
    timed = tracing.Timed(specs) if trace and cuda else None
    prof = tracing.Profiled() if trace and cuda else None
    marks, half = {}, []

    def on_step(i, phase):
        # the rate over the window's first half, printed beside the whole
        # window's, shows what a window half as long would have read
        if phase == "pre" and i == 0:
            marks["t0"], marks["e0"] = time.perf_counter(), prob.closure_eval
        elif phase == "post" and not half and \
                time.perf_counter() - marks["t0"] >= seconds / 2:
            half.append((time.perf_counter() - marks["t0"],
                         prob.closure_eval - marks["e0"]))
        if prof is None:
            return
        if phase == "pre" and i == PROFILE_FROM:
            prof.start()
            timed.profiling = True
            marks["evals"] = prob.closure_eval
        elif phase == "post" and i == PROFILE_FROM + PROFILE_STEPS - 1:
            prof.stop()
            timed.profiling = False
            marks["evals"] = prob.closure_eval - marks["evals"]

    evals0 = prob.closure_eval
    l0, d0 = rime_cuda.launches, rime_cuda.dtau_launches
    window_s, walls, bad = fitmod.window(
        fit, seconds, on_step, lambda: _sync(device))
    evals = prob.closure_eval - evals0
    launches, dtau = rime_cuda.launches - l0, rime_cuda.dtau_launches - d0
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cfg = c.cfg
    points = cfg["nfreq"] * cfg["ntime"] * prob.target[0].data.shape[2]
    q = np.percentile([w * 1e3 for w in walls], [0, 25, 50, 75, 95, 100])
    print(f"window: {window_s:.3f} s, {len(walls)} steps, {evals} "
          f"evaluations, step walls ms min / q1 / median / q3 / p95 / max "
          f"{' / '.join(f'{v:.2f}' for v in q)}", file=sys.stderr,
          flush=True)
    if half:
        print(f"first half of the window: {half[0][1]} evaluations in "
              f"{half[0][0]:.3f} s, vis_per_s {half[0][1] * points / half[0][0]!r}",
              file=sys.stderr, flush=True)

    result = dict(attempted=len(walls), failed=bad, metrics={}, device={})
    if not trace:
        values = dict(
            setup_s=setup_s,
            vis_per_s=evals * points / window_s,
            steps_per_s=len(walls) / window_s,
            peak_mem_gib=peak / 2 ** 30)
        for m in c.end_to_end:
            result["metrics"][m["name"]] = dict(value=values[m["name"]],
                                                unit=m["unit"])
    else:
        if timed is not None:
            timed.restore()
        geo, _, _, _ = astro.sky_geometry(
            cfg["nside"], cfg["time0_jd"] + np.arange(cfg["ntime"])
            * cfg["dtime_jd"])
        t = SimpleNamespace(
            cfg=cfg, traffic=c.traffic, window_s=window_s, steps=len(walls),
            evals=evals, launches=launches,
            dtau_launches=dtau,
            timed=timed.totals() if timed else {k: (0, 0.0, 0.0) for k in specs},
            timed_prof=timed.totals(True) if timed else
            {k: (0, 0.0, 0.0) for k in specs},
            prof=prof.summary() if prof else None,
            prof_evals=marks.get("evals", 0),
            flops_per_eval=counting.eval_flops(
                cfg, max(s.shape[1] for _, s in geo)))
        for m in c.per_layer:
            v = c.metrics[m["name"]].read(t)
            if v is not None:
                result["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
        if t.prof is not None:
            result["device"].update(busy_s=t.prof["busy_s"],
                                    window_s=t.prof["wall_s"])
            result["breakdown"] = dict(device_ops=t.prof["device_ops"],
                                       idle_gaps=t.prof["idle_gaps"])
            print(f"profiler: {t.prof['marks']} of {tracing.MARKS} spin "
                  f"markers kept (one or more: no kernel of the profiled "
                  f"steps was dropped)", file=sys.stderr, flush=True)
    result["device"] = dict(
        platform="gpu" if cuda else device.type,
        kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        count=1, memory_peak_bytes=int(max(peak, setup_peak) if cuda else 0),
        **result["device"])

    # the program's state goes before the reference runs
    del fit, prob
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.time()
    x1 = readings.pop("x1")
    ref = reference_check(c, inp, data_host, device,
                          at=[x1] if "dir" in readings else [])
    values = check.gaps(readings, ref, c.traffic["compared"])
    print(f"reference check {time.time() - t_ref:.3f} s", file=sys.stderr,
          flush=True)
    return result, readings, check.printable(ref), values, c.limits
