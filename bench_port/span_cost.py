#!/usr/bin/env python3
"""
What the program's spans cost: one cell's rate with the whole window
under a bare torch.profiler (CPU and CUDA activities), against the same
window with none, and against the profiler with the spans' ranges
emptied (bayeslim_tpu_torch.utils.logging._Span entering nothing), in
turns in one process on one card:

    python3 bench_port/span_cost.py --workload alm64.adam --seed 12345 \\
        --seconds 20 --rounds 3

Prints one JSON line a window (mode, steps, evaluations, seconds,
steps_per_s, the profiler's parse seconds) and, last, the medians by
mode. Set-up as bench_port/run.py's (the reference's target included,
no reference check).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("none", "profiler", "profiler, spans empty")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.utils import logging as blog
    from bench_port import check, fit as fitmod, harness, tracing
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", file=sys.stderr, flush=True)
    dev = torch.device("cuda", 0)
    c = harness.cell(ROOT, args.workload)
    inp = c.maker.inputs(c.cfg, args.seed, dev)
    target, _ = harness.make_target(c, inp, dev)
    prob, keys = c.maker.build(bt, c.cfg, inp, target, dev)
    fit = fitmod.Fit(bt, prob, keys, c.traffic, c.cfg)
    del target
    fitmod.first_steps(fit, check.STEPS)
    fit.reset()
    fit.step()
    tracing.warm_profiler()
    sync = lambda: torch.cuda.synchronize(dev)
    enter, leave = blog._Span.__enter__, blog._Span.__exit__
    rates = {m: [] for m in MODES}
    for r in range(args.rounds):
        # each round starts its turns one mode further on
        for m in MODES[r % 3:] + MODES[:r % 3]:
            if m == "profiler, spans empty":
                blog._Span.__enter__ = lambda self: None
                blog._Span.__exit__ = lambda self, *exc: None
            e0 = prob.closure_eval
            parse = 0.0
            if m == "none":
                secs, walls, _ = fitmod.window(fit, args.seconds, sync=sync)
            else:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                secs, walls, _ = fitmod.window(fit, args.seconds, sync=sync)
                t = time.perf_counter()
                prof.__exit__(None, None, None)
                parse = time.perf_counter() - t
                del prof
            blog._Span.__enter__, blog._Span.__exit__ = enter, leave
            rates[m].append(len(walls) / secs)
            print(json.dumps(dict(mode=m, steps=len(walls),
                                  evals=prob.closure_eval - e0,
                                  seconds=secs, steps_per_s=rates[m][-1],
                                  parse_s=parse)), flush=True)
    print(json.dumps({m: dict(median=statistics.median(v), runs=v)
                      for m, v in rates.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
