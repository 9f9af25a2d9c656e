"""
The comparison that decides ``correct``. The reference follows the first
optimizer steps of a fit from the same start on the same data, in
float64, with its own model and optimizer. The traffic file's
``compared`` says how many of them each number takes ({"loss": n,
"change": m, "direction": true or false}); the numbers compared are

- ``loss_gap``: the largest |L_prog - L_ref| / |L_ref| over the loss at
  the start and the first n steps' losses;
- ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first gradient the optimizer took,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
- ``step_gap``: the same for the norm of each leaf's change after m
  steps, leaving out leaves whose reference first gradient is below a
  thousandth of the median leaf's (round-off alone moves them);
- ``dir_gap`` (L-BFGS, where "direction" is true): the same for the
  norm of each leaf of the search direction -H1 g1 that the program's
  step 2 takes, against the reference's rule at the program's own point
  x1 after step 1: the pair (x1 - x0, g(x1) - g(x0)) from the
  reference's float64 gradients, the rescaled starting diagonal and the
  two-loop recursion. So the curvature update is held to the reference,
  and the line search's choices cannot move it.

Each is held to the cell's limit (cells/<workload>.json).
"""
from __future__ import annotations

import math
import statistics

import torch

from bench_port.reference import optim

STEPS = 3


def steps_compared(compared):
    return max(compared["loss"], compared["change"])


def reference_readings(cfg, traffic, ref, start, weight=None, steps=None,
                       broken=None, at=()):
    """Follow the compared steps (or `steps`) of the reference model `ref`
    from `start` ({leaf: tensor}); the same readings as fit.first_steps.
    For L-BFGS also 'dir_at': each leaf's norm of the direction the rule
    takes at each point of `at` (see dir_gap).
    weight: per-baseline weights of the chi^2 (a fault: half the data);
    broken='unchanged': the steps return the state unchanged."""
    fun = lambda x: ref.value_and_grad(x, weight)
    x0 = {k: v.to(ref.dev, ref.dt) for k, v in start.items()}
    lbfgs = traffic["optimizer"] == "lbfgs"
    if lbfgs:
        opt = optim.LBFGS(fun, x0, cfg["lbfgs_first_step"],
                          history=traffic["history"])
    else:
        opt = optim.Adam(fun, x0, traffic["lr"])
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    norms = lambda d: {k: norm(v) for k, v in d.items()}
    losses, change, out = [], [], {}
    for i in range(steps or steps_compared(traffic["compared"])):
        if broken == "unchanged":
            f, g = fun(x0)
            losses.append(f)
            if opt.first_grad is None:
                opt.first_loss, opt.first_grad = f, g
            x = x0
        else:
            losses.append(opt.step())
            x = opt.x if isinstance(opt.x, dict) else opt.leaves()
        change.append({k: norm(x[k] - x0[k]) for k in x0})
        if i == 0 and lbfgs:
            # put in the program's place: its own point after step 1 and
            # the direction its step 2 takes
            out["x1"] = {k: v.clone() for k, v in x.items()}
            out["dir"] = norms(opt.unravel(opt._two_loop(
                opt.g, opt.s, opt.y, opt.rho, opt.H)))
    if lbfgs:
        out["dir_at"] = [norms(opt.direction_at(p)) for p in at]
    out.update(loss0=opt.first_loss, losses=losses, change=change,
               grad={k: norm(v) for k, v in opt.first_grad.items()})
    return out


def gaps(prog, ref, compared, ref_dir=None):
    """The numbers compared, from the program's and the reference's
    readings; ref_dir: the reference's direction norms at the program's
    x1 (default: its first 'dir_at')."""
    n, m = compared["loss"], compared["change"]
    pl = [prog["loss0"]] + prog["losses"][:n]
    rl = [ref["loss0"]] + ref["losses"][:n]
    loss = max(abs(p - r) / abs(r) for p, r in zip(pl, rl))
    gmed = statistics.median(ref["grad"].values())

    def worst(p, r, keys):
        med = statistics.median(r[k] for k in keys)
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in keys)
    moved = [k for k in ref["grad"] if ref["grad"][k] >= 1e-3 * gmed]
    out = dict(loss_gap=loss,
               grad_gap=worst(prog["grad"], ref["grad"], list(ref["grad"])),
               step_gap=worst(prog["change"][m - 1], ref["change"][m - 1],
                              moved))
    if compared.get("direction"):
        rd = ref["dir_at"][0] if ref_dir is None else ref_dir
        out["dir_gap"] = math.nan if not prog.get("dir") else \
            worst(prog["dir"], rd, list(rd))
    return out


def printable(readings):
    """The readings without the points they hold."""
    return {k: v for k, v in readings.items() if k != "x1"}


def verdict(values, limits):
    """True when every number is finite and within its limit."""
    return all(v == v and v <= limits[k] for k, v in values.items())
