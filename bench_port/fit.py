"""
The one loop every cell's window runs: a traffic file names the
optimizer and its settings, and ``steps_per_fit``: fits of that many
steps, each from the seeded start, one after another (null: one fit for
the whole window).

- ``"lbfgs"``: each fit's first gradient (one posterior evaluation) sets
  a diagonal starting inverse Hessian under which the first trial step
  moves leaf k by at most the configuration's ``lbfgs_first_step[k]``;
  then the program's strong-Wolfe LBFGS, history ``history``. That first
  evaluation's wall joins the fit's first step.
- ``"adam"``: the program's Trainer (torch.optim.Adam) at ``lr``.

A step is timed from its call until its loss is a host float.
"""
from __future__ import annotations

import functools
import time

import torch


class Fit:
    def __init__(self, bt, prob, keys, traffic, cfg):
        self.bt, self.prob, self.keys = bt, prob, keys   # ref leaf -> key
        self.kind = traffic["optimizer"]
        self.traffic, self.cfg = traffic, cfg
        params = dict(prob.model.named_parameters())
        self.start = {k: params[k].detach().clone() for k in keys.values()}
        self.opt = None
        if self.kind == "adam":
            self.trainer = bt.Trainer(prob, lr=traffic["lr"])
        elif self.kind != "lbfgs":
            raise ValueError(f"unknown optimizer {self.kind!r}")
        self.first_loss = self.first_grad = None

    def reset(self):
        """Back to the seeded start with a fresh optimizer state."""
        if self.kind == "adam":
            with torch.no_grad():
                for k, v in self.trainer.pdict.items():
                    v.copy_(self.start[k])
            self.trainer.set_opt(functools.partial(torch.optim.Adam,
                                                   lr=self.traffic["lr"]))
        else:
            self.prob.update(self.bt.ParamDict(
                {k: v.clone() for k, v in self.start.items()}))
            self.opt = None

    def step(self):
        """One optimizer step; its loss as a host float."""
        if self.kind == "adam":
            return float(self.trainer.step())
        if self.opt is None:
            v, g = self.prob.value_and_grad()
            self.first_loss, self.first_grad = float(v), g
            first = self.cfg["lbfgs_first_step"]
            by_key = {v: first[k] for k, v in self.keys.items()}
            H0 = self.bt.DiagMat(self.bt.ParamDict({
                k: torch.full_like(v, by_key[k] / float(v.abs().max()))
                for k, v in g.items()}).ravel())
            self.opt = self.bt.LBFGS(self.prob, H0=H0,
                                     history_size=self.traffic["history"])
        return self.opt.step()

    def first_gradient(self):
        """{ref leaf: the gradient the optimizer took first}: Adam's first
        moment after one step over (1 - beta1), zero where it holds none;
        L-BFGS's gradient of the call that set its starting inverse
        Hessian."""
        if self.kind == "adam":
            out = {}
            b1 = self.trainer.opt.param_groups[0]["betas"][0]
            for k, v in self.trainer.pdict.items():
                m = self.trainer.opt.state[v].get("exp_avg")
                out[k] = torch.zeros_like(v) if m is None else m / (1 - b1)
        else:
            out = dict(self.first_grad.items())
        return {r: out[k].detach() for r, k in self.keys.items()}

    def params(self):
        """{ref leaf: the program's current value}."""
        if self.kind == "adam":
            src = self.trainer.pdict
        else:
            src = dict(self.prob.model.named_parameters())
        return {r: src[k].detach() for r, k in self.keys.items()}


def first_steps(fit, n=3):
    """Run the first n steps of a fit from the start: the program's
    readings that the reference is held to (the loss at the start, each
    step's loss, each leaf's norm of the first gradient, and of its change
    after each step; for L-BFGS, each leaf's norm of the search direction
    that step 2 takes, and the point x1 after step 1 where it was taken)."""
    fit.reset()
    x0 = {k: v.double().clone() for k, v in fit.params().items()}
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    losses, change, grad, seen = [], [], None, []
    out = {}
    for i in range(n):
        if fit.kind == "lbfgs" and i == 1:
            orig = fit.opt._direction
            fit.opt._direction = lambda g: seen.append(orig(g)) or seen[-1]
        losses.append(fit.step())
        if fit.kind == "lbfgs" and i == 1:
            del fit.opt._direction
        if i == 0:
            grad = fit.first_gradient()
            out["x1"] = {k: v.detach().clone()
                         for k, v in fit.params().items()}
        x = fit.params()
        change.append({k: norm(x[k].double() - x0[k]) for k in x})
    first = losses[0] if fit.first_loss is None else fit.first_loss
    out.update(loss0=first, losses=losses, change=change,
               grad={k: norm(v) for k, v in grad.items()})
    if fit.kind == "lbfgs":
        # the program's step minus the direction: -H g (None: step 2 took
        # no direction)
        d = fit.opt._template.unravel(seen[0]) if seen else None
        out["dir"] = None if d is None else \
            {r: norm(d[k]) for r, k in fit.keys.items()}
    return out


def window(fit, seconds, on_step=None, sync=lambda: None):
    """Fits one after another for `seconds`: a step starts only while the
    window is open, and the window closes when the last one ends.
    on_step(i, phase) is called before ('pre') and after ('post') step i.
    Returns (seconds, step walls, non-finite losses)."""
    walls, bad, i = [], 0, 0
    nfit = fit.traffic["steps_per_fit"]
    sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if nfit is not None and i % nfit == 0:
            fit.reset()
        if on_step:
            on_step(i, "pre")
        t1 = time.perf_counter()
        loss = fit.step()
        walls.append(time.perf_counter() - t1)
        bad += not (loss == loss and abs(loss) != float("inf"))
        if on_step:
            on_step(i, "post")
        i += 1
    return time.perf_counter() - t0, walls, bad
