"""
The reference's optimizers on a dict of float64 leaves: Adam as
torch.optim.Adam defines it, and L-BFGS with a strong-Wolfe line search.
The L-BFGS is a frozen copy of the algorithm the program runs (two-loop
recursion, the starting diagonal rescaled by s.y / y.H.y at each
accepted pair, Nocedal and Wright's strong-Wolfe bracket and zoom with
cubic interpolation): the reference has to take the same trial points to
be compared step by step, so it copies the rule, not the code's
arithmetic, and computes it in float64.

``fun(leaves) -> (loss, grads)`` is the reference model's evaluation.
Each optimizer's ``step()`` returns the loss the program's optimizer
reports: Adam's before its update, L-BFGS's after its step.
"""
from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, fun, leaves, lr, betas=(0.9, 0.999), eps=1e-8):
        self.fun, self.x = fun, {k: v.clone() for k, v in leaves.items()}
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in self.x.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.x.items()}
        self.t = 0
        self.first_loss = self.first_grad = None

    def step(self):
        loss, g = self.fun(self.x)
        if self.first_grad is None:
            self.first_loss, self.first_grad = loss, g
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k in self.x:
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g[k]
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g[k] ** 2
            denom = torch.sqrt(self.v[k]) / math.sqrt(c2) + self.eps
            self.x[k] = self.x[k] - (self.lr / c1) * self.m[k] / denom
        return loss


def _cubic(x1, f1, g1, x2, f2, g2, bounds=None):
    lo, hi = bounds if bounds is not None else (min(x1, x2), max(x1, x2))
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2s = d1 ** 2 - g1 * g2
    if d2s >= 0:
        d2 = math.sqrt(d2s)
        if x1 <= x2:
            p = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            p = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(p, lo), hi)
    return (lo + hi) / 2.0


def _strong_wolfe(fun, x, t, d, f, g, gtd, c1=1e-4, c2=0.9, tol=1e-9,
                  max_ls=25):
    d_norm = float(d.abs().max())
    f_new, g_new = fun(x + t * d)
    gtd_new = float(g_new @ d)
    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    done, it = False, 0
    while it < max_ls:
        if f_new > f + c1 * t * gtd or (it > 1 and f_new >= f_prev):
            br, bf, bg, bd = [t_prev, t], [f_prev, f_new], [g_prev, g_new], \
                [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            br, bf, bg, bd = [t, t], [f_new, f_new], [g_new, g_new], None
            done = True
            break
        if gtd_new >= 0:
            br, bf, bg, bd = [t_prev, t], [f_prev, f_new], [g_prev, g_new], \
                [gtd_prev, gtd_new]
            break
        tmp = t
        t = _cubic(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                   bounds=(t + 0.01 * (t - t_prev), t * 10))
        t_prev, f_prev, g_prev, gtd_prev = tmp, f_new, g_new, gtd_new
        f_new, g_new = fun(x + t * d)
        gtd_new = float(g_new @ d)
        it += 1
    else:
        br, bf, bg, bd = [0, t], [f, f_new], [g, g_new], [gtd, gtd_new]
    insuf = False
    lo, hi = (0, 1) if bf[0] <= bf[-1] else (1, 0)
    while not done and it < max_ls:
        if abs(br[1] - br[0]) * d_norm < tol:
            break
        t = _cubic(br[0], bf[0], bd[0], br[1], bf[1], bd[1])
        eps = 0.1 * (max(br) - min(br))
        if min(max(br) - t, t - min(br)) < eps:
            if insuf or t >= max(br) or t <= min(br):
                t = max(br) - eps if abs(t - max(br)) < abs(t - min(br)) \
                    else min(br) + eps
                insuf = False
            else:
                insuf = True
        else:
            insuf = False
        f_new, g_new = fun(x + t * d)
        gtd_new = float(g_new @ d)
        it += 1
        if f_new > f + c1 * t * gtd or f_new >= bf[lo]:
            br[hi], bf[hi], bg[hi], bd[hi] = t, f_new, g_new, gtd_new
            lo, hi = (0, 1) if bf[0] <= bf[1] else (1, 0)
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (br[hi] - br[lo]) >= 0:
                br[hi], bf[hi], bg[hi], bd[hi] = br[lo], bf[lo], bg[lo], \
                    bd[lo]
            br[lo], bf[lo], bg[lo], bd[lo] = t, f_new, g_new, gtd_new
    if not done:
        t, f_new, g_new = br[lo], bf[lo], bg[lo]
    return f_new, g_new, t


class LBFGS:
    """From leaves x0 with the starting inverse Hessian diagonal set so
    that the first trial step moves leaf k by at most first_step[k]
    (first_step[k] / max|g_k|, the gradient at x0)."""

    def __init__(self, fun, leaves, first_step, history=20, tol_grad=1e-14,
                 tol_change=1e-16):
        self.keys = list(leaves)
        self.shapes = {k: leaves[k].shape for k in self.keys}
        self.fun = fun
        self.x = self._ravel(leaves)
        self.history, self.tol_grad, self.tol_change = history, tol_grad, \
            tol_change
        self.s, self.y, self.rho = [], [], []
        f, g = self.fun(leaves)
        self.first_loss, self.first_grad = f, g
        self.f, self.g = f, self._ravel(g)
        self.x0, self.g0 = self.x, self.g
        self.H = torch.cat([torch.full((g[k].numel(),), first_step[k]
                                       / float(g[k].abs().max()),
                                       dtype=self.x.dtype,
                                       device=self.x.device)
                            for k in self.keys])
        self.H0 = self.H

    def _ravel(self, d):
        return torch.cat([d[k].reshape(-1) for k in self.keys])

    def unravel(self, v):
        out, i = {}, 0
        for k in self.keys:
            n = math.prod(self.shapes[k])
            out[k] = v[i:i + n].reshape(self.shapes[k])
            i += n
        return out

    def _fun(self, v):
        f, g = self.fun(self.unravel(v))
        return f, self._ravel(g)

    def _two_loop(self, g, S, Y, R, H):
        """-H g by the two-loop recursion over the pairs S, Y, R."""
        q, alphas = g, []
        for s, y, rho in zip(reversed(S), reversed(Y), reversed(R)):
            a = rho * float(s @ q)
            alphas.append(a)
            q = q - a * y
        r = q * H
        for (s, y, rho), a in zip(zip(S, Y, R), reversed(alphas)):
            r = r + (a - rho * float(y @ r)) * s
        return -r

    def direction_at(self, leaves):
        """The search direction the rule takes at `leaves` as its second
        step's, had its first step gone from the start to `leaves`: the
        pair (x1 - x0, g(x1) - g(x0)) from this model's own gradients,
        with the starting diagonal rescaled by it."""
        x1 = self._ravel(leaves).to(self.x0)
        _, g1 = self._fun(x1)
        s, y = x1 - self.x0, g1 - self.g0
        ys = float(y @ s)
        if ys <= self.tol_grad:
            return self.unravel(self._two_loop(g1, [], [], [], self.H0))
        H = self.H0 * (ys / float(y @ (self.H0 * y)))
        return self.unravel(self._two_loop(g1, [s], [y], [1.0 / ys], H))

    def step(self):
        f, g = self.f, self.g
        if float(g.abs().max()) <= self.tol_grad:
            return f
        d = self._two_loop(g, self.s, self.y, self.rho, self.H)
        gtd = float(g @ d)
        if gtd > -self.tol_change:
            return f
        f_new, g_new, t = _strong_wolfe(self._fun, self.x, 1.0, d, f, g, gtd)
        x_new = self.x + t * d
        s, y = x_new - self.x, g_new - g
        self.x, self.f, self.g = x_new, f_new, g_new
        if float(g_new.abs().max()) <= self.tol_grad \
                or float((t * d).abs().max()) <= self.tol_change \
                or abs(f_new - f) < self.tol_change:
            return f_new
        ys = float(y @ s)
        if ys > self.tol_grad:
            self.s.append(s)
            self.y.append(y)
            self.rho.append(1.0 / ys)
            if len(self.s) > self.history:
                self.s.pop(0), self.y.pop(0), self.rho.pop(0)
            self.H = self.H * (ys / float(y @ (self.H * y)))
        return f_new

    def leaves(self):
        return self.unravel(self.x)
