"""
Quasi-Newton optimizers: dense BFGS and low-memory L-BFGS with a
strong-Wolfe line search.

Counterpart of bayeslim_tpu/inference/bfgs.py (`_cubic_interpolate`
:22, strong_wolfe :41, `_QuasiNewtonBase` :144, BFGS :189, LBFGS :257,
lbfgs_approx_cov :373).
The algorithms work on the raveled ParamDict vector, a tensor on the
parameters' device; the closure is the LogProb's value_and_grad. The
two-loop recursion and the Wolfe zoom are sequential scalar logic:
their scalars come to the host with float(), as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.logging import span
from ..utils.paramdict import ParamDict
from .hmat import DiagMat

__all__ = ["BFGS", "LBFGS", "strong_wolfe", "lbfgs_approx_cov"]


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Cubic minimizer of a 1D function from two (x, f, f') samples."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    if d2_square >= 0:
        d2 = np.sqrt(d2_square)
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def strong_wolfe(fun, x, t, d, f, g, gtd, c1=1e-4, c2=0.9,
                 tolerance_change=1e-9, max_ls=25):
    """Strong-Wolfe line search along d from x, starting at step t.

    fun(x) -> (f, g-vector). Returns (f_new, g_new, t, ls_evals).
    """
    d_norm = float(d.abs().max())
    f_new, g_new = fun(x + t * d)
    ls_func_evals = 1
    gtd_new = float(g_new @ d)

    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    done = False
    ls_iter = 0
    while ls_iter < max_ls:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [t_prev, t]
            bracket_f = [f_prev, float(f_new)]
            bracket_g = [g_prev, g_new]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            bracket = [t, t]
            bracket_f = [float(f_new), float(f_new)]
            bracket_g = [g_new, g_new]
            done = True
            break
        if gtd_new >= 0:
            bracket = [t_prev, t]
            bracket_f = [f_prev, float(f_new)]
            bracket_g = [g_prev, g_new]
            bracket_gtd = [gtd_prev, gtd_new]
            break

        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, float(f_new),
                               gtd_new, bounds=(min_step, max_step))
        t_prev, f_prev, g_prev, gtd_prev = tmp, float(f_new), g_new, gtd_new
        f_new, g_new = fun(x + t * d)
        ls_func_evals += 1
        gtd_new = float(g_new @ d)
        ls_iter += 1
    else:
        bracket = [0, t]
        bracket_f = [f, float(f_new)]
        bracket_g = [g, g_new]
        bracket_gtd = [gtd, gtd_new]

    # zoom phase
    insuf_progress = False
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
    while not done and ls_iter < max_ls:
        if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0],
                               bracket[1], bracket_f[1], bracket_gtd[1])
        eps = 0.1 * (max(bracket) - min(bracket))
        if min(max(bracket) - t, t - min(bracket)) < eps:
            if insuf_progress or t >= max(bracket) or t <= min(bracket):
                if abs(t - max(bracket)) < abs(t - min(bracket)):
                    t = max(bracket) - eps
                else:
                    t = min(bracket) + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False

        f_new, g_new = fun(x + t * d)
        ls_func_evals += 1
        gtd_new = float(g_new @ d)
        ls_iter += 1

        if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
            bracket[high_pos] = t
            bracket_f[high_pos] = float(f_new)
            bracket_g[high_pos] = g_new
            bracket_gtd[high_pos] = gtd_new
            low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] \
                else (1, 0)
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                bracket[high_pos] = bracket[low_pos]
                bracket_f[high_pos] = bracket_f[low_pos]
                bracket_g[high_pos] = bracket_g[low_pos]
                bracket_gtd[high_pos] = bracket_gtd[low_pos]
            bracket[low_pos] = t
            bracket_f[low_pos] = float(f_new)
            bracket_g[low_pos] = g_new
            bracket_gtd[low_pos] = gtd_new

    t = bracket[low_pos] if not done else t
    f_new = bracket_f[low_pos] if not done else float(f_new)
    g_new = bracket_g[low_pos] if not done else g_new
    return f_new, g_new, t, ls_func_evals


class _QuasiNewtonBase:
    """Shared machinery: ravel/unravel, the closure, the step loop.
    func_evals counts closure evaluations."""

    def __init__(self, prob, pdict=None, lr=1.0, max_iter=20,
                 tolerance_grad=1e-14, tolerance_change=1e-16,
                 line_search_fn="strong_wolfe"):
        self.prob = prob
        self.pdict = pdict if pdict is not None \
            else prob.collect_main_params()
        if any(v.is_complex() for v in self.pdict.values()):
            # the JAX package's line search fails on them too (a float of
            # the complex g.d): they are never stepped, uphill or not
            raise ValueError("BFGS / LBFGS step real parameters: give "
                             "complex leaves as real pairs (a trailing "
                             "dim of 2)")
        self._template = self.pdict.copy()
        self.lr = lr
        self.max_iter = max_iter
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.line_search_fn = line_search_fn
        self.n_iter = 0
        self.func_evals = 0
        self._f = None
        self._g = None

    def _fun(self, x):
        pd = self._template.unravel(x)
        v, g = self.prob.value_and_grad(pd)
        self.func_evals += 1
        return float(v), g.ravel()

    def _exit_after_ls(self, f, f_new, g_new, t, d):
        """Break conditions evaluated after the line search: optimality,
        step-size stagnation, loss stagnation. True skips the curvature
        update of this iteration."""
        if float(g_new.abs().max()) <= self.tolerance_grad:
            return True
        if float((t * d).abs().max()) <= self.tolerance_change:
            return True
        if abs(f_new - f) < self.tolerance_change:
            return True
        return False

    @property
    def x(self):
        return self.pdict.ravel().detach()

    def _commit(self, x):
        self.pdict = self._template.unravel(x)
        self.prob.update(self.pdict)

    def _direction(self, g):
        raise NotImplementedError

    def _update_curvature(self, s, y, ys, t):
        raise NotImplementedError

    @span("bl.opt")
    def step(self):
        """One outer iteration (direction, line search, curvature
        update); returns the loss at the new point."""
        x = self.x
        if self._g is None:
            self._f, self._g = self._fun(x)
        f, g = self._f, self._g
        if float(g.abs().max()) <= self.tolerance_grad:
            return f
        d = -self._direction(g)
        gtd = float(g @ d)
        # non-descent direction guard
        if gtd > -self.tolerance_change:
            return f
        # without a line search the first trial step is scaled by the
        # gradient's size; strong_wolfe always starts at lr
        t = self.lr
        if self.n_iter == 0 and self.line_search_fn is None:
            t = min(1.0, 1.0 / float(g.abs().sum())) * self.lr
        if self.line_search_fn == "strong_wolfe":
            f_new, g_new, t, _ = strong_wolfe(self._fun, x, t, d, f, g, gtd)
        else:
            f_new, g_new = self._fun(x + t * d)
        x_new = x + t * d
        s = x_new - x
        y = g_new - g
        # the exits fire after the parameter update but before the
        # curvature update: the near-converged pair is dropped and n_iter
        # is not incremented
        if self._exit_after_ls(f, f_new, g_new, t, d):
            self._commit(x_new)
            self._f, self._g = f_new, g_new
            return f_new
        ys = float(y @ s)
        # sufficient-curvature condition
        if ys > self.tolerance_grad:
            self._update_curvature(s, y, ys, t)
        self._commit(x_new)
        self._f, self._g = f_new, g_new
        self.n_iter += 1
        return f_new

    def minimize(self, Nsteps=None):
        Nsteps = Nsteps if Nsteps is not None else self.max_iter
        return [self.step() for _ in range(Nsteps)]


class BFGS(_QuasiNewtonBase):
    """Dense inverse-Hessian BFGS. H0: None (identity), a scalar or a
    diagonal vector, or a dense matrix."""

    def __init__(self, prob, pdict=None, H0=None, **kwargs):
        super().__init__(prob, pdict, **kwargs)
        x = self.x
        eye = torch.eye(x.numel(), dtype=x.dtype, device=x.device)
        if H0 is None:
            self.H = eye
        else:
            H0 = torch.as_tensor(H0, dtype=x.dtype, device=x.device)
            self.H = eye * H0 if H0.ndim < 2 else H0

    def _direction(self, g):
        return self.H @ g

    def _update_curvature(self, s, y, ys, t):
        rho = 1.0 / ys
        eye = torch.eye(s.numel(), dtype=s.dtype, device=s.device)
        V = eye - rho * torch.outer(s, y)
        self.H = V @ self.H @ V.T + rho * torch.outer(s, s)


class LBFGS(_QuasiNewtonBase):
    """Two-loop-recursion L-BFGS.

    H0: starting inverse Hessian, a scalar, a diagonal vector or a
    DiagMat. update_Hdiag (default True) rescales the starting diagonal
    at each accepted curvature pair by s^T y / (y^T H0 y) (Nocedal Eqn
    7.20 normalized to the current diagonal); with a uniform H0 this is
    the standard gamma scaling s^T y / y^T y. s_hist, y_hist, rho_hist
    and t_hist (the line-search step of each pair) hold the retained
    curvature pairs, oldest first.
    """

    def __init__(self, prob, pdict=None, history_size=20, H0=None,
                 update_Hdiag=True, **kwargs):
        super().__init__(prob, pdict, **kwargs)
        self.history_size = history_size
        self.update_Hdiag = update_Hdiag
        self.s_hist = []
        self.y_hist = []
        self.rho_hist = []
        self.t_hist = []
        x = self.x
        if isinstance(H0, DiagMat):
            H0 = H0.diagonal().real
        if H0 is None:
            H0 = 1.0
        H0 = torch.as_tensor(H0, dtype=x.dtype, device=x.device)
        self._Hdiag = H0.expand(x.numel()).clone() if H0.ndim == 0 else H0

    @property
    def H(self):
        """Running starting inverse Hessian, as a DiagMat."""
        return DiagMat(self._Hdiag)

    def _direction(self, g):
        q = g
        alphas = []
        for s, y, rho in zip(reversed(self.s_hist), reversed(self.y_hist),
                             reversed(self.rho_hist)):
            a = rho * float(s @ q)
            alphas.append(a)
            q = q - a * y
        r = q * self._Hdiag
        for (s, y, rho), a in zip(zip(self.s_hist, self.y_hist,
                                      self.rho_hist), reversed(alphas)):
            b = rho * float(y @ r)
            r = r + (a - b) * s
        return r

    def _update_curvature(self, s, y, ys, t):
        self.s_hist.append(s)
        self.y_hist.append(y)
        self.rho_hist.append(1.0 / ys)
        self.t_hist.append(t)
        if len(self.s_hist) > self.history_size:
            for hist in (self.s_hist, self.y_hist, self.rho_hist,
                         self.t_hist):
                hist.pop(0)
        if self.update_Hdiag:
            self._Hdiag = self._Hdiag * (ys / float(y @ (self._Hdiag * y)))


def lbfgs_approx_cov(obj, Nsteps=5, as_dense=True, H0=None, **kwargs):
    """Approximate covariance (inverse Hessian) from L-BFGS curvature.
    as_dense is accepted, as in the JAX package, where neither form
    reads it: the LogProb form returns a DiagMat and the LBFGS form a
    dense matrix whatever its value.

    - obj a LogProb: a short L-BFGS run of Nsteps on each trainable leaf
      alone (the others held), whose running starting diagonal (LBFGS.H,
      Nocedal Eqn 7.20 scaling) gives that leaf's block; returns a
      DiagMat over the raveled main params, leaves in key order. The
      probe steps update the model's parameters, as in the JAX package:
      save them first to restore them. H0 may map leaf keys to each
      leaf's starting inverse Hessian; kwargs go to each LBFGS.
    - obj a finished LBFGS: the dense inverse Hessian of Nocedal Eqn
      6.20 from its (s, y) pairs, for small problems.
    """
    if hasattr(obj, "collect_main_params"):
        prob = obj
        pd = prob.collect_main_params()
        diags = []
        for key in pd:
            h0 = H0[key] if isinstance(H0, (dict, ParamDict)) else H0
            opt = LBFGS(prob, ParamDict({key: pd[key]}), H0=h0, **kwargs)
            opt.minimize(Nsteps)
            diags.append(opt._Hdiag)
        return DiagMat(torch.cat(diags))

    lbfgs = obj
    Hd = lbfgs._Hdiag
    H = torch.diag(Hd)
    eye = torch.eye(Hd.numel(), dtype=Hd.dtype, device=Hd.device)
    for s, y, rho in zip(lbfgs.s_hist, lbfgs.y_hist, lbfgs.rho_hist):
        V = eye - rho * torch.outer(s, y)
        H = V @ H @ V.T + rho * torch.outer(s, s)
    return H
