"""
MCMC samplers: HMC, RecycledHMC and NUTS, with diagonal, dense and
hierarchical (hmat) mass matrices, step-size schedules and npz chains.

Counterpart of bayeslim_tpu/inference/sampler.py (multiply_eps :33,
Potential :48, leapfrog :65, SamplerBase :276, _Mass :385, _t_matvec
:502, StepSize :509, RelativeStepSize :537, DynamicStepSize :584, HMC
:634, RecycledHMC :1042, NUTS :1130). The arithmetic is the JAX
package's; the differences:

- One eager path. The JAX package's jit caches around the same
  arithmetic (make_leapfrog_traj :242, make_nuts_subtree :116, the
  sample_chains runners :829, :1196) have no counterpart; ``on_device``
  is accepted and changes nothing. NUTS runs the JAX package's host
  trees (the slice variant's ``_build_tree`` and the reference variant's
  merge trees); fn_evals counts every potential evaluation, as the JAX
  host paths do.
- One host sync per decision: positions, momenta and energies stay on
  the params' device; HMC reads dH once a step for the Metropolis test,
  NUTS reads H once a leaf and its u-turn dots once a merge. Kinetic
  energies and H are summed in float64.
- Draws: momenta from a torch.Generator on the params' device, uniforms
  and integers from a CPU torch.Generator, both seeded from ``seed``
  (numpy SeedSequence). Every uniform goes through ``_u`` and every
  integer through ``_randint``. A complex leaf's momentum has real and
  imaginary parts of unit variance (the density exp(-|p|^2 / 2) that the
  kinetic energy says), drawn as the real pairs of the same shape would
  be, so a complex leaf and its real pairs follow one trajectory.
- Faults of the JAX package not carried over: the multi-chain kinetic
  energy takes conj (its :872-874 does not); no runner cache keyed by
  ids (:829-843), so sample_chains always sees the current model, data
  and mass; load_chain restores divergences as integers (:378) and the
  potential energies of the chain, and drops the cached energy of the
  old position; complex leaves move downhill (torch's gradient
  convention; ROADMAP queue C1).
- sample_chains runs its chains one after another, each from its own
  generators (seeded from (seed, chain)); a divergent trajectory is
  rejected in place, as in the JAX package.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..utils.paramdict import ParamDict
from .hmat import BaseMat, MatDict, TriangMat, _mm

__all__ = ["SamplerBase", "Potential", "leapfrog", "HMC", "NUTS",
           "RecycledHMC", "StepSize", "RelativeStepSize", "DynamicStepSize",
           "multiply_eps"]


def multiply_eps(x, eps):
    """Multiply a tensor by a leapfrog step size: a complex eps scales
    the real and imaginary planes of a complex x independently."""
    x = torch.as_tensor(x)
    if _is_complex(eps):
        if x.is_complex():
            return torch.complex(x.real * eps.real, x.imag * eps.imag)
        return x * eps.real
    return x * eps


def _is_complex(v):
    return v.is_complex() if isinstance(v, torch.Tensor) \
        else np.iscomplexobj(v)


def _f64(U):
    """A potential value (tensor or number) as a float64 scalar tensor on
    its own device."""
    return U.to(torch.float64) if isinstance(U, torch.Tensor) \
        else torch.tensor(float(U), dtype=torch.float64)


def _accept_prob(logr):
    """min(1, exp(logr)), without overflow (NaN gives 1, as
    min(1.0, nan) does)."""
    return math.exp(min(0.0, logr))


def _generators(seed, device):
    """(momentum generator on device, CPU generator for uniforms and
    integers), seeded from a numpy SeedSequence of seed."""
    s_mom, s_u = np.random.SeedSequence(seed).generate_state(2)
    gen = torch.Generator(device=device).manual_seed(int(s_mom))
    host = torch.Generator().manual_seed(int(s_u))
    return gen, host


def _normal(gen, t):
    """N(0, 1) of t's shape, dtype and device; a complex t gets unit
    variance in each of its real and imaginary parts."""
    if t.is_complex():
        real = torch.randn(tuple(t.shape) + (2,), generator=gen,
                           dtype=t.real.dtype, device=t.device)
        return torch.view_as_complex(real)
    return torch.randn(t.shape, generator=gen, dtype=t.dtype,
                       device=t.device)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


class Potential:
    """U(x) = -log p(x) and its gradient, from a LogProb with
    negate=True."""

    def __init__(self, prob):
        self.prob = prob

    def __call__(self, x):
        """(U, gradient ParamDict)."""
        return self.prob.value_and_grad(x)

    def value(self, x):
        with torch.no_grad():
            return self.prob(x)


def leapfrog(q, p, dUdq, eps, N, Minv=None, cov_L=None, diag_mass=True,
             dUdq0=None, states=None):
    """Leapfrog integrator.

    q, p : ParamDicts (or tensors); dUdq(q) -> (U, gradient); eps : step
    size (number, tensor, ParamDict or StepSize); Minv : callable applying
    the inverse mass matrix (None: identity). cov_L, the Cholesky factor
    of the covariance (inverse mass), is the other way to give it: a
    scalar / ParamDict of diagonals (diag_mass=True), a dict of dense
    per-key factors (diag_mass=False), or an hmat operator. dUdq0 is the
    gradient at q (saves an evaluation); states, if a list, collects
    (q, p) after every step.

    Returns (q_new, p_new, U_new, gradU_new, n_grad_evals).
    """
    if Minv is None and cov_L is not None:
        def Minv(x, _L=cov_L):
            if isinstance(_L, BaseMat):
                return _L(x)
            if diag_mass:
                return x * (_L * _L)
            if isinstance(x, ParamDict):
                return ParamDict({k: _mm(_L[k], _mm(_L[k].conj().T, x[k]))
                                  for k in x.keys()})
            return _mm(_L, _mm(_L.conj().T, x))
    Minv = Minv if Minv is not None else (lambda x: x)
    if dUdq0 is not None:
        U, grad, nev = None, dUdq0, 0
    else:
        U, grad = dUdq(q)
        nev = 1
    p = p - grad * (eps / 2)
    for i in range(N):
        q = q + Minv(p) * eps
        U, grad = dUdq(q)
        nev += 1
        if i < N - 1:
            p = p - grad * eps
        if states is not None:
            states.append((q, p))
    p = p - grad * (eps / 2)
    return q, p, U, grad, nev


class SamplerBase:
    """Chain bookkeeping, the sampling loop, npz checkpoints and the
    sampler's draws (_u, _randint, the momentum generator)."""

    def __init__(self, x0, seed=0):
        self.x = x0.detach()
        self.chain = {k: [] for k in x0.keys()}
        self._acceptances = []
        self._divergences = []
        self.Usteps = []
        self.Uchain = []
        self._gen, self._host = _generators(seed, self._device())

    def _device(self):
        return self.x[next(iter(self.x))].device

    def _u(self, gen=None):
        """One uniform draw in [0, 1), from gen (default: the sampler's
        own CPU generator)."""
        return float(torch.rand((), generator=gen or self._host,
                                dtype=torch.float64))

    def _randint(self, low, high):
        """One integer draw in [low, high)."""
        return int(torch.randint(low, high, (), generator=self._host))

    @property
    def Nsamples(self):
        k = next(iter(self.chain))
        return len(self.chain[k])

    @property
    def acceptance_rate(self):
        if not self._acceptances:
            return 0.0
        return float(np.mean(self._acceptances))

    def append_chain(self, x, U=None):
        """Append a position (host copy) and its potential energy U."""
        for k in self.chain:
            self.chain[k].append(_np(x[k]))
        self.Uchain.append(U)

    def clear_chain(self, N=None):
        """Drop the oldest N chain entries, all of them by default; the
        current state x is kept."""
        if N is None:
            self.chain = {k: [] for k in self.chain}
            self._acceptances = []
            self._divergences = []
            self.Usteps = []
            self.Uchain = []
            return
        for k in self.chain:
            self.chain[k] = self.chain[k][N:]
        self.Uchain = self.Uchain[N:]
        self._divergences = [d - N for d in self._divergences if d >= N]

    def step(self):
        raise NotImplementedError

    def sample(self, Nsample, Ncheck=None, outfile=None, verbose=False,
               description=""):
        """Run Nsample steps, checkpointing every Ncheck samples."""
        for i in range(Nsample):
            self.step()
            if verbose and (i + 1) % max(Nsample // 10, 1) == 0:
                print(f"sample {i+1}/{Nsample} "
                      f"accept={self.acceptance_rate:.2f}")
            if Ncheck and outfile and (i + 1) % Ncheck == 0:
                self.write_chain(outfile, overwrite=True,
                                 description=description)
        if outfile:
            self.write_chain(outfile, overwrite=True, description=description)

    def get_chain(self, keys=None, burn=0):
        """Stacked chain history of all params, one (str) or several
        (list); burn drops early samples."""
        if keys is None:
            keys = list(self.chain.keys())
        elif isinstance(keys, str):
            keys = [keys]
        return {k: np.stack(self.chain[k][burn:]) for k in keys}

    def write_chain(self, fname, overwrite=False, attrs=None,
                    description=""):
        """Checkpoint the chain to .npz (the JAX package's layout;
        divergences as integers)."""
        if os.path.exists(fname) and not overwrite:
            raise FileExistsError(fname)
        payload = {f"chain__{k}": np.stack(v) if len(v) else np.zeros(0)
                   for k, v in self.chain.items()}
        payload["acceptances"] = np.asarray(self._acceptances,
                                            dtype=np.float64)
        payload["divergences"] = np.asarray(self._divergences,
                                            dtype=np.int64)
        if any(u is not None for u in self.Uchain):
            payload["Uchain"] = np.asarray(
                [np.nan if u is None else float(u) for u in self.Uchain])
        if description:
            payload["description"] = description
        for k, v in (attrs or {}).items():
            payload[f"attr__{k}"] = v
        np.savez(fname, **payload)

    def load_chain(self, fname):
        """Resume from a checkpoint (this package's or the JAX
        package's): the chain, acceptances, integer divergences and
        potential energies; the position is the last sample, on the
        device and dtype of the current position."""
        with np.load(fname, allow_pickle=True) as f:
            for key in f.files:
                if key.startswith("chain__"):
                    self.chain[key[len("chain__"):]] = list(f[key])
            self._acceptances = [float(a) for a in f["acceptances"]]
            self._divergences = [int(d) for d in f["divergences"]]
            n = self.Nsamples
            self.Uchain = ([None if np.isnan(u) else float(u)
                            for u in f["Uchain"]] if "Uchain" in f.files
                           else [None] * n)
        if n:
            self.x = ParamDict({
                k: torch.as_tensor(v[-1], dtype=self.x[k].dtype,
                                   device=self.x[k].device)
                for k, v in self.get_chain().items()})
            self._U = self._grad = None


class _Mass:
    """Mass matrix: identity, a diagonal ParamDict (mass), or hmat
    operators per parameter (MatDict): chol L with M = L L^T, or invchol
    L' with M^-1 = L' L'^T."""

    def __init__(self, mass=None, chol=None, invchol=None):
        self.mass = mass
        self.chol = chol
        self.invchol = invchol

    def sample_momentum(self, gen, template):
        """p ~ N(0, M), drawn from gen in key order."""
        xi = ParamDict({k: _normal(gen, template[k])
                        for k in template.keys()})
        if self.mass is not None:
            return xi * self.mass.operator(torch.sqrt)
        if self.chol is not None:
            out = {}
            for k in xi:
                if k in self.chol:
                    op = self.chol[k]
                    f = getattr(op, "chol_mul", op.mat_vec_mul)
                    out[k] = f(xi[k].reshape(-1)).reshape(xi[k].shape)
                else:
                    out[k] = xi[k]
            return ParamDict(out)
        if self.invchol is not None:
            out = {}
            for k in xi:
                if k in self.invchol:
                    op = self.invchol[k]
                    v = xi[k].reshape(-1)
                    y = op.back_sub(v) if hasattr(op, "back_sub") else \
                        torch.linalg.solve(op.to_dense().T, v)
                    out[k] = y.reshape(xi[k].shape)
                else:
                    out[k] = xi[k]
            return ParamDict(out)
        return xi

    def minv(self, p):
        """M^-1 p."""
        if self.mass is not None:
            return p / self.mass
        if self.invchol is not None:
            out = {}
            for k in p:
                if k in self.invchol:
                    op = self.invchol[k]
                    y = _t_matvec(op, p[k].reshape(-1))
                    out[k] = op.mat_vec_mul(y).reshape(p[k].shape)
                else:
                    out[k] = p[k]
            return ParamDict(out)
        if self.chol is not None:
            out = {}
            for k in p:
                if k in self.chol:
                    op = self.chol[k]
                    v = p[k].reshape(-1)
                    if hasattr(op, "forward_sub"):
                        x = op.back_sub(op.forward_sub(v))
                    else:
                        L = op.to_dense()
                        y = torch.linalg.solve_triangular(
                            L, v[:, None], upper=False)
                        x = torch.linalg.solve_triangular(
                            L.T, y, upper=True)[:, 0]
                    out[k] = x.reshape(p[k].shape)
                else:
                    out[k] = p[k]
            return ParamDict(out)
        return p

    def kinetic_t(self, p):
        """K = 0.5 Re(p^H M^-1 p), summed in float64, as a tensor on
        p's device (no host sync)."""
        mp = self.minv(p)
        return 0.5 * sum(torch.sum((p[k].conj() * mp[k]).real,
                                   dtype=torch.float64) for k in p)

    def kinetic(self, p, with_logdet=False):
        """K = 0.5 p^H M^-1 p as a float (+ 0.5 log det M with
        with_logdet, needed if the mass is re-estimated mid-run)."""
        K = float(self.kinetic_t(p))
        if with_logdet:
            K += 0.5 * self.logdet()
        return K

    def logdet(self):
        """log det M over all parameters (0 for identity blocks)."""
        if self.mass is not None:
            return sum(float(torch.sum(torch.log(self.mass[k])))
                       for k in self.mass.keys())

        def op_logdet(op):
            if hasattr(op, "logdet"):
                return float(op.logdet())
            L = op.L if hasattr(op, "L") else op.to_dense()
            return 2.0 * float(torch.sum(torch.log(torch.abs(
                torch.diagonal(L)))))

        if self.chol is not None:
            return sum(op_logdet(self.chol[k]) for k in self.chol.mats)
        if self.invchol is not None:
            return -sum(op_logdet(self.invchol[k])
                        for k in self.invchol.mats)
        return 0.0


def _t_matvec(op, v):
    """op^T v for hmat operators (lazy; never densifies)."""
    return op.t_mat_vec_mul(v)


class StepSize(ParamDict):
    """Per-parameter leapfrog step size: a ParamDict of eps tensors.
    ``StepSize * ParamDict`` multiplies each complex leaf's real and
    imaginary parts by a complex eps's real and imaginary parts; the
    leapfrog's ``ParamDict * eps`` is a plain product, as in the JAX
    package."""

    def _eps_mul(self, x, eps):
        if x.is_complex() and _is_complex(eps):
            return torch.complex(x.real * eps.real, x.imag * eps.imag)
        if x.is_complex():
            return torch.complex(x.real * eps, x.imag * eps)
        return x * eps

    def __mul__(self, other):
        if isinstance(other, ParamDict):
            return ParamDict({k: self._eps_mul(other[k], self[k])
                              for k in self.keys()})
        return StepSize({k: self[k] * other for k in self.keys()})

    def __rmul__(self, other):
        return self.__mul__(other)


class RelativeStepSize(StepSize):
    """Acceptance-driven multiplicative per-parameter step sizes: below
    min_prob the multiplier shrinks by gamma, otherwise it grows by alpha
    (capped at 1); index optionally restricts the multiplier to a subset
    of each parameter; track keeps the multiplier before each update."""

    def __init__(self, params, eps_mul=None, gamma=0.8, min_prob=0.2,
                 alpha=1.25, index=None, track=False):
        super().__init__(dict(params.items()) if hasattr(params, "items")
                         else params)
        self.eps_mul = {k: 1.0 for k in self.keys()} if eps_mul is None \
            else dict(eps_mul)
        self.gamma = gamma
        self.min_prob = min_prob
        self.alpha = alpha
        self.index = index
        self.track = track
        self.chain = [] if track else None

    def effective(self):
        """StepSize of params * eps_mul (index-restricted)."""
        out = {}
        for k in self.keys():
            eps = self[k]
            if self.index is not None and k in self.index:
                eps = torch.as_tensor(eps).clone()
                ix = torch.as_tensor(np.asarray(self.index[k]),
                                     device=eps.device)
                eps[ix] = eps[ix] * self.eps_mul[k]
                out[k] = eps
            else:
                out[k] = eps * self.eps_mul[k]
        return StepSize(out)

    def update(self, accept_prob):
        if self.track:
            self.chain.append(dict(self.eps_mul))
        if accept_prob < self.min_prob:
            self.eps_mul = {k: v * self.gamma
                            for k, v in self.eps_mul.items()}
        else:
            self.eps_mul = {k: np.clip(v * self.alpha, None, 1.0)
                            for k, v in self.eps_mul.items()}
        return self.effective()


class DynamicStepSize:
    """Dual-averaging step-size adaptation (Hoffman & Gelman 2014). eps0
    is a number or a per-parameter StepSize base, which the dual-averaged
    scalar then multiplies; after Nadapt updates the averaged step
    freezes."""

    def __init__(self, eps0=0.1, target=0.8, gamma=0.05, t0=10, kappa=0.75,
                 Nadapt=None):
        self.base = None
        if hasattr(eps0, "keys"):
            self.base = eps0 if isinstance(eps0, StepSize) \
                else StepSize(dict(eps0.items()))
            scale0 = 1.0
        else:
            scale0 = float(eps0)
        self.eps = self._eff(scale0)
        self.mu = np.log(10 * scale0)
        self.target = target
        self.gamma = gamma
        self.t0 = t0
        self.kappa = kappa
        self.t = 0
        self.Hbar = 0.0
        self.log_eps_bar = np.log(scale0)
        self.Nadapt = Nadapt
        self.frozen = False

    def _eff(self, scale):
        return self.base * scale if self.base is not None else scale

    def update(self, accept_prob):
        if self.frozen:
            return self.eps
        self.t += 1
        if self.Nadapt is not None and self.t > self.Nadapt:
            self.frozen = True
            self.eps = self._eff(float(np.exp(self.log_eps_bar)))
            return self.eps
        eta = 1.0 / (self.t + self.t0)
        self.Hbar = (1 - eta) * self.Hbar + eta * (self.target - accept_prob)
        log_eps = self.mu - np.sqrt(self.t) / self.gamma * self.Hbar
        w = self.t ** (-self.kappa)
        self.log_eps_bar = w * log_eps + (1 - w) * self.log_eps_bar
        self.eps = self._eff(float(np.exp(log_eps)))
        return self.eps


def _start_points(x, Nchain, x0):
    """The chains' starting ParamDicts: x for every chain, a list, or a
    ParamDict whose leaves carry a leading chain axis."""
    if x0 is None:
        return [x] * int(Nchain)
    if isinstance(x0, (list, tuple)):
        return [q.detach() for q in x0]
    n = int(x0[next(iter(x0.keys()))].shape[0])
    return [ParamDict({k: v[c].detach() for k, v in x0.items()})
            for c in range(n)]


def _chains_result(qs, extra):
    """JAX's sample_chains dict from per-chain lists of positions and of
    per-sample records."""
    keys = qs[0][0].keys()
    out = {"chain": {k: np.stack([np.stack([_np(q[k]) for q in ch])
                                  for ch in qs]) for k in keys}}
    out.update({name: np.asarray(v) for name, v in extra.items()})
    out["acceptance_rate"] = out["accept_prob"].mean(axis=1)
    out["final"] = ParamDict({k: torch.stack([ch[-1][k] for ch in qs])
                             for k in keys})
    return out


class HMC(SamplerBase):
    """Hamiltonian Monte Carlo with a Metropolis test, divergence
    recovery, step-size adaptation (adapt_eps True / 'dual': dual
    averaging; 'relative': RelativeStepSize), a momentum mask (pmask: a
    [0, 1] ParamDict, zeros freeze parameters) and Nstep jitter."""

    def __init__(self, potential, x0, eps=0.1, Nstep=10, mass=None,
                 chol=None, invchol=None, dHmax=1000.0, seed=0,
                 adapt_eps=False, adapt_kwargs=None, jitter_Nstep=False,
                 pmask=None, on_device="auto"):
        super().__init__(x0, seed)
        self.potential = potential
        self.eps = eps
        self.Nstep = Nstep
        self.mass = _Mass(mass, chol, invchol)
        self.dHmax = dHmax
        self.fn_evals = 0
        self.jitter_Nstep = jitter_Nstep
        self.pmask = pmask
        if adapt_eps == "relative":
            if not hasattr(eps, "keys"):
                raise ValueError("adapt_eps='relative' needs a per-param "
                                 "eps ParamDict")
            self.stepsize = RelativeStepSize(eps, **(adapt_kwargs or {}))
            self.eps = self.stepsize.effective()
        elif adapt_eps:
            self.stepsize = DynamicStepSize(eps, **(adapt_kwargs or {}))
        else:
            self.stepsize = None
        self._U = None
        self._grad = None
        # every trajectory's dH, and the last one's (position, momentum,
        # U at its start, U at its end)
        self.dHs = []
        self.last_proposal = None

    def dUdx(self, x, Ucache=None, **kwargs):
        """Potential and gradient at x; Ucache, if a list, collects the
        potential value."""
        self.fn_evals += 1
        out = self.potential(x)
        if Ucache is not None:
            Ucache.append(out[0])
        return out

    def _energy(self, U, p):
        """H = U + K as a float64 tensor (no host sync)."""
        return _f64(U) + self.mass.kinetic_t(p)

    def K(self, p):
        """Kinetic energy 0.5 p^H M^-1 p under the current mass."""
        return self.mass.kinetic(p)

    def is_divergent(self, H_start, H_end):
        return (H_end - H_start) > self.dHmax

    def apply_pmask(self, momentum, pmask=None):
        """Multiply a momentum ParamDict by a [0, 1] mask."""
        pmask = pmask if pmask is not None else self.pmask
        if pmask is None:
            return momentum
        return ParamDict({k: momentum[k] * pmask[k] if k in pmask
                          else momentum[k] for k in momentum.keys()})

    def draw_momentum(self):
        """p ~ N(0, M), pmask applied."""
        return self.apply_pmask(self.mass.sample_momentum(self._gen, self.x))

    def set_chol(self, cov_L=None, hess_L=None, diag_mass=True):
        """Reset the mass matrix from Cholesky factors: M = Hessian,
        covariance C = M^-1. diag_mass: DIAGONAL factors (number or
        ParamDict), M = hess_L^2 = cov_L^-2; otherwise per-key operators
        (MatDict) with M = Lm Lm^T (hess_L) or M^-1 = Lc Lc^T (cov_L)."""
        if diag_mass:
            mass = None
            L = hess_L if hess_L is not None else cov_L
            if L is not None:
                if not hasattr(L, "keys"):
                    L = ParamDict({k: torch.as_tensor(
                        L, dtype=self.x[k].real.dtype,
                        device=self.x[k].device) for k in self.x.keys()})
                mass = L * L
                if hess_L is None:
                    mass = mass.operator(lambda x: 1.0 / x)
            self.mass = _Mass(mass=mass)
        else:
            self.mass = _Mass(chol=hess_L, invchol=cov_L)

    def dual_averaging(self, Nadapt, target=0.8, gamma=0.05, t0=10.0,
                       kappa=0.75):
        """Adapt the step size by dual averaging over the next Nadapt
        steps, from the current eps; then it freezes."""
        self.stepsize = DynamicStepSize(self.eps, target=target, gamma=gamma,
                                        t0=t0, kappa=kappa, Nadapt=Nadapt)

    def step(self, sample_p=True):
        """One HMC step: a trajectory, one host read of (dH, U0, U1), the
        Metropolis test; a divergent trajectory (dH not finite or above
        dHmax) restarts from a random chain sample. sample_p=False
        reuses self.p."""
        if sample_p or getattr(self, "p", None) is None:
            p = self.draw_momentum()
        else:
            p = self.p
        self.p = p
        if self._U is None:
            self._U, self._grad = self.dUdx(self.x)
        nstep = self.Nstep
        if self.jitter_Nstep:
            nstep = self._randint(1, self.Nstep + 1)
        H0 = self._energy(self._U, p)
        q_new, p_new, U_new, grad_new, _ = leapfrog(
            self.x, p, self.dUdx, self.eps, nstep, self.mass.minv)
        H1 = self._energy(U_new, p_new)
        dH, U0, U1 = torch.stack([H1 - H0, _f64(self._U).to(H0.device),
                                  _f64(U_new).to(H0.device)]).tolist()
        self.dHs.append(dH)
        self.last_proposal = (q_new, p_new, U0, U1)

        if not np.isfinite(dH) or dH > self.dHmax:
            self._divergences.append(self.Nsamples)
            if self.Nsamples > 1:
                idx = self._randint(0, self.Nsamples)
                self.x = ParamDict({k: torch.as_tensor(
                    self.chain[k][idx], device=self.x[k].device)
                    for k in self.chain})
                self._U = None
            self.append_chain(self.x)
            self._acceptances.append(0.0)
            if self.stepsize is not None:
                self.eps = self.stepsize.update(0.0)
            return False

        accept_prob = _accept_prob(-dH)
        accepted = self._u() < accept_prob
        if accepted:
            self.x = q_new
            self._U, self._grad = U_new, grad_new
        U = U1 if accepted else U0
        self.append_chain(self.x, U=U)
        self._acceptances.append(accept_prob)
        self.Usteps.append(U)
        if self.stepsize is not None:
            self.eps = self.stepsize.update(accept_prob)
        return accepted

    def sample_chains(self, Nsample, Nchain=4, x0=None, seed=None,
                      Nstep=None, eps=None):
        """Nchain independent HMC chains of Nsample samples, one after
        another, chain c drawing from generators seeded by (seed, c)
        (seed default: drawn from the sampler's own stream). A divergent
        trajectory is rejected in place and flagged; no restart and no
        step-size adaptation (run dual_averaging + sample first).

        x0: None (every chain starts at self.x), a list of ParamDicts, or
        a ParamDict whose leaves carry a leading chain axis.

        Returns a dict: ``chain`` {key: (Nchain, Nsample, *shape)}, ``U``,
        ``accept_prob``, ``divergent`` (bool), each (Nchain, Nsample),
        ``acceptance_rate`` (Nchain,) and ``final`` (a ParamDict of
        tensors with a leading chain axis).
        """
        nstep = int(Nstep if Nstep is not None else self.Nstep)
        eps = eps if eps is not None else self.eps
        starts = _start_points(self.x, Nchain, x0)
        if seed is None:
            seed = self._randint(0, 2 ** 31 - 1)
        qs, rec = [], {"U": [], "accept_prob": [], "divergent": []}
        for c, q in enumerate(starts):
            gen, host = _generators([int(seed), c], self._device())
            chain, us, aps, divs = [], [], [], []
            for _ in range(int(Nsample)):
                p = self.apply_pmask(self.mass.sample_momentum(gen, q))
                U0, g0 = self.dUdx(q)
                H0 = self._energy(U0, p)
                q1, p1, U1, _, _ = leapfrog(q, p, self.dUdx, eps, nstep,
                                            self.mass.minv, dUdq0=g0)
                H1 = self._energy(U1, p1)
                dH, u0, u1 = torch.stack([H1 - H0, _f64(U0).to(H0.device),
                                          _f64(U1).to(H0.device)]).tolist()
                divergent = not np.isfinite(dH) or dH > self.dHmax
                ap = 0.0 if divergent else _accept_prob(-dH)
                acc = self._u(host) < ap
                if acc:
                    q = q1
                chain.append(q)
                us.append(u1 if acc else u0)
                aps.append(ap)
                divs.append(divergent)
            qs.append(chain)
            for name, v in zip(("U", "accept_prob", "divergent"),
                               (us, aps, divs)):
                rec[name].append(v)
        return _chains_result(qs, rec)

    def estimate_cov(self, Nback=None, diag_mass=True, robust=False,
                     eps=None, set_mass=True, burn=0):
        """Parameter covariance from the Nback most recent chain samples,
        installed as the mass matrix by default: per-element variances
        (robust: (1.42 MAD)^2) as a diagonal mass 1/var, or dense sample
        covariances (plus eps[k] on the diagonal) whose Cholesky factors
        become the inverse-mass factors. Returns a ParamDict of variances
        (diag_mass) or a dict of dense covariances."""
        ch = self.get_chain(burn=burn)
        eps = eps if eps is not None else {k: 0.0 for k in ch}
        variances, chols, covs = {}, {}, {}
        for k, v in ch.items():
            c = v.reshape(len(v), -1)
            if Nback is not None:
                c = c[-Nback:]
            ref = self.x[k]
            if diag_mass:
                if robust:
                    med = np.median(c, axis=0)
                    var = (1.42 * np.median(np.abs(c - med), axis=0)) ** 2
                else:
                    var = np.var(c, axis=0)
                variances[k] = torch.as_tensor(var.reshape(v.shape[1:]),
                                               device=ref.device)
            else:
                cov = np.atleast_2d(np.cov(c.T))
                covs[k] = cov
                chols[k] = torch.as_tensor(np.linalg.cholesky(
                    cov + np.eye(len(cov)) * float(eps[k])),
                    device=ref.device)
        if diag_mass:
            if set_mass:
                self.mass = _Mass(mass=ParamDict(
                    {k: 1.0 / torch.clamp(v, min=1e-30)
                     for k, v in variances.items()}))
            return ParamDict(variances)
        if set_mass:
            self.mass = _Mass(invchol=MatDict(
                {k: TriangMat(L) for k, L in chols.items()}))
        return covs


class RecycledHMC(HMC):
    """Recycled-momentum HMC (Nishimura & Dunson 2020): every
    intermediate leapfrog state of a trajectory is tested against the
    start's energy and stored as a sample. The trajectory evaluates the
    gradient at its start and then once a step (Nstep + 1 evaluations,
    as the JAX package's trajectory does), and the states' energies are
    read from the device once."""

    def step(self):
        p = self.mass.sample_momentum(self._gen, self.x)
        if self._U is None:
            self._U, self._grad = self.dUdx(self.x)
        H0 = self._energy(self._U, p)
        Minv, eps = self.mass.minv, self.eps
        q = self.x
        _, g = self.dUdx(q)
        states, Hs = [], []
        for _ in range(self.Nstep):
            p1 = p - g * (eps * 0.5)
            q = q + Minv(p1) * eps
            U, g = self.dUdx(q)
            p = p1 - g * (eps * 0.5)
            states.append((q, U, g))
            Hs.append(self._energy(U, p))
        dHs = (torch.stack(Hs) - H0).tolist()
        any_acc = False
        for (q, U, grad), dH in zip(states, dHs):
            self.dHs.append(dH)
            if not np.isfinite(dH):
                continue
            ap = _accept_prob(-dH)
            if self._u() < ap:
                self.x = q
                self._U, self._grad = U, grad
                any_acc = True
            self.append_chain(self.x)
            self._acceptances.append(ap)
        return any_acc


class NUTS(SamplerBase):
    """No-U-Turn Sampler.

    tree_variant 'slice' (default): Hoffman & Gelman Alg. 3 with slice
    sampling and recursive doubling (the JAX package's host tree).
    'reference': the original BayesLIM merge-trees NUTS (biased
    progressive sampling with multinomial logaddexp weights, the raw-
    momentum u-turn check, a final Metropolis test on the active state);
    biased and sample_direction are its options.
    """

    def __init__(self, potential, x0, eps=0.1, mass=None, chol=None,
                 invchol=None, max_treedepth=8, dHmax=1000.0, seed=0,
                 adapt_eps=False, adapt_kwargs=None, on_device="auto",
                 tree_variant="slice", biased=True, sample_direction=True):
        super().__init__(x0, seed)
        if tree_variant not in ("slice", "reference"):
            raise ValueError(f"unknown tree_variant {tree_variant!r}")
        self.potential = potential
        self.eps = eps
        self.mass = _Mass(mass, chol, invchol)
        self.max_treedepth = max_treedepth
        self.dHmax = dHmax
        self.fn_evals = 0
        self.stepsize = DynamicStepSize(eps, **(adapt_kwargs or {})) \
            if adapt_eps else None
        self.tree_depths = []
        self.tree_variant = tree_variant
        self.biased = biased
        self.sample_direction = sample_direction

    set_chol = HMC.set_chol
    K = HMC.K
    is_divergent = HMC.is_divergent

    def dUdx(self, x):
        self.fn_evals += 1
        return self.potential(x)

    def _HU(self, U, p):
        """(H = U + K, U) read from the device in one sync."""
        U = _f64(U)
        H = U + self.mass.kinetic_t(p)
        return tuple(torch.stack([H, U.to(H.device)]).tolist())

    def _dots(self, pairs):
        """Re(a . b) summed over keys for each (a, b) pair, read from the
        device in one sync."""
        return torch.stack([sum(torch.sum((a[k].conj() * b[k]).real,
                                          dtype=torch.float64)
                                for k in a.keys())
                            for a, b in pairs]).tolist()

    def _uturn(self, q_minus, q_plus, p_minus, p_plus):
        """Hoffman's u-turn criterion under the mass."""
        dq = q_plus - q_minus
        a, b = self._dots([(dq, self.mass.minv(p_minus)),
                           (dq, self.mass.minv(p_plus))])
        return a < 0 or b < 0

    def _leap1(self, q, p, direction):
        q2, p2, U2, _, _ = leapfrog(q, p, self.dUdx, self.eps * direction,
                                    1, self.mass.minv)
        return q2, p2, U2

    # ---- tree_variant='slice'
    def _build_tree(self, q, p, logu, direction, depth, H0):
        """Recursive doubling (Alg. 3). Returns (q-, p-, q+, p+,
        proposal, its U, n, s, alpha sum, alpha count)."""
        if depth == 0:
            q2, p2, U2 = self._leap1(q, p, direction)
            H2, U2 = self._HU(U2, p2)
            n2 = int(logu <= -H2)
            s2 = int(logu < self.dHmax - H2)
            return (q2, p2, q2, p2, q2, U2, n2, s2,
                    _accept_prob(H0 - H2), 1)
        qm, pm, qp, pp, q2, U2, n2, s2, a2, na2 = self._build_tree(
            q, p, logu, direction, depth - 1, H0)
        if s2:
            if direction == -1:
                qm, pm, _, _, q3, U3, n3, s3, a3, na3 = self._build_tree(
                    qm, pm, logu, direction, depth - 1, H0)
            else:
                _, _, qp, pp, q3, U3, n3, s3, a3, na3 = self._build_tree(
                    qp, pp, logu, direction, depth - 1, H0)
            if n3 > 0 and self._u() < n3 / max(n2 + n3, 1):
                q2, U2 = q3, U3
            a2 += a3
            na2 += na3
            s2 = s3 * int(not self._uturn(qm, qp, pm, pp))
            n2 += n3
        return qm, pm, qp, pp, q2, U2, n2, s2, a2, na2

    def _slice_draw(self, x, p0):
        """One slice-variant transition from x with momentum p0: returns
        (new position, its U, mean acceptance statistic, tree depth)."""
        U0, _ = self.dUdx(x)
        H0, U_keep = self._HU(U0, p0)
        logu = -H0 + float(np.log(self._u() + 1e-300))
        qm = qp = x_keep = x
        pm = pp = p0
        n, s, depth = 1, 1, 0
        alpha, nalpha = 0.0, 0
        while s and depth < self.max_treedepth:
            direction = 1 if self._u() < 0.5 else -1
            if direction == -1:
                qm, pm, _, _, q2, U2, n2, s2, a2, na2 = self._build_tree(
                    qm, pm, logu, direction, depth, H0)
            else:
                _, _, qp, pp, q2, U2, n2, s2, a2, na2 = self._build_tree(
                    qp, pp, logu, direction, depth, H0)
            if s2 and self._u() < min(1.0, n2 / max(n, 1)):
                x_keep, U_keep = q2, U2
            n += n2
            alpha += a2
            nalpha += na2
            s = s2 * int(not self._uturn(qm, qp, pm, pp))
            depth += 1
        return x_keep, U_keep, alpha / max(nalpha, 1), depth

    def step(self, sample_p=True):
        if self.tree_variant == "reference":
            return self._step_reference(sample_p=sample_p)
        p0 = self.mass.sample_momentum(self._gen, self.x) \
            if sample_p or getattr(self, "p", None) is None else self.p
        self.x, U, ap, depth = self._slice_draw(self.x, p0)
        self.append_chain(self.x, U=U)
        self._acceptances.append(ap)
        self.tree_depths.append(depth)
        if self.stepsize is not None:
            self.eps = self.stepsize.update(ap)
        return True

    def sample_chains(self, Nsample, Nchain=4, x0=None, seed=None,
                      eps=None):
        """Nchain independent slice-variant NUTS chains of Nsample
        draws, one after another, chain c drawing from generators seeded
        by (seed, c); no step-size adaptation.

        Returns a dict: ``chain`` {key: (Nchain, Nsample, *shape)}, ``U``,
        ``accept_prob``, ``tree_depth``, each (Nchain, Nsample),
        ``acceptance_rate`` (Nchain,) and ``final``.
        """
        starts = _start_points(self.x, Nchain, x0)
        if seed is None:
            seed = self._randint(0, 2 ** 31 - 1)
        saved = (self._gen, self._host, self.eps)
        if eps is not None:
            self.eps = eps
        qs, rec = [], {"U": [], "accept_prob": [], "tree_depth": []}
        try:
            for c, q in enumerate(starts):
                self._gen, self._host = _generators([int(seed), c],
                                                    self._device())
                chain, us, aps, depths = [], [], [], []
                for _ in range(int(Nsample)):
                    p0 = self.mass.sample_momentum(self._gen, q)
                    q, U, ap, depth = self._slice_draw(q, p0)
                    chain.append(q)
                    us.append(U)
                    aps.append(ap)
                    depths.append(depth)
                qs.append(chain)
                for name, v in zip(("U", "accept_prob", "tree_depth"),
                                   (us, aps, depths)):
                    rec[name].append(v)
        finally:
            self._gen, self._host, self.eps = saved
        return _chains_result(qs, rec)

    # ---- tree_variant='reference': the uniform draws come in the
    # reference's order: one direction a doubling, one a merge inside a
    # tree (bottom-up), one a step-level merge, one final Metropolis.
    def _ref_uturn(self, qm, qp_, pm, pp_):
        """The reference's u-turn check: raw momentum (no mass inverse),
        conjugated position difference."""
        dq = qp_ - qm
        a, b = self._dots([(dq, pm), (dq, pp_)])
        return a < 0 or b < 0

    def _ref_basetree(self, q, p, direction, H0):
        """Depth-0 tree: one leapfrog step, node weight
        logaddexp(-H_start, -H_new) as in the reference. A NaN H is not
        divergent (NaN > dHmax is False), as in the reference."""
        q2, p2, U2 = self._leap1(q, p, direction)
        H2, U2 = self._HU(U2, p2)
        return dict(ql=q2, pl=p2, qr=q2, pr=p2, qp=q2, pp=p2, U=U2,
                    H=H2, w=float(np.logaddexp(-H0, -H2)), turning=False,
                    diverging=(H2 - H0) > self.dHmax)

    def _ref_merge(self, old, new, new_right):
        """Biased (or uniform) progressive sampling of two trees."""
        if self.biased:
            prob = _accept_prob(new["w"] - old["w"])
        else:
            prob = _accept_prob(new["w"] - np.logaddexp(old["w"], new["w"]))
        m = dict(new if self._u() < prob else old)
        left, right = (old, new) if new_right else (new, old)
        m["ql"], m["pl"] = left["ql"], left["pl"]
        m["qr"], m["pr"] = right["qr"], right["pr"]
        m["w"] = float(np.logaddexp(old["w"], new["w"]))
        m["turning"] = old["turning"] or new["turning"]
        m["diverging"] = old["diverging"] or new["diverging"]
        return m

    def _ref_build(self, q, p, direction, depth, H0, base):
        """Recursive doubling: both halves always built, merged with one
        uniform, then the u-turn check against the base tree's far
        edge."""
        if depth == 0:
            return self._ref_basetree(q, p, direction, H0)
        half = self._ref_build(q, p, direction, depth - 1, H0, base)
        qs, ps_ = (half["qr"], half["pr"]) if direction > 0 \
            else (half["ql"], half["pl"])
        other = self._ref_build(qs, ps_, direction, depth - 1, H0, base)
        m = self._ref_merge(half, other, new_right=direction > 0)
        if direction > 0:
            qm, pm, qp_, pp_ = base["ql"], base["pl"], m["qr"], m["pr"]
        else:
            qm, pm, qp_, pp_ = m["ql"], m["pl"], base["qr"], base["pr"]
        m["turning"] = m["turning"] or self._ref_uturn(qm, qp_, pm, pp_)
        return m

    def _step_reference(self, sample_p=True):
        """One reference-semantics step: doublings merged into a base
        tree, a final Metropolis test on the active state; a divergence
        below depth 2 restarts from a random chain position."""
        if sample_p or getattr(self, "p", None) is None:
            p = self.mass.sample_momentum(self._gen, self.x)
        else:
            p = self.p
        U0, _ = self.dUdx(self.x)
        H0, U0 = self._HU(U0, p)
        base = dict(ql=self.x, pl=p, qr=self.x, pr=p, qp=self.x, pp=p,
                    U=U0, H=H0, w=-H0, turning=False, diverging=False)
        depth = 0
        new = base
        while depth < self.max_treedepth:
            direction = (1 if self._u() > 0.5 else -1) \
                if self.sample_direction else 1
            qs, ps_ = (base["qr"], base["pr"]) if direction > 0 \
                else (base["ql"], base["pl"])
            new = self._ref_build(qs, ps_, direction, depth, H0, base)
            if new["diverging"] or new["turning"]:
                break
            base = self._ref_merge(base, new, direction > 0)
            depth += 1

        if new["diverging"]:
            self._divergences.append(self.Nsamples)
            if self.Nsamples > 0 and depth < 2:
                idx = self._randint(0, self.Nsamples)
                self.x = ParamDict({k: torch.as_tensor(
                    self.chain[k][idx], device=self.x[k].device)
                    for k in self.chain})
                self.append_chain(self.x)
                self._acceptances.append(0.0)
                self.tree_depths.append(depth)
                return False

        prob = _accept_prob(H0 - base["H"])
        accept = bool(self._u() < prob)
        if accept:
            self.x = base["qp"]
            self.p = base["pp"]
            U = base["U"]
        else:
            U = U0
        self.append_chain(self.x, U=U)
        self._acceptances.append(prob)
        self.tree_depths.append(depth)
        if self.stepsize is not None:
            self.eps = self.stepsize.update(prob)
        return accept
