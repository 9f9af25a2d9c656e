"""The port's inference/sampler.py against the JAX package's at float64
on the CPU.

Trajectories are held draw for draw: both packages get the same white
noise for their momenta and the same uniform and integer stream, from
one numpy Generator each (the port through its own draw methods, the
JAX package by replacing ``jax.random``'s normal / uniform / randint as
its sampler module sees them, in the test only). The port's own
properties (moments of sample_chains, complex leaves, chains carried
across packages, the JAX faults it does not copy) are tested on the
port. Queue C1 (ROADMAP): what the JAX HMC and NUTS do to a complex
leaf."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.inference import hmat as jh
from bayeslim_tpu.inference import sampler as jsampler
from bayeslim_tpu.utils import ParamDict as JParamDict
from bayeslim_tpu_torch.inference import hmat as th
from bayeslim_tpu_torch.inference import sampler as tsampler
from bayeslim_tpu_torch.utils import ParamDict

TOL = 1e-9


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


# ---------------------------------------------------------------------------
# the two packages, a Gaussian target in each, and one draw stream
# ---------------------------------------------------------------------------

def _gauss_spec():
    """Independent Gaussians per key: (mean, covariance over the raveled
    key)."""
    rng = np.random.default_rng(0)
    La = np.array([[1.0, 0.0], [0.5, 0.8]])
    Lb = np.tril(rng.standard_normal((4, 4))) * 0.3 + np.eye(4)
    x = np.linspace(0, 1, 16)
    Kc = np.exp(-(x[:, None] - x[None]) ** 2 / 0.3 ** 2) + 0.5 * np.eye(16)
    return {"a": (np.array([1.0, -2.0]), La @ La.T, (2,)),
            "b": (rng.standard_normal(4), Lb @ Lb.T, (2, 2)),
            "c": (np.zeros(16), Kc, (16,))}


class _Gauss:
    """U = sum_k 0.5 r_k^T icov_k r_k, r_k = x_k - mu_k (raveled), and
    its gradient, in the package P's arithmetic."""

    def __init__(self, P, spec=None, keys=None):
        spec = spec or _gauss_spec()
        keys = keys or sorted(spec)
        self.P = P
        self.mu = {k: P.arr(spec[k][0]) for k in keys}
        self.icov = {k: P.arr(np.linalg.inv(spec[k][1])) for k in keys}
        self.shape = {k: spec[k][2] for k in keys}

    def __call__(self, x):
        U, g = 0.0, {}
        for k in self.mu:
            r = x[k].reshape(-1) - self.mu[k]
            icov = self.icov[k]
            if isinstance(r, torch.Tensor):
                icov = icov.to(r.dtype)
            gk = icov @ r
            U = U + 0.5 * r @ gk
            g[k] = gk.reshape(self.shape[k])
        return U, self.P.PD(g)


J = types.SimpleNamespace(name="jax", PD=JParamDict, s=jsampler, h=jh,
                          arr=lambda x: jnp.asarray(np.asarray(x)))
T = types.SimpleNamespace(name="torch", PD=ParamDict, s=tsampler, h=th,
                          arr=lambda x: torch.as_tensor(np.asarray(x)))


def _x0(P, keys=("a", "b", "c")):
    rng = np.random.default_rng(1)
    spec = _gauss_spec()
    return P.PD({k: P.arr(rng.standard_normal(spec[k][2])) for k in keys})


class Feed:
    """One numpy stream of white noise, uniforms and integers."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape):
        return self.rng.standard_normal(shape)

    def u(self, *_):
        return float(self.rng.uniform())

    def randint(self, low, high):
        return int(self.rng.integers(low, high))


def _feed_jax(monkeypatch, feed):
    """The JAX sampler module sees a jax whose random.normal / uniform /
    randint read the feed (everything else is jax's own)."""
    class Random:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        def normal(self, key, shape=(), dtype=float):
            return jnp.asarray(feed.normal(shape), dtype)

        def uniform(self, key, shape=(), *a, **k):
            return jnp.asarray(feed.u())

        def randint(self, key, shape, minval, maxval, *a, **k):
            return jnp.asarray(feed.randint(minval, maxval))

    class Jax:
        random = Random()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(jsampler, "jax", Jax())


def _feed_torch(monkeypatch, sampler, feed):
    monkeypatch.setattr(tsampler, "_normal", lambda gen, t: torch.as_tensor(
        feed.normal(tuple(t.shape)), dtype=t.dtype, device=t.device))
    sampler._u = feed.u
    sampler._randint = feed.randint


def _same(js, ts, evals=True, depths=False):
    """The two samplers' records agree (chain to 1e-9)."""
    assert ts.Nsamples == js.Nsamples > 0
    jc, tc = js.get_chain(), ts.get_chain()
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert _relerr(tc[k], jc[k]) <= TOL, k
    np.testing.assert_allclose(ts._acceptances, js._acceptances, rtol=TOL,
                               atol=1e-12)
    assert ts._divergences == [int(d) for d in js._divergences]
    if evals:
        assert ts.fn_evals == js.fn_evals
    if depths:
        assert ts.tree_depths == js.tree_depths


def _run(monkeypatch, make, nstep, between=None, seed=3, evals=True,
         depths=False):
    """Build the sampler in both packages, feed both one stream, run
    nstep steps (between(P, sampler, i) after step i, if given)."""
    out = {}
    for P in (J, T):
        feed = Feed(seed)
        with monkeypatch.context() as m:
            s = make(P)
            if P is J:
                _feed_jax(m, feed)
            else:
                _feed_torch(m, s, feed)
            for i in range(nstep):
                s.step()
                if between is not None:
                    between(P, s, i)
        out[P.name] = s
    _same(out["jax"], out["torch"], evals=evals, depths=depths)
    return out["jax"], out["torch"]


# ---------------------------------------------------------------------------
# leapfrog
# ---------------------------------------------------------------------------

def _mass_forms(P):
    spec = _gauss_spec()
    La = np.linalg.cholesky(spec["a"][1])
    return {
        "identity": {},
        "Minv": dict(Minv=lambda x: x * P.PD({"a": P.arr([1.0, 0.5]),
                                              "b": P.arr(0.7),
                                              "c": P.arr(1.3)})),
        "cov_L_scalar": dict(cov_L=0.8),
        "cov_L_diag": dict(cov_L=P.PD({"a": P.arr([1.0, 0.5]),
                                       "b": P.arr(np.full((2, 2), 0.9)),
                                       "c": P.arr(1.1)})),
        "cov_L_dense": dict(cov_L={"a": P.arr(La), "b": P.arr(np.eye(4)),
                                   "c": P.arr(np.eye(16))},
                            diag_mass=False),
    }


def _eps_forms(P):
    return {"scalar": 0.2,
            "stepsize": P.s.StepSize({"a": P.arr([0.1, 0.2]),
                                      "b": P.arr(np.full((2, 2), 0.15)),
                                      "c": P.arr(0.1)}),
            "complex": 0.2 + 0.05j}


@pytest.mark.parametrize("eps", ["scalar", "stepsize", "complex"])
@pytest.mark.parametrize("mass", ["identity", "Minv", "cov_L_scalar",
                                  "cov_L_diag", "cov_L_dense"])
def test_leapfrog_matches_jax(mass, eps):
    """leapfrog under every mass form and step-size form: positions,
    momenta, U, gradient, evaluations and the per-step states."""
    res = {}
    for P in (J, T):
        pot = _Gauss(P)
        q = _x0(P)
        p = _x0(P).operator(lambda v: v * 0.5 + 0.1)
        kw = dict(_mass_forms(P)[mass])
        if mass == "cov_L_dense":
            q = P.PD({k: q[k].reshape(-1) for k in q.keys()})
            p = P.PD({k: p[k].reshape(-1) for k in p.keys()})
            pot.shape = {k: (v.shape[0],) for k, v in pot.mu.items()}
            e = 0.2 if eps == "stepsize" else _eps_forms(P)[eps]
        else:
            e = _eps_forms(P)[eps]
        states = []
        res[P.name] = P.s.leapfrog(q, p, pot, e, 4, states=states, **kw) \
            + (states,)
    (qj, pj, Uj, gj, nj, sj), (qt, pt, Ut, gt, nt, st) = res["jax"], \
        res["torch"]
    assert nt == nj == 5
    assert abs(complex(Ut) - complex(Uj)) <= TOL * abs(complex(Uj))
    for a, b in ((qt, qj), (pt, pj), (gt, gj)):
        for k in b.keys():
            assert _relerr(a[k].numpy(), b[k]) <= TOL, k
    assert len(st) == len(sj) == 4
    for (a, b), (c, d) in zip(st, sj):
        for k in c.keys():
            assert _relerr(a[k].numpy(), c[k]) <= TOL
            assert _relerr(b[k].numpy(), d[k]) <= TOL


@pytest.mark.parametrize("op", ["dense", "solve", "solve_hier"])
def test_leapfrog_hmat_cov_L_matches_jax(op):
    """cov_L as an hmat operator acting on a flat position, and dUdq0."""
    spec = _gauss_spec()
    K = spec["c"][1]
    res = {}
    for P in (J, T):
        mk = {"dense": lambda: P.h.DenseMat(P.arr(np.linalg.inv(K))),
              "solve": lambda: P.h.SolveMat(A=P.arr(K)),
              "solve_hier": lambda: P.h.SolveHierMat(P.h.make_hodlr(
                  P.arr(K), min_size=4, rank=8))}[op]
        icov = P.arr(np.linalg.inv(K))

        def pot(x, icov=icov):
            return 0.5 * x @ icov @ x, icov @ x
        rng = np.random.default_rng(2)
        q, p = P.arr(rng.standard_normal(16)), P.arr(rng.standard_normal(16))
        g0 = pot(q)[1]
        res[P.name] = P.s.leapfrog(q, p, pot, 0.3, 6, cov_L=mk(), dUdq0=g0)
    for a, b in zip(res["torch"][:4], res["jax"][:4]):
        assert _relerr(np.asarray(a), np.asarray(b)) <= TOL
    assert res["torch"][4] == res["jax"][4] == 6


def test_multiply_eps_and_stepsize_match_jax():
    rng = np.random.default_rng(3)
    z = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    r = rng.standard_normal(5)
    for x in (z, r):
        for eps in (0.3, 0.3 + 0.7j):
            a = tsampler.multiply_eps(torch.as_tensor(x), eps)
            b = jsampler.multiply_eps(jnp.asarray(x), eps)
            assert _relerr(a.numpy(), b) <= TOL
    se = {"z": z * 0.1, "r": r}
    a = tsampler.StepSize({k: torch.as_tensor(v) for k, v in se.items()}) \
        * ParamDict({"z": torch.as_tensor(z), "r": torch.as_tensor(r)})
    b = jsampler.StepSize({k: jnp.asarray(v) for k, v in se.items()}) \
        * JParamDict({"z": jnp.asarray(z), "r": jnp.asarray(r)})
    for k in ("z", "r"):
        assert _relerr(a[k].numpy(), b[k]) <= TOL


# ---------------------------------------------------------------------------
# HMC, draw for draw
# ---------------------------------------------------------------------------

def _hmc_configs():
    spec = _gauss_spec()
    La = np.linalg.cholesky(np.linalg.inv(spec["a"][1]))
    Lb = np.linalg.cholesky(spec["b"][1])

    def hmc(P, **kw):
        kw.setdefault("eps", 0.3)
        kw.setdefault("Nstep", 5)
        return P.s.HMC(_Gauss(P), _x0(P), seed=0, **kw)
    return {
        "identity": lambda P: hmc(P),
        "diag_mass": lambda P: hmc(P, mass=P.PD({
            "a": P.arr([1.0, 4.0]), "b": P.arr(np.full((2, 2), 2.0)),
            "c": P.arr(np.full(16, 0.5))})),
        "chol_dense": lambda P: hmc(P, chol=P.h.MatDict(
            {"a": P.h.DenseMat(P.arr(La))})),
        "chol_solve_hier": lambda P: hmc(P, chol=P.h.MatDict(
            {"c": P.h.SolveHierMat(P.h.make_hodlr(
                P.arr(np.linalg.inv(spec["c"][1])), min_size=4, rank=8))})),
        "invchol_triang": lambda P: hmc(P, invchol=P.h.MatDict(
            {"b": P.h.TriangMat(P.arr(Lb))})),
        "pmask": lambda P: hmc(P, pmask=P.PD({"a": P.arr([1.0, 0.0])})),
        "jitter_Nstep": lambda P: hmc(P, jitter_Nstep=True, Nstep=8),
        "dual_eps": lambda P: hmc(P, eps=0.9, adapt_eps=True,
                                  adapt_kwargs=dict(target=0.8, Nadapt=6)),
        "relative_eps": lambda P: hmc(
            P, eps=P.PD({"a": P.arr([0.3, 0.2]),
                         "b": P.arr(np.full((2, 2), 0.6)),
                         "c": P.arr(np.full(16, 0.3))}),
            adapt_eps="relative", adapt_kwargs=dict(
                gamma=0.5, min_prob=0.6, index={"a": np.array([1])})),
        "stepsize_eps": lambda P: hmc(P, eps=P.s.StepSize({
            "a": P.arr([0.3, 0.2]), "b": P.arr(np.full((2, 2), 0.25)),
            "c": P.arr(0.35)})),
        "divergence_restart": lambda P: hmc(P, eps=1.2, Nstep=6, dHmax=0.5),
    }


@pytest.mark.parametrize("name", sorted(_hmc_configs()))
def test_hmc_matches_jax_draw_for_draw(monkeypatch, name):
    """HMC chains, acceptances, divergence indices and evaluations equal
    from the same momenta and uniforms."""
    js, ts = _run(monkeypatch, _hmc_configs()[name], 12)
    if name == "divergence_restart":
        assert len(ts._divergences) > 1
    if name in ("dual_eps", "relative_eps"):
        e_t, e_j = ts.eps, js.eps
        if hasattr(e_j, "keys"):
            for k in e_j.keys():
                assert _relerr(e_t[k].numpy(), e_j[k]) <= TOL
        else:
            assert abs(e_t - e_j) <= TOL * abs(e_j)
    np.testing.assert_allclose(
        [u for u in ts.Uchain if u is not None],
        [float(u) for u in js.Uchain if u is not None], rtol=TOL)


def test_hmc_dual_averaging_and_sample_p(monkeypatch):
    """dual_averaging from the current eps, and steps that reuse the
    momentum (sample_p=False)."""
    def make(P):
        s = P.s.HMC(_Gauss(P), _x0(P), eps=0.5, Nstep=4, seed=0)
        s.dual_averaging(5, target=0.7)
        return s

    def between(P, s, i):
        if i % 3 == 2:
            s.step(sample_p=False)
    js, ts = _run(monkeypatch, make, 9, between)
    assert ts.stepsize.frozen and js.stepsize.frozen
    assert abs(ts.eps - js.eps) <= TOL * js.eps


def test_hmc_estimate_cov_then_set_chol(monkeypatch):
    """estimate_cov (diagonal, robust, dense) installed as the mass, and
    set_chol's diagonal and operator forms, each followed by steps."""
    spec = _gauss_spec()
    Lb = np.linalg.cholesky(spec["b"][1])
    covs = {}

    def between(P, s, i):
        if i == 14:
            covs[P.name, "diag"] = s.estimate_cov(Nback=10)
        elif i == 17:
            covs[P.name, "robust"] = s.estimate_cov(Nback=10, robust=True)
        elif i == 20:
            covs[P.name, "dense"] = s.estimate_cov(
                diag_mass=False, eps={"a": 1e-6, "b": 1e-6, "c": 1e-3})
        elif i == 23:
            s.set_chol(cov_L=P.PD({"a": P.arr([1.0, 0.5]),
                                   "b": P.arr(0.8), "c": P.arr(1.2)}))
        elif i == 26:
            s.set_chol(hess_L=1.5)
        elif i == 29:
            s.set_chol(cov_L=P.h.MatDict({"b": P.h.TriangMat(P.arr(Lb))}),
                       diag_mass=False)

    def make(P):
        return P.s.HMC(_Gauss(P), _x0(P), eps=0.3, Nstep=4, seed=0)
    _run(monkeypatch, make, 33, between)
    for kind in ("diag", "robust"):
        for k in ("a", "b", "c"):
            assert _relerr(covs["torch", kind][k].numpy(),
                           covs["jax", kind][k]) <= TOL
    for k in ("a", "b", "c"):
        assert _relerr(covs["torch", "dense"][k], covs["jax", "dense"][k]) \
            <= TOL


# ---------------------------------------------------------------------------
# RecycledHMC and NUTS, draw for draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mass", ["identity", "diag_mass"])
def test_recycled_hmc_matches_jax_draw_for_draw(monkeypatch, mass):
    """Every recycled state's accept decision and the chain equal. The
    evaluations are not compared: the JAX host path evaluates twice a
    state, its device path and the port once a state plus once a
    trajectory."""
    def make(P):
        kw = {} if mass == "identity" else dict(mass=P.PD({
            "a": P.arr([1.0, 4.0]), "b": P.arr(np.full((2, 2), 2.0)),
            "c": P.arr(np.full(16, 0.5))}))
        return P.s.RecycledHMC(_Gauss(P), _x0(P), eps=0.4, Nstep=5, seed=0,
                               **kw)
    js, ts = _run(monkeypatch, make, 6, evals=False)
    assert ts.Nsamples == 30
    assert ts.fn_evals == 1 + 6 * (5 + 1)


def _nuts_configs():
    def nuts(P, **kw):
        kw.setdefault("eps", 0.3)
        kw.setdefault("max_treedepth", 5)
        return P.s.NUTS(_Gauss(P), _x0(P), seed=0, on_device=False, **kw)
    return {
        "slice": lambda P: nuts(P),
        "slice_diag_mass": lambda P: nuts(P, mass=P.PD({
            "a": P.arr([1.0, 4.0]), "b": P.arr(np.full((2, 2), 2.0)),
            "c": P.arr(np.full(16, 0.5))})),
        "slice_adapt": lambda P: nuts(P, eps=0.8, adapt_eps=True,
                                      adapt_kwargs=dict(Nadapt=5)),
        "slice_stepsize": lambda P: nuts(P, eps=P.s.StepSize({
            "a": P.arr([0.3, 0.2]), "b": P.arr(np.full((2, 2), 0.25)),
            "c": P.arr(0.35)})),
        "reference": lambda P: nuts(P, tree_variant="reference"),
        "reference_unbiased": lambda P: nuts(P, tree_variant="reference",
                                             biased=False),
        "reference_forward_only": lambda P: nuts(
            P, tree_variant="reference", sample_direction=False),
        "reference_divergent": lambda P: nuts(P, tree_variant="reference",
                                              eps=2.5, dHmax=0.5),
        "reference_diag_mass": lambda P: nuts(
            P, tree_variant="reference", mass=P.PD({
                "a": P.arr([1.0, 4.0]), "b": P.arr(np.full((2, 2), 2.0)),
                "c": P.arr(np.full(16, 0.5))})),
    }


@pytest.mark.parametrize("name", sorted(_nuts_configs()))
def test_nuts_matches_jax_draw_for_draw(monkeypatch, name):
    """NUTS (both tree variants): chain, acceptance statistics, tree
    depths, divergences and evaluations equal from the same draws."""
    js, ts = _run(monkeypatch, _nuts_configs()[name], 8, depths=True)
    if name == "reference_divergent":
        assert len(ts._divergences) > 1
    else:
        assert max(ts.tree_depths) >= 2


# ---------------------------------------------------------------------------
# sample_chains (the port's): moments, determinism, and no stale cache
# ---------------------------------------------------------------------------

def _gauss2():
    mu = np.array([1.0, -2.0])
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    return {"x": (mu, cov, (2,))}, mu, cov


def test_hmc_sample_chains_gaussian_moments():
    spec, mu, cov = _gauss2()
    pot = _Gauss(T, spec)
    hmc = tsampler.HMC(pot, ParamDict({"x": torch.as_tensor(mu)}), eps=0.3,
                       Nstep=5, mass=ParamDict({"x": torch.tensor([1.0, 0.5],
                                                dtype=torch.float64)}),
                       seed=7)
    out = hmc.sample_chains(500, Nchain=4, seed=11)
    ch = out["chain"]["x"]
    assert ch.shape == (4, 500, 2) and out["U"].shape == (4, 500)
    assert out["divergent"].dtype == bool and not out["divergent"].any()
    assert (out["acceptance_rate"] > 0.6).all()
    assert not np.allclose(ch[0], ch[1])
    pooled = ch[:, 100:].reshape(-1, 2)
    assert np.abs(pooled.mean(0) - mu).max() < 0.15
    assert np.abs(np.cov(pooled.T) - cov).max() < 0.35
    assert hmc.fn_evals == 4 * 500 * 6
    out2 = hmc.sample_chains(500, Nchain=4, seed=11)
    assert np.array_equal(ch, out2["chain"]["x"])
    assert np.allclose(out["final"]["x"].numpy(), ch[:, -1])
    # U is the potential at each recorded position
    U = [float(pot(ParamDict({"x": torch.as_tensor(q)}))[0])
         for q in ch[1, :20]]
    np.testing.assert_allclose(out["U"][1, :20], U, rtol=1e-12)


def test_nuts_sample_chains_gaussian_moments():
    spec, mu, cov = _gauss2()
    nuts = tsampler.NUTS(_Gauss(T, spec),
                         ParamDict({"x": torch.as_tensor(mu)}), eps=0.5,
                         seed=3)
    out = nuts.sample_chains(300, Nchain=3, seed=9)
    ch = out["chain"]["x"]
    assert ch.shape == (3, 300, 2) and out["tree_depth"].shape == (3, 300)
    assert out["tree_depth"].min() >= 1
    assert (out["acceptance_rate"] > 0.6).all()
    pooled = ch[:, 50:].reshape(-1, 2)
    assert np.abs(pooled.mean(0) - mu).max() < 0.2
    assert np.abs(np.cov(pooled.T) - cov).max() < 0.45
    out2 = nuts.sample_chains(300, Nchain=3, seed=9)
    assert np.array_equal(ch, out2["chain"]["x"])
    # the sampler's own stream and step size are untouched
    assert nuts.eps == 0.5 and nuts.Nsamples == 0


def test_sample_chains_start_points():
    spec, mu, cov = _gauss2()
    hmc = tsampler.HMC(_Gauss(T, spec), ParamDict({"x": torch.as_tensor(mu)}),
                       eps=0.3, Nstep=3)
    starts = [ParamDict({"x": torch.as_tensor(mu + i)}) for i in range(3)]
    a = hmc.sample_chains(4, x0=starts, seed=1)
    b = hmc.sample_chains(4, x0=ParamDict({"x": torch.stack(
        [s["x"] for s in starts])}), seed=1)
    assert a["chain"]["x"].shape == (3, 4, 2)
    assert np.array_equal(a["chain"]["x"], b["chain"]["x"])


def test_sample_chains_see_the_current_target():
    """No runner cache: moving the target's mean (and the start) by d
    between calls moves every HMC sample by d. The JAX package's cached
    runner keeps the mean it was traced with (sampler.py:829-843)."""
    spec, mu, cov = _gauss2()
    d = np.array([0.5, -0.25])
    got = {}
    for P in (J, T):
        pot = _Gauss(P, spec)
        hmc = P.s.HMC(pot, P.PD({"x": P.arr(mu)}), eps=0.3, Nstep=4, seed=2)
        a = hmc.sample_chains(6, Nchain=2, seed=4)["chain"]["x"]
        pot.mu["x"] = P.arr(mu + d)
        b = hmc.sample_chains(6, Nchain=2, seed=4, x0=[
            P.PD({"x": P.arr(mu + d)})] * 2)["chain"]["x"]
        got[P.name] = np.abs(b - a - d).max()
    assert got["torch"] < 1e-12
    assert got["jax"] > 0.1


# ---------------------------------------------------------------------------
# complex leaves: the port's HMC / NUTS equal their runs on real pairs;
# queue C1, what the JAX samplers do to a complex leaf
# ---------------------------------------------------------------------------

Z0 = np.array([1.0 + 2.0j, -0.5 + 0.3j, 0.2 - 1.0j])


def _autograd_pot(z0):
    """U = 0.5 sum |z - z0|^2 for a complex leaf 'z' or its real pairs
    'z' (last axis 2), gradient by torch.autograd."""
    def pot(x):
        z = x["z"].detach().requires_grad_(True)
        zz = z if z.is_complex() else torch.view_as_complex(z)
        U = 0.5 * torch.sum(torch.abs(zz - z0) ** 2)
        (g,) = torch.autograd.grad(U, z)
        return U.detach(), ParamDict({"z": g})
    return pot


def _complex_and_pairs(make):
    z0 = torch.as_tensor(Z0)
    pot = _autograd_pot(z0)
    zc = make(pot, ParamDict({"z": torch.zeros(3, dtype=torch.complex128)}))
    zr = make(pot, ParamDict({"z": torch.zeros((3, 2), dtype=torch.float64)}))
    return zc, zr


@pytest.mark.parametrize("kind", ["hmc", "hmc_diag_mass", "nuts_slice",
                                  "nuts_reference", "recycled"])
def test_port_complex_leaf_equals_real_pairs(kind):
    def make(pot, x0):
        if kind.startswith("hmc"):
            mass = None
            if kind == "hmc_diag_mass":
                m = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)
                mass = ParamDict({"z": m if x0["z"].is_complex()
                                  else m[:, None].expand(3, 2)})
            return tsampler.HMC(pot, x0, eps=0.4, Nstep=6, seed=5, mass=mass)
        if kind == "recycled":
            return tsampler.RecycledHMC(pot, x0, eps=0.4, Nstep=4, seed=5)
        return tsampler.NUTS(pot, x0, eps=0.4, seed=5, max_treedepth=5,
                             tree_variant=kind.split("_")[1])
    zc, zr = _complex_and_pairs(make)
    for s in (zc, zr):
        s.sample(40)
    a = zc.get_chain()["z"]
    b = zr.get_chain()["z"]
    assert _relerr(np.stack([a.real, a.imag], -1), b) <= 1e-12
    np.testing.assert_allclose(zc._acceptances, zr._acceptances, rtol=1e-12)
    # the chain samples N(z0, 1) per real part
    assert zc.acceptance_rate > 0.6
    assert np.abs(a.mean(0) - Z0).max() < 1.0


def test_port_sample_chains_complex_leaf_equals_real_pairs():
    """The multi-chain kinetic energy takes conj (a complex momentum's
    0.5 |p|^2), so complex and real-pair chains agree."""
    def make(pot, x0):
        return tsampler.HMC(pot, x0, eps=0.4, Nstep=5, seed=1)
    zc, zr = _complex_and_pairs(make)
    a = zc.sample_chains(30, Nchain=2, seed=3)
    b = zr.sample_chains(30, Nchain=2, seed=3)
    ca = a["chain"]["z"]
    assert _relerr(np.stack([ca.real, ca.imag], -1), b["chain"]["z"]) <= 1e-12
    np.testing.assert_allclose(a["accept_prob"], b["accept_prob"],
                               rtol=1e-12)
    assert a["acceptance_rate"].min() > 0.6


def _jax_complex_pot(z0):
    def U(x):
        z = x["z"]
        zz = z if jnp.iscomplexobj(z) else jax.lax.complex(z[..., 0],
                                                            z[..., 1])
        return 0.5 * jnp.sum(jnp.abs(zz - z0) ** 2)
    vg = jax.value_and_grad(U)
    return lambda x: vg(x)


def test_c1_jax_hmc_on_a_complex_leaf():
    """Queue C1 for HMC: the JAX HMC on a complex leaf integrates with
    the conjugated gradient, so the imaginary parts are pushed away
    from the mode. On |z - z0|^2 / 2 with the same settings its real
    pairs accept nearly every trajectory while the complex leaf's
    acceptance collapses and its imaginary parts leave the posterior."""
    z0 = jnp.asarray(Z0)
    pot = _jax_complex_pot(z0)
    kw = dict(eps=0.4, Nstep=6, seed=5)
    hc = jsampler.HMC(pot, JParamDict({"z": jnp.zeros(3, complex)}), **kw)
    hr = jsampler.HMC(pot, JParamDict({"z": jnp.zeros((3, 2))}), **kw)
    hc.sample(40)
    hr.sample(40)
    assert hr.acceptance_rate > 0.8
    assert hc.acceptance_rate < 0.5 * hr.acceptance_rate
    # the gradient JAX hands the sampler is conj(z - z0)
    _, g = pot(JParamDict({"z": jnp.zeros(3, complex)}))
    np.testing.assert_allclose(np.asarray(g["z"]), -np.conj(Z0))


def test_c1_jax_nuts_on_a_complex_leaf():
    """Queue C1 for NUTS: the JAX host slice tree cannot take a complex
    leaf (float() of its complex u-turn dot); the reference variant runs
    on the conjugated gradient and its acceptance collapses against the
    real pairs'."""
    z0 = jnp.asarray(Z0)
    pot = _jax_complex_pot(z0)
    nc = jsampler.NUTS(pot, JParamDict({"z": jnp.zeros(3, complex)}),
                       eps=0.4, seed=5, max_treedepth=5, on_device=False)
    with pytest.raises(TypeError):
        nc.step()
    kw = dict(eps=0.4, seed=5, max_treedepth=5, tree_variant="reference")
    rc = jsampler.NUTS(pot, JParamDict({"z": jnp.zeros(3, complex)}), **kw)
    rr = jsampler.NUTS(pot, JParamDict({"z": jnp.zeros((3, 2))}), **kw)
    rc.sample(20)
    rr.sample(20)
    assert rr.acceptance_rate > 0.6
    assert rc.acceptance_rate < 0.5 * rr.acceptance_rate


# ---------------------------------------------------------------------------
# chains carried across packages
# ---------------------------------------------------------------------------

def _keys_ab(P):
    return _x0(P, keys=("a", "b"))


def test_jax_chain_resumes_in_the_port(tmp_path):
    js = jsampler.HMC(_Gauss(J, keys=["a", "b"]), _keys_ab(J), eps=1.0,
                      Nstep=5, seed=1, dHmax=1.0)
    js.sample(12)
    f = str(tmp_path / "jax_chain.npz")
    js.write_chain(f)
    assert js._divergences
    ts = tsampler.HMC(_Gauss(T, keys=["a", "b"]), _keys_ab(T), eps=1.0,
                      Nstep=5, seed=1, dHmax=1.0)
    ts.load_chain(f)
    assert ts.Nsamples == 12
    assert ts._divergences == [int(d) for d in js._divergences]
    assert all(type(d) is int for d in ts._divergences)
    for k in ("a", "b"):
        assert np.array_equal(ts.x[k].numpy(), np.asarray(js.chain[k][-1]))
    np.testing.assert_allclose(
        [np.nan if u is None else u for u in ts.Uchain],
        [np.nan if u is None else u for u in js.Uchain])
    ts.sample(3)
    assert ts.Nsamples == 15 and len(ts.Uchain) == 15


def test_port_chain_resumes_in_jax(tmp_path):
    ts = tsampler.HMC(_Gauss(T, keys=["a", "b"]), _keys_ab(T), eps=1.0,
                      Nstep=5, seed=1, dHmax=1.0)
    ts.sample(12)
    assert ts._divergences
    f = str(tmp_path / "port_chain.npz")
    ts.write_chain(f, description="port run", attrs={"eps": 1.0})
    with np.load(f) as d:
        assert d["divergences"].dtype == np.int64
    js = jsampler.HMC(_Gauss(J, keys=["a", "b"]), _keys_ab(J), eps=1.0,
                      Nstep=5, seed=1, dHmax=1.0)
    js.load_chain(f)
    assert js.Nsamples == 12
    assert [int(d) for d in js._divergences] == ts._divergences
    for k in ("a", "b"):
        assert np.array_equal(np.asarray(js.x[k]), ts.chain[k][-1])
    js.sample(3)
    assert js.Nsamples == 15


def test_chain_surface(tmp_path):
    """append_chain(U), get_chain(keys, burn), clear_chain(N), and a
    round trip of write_chain / load_chain in the port."""
    s = tsampler.SamplerBase(ParamDict({"a": torch.zeros(2),
                                        "b": torch.ones(3)}))
    for i in range(5):
        s.append_chain(ParamDict({"a": torch.full((2,), float(i)),
                                  "b": torch.ones(3)}), U=float(i))
    s._divergences = [1, 3]
    assert s.Uchain == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert set(s.get_chain("a")) == {"a"}
    assert s.get_chain(["a", "b"], burn=2)["a"].shape == (3, 2)
    f = str(tmp_path / "c.npz")
    s.write_chain(f, description="notes")
    with pytest.raises(FileExistsError):
        s.write_chain(f)
    s2 = tsampler.SamplerBase(ParamDict({"a": torch.zeros(2),
                                         "b": torch.ones(3)}))
    s2.load_chain(f)
    assert s2.Nsamples == 5 and s2.Uchain == s.Uchain
    assert s2._divergences == [1, 3]
    assert s2.x["a"].dtype == torch.float32
    assert torch.equal(s2.x["a"], torch.full((2,), 4.0))
    s.clear_chain(N=2)
    assert s.Nsamples == 3 and s._divergences == [1]
    s.clear_chain()
    assert s.Nsamples == 0 and s.Uchain == []


def test_mass_kinetic_and_logdet_match_jax():
    """_Mass.kinetic (with logdet) and momentum draws under each mass
    form, from the same white noise."""
    spec = _gauss_spec()
    K = np.linalg.inv(spec["c"][1])
    rng = np.random.default_rng(9)
    xi = {k: rng.standard_normal(spec[k][2]) for k in ("a", "b", "c")}
    forms = {
        "diag": lambda P: dict(mass=P.PD({"a": P.arr([1.0, 4.0]),
                                          "b": P.arr(np.full((2, 2), 2.0)),
                                          "c": P.arr(np.full(16, 0.5))})),
        "chol_hier": lambda P: dict(chol=P.h.MatDict({"c": P.h.SolveHierMat(
            P.h.make_hodlr(P.arr(K), min_size=4, rank=8))})),
        "chol_triang": lambda P: dict(chol=P.h.MatDict({"c": P.h.TriangMat(
            P.arr(np.linalg.cholesky(K)))})),
        "invchol_solve": lambda P: dict(invchol=P.h.MatDict({
            "c": P.h.SolveMat(A=P.arr(spec["c"][1]))})),
        "invchol_triang": lambda P: dict(invchol=P.h.MatDict({
            "c": P.h.TriangMat(P.arr(np.linalg.cholesky(spec["c"][1])))})),
    }
    for name, f in forms.items():
        mj = jsampler._Mass(**f(J))
        mt = tsampler._Mass(**f(T))
        p = {k: rng.standard_normal(spec[k][2]) for k in ("a", "b", "c")}
        for wl in (False, True):
            a = mt.kinetic(ParamDict({k: torch.as_tensor(v)
                                      for k, v in p.items()}), wl)
            b = mj.kinetic(JParamDict({k: jnp.asarray(v)
                                       for k, v in p.items()}), wl)
            assert abs(a - b) <= TOL * abs(b), name
        it = iter([xi[k] for k in sorted(xi)])
        orig = tsampler._normal
        tsampler._normal = lambda gen, t: torch.as_tensor(next(it))
        try:
            pt = mt.sample_momentum(None, ParamDict(
                {k: torch.as_tensor(v) for k, v in xi.items()}))
        finally:
            tsampler._normal = orig
        jit = iter([xi[k] for k in sorted(xi)])
        saved = jsampler.jax
        jsampler.jax = types.SimpleNamespace(random=types.SimpleNamespace(
            split=jax.random.split,
            normal=lambda key, shape, dtype: jnp.asarray(next(jit))))
        try:
            pj = mj.sample_momentum(jax.random.PRNGKey(0), JParamDict(
                {k: jnp.asarray(v) for k, v in xi.items()}))
        finally:
            jsampler.jax = saved
        for k in xi:
            assert _relerr(pt[k].numpy(), pj[k]) <= TOL, (name, k)


def test_hmc_helpers_match_jax():
    """K, is_divergent, set_chol's diagonal forms, draw_momentum with
    pmask."""
    for P in (J, T):
        s = P.s.HMC(_Gauss(P), _x0(P), eps=0.3, Nstep=4, seed=7)
        p = _x0(P)
        K0 = s.K(p)
        assert s.is_divergent(0.0, s.dHmax + 1.0)
        assert not s.is_divergent(0.0, s.dHmax - 1.0)
        s.set_chol(hess_L=2.0)
        assert abs(s.K(p) - K0 / 4.0) <= TOL * K0
        s.set_chol(cov_L=2.0)
        assert abs(s.K(p) - K0 * 4.0) <= TOL * K0
        s.set_chol()
        assert abs(s.K(p) - K0) <= TOL * K0
        s.pmask = P.PD({"a": P.arr([1.0, 0.0])})
        assert float(s.draw_momentum()["a"][1]) == 0.0


# ---------------------------------------------------------------------------
# a hex-2 Sequential(RIME -> JonesModel) trajectory, both packages
# ---------------------------------------------------------------------------

def test_hex2_rime_jones_hmc_matches_jax(monkeypatch):
    """Sky, beam and gains sampled through the hera-hmc chain at hex-2
    (tests/_torch_graft.py's build functions), JAX's host leapfrog
    against the port, draw for draw: 3 HMC steps of 4 leapfrog steps."""
    import _torch_graft as g
    from bayeslim_tpu.inference.sampler import Potential as JPotential

    tprob = g.build_cal_torch(sky_beam=True)
    truth = g.cal_truth(np.asarray(tprob.model.rime.array.antvecs))
    del truth["models.rime.array.antvecs"]
    target = g.cal_target(tprob, truth)
    tprob = g.build_cal_torch(target, sky_beam=True)
    jprob = g.build_cal_jax(target, sky_beam=True)

    def make(P):
        prob = jprob if P is J else tprob
        pot = JPotential(prob) if P is J else tsampler.Potential(prob)
        x0 = prob.collect_main_params()
        mass = P.PD({k: P.arr(np.full(np.shape(v), m)) for (k, v), m in
                     zip(sorted(x0.items()), (1e4, 1.0, 1e2))})
        return P.s.HMC(pot, x0, eps=2e-4, Nstep=4, seed=0, mass=mass,
                       on_device=False)
    js, ts = _run(monkeypatch, make, 3)
    assert sorted(ts.chain) == ["models.cal.params",
                                "models.rime.beam.params",
                                "models.rime.sky.params"]
    assert 0.0 < ts.acceptance_rate
    np.testing.assert_allclose(ts.Uchain, [float(u) for u in js.Uchain],
                               rtol=TOL)
