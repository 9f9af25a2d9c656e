"""The sharded posterior of the port on two gloo ranks on the CPU
(float64), third part: time sharding on {'data': 2}, a time-coupled
covariance on {'model': 2}, the WedgeFilter chain under time sharding,
and what drives the posterior: a Trainer (Adam), L-BFGS, one HMC
trajectory, compute_hessian, and VisMapper with the channels split over
the ranks. Each against the JAX package (its ShardedLogProb on the
8-device CPU mesh) and the single-process port; after the optimizers'
steps the parameters are the same bits on both ranks
(tests/_torch_dist.py).
"""
import numpy as np
import pytest

import _torch_dist as D

WORLD = 2
EVAL = ["time2", "cov_time_m2", "wedge_time"]
NAMES = EVAL + ["trainer", "lbfgs", "hmc", "hessian", "vismapper"]
STEPS, NSTEP, EPS = 3, 5, 1e-3


class _Smap:
    """The JAX ShardedLogProb as its tests drive it (the shard_map
    path)."""

    def __init__(self, sp):
        self.sp = sp

    def collect_main_params(self):
        return self.sp.collect_main_params()

    def value_and_grad(self, pdict=None):
        return self.sp.smap_value_and_grad(pdict)

    def update(self, pdict):
        self.sp.update(pdict)

    def __call__(self, pdict=None, **kwargs):
        return self.sp(pdict, **kwargs)


def jax_pert():
    from bayeslim_tpu.parallel import ShardedLogProb, make_mesh
    prob, spec = D.build(D.JaxPkg(), "pert")
    return ShardedLogProb(prob, make_mesh(spec["mesh"]))


def jax_refs():
    """The JAX package's Trainer (optax Adam), L-BFGS, leapfrog (the
    trajectory's momenta drawn as the ranks draw them), Hessian and
    maps over the 'pert' posterior sharded on {'data': 2}."""
    import optax
    from bayeslim_tpu.inference import bfgs, hessian, sampler
    from bayeslim_tpu.inference.trainer import Trainer
    from bayeslim_tpu.models.imaging import VisMapper
    from bayeslim_tpu.utils import ParamDict
    out = {}
    tr = Trainer(_Smap(jax_pert()), optimizer=optax.adam(1e-2),
                 verbose=False)
    tr.train(STEPS)
    out["trainer"] = (list(tr.loss_history),
                      {k: np.asarray(v) for k, v in tr.pdict.items()})
    opt = bfgs.LBFGS(_Smap(jax_pert()))
    out["lbfgs"] = ([float(opt.step()) for _ in range(STEPS)],
                    {k: np.asarray(v) for k, v in opt.pdict.items()})
    sp = _Smap(jax_pert())
    q0 = sp.collect_main_params()
    rng = np.random.default_rng(7)
    p0 = ParamDict({k: rng.standard_normal(np.shape(v)) for k, v in
                    q0.items()})
    q, p, *_ = sampler.leapfrog(q0, p0, sampler.Potential(sp), EPS, NSTEP)
    out["hmc"] = ({k: np.asarray(v) for k, v in q.items()},
                  {k: np.asarray(v) for k, v in p.items()})
    out["hessian"] = np.asarray(hessian.compute_hessian(jax_pert())[0])
    vd, ra, dec = D.vismapper_vd(D.JaxPkg())
    m, P = VisMapper(vd, ra, dec, fov=180.0).make_map(return_P=True)
    out["vismapper"] = (np.asarray(m), np.asarray(P))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = D.start_ranks(WORLD, NAMES, tmp_path_factory.mktemp("ranks"))
    refs = {n: (D.jax_sharded(n), D.torch_single(n)) for n in EVAL}
    jax = jax_refs()
    single = {"trainer": D.opt_trainer(D.pert(), STEPS),
              "lbfgs": D.opt_lbfgs(D.pert(), STEPS),
              "hmc": D.hmc_traj(D.pert(), NSTEP, EPS),
              "hessian": D.hessian(D.pert()),
              "vismapper": D.vismapper(False)}
    for k in single:
        refs[k] = (jax[k], single[k])
    return D.join_ranks(run), refs


@pytest.mark.parametrize("name", EVAL)
def test_sharded_matches_jax_and_single_process(ranks, name):
    results, refs = ranks
    D.assert_same_bits(results, name)
    jax_ref, single = refs[name]
    D.assert_close(results[0][name], single)
    D.assert_close(results[0][name], jax_ref, conj=True)


def _params_close(a, b, tol=1e-9):
    assert sorted(a) == sorted(b)
    for k in b:
        assert np.abs(a[k] - b[k]).max() <= tol * np.abs(b[k]).max(), k


def _same_bits(results, name):
    for r in results[1:]:
        for x, y in zip(r[name], results[0][name]):
            if isinstance(y, dict):
                for k in y:
                    np.testing.assert_array_equal(x[k], y[k])
            else:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["trainer", "lbfgs"])
def test_optimizer_over_sharded_posterior(ranks, name):
    """3 Adam steps of a Trainer, 3 L-BFGS steps: the losses and the
    parameters the same bits on both ranks, and within 1e-9 of the
    single-process port's and of the JAX package's."""
    results, refs = ranks
    _same_bits(results, name)
    losses, params = results[0][name]
    jax_ref, single = refs[name]
    for ref in (single, jax_ref):
        np.testing.assert_allclose(losses, ref[0], rtol=1e-9)
        _params_close(params, ref[1])
    assert losses[-1] < losses[0]


def test_hmc_trajectory_over_sharded_posterior(ranks):
    """One HMC trajectory (5 leapfrog steps, fixed momenta): its end
    position and momentum equal the single-process port's and the JAX
    leapfrog's over the JAX ShardedLogProb; dH the single-process one."""
    results, refs = ranks
    _same_bits(results, "hmc")
    q, p, dH = results[0]["hmc"]
    jax_ref, single = refs["hmc"]
    _params_close(q, single[0])
    _params_close(p, single[1])
    _params_close(q, jax_ref[0])
    _params_close(p, jax_ref[1])
    assert abs(dH - single[2]) <= 1e-9 * max(abs(single[2]), 1.0)


def test_compute_hessian_of_sharded_posterior(ranks):
    """compute_hessian of a ShardedLogProb: each rank's local Hessian
    summed over the ranks equals the single-process Hessian and the JAX
    package's compute_hessian of its ShardedLogProb."""
    results, refs = ranks
    H = results[0]["hessian"]
    np.testing.assert_array_equal(results[1]["hessian"], H)
    jax_ref, single = refs["hessian"]
    scale = np.abs(single).max()
    assert np.abs(H - single).max() <= 1e-9 * scale
    assert np.abs(H - jax_ref).max() <= 1e-9 * scale


def test_vismapper_channels_over_ranks(ranks):
    """Each rank images its channels; the maps and P gathered along the
    channel axis equal the single-process VisMapper's and the JAX
    package's."""
    results, refs = ranks
    _same_bits(results, "vismapper")
    m, P = results[0]["vismapper"]
    jax_ref, single = refs["vismapper"]
    for ref in (single, jax_ref):
        assert np.abs(m - ref[0]).max() <= 1e-10 * np.abs(ref[0]).max()
        assert np.abs(P - ref[1]).max() <= 1e-10 * np.abs(ref[1]).max()
