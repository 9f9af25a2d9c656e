"""The port's posterior layer (inference/prob.py, trainer.py, the prior
hooks of utils/module.py, structured covariances of data/containers.py)
against the JAX package at float64 on the CPU: apply_icov and set_cov
for every covariance structure, the five priors (value and gradient),
MainParams, forward_chisq / forward_like / forward_prior under each
compute, prior_dict against the module cache, grad_modify, the LM hook,
and the Trainer's chain tracking and rollback. Inputs come from numpy
seeds; values and gradients agree to 1e-9 relative, optimizer
trajectories to 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bayeslim_tpu_torch as bt
from bayeslim_tpu.data import containers as jcont
from bayeslim_tpu.inference import prob as jprob
from bayeslim_tpu.inference.trainer import Trainer as JTrainer
from bayeslim_tpu.utils import Module as JModule, ParamDict as JParamDict
from bayeslim_tpu_torch.data import containers as tcont
from bayeslim_tpu_torch.inference import prob as tprob

TOL = 1e-9
N = 6


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _spd_blocks(rng, lead, n):
    A = rng.standard_normal(lead + (n, n)) + 1j * rng.standard_normal(
        lead + (n, n))
    return A @ np.swapaxes(A.conj(), -1, -2) + n * np.eye(n)


# ------------------------------------------------------------ covariances
# (cov_axis, mode, data shape, icov shape)
COV_CASES = [
    (None, "vis", (1, 1, 3, 2, 4), None),
    (None, "vis", (1, 1, 3, 2, 4), "diag"),
    ("full", "vis", (1, 1, 3, 2, 2), ((12,), 12)),
    ("bl", "vis", (1, 1, 3, 2, 4), ((1, 1, 2, 4), 3)),
    ("time", "vis", (1, 1, 3, 2, 4), ((1, 1, 3, 4), 2)),
    ("freq", "vis", (1, 1, 3, 2, 4), ((1, 1, 3, 2), 4)),
    ("freq", "map", (1, 1, 4, 5), ((1, 1, 5), 4)),
    ("pix", "map", (1, 1, 4, 5), ((1, 1, 4), 5)),
]


def _cov_case(cov_axis, dshape, ishape, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(dshape) + 1j * rng.standard_normal(dshape)
    if ishape is None:
        return d, None
    if ishape == "diag":
        return d, rng.uniform(0.5, 2, dshape)
    lead, n = ishape
    if cov_axis == "full":
        return d, _spd_blocks(rng, (), n)
    return d, _spd_blocks(rng, lead, n)


@pytest.mark.parametrize("cov_axis,mode,dshape,ishape", COV_CASES)
def test_apply_icov_vs_jax(cov_axis, mode, dshape, ishape):
    d, icov = _cov_case(cov_axis, dshape, ishape)
    ref = jprob.apply_icov(jnp.asarray(d), None if icov is None
                           else jnp.asarray(icov), cov_axis, mode=mode)
    got = tprob.apply_icov(torch.as_tensor(d), None if icov is None
                           else torch.as_tensor(icov), cov_axis, mode=mode)
    assert got.shape == tuple(np.shape(ref))
    assert _relerr(got.numpy(), ref) <= TOL
    # the quadratic form is real and positive for a positive-definite icov
    if icov is not None:
        assert float(got.real.sum()) > 0
        assert float(got.imag.abs().max()) <= 1e-9 * float(
            got.real.abs().max())


@pytest.mark.parametrize("cov_axis,mode,dshape,ishape",
                         [c for c in COV_CASES if c[3] is not None])
@pytest.mark.parametrize("given", ["cov", "icov"])
def test_set_cov_logdet_vs_jax(cov_axis, mode, dshape, ishape, given):
    """cov_ndim and cov_logdet per structure, from cov or from icov
    alone; compute_icov inverts a structured cov; a structured icov is
    handed over unsqueezed."""
    d, cov = _cov_case(cov_axis, dshape, ishape, seed=1)
    if ishape == "diag":
        cov = cov.real
    jd, td = jcont.TensorData(), tcont.TensorData()
    kw = dict(cov=cov) if given == "cov" else dict(icov=cov)
    jd.setup_data(data=jnp.asarray(d), cov_axis=cov_axis,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    td.setup_data(data=torch.as_tensor(d), cov_axis=cov_axis,
                  **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert td.cov_ndim == jd.cov_ndim
    assert abs(td.cov_logdet - jd.cov_logdet) <= TOL * max(
        1.0, abs(jd.cov_logdet))
    if given == "cov":
        for inv in (("pinv", "inv") if cov_axis else ("pinv",)):
            ref = jd.compute_icov(inv=inv)
            got = td.compute_icov(inv=inv)
            assert _relerr(got.numpy(), ref) <= TOL


def test_visdata_structured_icov_is_not_squeezed():
    rng = np.random.default_rng(2)
    shp = (1, 1, 3, 2, 4)
    d = rng.standard_normal(shp) + 0j
    icov = _spd_blocks(rng, (1, 1, 3, 2), 4)
    vd = bt.VisData()
    vd.setup_data([(0, 1), (0, 2), (1, 2)], np.arange(2.0), np.arange(4.0),
                  pol="ee", data=torch.as_tensor(d),
                  icov=torch.as_tensor(icov), cov_axis="freq")
    assert vd.get_icov().shape == icov.shape
    assert vd.get_data().shape == shp[2:]
    assert vd.cov_logdet == 0.0 and vd.cov_ndim == d.size


# ------------------------------------------------------------------ priors
def _prior_cases():
    rng = np.random.default_rng(3)
    mean = rng.standard_normal(N)
    cov = rng.uniform(0.5, 2.0, N)
    A = rng.standard_normal((N, N))
    dense = A @ A.T + N * np.eye(N)
    idx = np.array([0, 2, 5])

    def sq(x):
        return x ** 2
    return [
        ("LogUniformPrior", (-3.0, 3.0), {}),
        ("LogUniformPrior", (np.full(N, -0.1), np.full(N, 0.1)), {}),
        ("LogUniformPrior", (-3.0, 3.0), dict(index=idx)),
        ("LogTaperedUniformPrior", (), dict(lower_bound=-1.0,
                                            upper_bound=1.0, alpha=5.0)),
        ("LogTaperedUniformPrior", (), dict(lower_bound=-1.5, alpha=2.0,
                                            kind="tanh")),
        ("LogTaperedUniformPrior", (), dict(upper_bound=0.5, alpha=3.0)),
        ("LogGaussPrior", (mean, cov), {}),
        ("LogGaussPrior", (mean, cov), dict(side="upper", density=False)),
        ("LogGaussPrior", (mean, cov), dict(side="lower")),
        ("LogGaussPrior", (0.0, 2.0), dict(func=sq)),
        ("LogGaussPrior", (mean, dense), dict(diag_cov=False)),
        ("LogGaussPrior", (mean[idx], dense[:3, :3]),
         dict(diag_cov=False, index=idx)),
        ("LogLaplacePrior", (mean, cov), {}),
        ("LogLaplacePrior", (0.5, 2.0), dict(density=False,
                                            index=(slice(1, 4),))),
    ]


@pytest.mark.parametrize("name,args,kw", _prior_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_priors_value_and_grad_vs_jax(name, args, kw):
    rng = np.random.default_rng(4)
    x = 0.8 * rng.standard_normal(N)
    jp = getattr(jprob, name)(*[jnp.asarray(a) for a in args], **kw)
    tp = getattr(tprob, name)(*args, **kw)
    jv, jg = jax.value_and_grad(lambda p: jp(p))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    tv = tp(xt)
    (tg,) = torch.autograd.grad(tv, xt)
    if np.isinf(float(jv)):
        assert float(tv) == float(jv) == -np.inf
    else:
        assert abs(float(tv) - float(jv)) <= TOL * abs(float(jv))
    assert _relerr(tg.numpy(), jg) <= TOL


def test_uniform_prior_is_minus_inf_outside_its_bounds():
    """The normalisation counts the bounds' entries (scalar bounds: one
    term), as in the JAX package; outside the bounds the value is -inf
    and the gradient zero."""
    p = tprob.LogUniformPrior(-1.0, 1.0)
    inside = p(torch.tensor([0.5, -0.5], dtype=torch.float64))
    assert float(inside) == pytest.approx(np.log(0.5), rel=1e-12)
    x = torch.tensor([0.5, 1.5], dtype=torch.float64, requires_grad=True)
    out = p(x)
    assert float(out) == -np.inf
    assert torch.equal(torch.autograd.grad(out, x)[0], torch.zeros(2,
                       dtype=torch.float64))


def test_gauss_prior_on_complex_params_vs_jax():
    """A complex leaf: the value agrees, the gradient is the conjugate
    of JAX's (ROADMAP queue C1)."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    mean = 0.5 + 0.1j
    jp, tp = jprob.LogGaussPrior(mean, 0.3), tprob.LogGaussPrior(mean, 0.3)
    jv, jg = jax.value_and_grad(lambda p: jp(p))(jnp.asarray(z))
    zt = torch.as_tensor(z).requires_grad_(True)
    tv = tp(zt)
    (tg,) = torch.autograd.grad(tv, zt)
    assert abs(float(tv) - float(jv)) <= TOL * abs(float(jv))
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= TOL


# ------------------------------------------------------------ LogProb
class JChild(JModule):
    def __init__(self, p):
        super().__init__(name="child")
        self.params = p
        self.set_param("params")


class JModel(JModule):
    """data = params + child.params ** 2 (priors evaluated in forward
    when in_forward, else found by walking the model)."""

    def __init__(self, p, c, in_forward):
        super().__init__(name="parent")
        self.params = p
        self.child = JChild(c)
        self.set_param("params")
        self.in_forward = in_forward

    def forward(self, inp=None, prior_cache=None, **kwargs):
        if self.in_forward:
            self.eval_prior(prior_cache, inp_params=self.params)
            self.child.eval_prior(prior_cache, inp_params=self.child.params)
        return self.params + self.child.params ** 2


class TChild(bt.Module):
    def __init__(self, p):
        super().__init__(name="child")
        self.register_buffer("params", torch.as_tensor(p))
        self.set_param("params")


class TModel(bt.Module):
    def __init__(self, p, c, in_forward):
        super().__init__(name="parent")
        self.register_buffer("params", torch.as_tensor(p))
        self.child = TChild(c)
        self.set_param("params")
        self.in_forward = in_forward

    def forward(self, inp=None, prior_cache=None, **kwargs):
        if self.in_forward:
            self.eval_prior(prior_cache, inp_params=self.params)
            self.child.eval_prior(prior_cache, inp_params=self.child.params)
        return self.params + self.child.params ** 2


def _priors(pkg):
    rng = np.random.default_rng(6)
    m = rng.standard_normal(N)
    return (pkg.LogGaussPrior(m, 0.5), pkg.LogLaplacePrior(0.2, 1.5))


def _probs(priors="modules", in_forward=True, cov_axis=None, **kw):
    """The toy posterior in both packages (real data, a covariance of
    the given structure); priors 'modules' (set_priors), 'dict'
    (prior_dict) or None."""
    rng = np.random.default_rng(7)
    p, c = rng.standard_normal(N), 0.5 * rng.standard_normal(N)
    data = rng.standard_normal(N)
    if cov_axis == "full":
        A = rng.standard_normal((N, N))
        cov = A @ A.T + N * np.eye(N)
    else:
        cov = rng.uniform(0.5, 2, N)
    out = []
    for pkg, mod, Model, arr in ((jprob, jcont, JModel, jnp.asarray),
                                 (tprob, tcont, TModel, torch.as_tensor)):
        model = Model(arr(p), arr(c), in_forward)
        tgt = mod.TensorData()
        tgt.setup_data(data=arr(data), cov=arr(cov), cov_axis=cov_axis)
        tgt.compute_icov()
        pd = None
        if priors is not None:
            pp, pc = _priors(pkg)
            if priors == "modules":
                model.set_priors(priors_inp_params=pp)
                model.child.set_priors(priors_inp_params=[pc])
            else:
                pd = {"params": pp, "child.params": [pc]}
        out.append(pkg.LogProb(model, tgt, prior_dict=pd, **kw))
    return out


def _vg(jp, tp, pdict=None):
    jv, jg = jp.value_and_grad(None if pdict is None else JParamDict(
        {k: jnp.asarray(v) for k, v in pdict.items()}))
    tv, tg = tp.value_and_grad(None if pdict is None else bt.ParamDict(
        {k: torch.as_tensor(v) for k, v in pdict.items()}))
    return (float(jv), {k: np.asarray(v) for k, v in jg.items()},
            float(tv), {k: v.numpy() for k, v in tg.items()})


def _assert_vg(jv, jg, tv, tg):
    assert abs(tv - jv) <= TOL * abs(jv)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        assert _relerr(tg[k], jg[k]) <= TOL, k


@pytest.mark.parametrize("compute", ["post", "like", "prior"])
@pytest.mark.parametrize("negate", [True, False])
@pytest.mark.parametrize("complex_circular", [True, False])
@pytest.mark.parametrize("cov_axis", [None, "full"])
def test_logprob_compute_modes_vs_jax(compute, negate, complex_circular,
                                      cov_axis):
    jp, tp = _probs(compute=compute, negate=negate,
                    complex_circular=complex_circular, cov_axis=cov_axis)
    _assert_vg(*_vg(jp, tp))
    # the three forward_* surfaces
    jc = jp.forward_chisq()
    tc = tp.forward_chisq()
    assert abs(float(tc[0]) - float(jc[0])) <= TOL * abs(float(jc[0]))
    assert _relerr(tc[1].detach().numpy(), jc[1]) <= TOL
    assert sorted(tc[2]) == sorted(jc[2]) == ["child", "parent"]
    jl, _ = jp.forward_like()
    tl, _ = tp.forward_like()
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    jpr, tpr = jp.forward_prior(idx=0), tp.forward_prior(idx=0)
    assert abs(float(tpr) - float(jpr)) <= TOL * abs(float(jpr))
    assert float(tp.forward_prior(idx=1)) == float(jp.forward_prior(idx=1))


@pytest.mark.parametrize("in_forward", [True, False])
def test_prior_dict_matches_the_module_cache(in_forward):
    """Priors attached to the modules (memoised in the forward, or found
    by walking the model) and the same priors in prior_dict give one
    posterior, equal to the JAX package's."""
    jm, tm = _probs("modules", in_forward=in_forward)
    jd, td = _probs("dict")
    vals = _vg(jm, tm)
    _assert_vg(*vals)
    _assert_vg(*_vg(jd, td))
    tv_dict = float(td.value_and_grad()[0])
    assert abs(vals[2] - tv_dict) <= TOL * abs(tv_dict)
    # the cache is memoised by name: a second eval_prior adds nothing
    cache = {}
    tm.model.eval_prior(cache, inp_params=tm.model.params)
    first = float(cache["parent"])
    tm.model.eval_prior(cache, inp_params=tm.model.params * 0)
    assert float(cache["parent"]) == first


def test_lm_hook_vs_jax():
    jp, tp = _probs()
    jp.LM = lambda k, v: 2.0 * v if k == "params" else v
    tp.LM = lambda k, v: 2.0 * v if k == "params" else v
    _assert_vg(*_vg(jp, tp))


@pytest.mark.parametrize("spec", [
    {"params": None},
    {"params": None, "child.params": np.array([4, 0, 2])},
    {"child.params": np.array([True, False, True, True, False, False])},
])
def test_main_params_vs_jax(spec):
    jp, tp = _probs()
    jm, tm = jp.set_main_params(spec), tp.set_main_params(spec)
    assert tm.size == jm.size and tm.offsets == jm.offsets
    jvec = jp.collect_main_params()["main"]
    tvec = tp.collect_main_params()["main"]
    assert _relerr(tvec.numpy(), jvec) <= TOL
    rng = np.random.default_rng(8)
    vec = np.asarray(jvec) + 0.1 * rng.standard_normal(jm.size)
    _assert_vg(*_vg(jp, tp, {"main": vec}))
    # the scatter is out of place: the model keeps its values
    before = {k: v.detach().clone() for k, v in tp.model.named_parameters()}
    tp.forward(bt.ParamDict({"main": torch.as_tensor(vec)}))
    for k, v in tp.model.named_parameters():
        assert torch.equal(v, before[k])
    # send_main_params with fill and main_p0, then sort_main_params
    jmod = jp.send_main_params(JParamDict({"main": jnp.asarray(vec)}),
                               inplace=False, fill=0.25, main_p0=0.5)
    tmod = tp.send_main_params(bt.ParamDict({"main": torch.as_tensor(vec)}),
                               inplace=False, fill=0.25, main_p0=0.5)
    for k in ("params", "child.params"):
        assert _relerr(tmod[k].detach().numpy(), jmod[k]) <= TOL
    tp.send_main_params(bt.ParamDict({"main": torch.as_tensor(vec)}))
    jp.send_main_params(JParamDict({"main": jnp.asarray(vec)}))
    for k in ("params", "child.params"):
        assert _relerr(tp.model[k].detach().numpy(), jp.model[k]) <= TOL
    new = {"params": np.array([1, 3])}
    jp.sort_main_params(new, incomplete=True)
    tp.sort_main_params(new, incomplete=True)
    assert tp.main_params.keys == jp.main_params.keys
    assert tp.main_params.size == jp.main_params.size
    _assert_vg(*_vg(jp, tp))


@pytest.mark.parametrize("mods", [
    {"params": ("clamp", 0.1)},
    {"params": ("mult", 3.0), "child.params": ("replace", 0.5)},
    {"child.params": ("isolate", None)},
    {"params": ("clip", 0.2)},
])
def test_grad_modify_vs_jax(mods):
    jp, tp = _probs()
    jp.set_grad_mod(mods)
    tp.set_grad_mod(mods)
    _assert_vg(*_vg(jp, tp))


# ------------------------------------------------------------ Trainer
def test_trainer_chain_tracking_and_revert_vs_jax():
    """Adam (the default, lr 1e-2) with the chain tracked; an optimizer
    swap that keeps its state; revert_chain rolls parameters, losses
    and times back and writes the model."""
    jp, tp = _probs()
    jt = JTrainer(jp, track=True, verbose=False)
    tt = bt.Trainer(tp, track=True)
    jl, tl = jt.train(3), tt.train(3)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    jt.set_opt(optax.adam(5e-3), reset_state=False)
    tt.set_opt(lambda p: torch.optim.Adam(p, lr=5e-3), reset_state=False)
    np.testing.assert_allclose(tt.train(2), jt.train(2), rtol=1e-8)
    assert tt.loss.shape == (5,) and tt.times.shape == (5,)
    for k in ("params", "child.params"):
        np.testing.assert_allclose(tt.get_chain(k), jt.get_chain(k),
                                   rtol=1e-8)
    tt.revert_chain(2)
    jt.revert_chain(2)
    assert len(tt.loss_history) == len(jt.loss_history) == 3
    for k in ("params", "child.params"):
        assert _relerr(tt.pdict[k].detach().numpy(), jt.pdict[k]) <= 1e-8
        np.testing.assert_array_equal(tp.model[k].detach().numpy(),
                                      tt.pdict[k].detach().numpy())
        assert len(tt.chain[k]) == len(jt.chain[k]) == 3
    # a fresh chain of one key, by norm
    tt.init_chain(["params"])
    tt.track_norm = True
    tt.train(1)
    assert np.shape(tt.get_chain("params")) == (1,)
    with pytest.raises(ValueError):
        tt.revert_chain(1)


def test_trainer_reset_state_restarts_adam():
    _, tp = _probs()
    ta, tb = bt.Trainer(tp), bt.Trainer(_probs()[1])
    ta.train(2)
    tb.train(2)
    ta.set_opt(lambda p: torch.optim.Adam(p, lr=1e-2), reset_state=False)
    tb.set_opt(lambda p: torch.optim.Adam(p, lr=1e-2), reset_state=True)
    assert ta.opt.state and not tb.opt.state
