"""The port's calibration slice against the JAX package: gain
parameterisations, JonesModel, apply_cal, the refant projection, the
small hera-cal chain Sequential(RIME -> JonesModel) with trainable
antenna positions and gains (value and gradients), and BFGS / L-BFGS
trajectories on it. Inputs come from numpy seeds; everything compares at
float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.inference import bfgs as jbfgs
from bayeslim_tpu.models import calibration as jcal
from bayeslim_tpu.models import linear_model as jlm
from bayeslim_tpu_torch.models import calibration as tcal

from _torch_graft import build_cal_jax, build_cal_torch, cal_target, cal_truth

NANT, NFREQ = 5, 6
ANTS = [0, 2, 3, 7, 9]
BLS = [(0, 2), (0, 7), (2, 3), (3, 9), (7, 9), (9, 0), (2, 2)]


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _cplx(rng, shape, scale=0.1):
    return 1 + scale * (rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape))


@pytest.mark.parametrize("ptype", ["com", "real", "amp", "phs", "amp_phs",
                                   "dly"])
def test_params2complex_vs_jax(ptype):
    rng = np.random.default_rng(0)
    shape = (1, 1, NANT, 2, NFREQ) + ((2,) if ptype in ("com", "amp_phs")
                                      else ())
    p = rng.standard_normal(shape)
    freqs = np.linspace(100e6, 120e6, NFREQ)
    ref = jcal.params2complex(jnp.asarray(p), ptype, freqs=freqs)
    got = tcal.params2complex(torch.as_tensor(p), ptype, freqs=freqs)
    assert got.dtype == torch.complex128
    assert _relerr(got.numpy(), ref) <= 1e-9
    if ptype not in ("com", "dly"):
        back = tcal.complex2params(got, ptype)
        assert _relerr(back.numpy(),
                       jcal.complex2params(ref, ptype)) <= 1e-9


@pytest.mark.parametrize("npol,cal_2pol", [(1, False), (2, True), (2, False)])
@pytest.mark.parametrize("undo", [False, True])
def test_apply_cal_vs_jax(npol, cal_2pol, undo):
    rng = np.random.default_rng(1)
    vis = _cplx(rng, (npol, npol, len(BLS), 2, NFREQ), 1.0)
    gains = _cplx(rng, (npol, npol, NANT, 2, NFREQ))
    ref, _ = jcal.apply_cal(jnp.asarray(vis), BLS, jnp.asarray(gains), ANTS,
                            cal_2pol=cal_2pol, undo=undo)
    got, _ = tcal.apply_cal(torch.as_tensor(vis), BLS,
                            torch.as_tensor(gains), ANTS, cal_2pol=cal_2pol,
                            undo=undo)
    assert _relerr(got.numpy(), ref) <= 1e-9
    # undo inverts apply
    back, _ = tcal.apply_cal(got, BLS, torch.as_tensor(gains), ANTS,
                             cal_2pol=cal_2pol, undo=not undo)
    assert _relerr(back.numpy(), vis) <= 1e-9


@pytest.mark.parametrize("ptype,mode", [("com", "rephase"), ("com", "zero"),
                                        ("phs", "rephase"), ("dly", "zero")])
@pytest.mark.parametrize("with_p0", [False, True])
def test_rephase_to_refant_vs_jax(ptype, mode, with_p0):
    rng = np.random.default_rng(2)
    shape = (1, 1, NANT, 1, NFREQ)
    if ptype == "com":
        p, p0 = _cplx(rng, shape), _cplx(rng, shape, 0.01) - 1
    else:
        p, p0 = rng.standard_normal(shape), rng.standard_normal(shape)
    p0 = p0 if with_p0 else None
    ref = jcal.rephase_to_refant(jnp.asarray(p), ptype, 2,
                                 p0=None if p0 is None else jnp.asarray(p0),
                                 mode=mode)
    got = tcal.rephase_to_refant(torch.as_tensor(p), ptype, 2,
                                 p0=None if p0 is None
                                 else torch.as_tensor(p0), mode=mode)
    assert _relerr(got.numpy(), ref) <= 1e-9


def _jones_pair(seed, polmode, slope=None):
    """The same JonesModel through both packages (refant ANTS[1])."""
    rng = np.random.default_rng(seed)
    npol = 1 if polmode == "1pol" else 2
    freqs = np.linspace(100e6, 120e6, NFREQ)
    if slope:
        p = rng.standard_normal((npol, npol, 2, 1, NFREQ)) * 0.01
        antvecs = rng.uniform(-30, 30, (NANT, 3))
        kw = dict(param_type=slope, freqs=freqs)
        jR = jcal.JonesResponse(antpos=bl.utils.AntposDict(ANTS, antvecs),
                                **kw)
        tR = tcal.JonesResponse(antpos=bt.utils.AntposDict(ANTS, antvecs),
                                **kw)
        refant = None
    else:
        g = _cplx(rng, (npol, npol, NANT, 1, NFREQ))
        p = np.stack([g.real, g.imag], axis=-1)
        jR, tR = (m.JonesResponse(param_type="com") for m in (jcal, tcal))
        refant = ANTS[1]
    J = jcal.JonesModel(jnp.asarray(p), ANTS, refant=refant, R=jR,
                        polmode=polmode)
    T = tcal.JonesModel(p, ANTS, refant=refant, R=tR, polmode=polmode,
                        device="cpu", dtype=torch.float64)
    vis = _cplx(rng, (npol, npol, len(BLS), 2, NFREQ), 1.0)
    return J, T, vis


def _vd(pkg, vis, asarray):
    vd = pkg.VisData()
    vd.setup_data(BLS, 2458168.3 + np.arange(2) * 5e-4,
                  np.linspace(100e6, 120e6, NFREQ),
                  pol="ee" if vis.shape[0] == 1 else None, data=asarray(vis))
    return vd


@pytest.mark.parametrize("polmode,slope", [("1pol", None), ("2pol", None),
                                           ("4pol", None),
                                           ("1pol", "dly_slope"),
                                           ("1pol", "phs_slope")])
def test_jones_model_forward_and_grad_vs_jax(polmode, slope):
    J, T, vis = _jones_pair(3, polmode, slope)
    # fix_refant_phs ran on both at construction
    np.testing.assert_allclose(T.params.detach().numpy(), J.params,
                               rtol=1e-12, atol=1e-14)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape)

    def jloss(p):
        J.params = p
        out = J(_vd(bl, vis, jnp.asarray)).data
        return jnp.sum(jnp.real(out * w)), out
    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(J.params))
    out = T(_vd(bt, vis, torch.as_tensor)).data
    tl = torch.sum(torch.real(out * torch.as_tensor(w)))
    (tg,) = torch.autograd.grad(tl, T.params)
    assert _relerr(out.detach().numpy(), jout) <= 1e-9
    assert abs(tl.item() - float(jl)) <= 1e-9 * abs(float(jl))
    assert _relerr(tg.numpy(), jg) <= 1e-9


def test_jones_model_rejects_what_is_not_ported():
    """The redcal degeneracy projections, the 'linear' modes and the
    CalData export are ported: to_CalData's gains match the JAX
    package's, detached."""
    LM = bt.LinearModel("poly", dim=4, x=np.linspace(1e8, 2e8, 4), Ndeg=2,
                        device="cpu")
    R = tcal.JonesResponse(freq_mode="linear", freq_LM=LM)
    assert R.freq_LM is LM and dict(R.named_buffers())["freq_LM.A"] is LM.A
    R = tcal.JonesResponse(abs_amp_gain=True)
    assert R._proj_abs_amp and R._projection
    p = np.random.default_rng(0).standard_normal((1, 1, 2, 1, 2, 2))
    J = tcal.JonesModel(p, [0, 1], refant=0, device="cpu",
                        dtype=torch.float64)
    cd = J.to_CalData(np.ones(2), np.ones(1), pol="ee")
    jcd = jcal.JonesModel(jnp.asarray(p), [0, 1], refant=0).to_CalData(
        np.ones(2), np.ones(1), pol="ee")
    assert cd.ants == jcd.ants and cd.pol == jcd.pol == "ee"
    assert not cd.data.requires_grad and J.params.requires_grad
    assert _relerr(cd.data.numpy(), jcd.data) <= 1e-9


def _linear_LMs(pkg, freq, time, ntime):
    """The 'linear' modes' LinearModels of a JonesResponse: 4 Legendre
    coefficients over the channels (dim 4), 2 over the times (dim 3)."""
    kw = {} if pkg is jlm else dict(dtype=torch.float64, device="cpu")
    out = {}
    if freq:
        out.update(freq_mode="linear", freq_LM=pkg.LinearModel(
            "poly", dim=4, x=np.linspace(100e6, 120e6, NFREQ), Ndeg=4,
            basis="legendre", whiten=True, **kw))
    if time:
        out.update(time_mode="linear", time_LM=pkg.LinearModel(
            "poly", dim=3, x=np.arange(ntime, dtype=float), Ndeg=2,
            basis="direct", whiten=True, **kw))
    return out


@pytest.mark.parametrize("freq,time,ptype,refant", [
    (True, False, "com", True), (False, True, "com", False),
    (True, True, "com", True), (True, False, "amp", False),
    (True, False, "phs", True), (True, False, "dly_slope", False)])
def test_jones_linear_modes_vs_jax(freq, time, ptype, refant):
    """JonesModel with the 'linear' freq and / or time modes (gains from
    polynomial coefficients, tests/test_calibration.py:187's form), each
    param type, the refant's phase zeroed on the coefficients: forward
    and gradient against the JAX package, and vis2JonesModel's sizing
    by the LinearModels' columns."""
    rng = np.random.default_rng(6)
    freqs = np.linspace(100e6, 120e6, NFREQ)
    ntime = 2
    nf = 4 if freq else NFREQ
    nt = 2 if time else ntime
    slope = ptype == "dly_slope"
    nant = 2 if slope else NANT
    shape = (1, 1, nant, nt, nf)
    if ptype == "com":
        p = np.stack([1 + 0.1 * rng.standard_normal(shape),
                      0.1 * rng.standard_normal(shape)], axis=-1)
    else:
        p = 0.1 * rng.standard_normal(shape)
    antvecs = rng.uniform(-30, 30, (NANT, 3))
    kw = dict(param_type=ptype, freqs=freqs)
    jR = jcal.JonesResponse(antpos=bl.utils.AntposDict(ANTS, antvecs), **kw,
                            **_linear_LMs(jlm, freq, time, ntime))
    tR = tcal.JonesResponse(antpos=bt.utils.AntposDict(ANTS, antvecs), **kw,
                            **_linear_LMs(bt, freq, time, ntime))
    ra = ANTS[1] if refant else None
    J = jcal.JonesModel(jnp.asarray(p), ANTS, refant=ra, R=jR)
    T = tcal.JonesModel(p, ANTS, refant=ra, R=tR, device="cpu",
                        dtype=torch.float64)
    np.testing.assert_allclose(T.params.detach().numpy(), J.params,
                               rtol=1e-12, atol=1e-14)
    vis = _cplx(rng, (1, 1, len(BLS), ntime, NFREQ), 1.0)
    w = rng.standard_normal(vis.shape) + 1j * rng.standard_normal(vis.shape)

    def jloss(q):
        J.params = q
        out = J(_vd(bl, vis, jnp.asarray)).data
        return jnp.sum(jnp.real(out * w)), out
    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(J.params))
    out = T(_vd(bt, vis, torch.as_tensor)).data
    tl = torch.sum(torch.real(out * torch.as_tensor(w)))
    (tg,) = torch.autograd.grad(tl, T.params)
    assert _relerr(out.detach().numpy(), jout) <= 1e-9
    assert _relerr(tg.numpy(), jg) <= 1e-9
    # vis2JonesModel sizes the params by the LinearModels' columns
    jvd, tvd = _vd(bl, vis, jnp.asarray), _vd(bt, vis, torch.as_tensor)
    tvd.setup_meta(antpos=bt.utils.AntposDict(ANTS, antvecs))
    jvd.setup_meta(antpos=bl.utils.AntposDict(ANTS, antvecs))
    jj = jcal.vis2JonesModel(jvd, param_type=ptype, freqs=freqs,
                             **_linear_LMs(jlm, freq, time, ntime))
    tj = bt.vis2JonesModel(tvd, param_type=ptype, freqs=freqs,
                           **_linear_LMs(bt, freq, time, ntime),
                           device="cpu", dtype=torch.float64)
    assert tuple(tj.params.shape) == jj.params.shape
    np.testing.assert_array_equal(tj.params.detach().numpy(), jj.params)


# ------------------------------------------------------- small hera-cal chain
@pytest.fixture(scope="module")
def cal_case():
    """Numpy truth and noisy target of the small chain (hex-2, nside 8,
    8 frequencies, 2 times)."""
    prob = build_cal_torch()
    antvecs = prob.model.rime.array.antvecs.detach().numpy()
    truth = cal_truth(antvecs)
    # a start away from the truth and from the construction positions
    rng = np.random.default_rng(5)
    start = {k: v + 0.3 * (v - p) * rng.standard_normal(np.shape(v))
             for (k, v), p in zip(sorted(truth.items()),
                                  (np.asarray(prob.model.cal.params.detach()),
                                   antvecs))}
    return cal_target(prob, truth), truth, start


def _pair(cal_case, load_start=True):
    target, _, start = cal_case
    tp, jp = build_cal_torch(target=target), build_cal_jax(target)
    if load_start:
        bt.load_numpy_pdict(tp.model, start)
        jp.update(bl.ParamDict({k: jnp.asarray(v)
                                for k, v in start.items()}))
    return tp, jp


def test_cal_chain_keys_and_sequential(cal_case):
    tp, _ = _pair(cal_case, load_start=False)
    seq = tp.model
    assert tp.collect_main_params().keys() == [
        "models.cal.params", "models.rime.array.antvecs"]
    assert seq.rime is seq.models["rime"] and seq.cal is seq.models["cal"]
    assert seq.Nbatch == 1 and seq.batch_idx == 0
    with pytest.raises(ValueError):
        seq.batch_idx = 1
    pd = tp.collect_main_params()
    flat = pd.ravel()
    assert flat.shape == (sum(v.numel() for v in pd.values()),)
    back = pd.unravel(flat * 2)
    for k in pd.keys():
        assert torch.equal(back[k], pd[k] * 2)
    # updated() walks through the ModuleDict and leaves the original
    new = seq.updated(bt.ParamDict({"models.rime.array.antvecs":
                                    pd["models.rime.array.antvecs"] + 1}))
    assert torch.equal(new.rime.array.antvecs, seq.rime.array.antvecs + 1)
    assert new.cal is seq.cal


@pytest.mark.parametrize("complex_circular", [True, False])
def test_cal_chain_value_and_grad_vs_jax(cal_case, complex_circular):
    tp, jp = _pair(cal_case)
    tp.complex_circular = jp.complex_circular = complex_circular
    tv, tg = tp.value_and_grad()
    jv, jg = jp.value_and_grad()
    assert abs(tv.item() - float(jv)) <= 1e-9 * abs(float(jv))
    for k in tg.keys():
        assert _relerr(tg[k].numpy(), jg[k]) <= 1e-9, k


@pytest.mark.parametrize("opt,kw", [
    ("LBFGS", dict(H0=1e-5)),
    ("LBFGS", dict(H0=bt.DiagMat(torch.tensor(1e-5, dtype=torch.float64),
                                 size=133), history_size=2)),
    ("BFGS", dict(H0=1e-5)),
])
def test_quasi_newton_trajectory_vs_jax(cal_case, opt, kw):
    tp, jp = _pair(cal_case)
    jkw = dict(kw)
    if isinstance(kw["H0"], bt.DiagMat):
        jkw["H0"] = bl.inference.hmat.DiagMat(kw["H0"].diag.numpy())
    to, jo = getattr(bt, opt)(tp, **kw), getattr(jbfgs, opt)(jp, **jkw)
    tl, jl = to.minimize(5), jo.minimize(5)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    assert tl[-1] < tl[0]
    assert to.func_evals == jo.func_evals and to.n_iter == jo.n_iter
    for k in to.pdict.keys():
        assert _relerr(to.pdict[k].detach().numpy(), jo.pdict[k]) <= 1e-8, k
        # each step writes its parameters into the model
        np.testing.assert_array_equal(
            dict(tp.model.named_parameters())[k].detach().numpy(),
            to.pdict[k].detach().numpy())
    if opt == "LBFGS":
        assert _relerr(to.H.diag.numpy(), jo.H.diag) <= 1e-8


def test_to_antpos_follows_trained_antvecs(cal_case):
    """After an optimizer step the array reports its trained positions,
    as the JAX package's ArrayModel.to_antpos does."""
    tp, jp = _pair(cal_case)
    bt.LBFGS(tp, H0=1e-5).step()
    jbfgs.LBFGS(jp, H0=1e-5).step()
    tarr, jarr = tp.model.rime.array, jp.model.models["rime"].array
    got = tarr.to_antpos()
    ref = jarr.to_antpos().asnumpy()
    assert not np.allclose(ref, cal_case[2]["models.rime.array.antvecs"])
    assert _relerr(got.asnumpy(), ref) <= 1e-9
    # differentiable accessors
    ants = got.ants
    np.testing.assert_allclose(tarr.get_antpos(ants[2]).detach().numpy(),
                               ref[2], rtol=1e-12)
    bls = [(ants[0], ants[3]), (ants[4], ants[1])]
    bv = tarr.get_blvecs(bls)
    np.testing.assert_allclose(bv.detach().numpy(),
                               np.asarray(jarr.get_blvecs(bls)), rtol=1e-12)
    assert bv.requires_grad
