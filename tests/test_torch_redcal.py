"""The port's redundant calibration (models/calibration.py: VisModel,
RedVisModel, the redcal degeneracy projection and functions,
vis2JonesModel / vis2RedVisModel, chisq; inference/bfgs.py:
lbfgs_approx_cov) against the JAX package at float64 on the CPU, and a
small hera-redcal chain (hex-2, nside 8, 8 channels, 2 times):
Sequential(RIME -> RedVisModel -> JonesModel) with priors, its value and
gradients to 1e-9 relative and its L-BFGS trajectory to 1e-8. Inputs
come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.inference import bfgs as jbfgs
from bayeslim_tpu.models import calibration as jcal
from bayeslim_tpu_torch.models import calibration as tcal

from _torch_graft import (REDVIS, RGAINS, build_redcal_jax,
                          build_redcal_torch, cal_target, redcal_truth)

TOL = 1e-9
NF, NT = 5, 3


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _antpos(pkg):
    ants, antvecs = bt.utils.make_hex(2, D=15.0)
    return ants, pkg.utils.AntposDict(ants, antvecs)


def _bls(ants):
    return [(a, b) for i, a in enumerate(ants) for b in ants[i + 1:]]


def _vd(pkg, arr, bls, times, data, antpos=None):
    vd = pkg.VisData()
    vd.setup_meta(antpos=antpos)
    vd.setup_data(bls, times, np.linspace(100e6, 120e6, NF), pol="ee",
                  data=arr(data))
    return vd


def _grad_pair(jfn, tfn, x, w):
    """Value and gradient of sum(Re(f(x) w)) through both packages, for
    real x."""
    def jl(p):
        out = jfn(p)
        return jnp.sum(jnp.real(out * w)), out
    (jv, jout), jg = jax.value_and_grad(jl, has_aux=True)(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = tfn(xt)
    tv = torch.sum(torch.real(out * torch.as_tensor(w)))
    (tg,) = torch.autograd.grad(tv, xt)
    assert _relerr(out.detach().numpy(), jout) <= TOL
    assert abs(float(tv) - float(jv)) <= TOL * abs(float(jv))
    assert _relerr(tg.numpy(), jg) <= TOL


# ------------------------------------------------ VisModel / RedVisModel
@pytest.mark.parametrize("sel", ["all", "bls", "times", "both"])
@pytest.mark.parametrize("undo", [False, True])
def test_vis_model_minibatches_vs_jax(sel, undo):
    """A VisData carrying a subset of the params' baselines and / or
    times gets the matching params rows."""
    rng = np.random.default_rng(0)
    ants, _ = _antpos(bt)
    bls = _bls(ants)
    times = 2458168.3 + np.arange(NT) * 5e-4
    p = rng.standard_normal((1, 1, len(bls), NT, NF, 2))
    bsel = [bls[i] for i in (7, 2, 11)] if sel in ("bls", "both") else bls
    tsel = times[[2, 0]] if sel in ("times", "both") else times
    data = _c(rng, 1, 1, len(bsel), len(tsel), NF)
    blnums = bt.utils.ants2blnum(bls)
    jR = jcal.VisModelResponse(times=times)
    tR = tcal.VisModelResponse(times=times)

    def jfn(x):
        m = jcal.VisModel(x, R=jR, blnums=blnums)
        return m(_vd(bl, jnp.asarray, bsel, tsel, data), undo=undo).data

    def tfn(x):
        m = tcal.VisModel(x.detach(), R=tR, blnums=blnums, parameter=False,
                          device="cpu", dtype=torch.float64)
        m.params = x
        return m(_vd(bt, torch.as_tensor, bsel, tsel, data), undo=undo).data
    _grad_pair(jfn, tfn, p, _c(rng, 1, 1, len(bsel), len(tsel), NF))


@pytest.mark.parametrize("tsel", [None, [1], [2, 0]])
@pytest.mark.parametrize("pinned", [False, True])
def test_red_vis_model_vs_jax(tsel, pinned):
    """Expansion of the groups onto the baselines, with time minibatches
    and with the expansion index pinned by set_bls."""
    rng = np.random.default_rng(1)
    ants, tap = _antpos(bt)
    _, jap = _antpos(bl)
    bls = _bls(ants)
    reds, _, bl2red = bt.models.build_reds(tap, bls=bls, redtol=0.5)[:3]
    times = 2458168.3 + np.arange(NT) * 5e-4
    t = times if tsel is None else times[tsel]
    p = rng.standard_normal((1, 1, len(reds), NT, NF, 2))
    data = _c(rng, 1, 1, len(bls), len(t), NF)

    def jfn(x):
        m = jcal.RedVisModel(x, bl2red, R=jcal.VisModelResponse(times=times))
        if pinned:
            m.set_bls(np.asarray(bls))
        return m(_vd(bl, jnp.asarray, bls, t, data)).data

    def tfn(x):
        m = tcal.RedVisModel(x.detach(), bl2red,
                             R=tcal.VisModelResponse(times=times),
                             parameter=False, device="cpu",
                             dtype=torch.float64)
        m.params = x
        if pinned:
            m.set_bls(np.asarray(bls))
        return m(_vd(bt, torch.as_tensor, bls, t, data)).data
    _grad_pair(jfn, tfn, p, _c(rng, 1, 1, len(bls), len(t), NF))
    # each baseline carries its group's value
    m = tcal.RedVisModel(p, bl2red, device="cpu", dtype=torch.float64)
    out = m(_vd(bt, torch.as_tensor, bls, times,
                np.zeros((1, 1, len(bls), NT, NF), complex)), undo=True)
    pc = p[..., 0] + 1j * p[..., 1]
    for i, b in enumerate(bls):
        np.testing.assert_array_equal(out.data[0, 0, i].detach().numpy(),
                                      -pc[0, 0, bl2red[b]])


# ------------------------------------------------ degeneracy projection
@pytest.mark.parametrize("abs_amp,phs_slope", [(True, False), (False, True),
                                               (True, True)])
@pytest.mark.parametrize("wgts", [False, True])
@pytest.mark.parametrize("refant_idx", [None, 0])
def test_projection_value_and_grad_vs_jax(abs_amp, phs_slope, wgts,
                                          refant_idx):
    """JonesResponse with setup_projection: the degeneracies are fitted
    on the detached gains in both packages, so value and gradient
    agree."""
    rng = np.random.default_rng(2)
    ants, tap = _antpos(bt)
    _, jap = _antpos(bl)
    w = rng.uniform(0.5, 2, len(ants)) if wgts else None
    kw = dict(param_type="com", abs_amp_gain=abs_amp,
              phs_slope_gain=phs_slope, wgts_gain=w, refant_idx=refant_idx)
    jR, tR = jcal.JonesResponse(antpos=jap, **kw), \
        tcal.JonesResponse(antpos=tap, **kw)
    p = rng.standard_normal((1, 1, len(ants), 2, NF, 2)) * 0.1
    p[..., 0] += 1
    _grad_pair(jR, tR, p, _c(rng, 1, 1, len(ants), 2, NF))
    # the projected gains carry no degeneracy (the refant's phase, taken
    # out after them, is a constant: no slope over the centred array,
    # but a weighted fit's centre is elsewhere)
    g = tR(torch.as_tensor(p))
    aa, ps = tcal.compute_redcal_degen(g, ants, tap, wgts=w)
    if abs_amp:
        assert float(aa.abs().max()) <= 1e-12
    if phs_slope and not (wgts and refant_idx is not None):
        assert float(ps.abs().max()) <= 1e-12


@pytest.mark.parametrize("wgts", [False, True])
def test_degeneracy_functions_vs_jax(wgts):
    rng = np.random.default_rng(3)
    ants, tap = _antpos(bt)
    _, jap = _antpos(bl)
    g = 1 + 0.1 * _c(rng, 1, 1, len(ants), 2, NF)
    w = rng.uniform(0.5, 2, len(ants)) if wgts else None
    ref = jcal.compute_redcal_degen(jnp.asarray(g), ants, jap, wgts=w)
    got = tcal.compute_redcal_degen(torch.as_tensor(g), ants, tap, wgts=w)
    for r, t in zip(ref, got):
        assert _relerr(t.numpy(), r) <= TOL
    dg_ref = jcal.redcal_degen_gains(*ref, ants=ants, antpos=jap)
    dg = tcal.redcal_degen_gains(*got, ants=ants, antpos=tap)
    assert _relerr(dg.numpy(), dg_ref) <= TOL
    # remove, with a replacement degeneracy and a redvis that takes them
    bls = _bls(ants)[:6]
    rv = _c(rng, 1, 1, len(bls), 2, NF)
    degen = np.exp(0.1j * rng.standard_normal((1, 1, len(ants), 2, NF)))
    jout = jcal.remove_redcal_degen(jnp.asarray(g), ants, jap,
                                    degen=jnp.asarray(degen), wgts=w,
                                    redvis=jnp.asarray(rv), bls=bls)
    tout = tcal.remove_redcal_degen(torch.as_tensor(g), ants, tap,
                                    degen=torch.as_tensor(degen), wgts=w,
                                    redvis=torch.as_tensor(rv), bls=bls)
    for r, t in zip(jout, tout):
        assert _relerr(t.numpy(), r) <= TOL
    # idempotent: a second removal leaves the gains as they are
    once = tcal.remove_redcal_degen(torch.as_tensor(g), ants, tap,
                                    wgts=w)[0]
    twice = tcal.remove_redcal_degen(once, ants, tap, wgts=w)[0]
    assert _relerr(twice.numpy(), once.numpy()) <= 1e-12


@pytest.mark.parametrize("wgts", [False, True])
@pytest.mark.parametrize("as_visdata", [False, True])
def test_degeneracy_of_visibilities_vs_jax(wgts, as_visdata):
    rng = np.random.default_rng(4)
    ants, tap = _antpos(bt)
    _, jap = _antpos(bl)
    bls = _bls(ants)
    data = _c(rng, 1, 1, len(bls), 2, NF)
    w = rng.uniform(0.5, 2, len(bls)) if wgts else None
    times = np.arange(2.0)
    if as_visdata:
        jin = _vd(bl, jnp.asarray, bls, times, data, jap)
        tin = _vd(bt, torch.as_tensor, bls, times, data, tap)
        jkw = tkw = {}
    else:
        jin, tin = jnp.asarray(data), torch.as_tensor(data)
        jkw, tkw = dict(bls=bls, antpos=jap), dict(bls=bls, antpos=tap)
    ref = jcal.compute_redcal_degen_vis(jin, wgts=w, **jkw)
    got = tcal.compute_redcal_degen_vis(tin, wgts=w, **tkw)
    for r, t in zip(ref, got):
        assert _relerr(t.numpy(), r) <= TOL
    vref = jcal.redcal_degen_vis(*ref, vd=jin if as_visdata else None,
                                 **jkw)
    vgot = tcal.redcal_degen_vis(*got, vd=tin if as_visdata else None,
                                 **tkw)
    if as_visdata:
        assert vgot.bls == list(vref.bls)
        vref, vgot = vref.data, vgot.data
    assert _relerr(vgot.numpy(), vref) <= TOL


# ------------------------------------------------ vis2* and chisq
def test_vis2models_vs_jax():
    ants, tap = _antpos(bt)
    _, jap = _antpos(bl)
    bls = _bls(ants)
    data = np.zeros((1, 1, len(bls), 2, NF), complex)
    jvd = _vd(bl, jnp.asarray, bls, np.arange(2.0), data, jap)
    tvd = _vd(bt, torch.as_tensor, bls, np.arange(2.0), data, tap)
    jr = jcal.vis2RedVisModel(jvd, redtol=0.5)
    tr = bt.vis2RedVisModel(tvd, redtol=0.5, device="cpu",
                            dtype=torch.float64)
    assert tuple(tr.params.shape) == jr.params.shape
    assert tr.bl2red == jr.bl2red
    np.testing.assert_array_equal(tr.red_index(tvd.blnums),
                                  jr.red_index(jvd.blnums))
    for refant, single in ((None, False), (ants[2], False), (None, True)):
        jj = jcal.vis2JonesModel(jvd, refant=refant, single_ant=single)
        tj = bt.vis2JonesModel(tvd, refant=refant, single_ant=single,
                               device="cpu", dtype=torch.float64)
        assert tj.ants == jj.ants and tj.refant_idx == jj.refant_idx
        np.testing.assert_array_equal(tj.params.detach().numpy(),
                                      jj.params)
    # the 'linear' modes size the params by their LinearModels' columns
    # and the response maps them back to the data's times and channels
    from bayeslim_tpu.models import linear_model as jlm
    lkw = dict(dim=3, x=np.arange(2.0), Ndeg=1, basis="direct")
    jr = jcal.vis2RedVisModel(jvd, redtol=0.5, time_mode="linear",
                              time_LM=jlm.LinearModel("poly", **lkw))
    tr = bt.vis2RedVisModel(tvd, redtol=0.5, time_mode="linear",
                            time_LM=bt.LinearModel("poly", device="cpu",
                                                   dtype=torch.float64,
                                                   **lkw),
                            device="cpu", dtype=torch.float64)
    assert tuple(tr.params.shape) == jr.params.shape
    assert jr.params.shape[3] == 1
    p = np.random.default_rng(3).standard_normal(jr.params.shape)
    assert _relerr(tr.R(torch.as_tensor(p)).numpy(),
                   jr.R(jnp.asarray(p))) <= TOL


@pytest.mark.parametrize("axis,dof,cov_axis", [
    (None, None, None), ((2, 3), 7.0, None), (None, 3.0, "freq"),
])
def test_chisq_vs_jax(axis, dof, cov_axis):
    rng = np.random.default_rng(5)
    a, b = _c(rng, 1, 1, 3, 2, NF), _c(rng, 1, 1, 3, 2, NF)
    if cov_axis is None:
        w = rng.uniform(0.5, 2, a.shape)
    else:
        A = _c(rng, 1, 1, 3, 2, NF, NF)
        w = A @ np.swapaxes(A.conj(), -1, -2) + NF * np.eye(NF)
    ref = jcal.chisq(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
                     axis=axis, dof=dof, cov_axis=cov_axis)
    got = tcal.chisq(torch.as_tensor(a), torch.as_tensor(b),
                     torch.as_tensor(w), axis=axis, dof=dof,
                     cov_axis=cov_axis)
    assert got.shape == tuple(np.shape(ref))
    assert _relerr(got.numpy(), ref) <= TOL


# ------------------------------------------------ small hera-redcal
@pytest.fixture(scope="module")
def redcal_case():
    """Truth and noisy target of the small chain, and a start away from
    both the truth and the construction point."""
    prob = build_redcal_torch()
    truth = redcal_truth(prob)
    rng = np.random.default_rng(6)
    start = {k: v + 0.3 * np.std(v) * rng.standard_normal(np.shape(v))
             for k, v in truth.items()}
    return cal_target(prob, truth), truth, start


def _pair(case, load_start=True):
    target, _, start = case
    tp, jp = build_redcal_torch(target=target), build_redcal_jax(target)
    if load_start:
        bt.load_numpy_pdict(tp.model, start)
        jp.update(bl.ParamDict({k: jnp.asarray(v) for k, v in start.items()}))
    return tp, jp


def test_redcal_chain_layout(redcal_case):
    tp, _ = _pair(redcal_case, load_start=False)
    seq = tp.model
    assert tp.collect_main_params().keys() == [RGAINS, REDVIS]
    assert tuple(seq.redvis.params.shape) == (1, 1, 9, 2, 8, 2)
    assert tuple(seq.cal.params.shape) == (1, 1, 7, 1, 8, 2)
    # the forward memoises both priors, under the modules' names
    _, _, cache = tp.forward_chisq()
    assert sorted(cache) == ["JonesModel", "RedVisModel"]


@pytest.mark.parametrize("compute", ["post", "like", "prior"])
def test_redcal_chain_value_and_grad_vs_jax(redcal_case, compute):
    tp, jp = _pair(redcal_case)
    tp.compute = jp.compute = compute
    tv, tg = tp.value_and_grad()
    jv, jg = jp.value_and_grad()
    assert abs(tv.item() - float(jv)) <= TOL * abs(float(jv))
    for k in tg.keys():
        assert _relerr(tg[k].numpy(), jg[k]) <= TOL, k


def test_redcal_lbfgs_trajectory_vs_jax(redcal_case):
    tp, jp = _pair(redcal_case, load_start=False)
    to, jo = bt.LBFGS(tp, H0=1e-3), jbfgs.LBFGS(jp, H0=1e-3)
    tl, jl = to.minimize(5), jo.minimize(5)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    assert tl[-1] < tl[0]
    assert to.func_evals == jo.func_evals and to.n_iter == jo.n_iter
    for k in to.pdict.keys():
        assert _relerr(to.pdict[k].detach().numpy(), jo.pdict[k]) <= 1e-8, k
    # the solved gains carry no redcal degeneracy
    g = tp.model.cal.get_jones().detach()
    ants = tp.model.cal.ants
    aa, ps = tcal.compute_redcal_degen(g, ants, tp.model.cal.R.antpos)
    assert float(aa.abs().max()) <= 1e-12 and float(ps.abs().max()) <= 1e-12


@pytest.mark.parametrize("form,as_dense", [
    ("per-leaf", True), ("dense", True), ("per-leaf", False),
    ("dense", False)], ids=["per-leaf", "dense", "per-leaf-as_dense=False",
                            "dense-as_dense=False"])
def test_lbfgs_approx_cov_vs_jax(redcal_case, form, as_dense):
    """Both forms against the JAX package at 1e-8; as_dense is accepted
    and read by neither form, in both packages (the per-leaf form gives
    a DiagMat, the dense form a matrix)."""
    tp, jp = _pair(redcal_case)
    if form == "per-leaf":
        tc = bt.lbfgs_approx_cov(tp, Nsteps=2, H0=1e-3, as_dense=as_dense)
        jc = jbfgs.lbfgs_approx_cov(jp, Nsteps=2, H0=1e-3, as_dense=as_dense)
        assert type(tc).__name__ == type(jc).__name__ == "DiagMat"
        assert tc.shape == jc.shape
        assert _relerr(tc.diag.numpy(), jc.diag) <= 1e-8
        # the probe steps moved the model, as in the JAX package
        for k in (RGAINS, REDVIS):
            assert not np.allclose(tp.model[k].detach().numpy(),
                                   redcal_case[2][k])
            assert _relerr(tp.model[k].detach().numpy(),
                           jp.model[k]) <= 1e-8
    else:
        to, jo = bt.LBFGS(tp, H0=1e-3), jbfgs.LBFGS(jp, H0=1e-3)
        to.minimize(3)
        jo.minimize(3)
        tH = bt.lbfgs_approx_cov(to, as_dense=as_dense)
        jH = jbfgs.lbfgs_approx_cov(jo, as_dense=as_dense)
        assert tH.shape == jH.shape == (to.x.numel(),) * 2
        assert _relerr(tH.numpy(), jH) <= 1e-8
        np.testing.assert_allclose(tH.numpy(), tH.numpy().T, rtol=1e-12,
                                   atol=1e-14 * float(tH.abs().max()))


def test_lbfgs_approx_cov_takes_an_h0_per_leaf(redcal_case):
    """H0 may map each leaf to its own start (the JAX package takes one
    for all): the leaf's block follows it."""
    tp, _ = _pair(redcal_case)
    h0 = {RGAINS: 1e-3, REDVIS: 1e-2}
    cov = bt.lbfgs_approx_cov(tp, Nsteps=1, H0=h0)
    n = tp.model.cal.params.numel()
    assert cov.shape == ((n + tp.model.redvis.params.numel()),) * 2
    assert torch.all(cov.diag > 0)


def test_quasi_newton_refuses_complex_leaves():
    """ROADMAP queue C1 for BFGS and L-BFGS: neither package steps a
    complex leaf (the JAX package fails in its line search, the port
    says why at construction), so neither steps one uphill."""
    class M(bt.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("params", torch.tensor([1 + 2j]))
            self.set_param("params")

        def forward(self, *args, **kwargs):
            return self.params
    tgt = bt.data.TensorData()
    tgt.setup_data(data=torch.zeros(1, dtype=torch.complex64))
    for opt in (bt.BFGS, bt.LBFGS):
        with pytest.raises(ValueError, match="real pairs"):
            opt(bt.LogProb(M(), tgt))
