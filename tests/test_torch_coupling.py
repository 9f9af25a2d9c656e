"""The port's antenna cross-coupling (models/coupling.py) against the JAX
package at float64 on the CPU: tests/test_coupling.py's cases rebuilt on
both sides (VisCoupling against a direct E V E^H, its double path and
identity, RedVisCoupling against VisCoupling on inflated data,
CouplingInflate, gen_coupling_terms' redundant compression and cut_bl,
setup_coupling's independent first / second-order cuts), values and
gradients; PartialRedVisInflate's mixing matrix; and the hera-coupling
chain of chip_smoke.py (RIME -> RedVisCoupling with CouplingInflate
terms -> JonesModel) at hex-2. Complex leaves compare the conjugate of
the JAX gradient (ROADMAP queue C1). Inputs come from numpy seeds;
1e-9 relative unless a case says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import coupling as jc
from bayeslim_tpu.models.telescope import build_reds
from bayeslim_tpu_torch.models import coupling as tc

TOL = 1e-9
T64 = dict(device="cpu", dtype=torch.float64)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _setup(seed=0, Nfreqs=4, Ntimes=1):
    """tests/test_coupling.py's _setup: hex-2, every upper-triangle
    baseline with autos, a Hermitian visibility matrix; the VisData in
    both packages."""
    rng = np.random.default_rng(seed)
    ants, antvecs = bt.utils.make_hex(2)
    nant = len(ants)
    freqs = np.linspace(100e6, 110e6, Nfreqs)
    bls = [(a1, a2) for i, a1 in enumerate(ants) for a2 in ants[i:]]
    Vm = rng.normal(size=(nant, nant, Ntimes, Nfreqs)) + \
        1j * rng.normal(size=(nant, nant, Ntimes, Nfreqs))
    Vm = Vm + Vm.conj().transpose(1, 0, 2, 3)
    lut = {a: i for i, a in enumerate(ants)}
    data = np.stack([Vm[lut[b[0]], lut[b[1]]] for b in bls])[None, None]
    jvd = bl.data.containers.VisData()
    jvd.setup_data(bls, np.arange(Ntimes) * 1.0, freqs, pol="ee",
                   data=jnp.asarray(data))
    tvd = bt.VisData()
    tvd.setup_data(bls, np.arange(Ntimes) * 1.0, freqs, pol="ee",
                   data=torch.as_tensor(data))
    return (ants, antvecs, freqs, bls, Vm, jvd, tvd, rng)


def _antpos(ants, antvecs):
    return (bl.utils.AntposDict(ants, antvecs),
            bt.utils.AntposDict(ants, antvecs))


def _dly(antvecs, freqs):
    av = np.asarray(antvecs)
    dist = np.linalg.norm(av[None] - av[:, None], axis=-1)
    return np.exp(2j * np.pi * (freqs - freqs[0]) / 2.99792458e8
                  * dist[..., None])


def _manual_couple(Vm, X, dly, add_I=True, double=False):
    """E V E^H per (time, freq), with numpy."""
    nant = Vm.shape[0]
    out = np.zeros_like(Vm)
    for t in range(Vm.shape[2]):
        for f in range(Vm.shape[3]):
            E = X[:, :, t % X.shape[2], f] * dly[:, :, f]
            if double:
                E = E + E @ E
            if add_I:
                E = E + np.eye(nant)
            out[:, :, t, f] = E @ Vm[:, :, t, f] @ E.conj().T
    return out


def _pairs(X):
    """Complex coupling params as real pairs (a trailing dim of 2)."""
    return np.stack([X.real, X.imag], axis=-1)


def _grads_vs_jax(jmod, tmod, jvd, tvd, key="params"):
    """d sum |out|^2 / d params of both packages (real-pair params)."""
    jp = getattr(jmod, key)
    jg = jax.grad(lambda p: jnp.sum(jnp.abs(
        _jax_with(jmod, key, p)(jvd).data) ** 2))(jp)
    tp = tmod.params.detach().clone().requires_grad_(True)
    out = tmod.updated(bt.ParamDict({key: tp}))(tvd).data
    tg, = torch.autograd.grad(torch.sum(out.abs() ** 2), tp)
    return _np(tg), np.asarray(jg)


def _jax_with(mod, key, val):
    from bayeslim_tpu.utils.module import tree_replace
    return tree_replace(mod, {key: val})


@pytest.mark.parametrize("double", [False, True])
def test_viscoupling_matches_matrix_product_vs_jax(double):
    ants, antvecs, freqs, bls, Vm, jvd, tvd, rng = _setup(seed=1 if double
                                                          else 0)
    nant = len(ants)
    X = (rng.normal(size=(nant, nant, 1, len(freqs))) +
         1j * rng.normal(size=(nant, nant, 1, len(freqs)))) * 0.01
    jap, tap = _antpos(ants, antvecs)
    jv = jc.VisCoupling(jnp.asarray(X[None, None]), freqs, jap, bls,
                        double=double)
    tv = tc.VisCoupling(X[None, None], freqs, tap, bls, double=double, **T64)
    out = _np(tv(tvd).data)
    truth_mat = _manual_couple(Vm, X, _dly(antvecs, freqs), double=double)
    lut = {a: i for i, a in enumerate(ants)}
    truth = np.stack([truth_mat[lut[b[0]], lut[b[1]]] for b in bls])
    assert np.abs(out[0, 0] - truth).max() < 1e-10
    assert _relerr(out, np.asarray(jv(jvd).data)) <= TOL
    # gradients, real-pair params
    jv = jc.VisCoupling(jnp.asarray(_pairs(X)[None, None]), freqs, jap, bls,
                        double=double)
    tv = tc.VisCoupling(_pairs(X)[None, None], freqs, tap, bls,
                        double=double, **T64)
    a, b = _grads_vs_jax(jv, tv, jvd, tvd)
    assert _relerr(a, b) <= TOL


@pytest.mark.parametrize("kw", [dict(prod="left"), dict(prod="right"),
                                dict(add_I=False)])
def test_viscoupling_products_vs_jax(kw):
    ants, antvecs, freqs, bls, Vm, jvd, tvd, rng = _setup(seed=5)
    nant = len(ants)
    X = (rng.normal(size=(1, 1, nant, nant, 1, len(freqs), 2))) * 0.01
    jap, tap = _antpos(ants, antvecs)
    jv = jc.VisCoupling(jnp.asarray(X), freqs, jap, bls, **kw)
    tv = tc.VisCoupling(X, freqs, tap, bls, **kw, **T64)
    assert _relerr(_np(tv(tvd).data), np.asarray(jv(jvd).data)) <= TOL
    a, b = _grads_vs_jax(jv, tv, jvd, tvd)
    assert _relerr(a, b) <= TOL
    # per-call overrides
    assert _relerr(_np(tv(tvd, prod="both", add_I=True).data),
                   np.asarray(jv(jvd, prod="both", add_I=True).data)) <= TOL


def test_viscoupling_identity():
    ants, antvecs, freqs, bls, Vm, jvd, tvd, rng = _setup(seed=1)
    nant = len(ants)
    tv = tc.VisCoupling(np.zeros((1, 1, nant, nant, 1, len(freqs)),
                                 dtype=np.complex128), freqs,
                        _antpos(ants, antvecs)[1], bls, **T64)
    assert np.allclose(_np(tv(tvd).data), _np(tvd.data), atol=1e-12)


def _red_case(seed):
    ants, antvecs, freqs, bls, _, _, _, rng = _setup(seed=seed)
    jap, tap = _antpos(ants, antvecs)
    reds, _, bl2red, all_bls, _, _, _ = build_reds(jap)
    red_bls = [r[0] for r in reds]
    rv = rng.normal(size=(1, 1, len(reds), 1, len(freqs))) + \
        1j * rng.normal(size=(1, 1, len(reds), 1, len(freqs)))
    jvd = bl.data.containers.VisData()
    jvd.setup_data(red_bls, np.asarray([0.0]), freqs, pol="ee",
                   data=jnp.asarray(rv))
    tvd = bt.VisData()
    tvd.setup_data(red_bls, np.asarray([0.0]), freqs, pol="ee",
                   data=torch.as_tensor(rv))
    nant = len(ants)
    X = rng.normal(size=(1, 1, nant, nant, 1, len(freqs), 2)) * 0.01
    return (ants, antvecs, freqs, jap, tap, red_bls, bl2red, list(all_bls),
            rv, X, jvd, tvd)


def test_redviscoupling_matches_viscoupling_vs_jax():
    (ants, antvecs, freqs, jap, tap, red_bls, bl2red, out_bls, rv, X,
     jvd, tvd) = _red_case(2)
    jr = jc.RedVisCoupling(jnp.asarray(X), freqs, jap, red_bls, bl2red,
                           out_bls)
    tr = tc.RedVisCoupling(X, freqs, tap, red_bls, bl2red, out_bls, **T64)
    out = tr(tvd)
    assert out.data.shape[2] == len(out_bls) and tr.full_bls == jr.full_bls
    assert out.bls == out_bls
    assert _relerr(_np(out.data), np.asarray(jr(jvd).data)) <= TOL
    # inflate then VisCoupling on the full set
    full_bls = tr.full_bls
    idx = [bl2red[b] if b in bl2red else bl2red[(b[1], b[0])]
           for b in full_bls]
    vfull = bt.VisData()
    vfull.setup_data(full_bls, np.asarray([0.0]), freqs, pol="ee",
                     data=torch.as_tensor(rv[:, :, idx]))
    expected = _np(tc.VisCoupling(X, freqs, tap, full_bls, **T64)(
        vfull).data)
    lut = {b: i for i, b in enumerate(full_bls)}
    for k, b in enumerate(out_bls):
        e = expected[0, 0, lut[b]] if b in lut else \
            expected[0, 0, lut[(b[1], b[0])]].conj()
        assert np.allclose(_np(out.data[0, 0, k]), e, atol=1e-12)
    assert _relerr(*_red_grads(jr, tr, jvd, tvd)) <= TOL


def _red_grads(jr, tr, jvd, tvd, key="coupling.params"):
    jg = jax.grad(lambda p: jnp.sum(jnp.abs(
        _jax_with(jr, key, p)(jvd).data) ** 2))(jr.coupling.params)
    tp = tr.coupling.params.detach().clone().requires_grad_(True)
    out = tr.updated(bt.ParamDict({key: tp}))(tvd).data
    tg, = torch.autograd.grad(torch.sum(out.abs() ** 2), tp)
    return _np(tg), np.asarray(jg)


def test_coupling_inflate_vs_jax():
    pos = {0: np.asarray([0., 0, 0]), 1: np.asarray([15., 0, 0]),
           2: np.asarray([30., 0, 0])}
    jterms, jidx = jc.gen_coupling_terms(pos, no_auto_coupling=True)
    terms, idx = tc.gen_coupling_terms(pos, no_auto_coupling=True)
    assert terms == jterms and idx == jidx
    rng = np.random.default_rng(0)
    p = rng.normal(size=(1, 1, len(terms), 1, 4)) + 0j
    out = tc.CouplingInflate([0, 1, 2], terms, idx)(torch.as_tensor(p))
    jout = jc.CouplingInflate([0, 1, 2], jterms, jidx)(jnp.asarray(p))
    assert out.shape == (1, 1, 3, 3, 1, 4)
    assert np.array_equal(_np(out), np.asarray(jout))
    assert np.allclose(_np(out[0, 0, 0, 0]), 0)
    for (ai, aj), t in idx.items():
        assert np.allclose(_np(out[0, 0, ai, aj]), p[0, 0, t])


@pytest.mark.parametrize("kw", [dict(compress_to_red=True, max_len=16.0),
                                dict(min_len=20.0, max_EW=40.0),
                                dict(max_NS=10.0, ants=[0, 1, 2]),
                                dict(compress_to_red=True, redtol=0.5)])
def test_gen_coupling_terms_and_cut_bl_vs_jax(kw):
    ants, antvecs = bt.utils.make_hex(2)
    pos = dict(zip(ants, antvecs))
    a = tc.gen_coupling_terms(bt.utils.AntposDict(ants, antvecs), **kw)
    b = jc.gen_coupling_terms(pos, **kw)
    assert a == b
    if kw.get("max_len") == 16.0:
        assert len(a[0]) == 6 and max(a[1].values()) == 5
    for bl_ in [(ants[0], ants[1]), (ants[0], ants[5]), (ants[2], ants[6])]:
        for cut in (dict(max_len=1.0), dict(max_len=100.0),
                    dict(min_EW=5.0), dict(max_NS=3.0), dict(min_NS=1.0),
                    dict(min_len=20.0)):
            assert tc.cut_bl(bl_, pos, **cut) == jc.cut_bl(bl_, pos, **cut)


def test_redviscoupling_setup_coupling_cuts_vs_jax():
    """First- and second-order cuts, each order on its own,
    include_second_order, min_dly; values and gradients."""
    (ants, antvecs, freqs, jap, tap, red_bls, bl2red, out_bls, rv, X,
     jvd, tvd) = _red_case(4)
    jr = jc.RedVisCoupling(jnp.asarray(X), freqs, jap, red_bls, bl2red,
                           out_bls)
    tr = tc.RedVisCoupling(X, freqs, tap, red_bls, bl2red, out_bls, **T64)
    full = _np(tr(tvd).data)
    settings = [dict(max_len=15.0, second_max_len=15.0),
                dict(max_len=15.0, second_max_len=None),
                dict(max_EW=20.0, second_max_NS=15.0),
                dict(include_second_order=False),
                dict(min_dly=20.0, include_second_order=True)]
    for kw in settings:
        jr.setup_coupling(**kw)
        tr.setup_coupling(**kw)
        a = _np(tr(tvd).data)
        assert _relerr(a, np.asarray(jr(jvd).data)) <= TOL
        g = _red_grads(jr, tr, jvd, tvd)
        assert _relerr(*g) <= TOL
    assert not np.allclose(a, full)
    # cutting both orders at max_len equals zeroing the cut cells of X
    tr.setup_coupling(max_len=15.0, second_max_len=15.0,
                      include_second_order=True)
    tr.coupling.setup_coupling()
    cut = _np(tr(tvd).data)
    dist = np.linalg.norm(antvecs[None] - antvecs[:, None], axis=-1)
    Xm = X.copy()
    Xm[0, 0, dist > 15.0] = 0.0
    tr2 = tc.RedVisCoupling(Xm, freqs, tap, red_bls, bl2red, out_bls, **T64)
    assert np.allclose(cut, _np(tr2(tvd).data), atol=1e-12)
    with pytest.raises(NotImplementedError):
        tr.setup_coupling(use_reds=False)


@pytest.mark.parametrize("double", [False, True])
def test_redviscoupling_hits_and_exact_path_vs_jax(double):
    """get_coupling_hits over CouplingInflate terms; a constructor
    double=True takes VisCoupling's exact-product path."""
    (ants, antvecs, freqs, jap, tap, red_bls, bl2red, out_bls, rv, _,
     jvd, tvd) = _red_case(6)
    terms, idx = tc.gen_coupling_terms(tap, max_len=16.0,
                                       compress_to_red=True)
    p = np.random.default_rng(7).normal(size=(1, 1, len(terms), 1, 1)) \
        * 0.01 + 0.01j
    jr = jc.RedVisCoupling(
        jnp.asarray(p), freqs, jap, red_bls, bl2red, out_bls,
        R=bl.calibration.VisModelResponse(LM=jc.CouplingInflate(ants, terms,
                                                                idx)),
        double=double)
    tr = tc.RedVisCoupling(
        p, freqs, tap, red_bls, bl2red, out_bls,
        R=bt.VisModelResponse(LM=tc.CouplingInflate(ants, terms, idx)),
        double=double, **T64)
    assert tr.get_coupling_hits() == jr.get_coupling_hits()
    assert _relerr(_np(tr(tvd).data), np.asarray(jr(jvd).data)) <= TOL
    a, b = _red_grads(jr, tr, jvd, tvd)
    assert _relerr(a, np.conj(b)) <= TOL            # complex leaf (C1)
    assert tr.export_to_viscoupling() is tr.coupling


def test_partial_red_vis_inflate_vs_jax():
    """The mixing-matrix form (one group a baseline, or a list of groups
    summed) and the fixed gather: values and the params' gradient."""
    (ants, antvecs, freqs, jap, tap, red_bls, bl2red, out_bls, rv, _,
     jvd, tvd) = _red_case(8)
    new_bls = out_bls[:10]
    b2r = {b: bl2red[b] for b in new_bls}
    b2r[new_bls[3]] = [0, 2]
    jp = jc.PartialRedVisInflate(b2r, new_bls)
    tp = tc.PartialRedVisInflate(b2r, new_bls, **T64)
    # the input holds exactly the groups the mixing matrix reads
    ncol = tp.Ashape[1]
    jvd, tvd = jvd.copy(), tvd.copy()
    jvd.data, tvd.data = jvd.data[:, :, :ncol], tvd.data[:, :, :ncol]
    a, b = tp(tvd), jp(jvd)
    assert a.bls == new_bls
    assert _relerr(_np(a.data), np.asarray(b.data)) <= TOL
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(_jax_with(jp, "params", q)(
        jvd).data) ** 2))(jp.params)
    q = tp.params.detach().clone().requires_grad_(True)
    tg, = torch.autograd.grad(torch.sum(tp.updated(bt.ParamDict(
        {"params": q}))(tvd).data.abs() ** 2), q)
    assert _relerr(_np(tg), np.asarray(jg)) <= TOL
    idx = [1, 0, 2, 2]
    assert np.array_equal(
        _np(tc.PartialRedVisInflate(red_idx=idx)(tvd.data)),
        np.asarray(jc.PartialRedVisInflate(red_idx=idx)(jvd.data)))


# ------------------------------------------------ the hera-coupling chain
def _chain_pair():
    """chip_smoke.build_coupling at hex-2 (nside 8, 8 channels, 2 times)
    and its JAX mirror on the same target."""
    from chip_smoke import (COUPLING, COUPLING_MAX_LEN, GAINS, LOC,
                            build_coupling, coupling_layout)
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512)
    tp, truth, terms = build_coupling(bt, device="cpu", dtype=torch.float64,
                                      **kw)
    target = _np(tp.target[0].data)
    from _torch_graft import _sky_params
    from bayeslim_tpu.models.calibration import JonesModel, JonesResponse
    from bayeslim_tpu.models.sky import PixelSky, PixelSkyResponse
    ants, antvecs = bt.utils.make_hex(2, D=15.0)
    freqs = np.linspace(100e6, 120e6, 8)
    T = bl.TelescopeModel(LOC)
    arr = bl.ArrayModel(bl.utils.AntposDict(ants, antvecs), freqs=freqs,
                        redtol=0.5)
    params, angs, px_area = _sky_params(8)
    params[0, 0, 0] *= 1e4
    sky = PixelSky(jnp.asarray(params), angs, px_area,
                   R=PixelSkyResponse(freqs, spatial_mode="pixel",
                                      freq_mode="powerlaw",
                                      f0=float(freqs[0])), parameter=False)
    beam = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bl.beam_model.AiryResponse(), pol="e",
                        powerbeam=True, fov=180.0, parameter=False)
    sim_bls, bl2red, out_bls = coupling_layout(tp.model.rime.array)
    times = 2458168.3 + np.arange(2) * 5e-4
    rime = bl.RIME(sky, T, beam, arr, sim_bls, times, freqs, pix_chunk=512)
    jap = arr.to_antpos()
    jterms, jidx = jc.gen_coupling_terms(jap, max_len=COUPLING_MAX_LEN,
                                         compress_to_red=True)
    assert jterms == terms
    R = bl.calibration.VisModelResponse(LM=jc.CouplingInflate(ants, jterms,
                                                              jidx))
    coupling = jc.RedVisCoupling(jnp.zeros((1, 1, len(terms), 1, 1),
                                           dtype=jnp.complex128), freqs,
                                 jap, sim_bls, bl2red, out_bls, R=R)
    gains = np.zeros((1, 1, len(ants), 1, 8, 2))
    gains[..., 0] = 1.0
    cal = JonesModel(jnp.asarray(gains), ants, refant=ants[0],
                     R=JonesResponse(param_type="com"))
    seq = bl.utils.Sequential({"rime": rime, "coupling": coupling,
                               "cal": cal})
    tgt = bl.VisData()
    tgt.setup_meta(T, jap)
    tgt.setup_data(out_bls, times, freqs, pol="ee", data=jnp.asarray(target),
                   icov=jnp.ones(target.shape))
    return tp, bl.inference.LogProb(seq, tgt), truth, COUPLING, GAINS


def test_coupling_chain_vs_jax():
    """The hera-coupling chain: its value and gradients at its start
    and at its truth (where the coupling terms are nonzero), against
    the JAX chain; the coupling's gradient is the conjugate of JAX's."""
    tp, jp, truth, COUPLING, GAINS = _chain_pair()
    for params in (None, truth):
        if params is not None:
            bt.load_numpy_pdict(tp.model, params)
            jpd = jp.collect_main_params()
            jpd[COUPLING] = jnp.asarray(params[COUPLING])
            jpd[GAINS] = jnp.asarray(params[GAINS])
        else:
            jpd = jp.collect_main_params()
        tv, tg = tp.value_and_grad()
        jv, jg = jp.value_and_grad(jpd)
        assert abs(float(tv) - float(jv)) <= TOL * abs(float(jv))
        assert _relerr(_np(tg[GAINS]), np.asarray(jg[GAINS])) <= TOL
        assert _relerr(_np(tg[COUPLING]),
                       np.conj(np.asarray(jg[COUPLING]))) <= TOL
