"""The port's sky models (models/sky.py) against the JAX package at
float64 (1e-9 relative): stokes2coherency, PointSkyResponse in its
channel, linear and power-law modes with and without log, PointSky,
CompositeModel with and without an index; and BASELINE config #1, a
point-source sky under a Gaussian or uniform beam through the RIME
(tests/test_rime.py's setup_PointSky / setup_GaussBeam /
setup_UniformBeam, its analytic check and its minibatched forward)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import sky as jsky
from bayeslim_tpu.utils import AntposDict as JAntposDict
from bayeslim_tpu.utils import make_hex as jmake_hex
from bayeslim_tpu_torch.models import sky as tsky
from bayeslim_tpu_torch.utils import AntposDict, make_hex

LOC = (21.428305555, -30.72152777, 1073.0)
JD0 = 2458168.3
T64 = dict(device="cpu", dtype=torch.float64)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2)])
def test_stokes2coherency_matches_jax(shape):
    rng = np.random.default_rng(0)
    S = rng.uniform(0.1, 1, shape + (3, 20))
    j = jsky.stokes2coherency(jnp.asarray(S))
    t = tsky.stokes2coherency(torch.as_tensor(S))
    assert t.shape == j.shape
    assert t.is_complex() == np.iscomplexobj(j)
    assert _relerr(t.numpy(), j) <= 1e-12
    md = bt.MapData()
    md.setup_data([1e8, 2e8, 3e8], data=torch.as_tensor(S))
    out = tsky.Stokes2Coherency()([md, md])
    assert len(out) == 2 and _relerr(out[1].data.numpy(), j) <= 1e-12
    assert out[0].data is not md.data or shape[0] == 1


def _linear(A, xp):
    """A frequency design matrix A (Nfreqs, Ncoeff) as a callable."""
    A = xp.asarray(A)
    return lambda p: xp.einsum("fc,...cn->...fn", A, p)


@pytest.mark.parametrize("mode", ["channel", "linear", "powerlaw"])
@pytest.mark.parametrize("log", [False, True])
def test_point_sky_matches_jax(mode, log):
    rng = np.random.default_rng(1)
    freqs = np.linspace(100e6, 120e6, 6)
    ncoeff = {"channel": 6, "linear": 3, "powerlaw": 2}[mode]
    params = rng.uniform(0.5, 2, (1, 1, ncoeff, 7))
    if mode == "powerlaw":
        params[:, :, 1] = -rng.uniform(1.5, 3, 7)
    A = rng.standard_normal((6, 3))
    p0 = 0.01 * rng.standard_normal(params.shape)
    angs = rng.uniform(0, 60, (2, 7))
    kw = dict(freq_mode=mode, log=log, f0=float(freqs[0]))
    jR = jsky.PointSkyResponse(freqs, freq_LM=_linear(A, jnp), **kw)
    tR = tsky.PointSkyResponse(freqs, freq_LM=_linear(torch.as_tensor(A),
                                                      torch), **kw, **T64)
    jm = jsky.PointSky(jnp.asarray(params), angs, R=jR, p0=p0)
    tm = tsky.PointSky(params, angs, R=tR, p0=p0, **T64)
    jd = jm().data
    td = tm()
    assert _relerr(td.data.detach().numpy(), jd) <= 1e-9
    np.testing.assert_array_equal(td.angs, angs)
    jg = jax.grad(lambda q: jnp.sum(jm.R(q + jnp.asarray(p0)) ** 2))(
        jnp.asarray(params))
    (tg,) = torch.autograd.grad(torch.sum(td.data ** 2), tm.params)
    assert _relerr(tg.numpy(), jg) <= 1e-9


def _pixel_pair(seed, npix, name, freqs):
    rng = np.random.default_rng(seed)
    p = rng.uniform(1, 2, (1, 1, len(freqs), npix))
    angs = rng.uniform(0, 60, (2, npix))
    return (jsky.PixelSky(jnp.asarray(p), angs, 0.5, name=name,
                          R=jsky.PixelSkyResponse(freqs)),
            tsky.PixelSky(p, angs, 0.5, name=name,
                          R=tsky.PixelSkyResponse(freqs, **T64), **T64))


# the coarse component's index onto the fine one's 48 pixels: (pred_index,
# this_index); "this" repeats each of its 12 pixels 4 times, "pred"
# places them on every 4th fine pixel, "both" gathers 48 values and adds
# them onto 48 fine pixels of which one (pixel 3) twice
_INDEX = {None: None,
          "this": (None, np.repeat(np.arange(12), 4)),
          "pred": (np.arange(0, 48, 4), None),
          "both": (np.r_[np.arange(47), 3], np.repeat(np.arange(12), 4))}


@pytest.mark.parametrize("index", list(_INDEX))
def test_composite_model_matches_jax(index):
    freqs = np.linspace(100e6, 120e6, 3)
    ja, ta = _pixel_pair(2, 48, "fine", freqs)
    jb, tb = _pixel_pair(3, 48 if index is None else 12, "coarse", freqs)
    idx = None if index is None else {"coarse": _INDEX[index]}
    jc = jsky.CompositeModel({"fine": ja, "coarse": jb}, sum_output=True,
                             index=idx)
    tc = tsky.CompositeModel({"fine": ta, "coarse": tb}, sum_output=True,
                             index=idx)
    assert _relerr(tc().data.detach().numpy(), jc().data) <= 1e-12
    # a list of components without sum_output; evaluate a subset
    jl = jsky.CompositeModel([ja, jb])
    tl = tsky.CompositeModel([ta, tb])
    outs = tl()
    assert [o.data.shape for o in outs] == [o.data.shape for o in jl()]
    tl.set_eval_models("coarse")
    jl.set_eval_models("coarse")
    (one,) = tl()
    assert _relerr(one.data.detach().numpy(), jl()[0].data) <= 1e-12
    assert sorted(dict(tc.named_parameters())) == [
        "models.coarse.params", "models.fine.params"]


# ---------------------------------------------------------------------------
# BASELINE config #1: point sources under a Gaussian or uniform beam
# ---------------------------------------------------------------------------

def _point_sky_params(Nsource, Nfreqs, seed=0):
    """tests/test_rime.py's setup_PointSky draws: sources scattered
    around zenith at JD0, amplitudes U(1, 10), index -2.2."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(100e6, 120e6, Nfreqs)
    ra0 = bt.TelescopeModel(LOC).JD2RA(JD0)
    angs = np.stack([ra0 + rng.uniform(-20, 20, Nsource),
                     LOC[1] + rng.uniform(-20, 20, Nsource)])
    params = np.zeros((1, 1, 2, Nsource))
    params[0, 0, 0] = rng.uniform(1, 10, Nsource)
    params[0, 0, 1] = -2.2
    return params, angs, freqs


def _rime_pair(beam, Nsource=5, sim_bls=None, times=None, nbls=5,
               composite=False):
    """The same point-source RIME through both packages."""
    params, angs, freqs = _point_sky_params(Nsource, 8)
    kw = dict(freq_mode="powerlaw", f0=freqs[0])
    jS = jsky.PointSky(jnp.asarray(params), angs,
                       R=jsky.PointSkyResponse(freqs, **kw))
    tS = tsky.PointSky(params, angs, R=tsky.PointSkyResponse(
        freqs, **kw, **T64), **T64)
    if composite:
        p2, a2, _ = _point_sky_params(3, 8, seed=4)
        jS = jsky.CompositeModel({"a": jS, "b": jsky.PointSky(
            jnp.asarray(p2), a2, R=jsky.PointSkyResponse(freqs, **kw))})
        tS = tsky.CompositeModel({"a": tS, "b": tsky.PointSky(
            p2, a2, R=tsky.PointSkyResponse(freqs, **kw, **T64), **T64)})
    if beam == "gauss":
        bp = np.ones((1, 1, 1, len(freqs), 2)) * 0.5
        jB = bl.PixelBeam(jnp.asarray(bp), freqs, R=bl.beam_model
                          .GaussResponse(), pol="e", fov=180.0)
        tB = bt.PixelBeam(bp, freqs, R=bt.GaussResponse(), pol="e",
                          fov=180.0, **T64)
    else:
        bp = np.ones((1, 1, 1, 1, 1))
        jB = bl.PixelBeam(jnp.asarray(bp), freqs, R=bl.beam_model
                          .UniformResponse(), pol="e", fov=180.0)
        tB = bt.PixelBeam(bp, freqs, R=bt.UniformResponse(), pol="e",
                          fov=180.0, **T64)
    jants, jav = jmake_hex(2, D=15.0)
    ants, av = make_hex(2, D=15.0)
    jarr = bl.ArrayModel(JAntposDict(jants, jav), freqs=freqs)
    tarr = bt.ArrayModel(AntposDict(ants, av), freqs=freqs, **T64)
    bls = tarr.get_bls(keep_autos=False)[:nbls]
    sim_bls = bls if sim_bls is None else sim_bls(bls)
    times = np.asarray([JD0, JD0 + 0.001]) if times is None else times
    jr = bl.RIME(jS, bl.TelescopeModel(LOC), jB, jarr, sim_bls, times, freqs)
    tr = bt.RIME(tS, bt.TelescopeModel(LOC), tB, tarr, sim_bls, times, freqs)
    return jr, tr, tarr, bls, times, freqs, params, angs


def test_point_sky_uniform_beam_analytic():
    """Uniform beam: V = sum_s S_s(f) exp(2 pi i f b.s / c) exactly
    (tests/test_rime.py::test_rime_pointsky_analytic), and the JAX
    package's forward."""
    jr, tr, arr, bls, times, freqs, params, angs = _rime_pair("uniform", 4)
    with torch.no_grad():
        vd = tr()
    assert vd.data.shape == (1, 1, 5, 2, len(freqs)) and vd.pol == "ee"
    spec = params[0, 0, 0][None] * (freqs[:, None] / freqs[0]) ** -2.2
    blvecs = arr.get_blvecs(bls).numpy()
    truth = np.zeros((5, 2, len(freqs)), dtype=complex)
    for ti, t in enumerate(times):
        zen, az = tr.telescope.eq2top(t, angs[0], angs[1])
        tau = blvecs @ arr.s_vector(zen, az) / 2.99792458e8
        fr = np.exp(2j * np.pi * freqs[None, :, None] * tau[:, None, :])
        truth[:, ti] = (fr * spec[None]).sum(-1)
    assert _relerr(vd.data[0, 0].numpy(), truth) <= 1e-9
    assert _relerr(vd.data.numpy(), jr.forward().data) <= 1e-9


@pytest.mark.parametrize("composite", [False, True])
def test_point_sky_gauss_beam_matches_jax(composite):
    jr, tr, *_ = _rime_pair("gauss", composite=composite)
    assert _relerr(tr().data.detach().numpy(), jr.forward().data) <= 1e-9
    # sky-parameter gradient of |V|^2
    pd = bl.utils.model2pdict(jr)
    jg = jax.grad(lambda p: jnp.sum(jnp.abs(jr.updated(p).forward().data)
                                    ** 2))(pd)
    tp = dict(tr.named_parameters())
    assert sorted(tp) == sorted(jg.keys())
    tg = torch.autograd.grad(torch.sum(torch.abs(tr().data) ** 2),
                             list(tp.values()))
    for k, g in zip(tp, tg):
        assert _relerr(g.numpy(), jg[k]) <= 1e-9, k


def test_point_sky_minibatched_equals_unbatched():
    """2 baseline groups x 2 time groups through run_batches equal one
    batch (tests/test_rime.py::test_rime_batched_equals_unbatched), in
    both packages."""
    times = np.asarray([JD0, JD0 + 5e-4, JD0 + 1e-3, JD0 + 1.5e-3])
    jr, tr, _, bls, *_ = _rime_pair("gauss", Nsource=3, nbls=6, times=times)
    jb, tb, *_ = _rime_pair("gauss", Nsource=3, nbls=6,
                            sim_bls=lambda b: [b[:3], b[3:]],
                            times=[times[:2], times[2:]])
    assert tb.Nbatch == jb.Nbatch == 4
    with torch.no_grad():
        full = tr()
        vd = tb.run_batches(concat=True)
        parts = tb.run_batches(concat=False)
    jvd = jb.run_batches(concat=True)
    assert vd.data.shape == full.data.shape
    assert _relerr(vd.data.numpy(), full.data.numpy()) <= 1e-10
    assert _relerr(vd.data.numpy(), jvd.data) <= 1e-9
    np.testing.assert_array_equal(vd.times, jvd.times)
    np.testing.assert_array_equal(vd.blnums, full.blnums)
    assert len(parts) == 4 and tb.batch_idx == 0
    tb.batch_idx = 3
    assert (tb.time_group_id, tb.bl_group_id) == (1, 1)
    assert tb.sim_bls == bls[3:] and list(tb.sim_times) == list(times[2:])
    with pytest.raises(ValueError):
        tb.batch_idx = 4


def _alm_models(lmax=6, nside=4, real_output=False):
    from bayeslim_tpu.ops import sph_harm as jsh
    from bayeslim_tpu_torch.ops import sph_harm as tsh
    from bayeslim_tpu_torch.utils import healpix as hp
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    l, m = jsh.gen_lm(lmax)
    jm = jsh.AlmModel(l, m, real_output=real_output)
    jm.generate_Ylm(theta, phi, high_prec=False)
    tm = tsh.AlmModel(l, m, real_output=real_output, **T64)
    tm.generate_Ylm(theta, phi, high_prec=False)
    angs = np.stack([np.degrees(phi), 90 - np.degrees(theta)])
    return jm, tm, angs, hp.nside2pixarea(nside)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("abs_output", [False, True])
@pytest.mark.parametrize("sky0", [False, True])
@pytest.mark.parametrize("comp_params", [False, True])
def test_alm_response_matches_jax(order, log, abs_output, sky0,
                                  comp_params):
    rng = np.random.default_rng(8)
    jm, tm, angs, _ = _alm_models()
    freqs = np.linspace(100e6, 120e6, 3)
    p = 0.1 * rng.standard_normal((1, 1, 3, len(jm.l), 2))
    if not comp_params:
        p = p[..., 0] + 1j * p[..., 1]
    s0 = rng.uniform(1, 2, (1, 1, 3, angs.shape[1])) if sky0 else None
    kw = dict(comp_params=comp_params, spatial_mode="alm",
              freq_mode="channel", transform_order=order, log=log,
              abs_output=abs_output, real_output=True)
    jr = jsky.PixelSkyResponse(freqs, spat_LM=jm, sky0=s0, **kw)
    tr = tsky.PixelSkyResponse(freqs, spat_LM=tm, sky0=s0, **kw, **T64)
    for idx in (None, [2, 0]):
        jr.set_freq_index(idx)
        tr.set_freq_index(idx)
        want = jr(jnp.asarray(p))
        got = tr(torch.as_tensor(p))
        assert got.shape == want.shape and not got.is_complex()
        assert _relerr(got.numpy(), want) <= 1e-12


def test_alm_powerlaw_response_matches_jax():
    """a_lm of amplitude and index through the power-law frequency
    response, complex all the way (real_output=False)."""
    rng = np.random.default_rng(9)
    jm, tm, _, _ = _alm_models()
    freqs = np.linspace(100e6, 120e6, 4)
    p = rng.standard_normal((1, 1, 2, len(jm.l), 2)) * 0.1
    kw = dict(comp_params=True, spatial_mode="alm", freq_mode="powerlaw",
              f0=110e6, real_output=False, transform_order=1)
    want = jsky.PixelSkyResponse(freqs, spat_LM=jm, **kw)(jnp.asarray(p))
    got = tsky.PixelSkyResponse(freqs, spat_LM=tm, **kw, **T64)(
        torch.as_tensor(p))
    assert got.is_complex() and _relerr(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("mode", [dict(spatial_mode="linear"),
                                  dict(freq_mode="linear")])
def test_pixel_response_names_what_it_waits_for(mode):
    """The 'linear' spatial and frequency modes (they raised before
    LinearModel was ported), in both transform orders, and the point
    sky's 'linear' mode with a LinearModel: values and gradients."""
    from bayeslim_tpu.models import linear_model as jlm
    from bayeslim_tpu_torch.models import linear_model as tlm
    rng = np.random.default_rng(11)
    freqs = np.linspace(100e6, 120e6, 5)
    if "spatial_mode" in mode:
        A = rng.standard_normal((10, 4))
        jLM = jlm.LinearModel("custom", A=A, dim=-1)
        tLM = tlm.LinearModel("custom", A=A, dim=-1, **T64)
        kw, shape = dict(spat_LM=None), (1, 1, 5, 4)
    else:
        lkw = dict(dim=2, x=freqs, Ndeg=3, basis="legendre", whiten=True)
        jLM = jlm.LinearModel("poly", **lkw)
        tLM = tlm.LinearModel("poly", **lkw, **T64)
        kw, shape = dict(freq_LM=None), (1, 1, 3, 10)
    p = rng.uniform(0.5, 2, shape)
    key = next(iter(kw))
    for order in (0, 1):
        jr = jsky.PixelSkyResponse(freqs, transform_order=order, **mode,
                                   **{key: jLM})
        tr = tsky.PixelSkyResponse(freqs, transform_order=order, **mode,
                                   **{key: tLM}, **T64)
        want = jr(jnp.asarray(p))
        pt = torch.as_tensor(p).requires_grad_(True)
        got = tr(pt)
        assert got.shape == want.shape == (1, 1, 5, 10)
        assert _relerr(got.detach().numpy(), want) <= 1e-12
        jg = jax.grad(lambda q: jnp.sum(jr(q) ** 2))(jnp.asarray(p))
        (tg,) = torch.autograd.grad(torch.sum(got ** 2), pt)
        assert _relerr(tg.numpy(), jg) <= 1e-12
    if key == "freq_LM":
        jR = jsky.PointSkyResponse(freqs, freq_mode="linear", log=True,
                                   freq_LM=jLM)
        tR = tsky.PointSkyResponse(freqs, freq_mode="linear", log=True,
                                   freq_LM=tLM, **T64)
        q = 0.1 * p[..., :7]
        assert _relerr(tR(torch.as_tensor(q)).numpy(),
                       jR(jnp.asarray(q))) <= 1e-12


@pytest.mark.parametrize("comp_params", [False, True])
def test_sph_harm_sky_and_ylm_cut_match_jax(comp_params):
    """SphHarmSky's forward (pixel area included), then
    pixelsky_Ylm_cut's trim of the modes, the params (a trainable leaf
    still) and p0, and the forward after it."""
    rng = np.random.default_rng(10)
    jm, tm, angs, px = _alm_models(real_output=False)
    freqs = np.linspace(100e6, 120e6, 3)
    p = rng.standard_normal((1, 1, 3, len(jm.l), 2))
    p0 = 0.1 * rng.standard_normal(p.shape)
    if not comp_params:
        p, p0 = p[..., 0] + 1j * p[..., 1], p0[..., 0] + 1j * p0[..., 1]
    js = jsky.SphHarmSky(jnp.asarray(p), angs, px, jm, freqs, p0=p0,
                         comp_params=comp_params)
    ts = tsky.SphHarmSky(p, angs, px, tm, freqs, p0=p0,
                         comp_params=comp_params, **T64)
    assert _relerr(ts().data.detach().numpy(), js().data) <= 1e-12
    jidx = jsky.pixelsky_Ylm_cut(js, lmin=1, mmax=4)
    tidx = tsky.pixelsky_Ylm_cut(ts, lmin=1, mmax=4)
    np.testing.assert_array_equal(tidx, jidx)
    assert dict(ts.named_parameters())["params"].shape == js.params.shape
    assert _relerr(ts.p0.numpy(), js.p0) == 0.0
    assert _relerr(ts().data.detach().numpy(), js().data) <= 1e-12


def test_alm_posterior_matches_jax():
    """BASELINE config #2 at hex-2, nside 8, lmax 23, 8 channels, 2
    times (build_alm_torch / build_alm_jax): the loss and the a_lm and
    beam gradients at the perturbed start, the same target."""
    from _torch_graft import build_alm_jax, build_alm_torch
    tp, truth, _ = build_alm_torch()
    target = tp.target[0].data.numpy()
    start = tp.model.sky.params.detach().numpy()
    jp = build_alm_jax(target, start)
    tv, tg = tp.value_and_grad()
    jv, jg = jp.value_and_grad()
    assert abs(float(tv) - float(jv)) <= 1e-9 * abs(float(jv))
    assert set(tg.keys()) == {"sky.params", "beam.params"}
    for k in tg.keys():
        assert _relerr(tg[k].numpy(), jg[k]) <= 1e-9, k
    # the truth sits lower than the perturbed start
    bt.load_numpy_pdict(tp.model, {
        "sky.params": truth,
        "beam.params": tp.model.beam.params.detach().numpy()})
    assert float(tp.value_and_grad()[0]) < float(tv)
