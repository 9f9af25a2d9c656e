"""Frequency interpolation and minibatching (ROADMAP A2) in the port
against the JAX package at float64 (1e-9 relative): run_rime_sim with a
sky whose channels differ from the template's (the sky is interpolated
onto the template's channels, as the JAX one is); utils.freq_interp;
SkyBase.freq_interp and PixelBeam.freq_interp (channel-mode params
interpolated, other beams moved); set_freq_index on DefaultResponse,
PointSkyResponse, PixelSkyResponse and ArrayModel; RIME.setup_freqs;
InterpSky; and chip_smoke.build_fmb's hera-fmb at hex-2 and 16 channels
(four contiguous minibatches of channels and four strided ones, each
set's summed loss and gradients against the full band and against the
JAX package's same composition)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.data import uvdata_interface as ju
from bayeslim_tpu.models import sky as jsky
from bayeslim_tpu.utils import AntposDict as JAntposDict
from bayeslim_tpu.utils import healpix as jhp
from bayeslim_tpu.utils import indexing as jix
from bayeslim_tpu_torch.data import uvdata_interface as tu
from bayeslim_tpu_torch.models import sky as tsky
from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
from bayeslim_tpu_torch.utils import indexing as tix

from _torch_graft import LOC

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

T64 = dict(device="cpu", dtype=torch.float64)
JD0 = 2458168.3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _pixel_sky_params(nside, freqs, seed=0):
    """Channel-mode pixel-sky params (1, 1, Nfreqs, Npix): a power law
    of random amplitudes with a random curvature, pixel angles and
    area."""
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    rng = np.random.default_rng(seed)
    x = np.asarray(freqs)[:, None] / freqs[0]
    params = rng.uniform(1, 10, npix) * x ** (-2.5 + 0.3 * np.log(x)
                                              * rng.uniform(-1, 1, npix))
    return params[None, None], angs, hp.nside2pixarea(nside)


def _pixel_skies(freqs, nside=4, parameter=True):
    params, angs, area = _pixel_sky_params(nside, freqs)
    t = bt.PixelSky(params, angs, area, bt.PixelSkyResponse(
        freqs, freq_mode="channel", **T64), parameter=parameter, **T64)
    j = jsky.PixelSky(jnp.asarray(params), angs, area,
                      R=jsky.PixelSkyResponse(freqs, freq_mode="channel"),
                      parameter=parameter)
    return t, j


# -------------------------------------------------- repair: run_rime_sim
def test_run_rime_sim_interpolates_the_sky(tmp_path):
    """A hex-2 template at 16 channels and a channel-mode PixelSky at 8
    (over a narrower band, so the ends extrapolate): run_rime_sim moves
    the sky onto the template's channels in both packages, and the
    visibilities agree at 1e-9."""
    ants, antvecs = make_hex(2, D=15.0)
    freqs = np.linspace(100e6, 130e6, 16)
    template = str(tmp_path / "template.uvh5")
    ju.write_uvh5(ju.setup_uvdata(
        antnums=ants, antpos=antvecs, no_autos=True,
        telescope_location=LOC, time_array=JD0 + np.arange(2) * 5e-4,
        freq_array=freqs), template)
    tsk, jsk = _pixel_skies(np.linspace(102e6, 128e6, 8), parameter=False)
    beam = dict(params=np.ones((1, 1, 1, 1, 2)) * 14.0, freqs=freqs,
                pol="e", powerbeam=True, fov=180.0)
    tbeam = bt.PixelBeam(R=bt.AiryResponse(), parameter=False, **beam,
                         **T64)
    jbeam = bl.PixelBeam(R=bl.beam_model.AiryResponse(), parameter=False,
                         **beam)
    jout = ju.run_rime_sim(jsk, jbeam, template)
    tout = tu.run_rime_sim(tsk, tbeam, template, **T64)
    assert tuple(tsk.params.shape) == (1, 1, 16, 192)
    assert np.array_equal(tsk.R.freqs, freqs)
    assert tout.data.shape == jout.data.shape == (1, 1, 21, 2, 16)
    assert _relerr(_np(tout.data), jout.data) <= 1e-9


# --------------------------------------------------- interpolation
@pytest.mark.parametrize("kind", ["linear", "quadratic", "cubic"])
@pytest.mark.parametrize("axis", [0, 1])
def test_utils_freq_interp_matches_jax(kind, axis):
    rng = np.random.default_rng(1)
    pf = np.linspace(1e8, 2e8, 9)
    p = rng.standard_normal((9, 5)) if axis == 0 \
        else rng.standard_normal((3, 9, 2))
    nf = np.linspace(0.95e8, 2.1e8, 23)
    j = np.asarray(jix.freq_interp(jnp.asarray(p), pf, nf, kind, axis))
    t = tix.freq_interp(torch.as_tensor(p), pf, nf, kind, axis)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
    assert _relerr(t.numpy(), j) <= 1e-12
    assert _relerr(tix.freq_interp(p, pf, nf, kind, axis), j) <= 1e-12
    assert bt.utils.freq_interp is tix.freq_interp


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_sky_freq_interp_matches_jax(kind):
    """Channel-mode params interpolated (extrapolating past both ends);
    a trainable leaf stays the same nn.Parameter; the 1 Hz no-op; a
    power-law response keeps its params and takes the new R.freqs."""
    tsk, jsk = _pixel_skies(np.linspace(100e6, 200e6, 12))
    param = tsk.params
    new = np.linspace(95e6, 205e6, 31)
    tsk.freq_interp(new, kind=kind)
    jsk.freq_interp(new, kind=kind)
    assert tsk.params is param and tsk.params.requires_grad
    assert _relerr(_np(tsk.params), jsk.params) <= 1e-12
    assert np.array_equal(tsk.R.freqs, jsk.R.freqs)
    before = tsk.params.detach().clone()
    tsk.freq_interp(new + 0.5, kind=kind)
    assert torch.equal(tsk.params.detach(), before)
    with torch.no_grad():
        assert _relerr(_np(tsk().data), jsk.forward().data) <= 1e-12
    # a power-law sky (and a point sky's response) keeps its params
    params = np.stack([np.ones((1, 5)), -2.0 * np.ones((1, 5))], 1)[None]
    f = np.linspace(100e6, 120e6, 4)
    tp = bt.PointSky(params[0], np.zeros((2, 5)), R=bt.PointSkyResponse(
        f, freq_mode="powerlaw", f0=1e8, **T64), **T64)
    jp = jsky.PointSky(jnp.asarray(params[0]), np.zeros((2, 5)),
                       R=jsky.PointSkyResponse(f, freq_mode="powerlaw",
                                               f0=1e8))
    tp.freq_interp(f[:2])
    jp.freq_interp(f[:2])
    assert np.array_equal(_np(tp.params), np.asarray(jp.params))
    assert np.array_equal(tp.R.freqs, jp.R.freqs)


def test_beam_freq_interp_matches_jax():
    """A channel-mode pixel beam's params are interpolated; an Airy
    beam keeps its params and is evaluated at the new channels; both
    beams' responses agree with the JAX package's afterwards."""
    freqs = np.linspace(100e6, 200e6, 10)
    new = np.linspace(110e6, 190e6, 7)
    nside = 4
    npix = hp.nside2npix(nside)
    rng = np.random.default_rng(2)
    params = rng.uniform(0.5, 1.5, (1, 1, 1, len(freqs), npix))
    zen, az = rng.uniform(0, 80, 20), rng.uniform(0, 360, 20)
    tR = bt.PixelResponse(freqs, "healpix", nside=nside)
    jR = bl.beam_model.PixelResponse(freqs, "healpix", nside=nside)
    tb = bt.PixelBeam(params, freqs, R=tR, **T64)
    jb = bl.PixelBeam(jnp.asarray(params), freqs, R=jR)
    param = tb.params
    tb.freq_interp(new)
    jb.freq_interp(new)
    assert tb.params is param and tuple(tb.params.shape)[3] == len(new)
    assert _relerr(_np(tb.params), jb.params) <= 1e-12
    assert np.array_equal(tb.freqs, new) and np.array_equal(tR.freqs, new)
    zt, at = (torch.as_tensor(x, dtype=torch.float64) for x in (zen, az))
    with torch.no_grad():
        tv = tb.gen_beam(zt, at)
    assert _relerr(_np(tv), jb.gen_beam(jnp.asarray(zen),
                                        jnp.asarray(az))) <= 1e-9
    ta = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                      R=bt.AiryResponse(), **T64)
    ja = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                      R=bl.beam_model.AiryResponse())
    ta.freq_interp(new)
    ja.freq_interp(new)
    assert tuple(ta.params.shape) == (1, 1, 1, 1, 2)
    with torch.no_grad():
        tv = ta.gen_beam(zt, at)
    assert tv.shape[3] == len(new)
    assert _relerr(_np(tv), ja.gen_beam(jnp.asarray(zen),
                                        jnp.asarray(az))) <= 1e-9


# ---------------------------------------------------- set_freq_index
@pytest.mark.parametrize("idx", [[1, 3], [0, 2, 4, 6], None, [5]])
def test_set_freq_index_matches_jax(idx):
    """DefaultResponse (a no-op), PointSkyResponse in each mode (with and
    without log), PixelSkyResponse and ArrayModel: the selected channels
    of the JAX package's."""
    rng = np.random.default_rng(3)
    freqs = np.linspace(1e8, 1.2e8, 8)
    p = rng.uniform(0.5, 2, (1, 1, 8, 5))
    for R in (bt.models.sky.DefaultResponse(freqs),):
        R.set_freq_index(idx)
        assert torch.equal(R(torch.as_tensor(p)), torch.as_tensor(p))
    jdr = jsky.DefaultResponse(freqs)
    jdr.set_freq_index(idx)
    for mode, ncoeff in (("channel", 8), ("powerlaw", 2)):
        for log in (False, True):
            pp = p[:, :, :ncoeff]
            t = bt.PointSkyResponse(freqs, freq_mode=mode, log=log, f0=1e8,
                                    **T64)
            j = jsky.PointSkyResponse(freqs, freq_mode=mode, log=log,
                                      f0=1e8)
            t.set_freq_index(idx)
            j.set_freq_index(idx)
            jv = np.asarray(j(jnp.asarray(pp)))
            assert _relerr(_np(t(torch.as_tensor(pp))), jv) <= 1e-12
            assert jv.shape[2] == (8 if idx is None else len(idx))
    t = bt.PixelSkyResponse(freqs, freq_mode="channel", **T64)
    j = jsky.PixelSkyResponse(freqs, freq_mode="channel")
    t.set_freq_index(idx)
    j.set_freq_index(idx)
    assert _relerr(_np(t(torch.as_tensor(p))),
                   j(jnp.asarray(p))) <= 1e-12
    ants, antvecs = make_hex(2)
    ta = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, **T64)
    ja = bl.ArrayModel(JAntposDict(ants, antvecs), freqs=freqs)
    ta.set_freq_index(idx)
    ja.set_freq_index(idx)
    assert np.array_equal(ta.freqs, ja.freqs)


def test_interp_sky_matches_jax():
    """InterpSky: the wrapped sky's map through a frequency
    interpolation at forward time, its freqs replaced."""
    freqs = np.linspace(100e6, 200e6, 6)
    new = np.linspace(110e6, 190e6, 9)
    tsk, jsk = _pixel_skies(freqs)

    def interp(ix):
        def f(md):
            md.data = ix.freq_interp(md.data, freqs, new, "linear", -2)
            return md
        return f
    t = tsky.InterpSky(tsk, freq_interp=interp(tix), new_freqs=new)
    j = jsky.InterpSky(jsk, freq_interp=interp(jix), new_freqs=new)
    tm, jm = t(), j()
    assert np.array_equal(tm.freqs, jm.freqs) and len(tm.freqs) == 9
    assert _relerr(_np(tm.data), jm.data) <= 1e-12
    # without an interpolation the wrapped map passes unchanged
    assert torch.equal(tsky.InterpSky(tsk)().data, tsk().data)


def test_rime_setup_freqs_matches_jax():
    """RIME.setup_freqs moves the RIME and its array onto new channels,
    in both packages: with the sky's channels selected and the beam moved
    alike, the port's visibilities equal the JAX package's after the same
    calls at 1e-9, and a slice of the port's own full band at 1e-12."""
    tp, _ = cs.build_fmb(bt, **FMB_SMALL, **T64)
    jp = _fmb_jax(tp)
    rime, jr = tp.model, jp.model
    freqs = np.asarray(rime.freqs)
    idx = np.arange(4, 12)
    cs.fmb_point(rime, freqs, idx)
    jr.setup_freqs(freqs[idx])
    jr.sky.R.set_freq_index(idx)
    jr.beam.freq_interp(freqs[idx])
    for r in (rime, jr):
        assert np.array_equal(r.freqs, freqs[idx]) and r.Nfreqs == 8
        assert np.array_equal(r.array.freqs, freqs[idx])
    with torch.no_grad():
        sub = rime().data
    jsub = np.asarray(jr.forward().data)
    assert sub.shape == jsub.shape and sub.shape[-1] == 8
    assert _relerr(_np(sub), jsub) <= 1e-9
    cs.fmb_point(rime, freqs, None)
    with torch.no_grad():
        full = rime().data
    assert _relerr(_np(sub), _np(full)[..., idx]) <= 1e-12


# ---------------------------------------------- hera-fmb, both packages
FMB_SMALL = dict(hexN=2, nside=8, nfreq=16, fmax=200e6, ntime=2,
                 pix_chunk=512, nknots=8)


def _fmb_jax(tp):
    """chip_smoke.build_fmb's chain through the JAX package: the same
    array, times, knots' params (moved by the JAX PixelSky.freq_interp),
    Airy beam and target."""
    from bayeslim_tpu.utils import make_hex as jmake_hex
    k = FMB_SMALL
    rime = tp.model
    freqs = np.linspace(100e6, k["fmax"], k["nfreq"])
    knots = np.linspace(100e6, k["fmax"], k["nknots"])
    ants, antvecs = jmake_hex(k["hexN"], D=15.0)
    T = bl.TelescopeModel(LOC)
    arr = bl.ArrayModel(JAntposDict(ants, antvecs), freqs=freqs, redtol=0.5)
    rng = np.random.default_rng(0)
    npix = jhp.nside2npix(k["nside"])
    amp = rng.uniform(1, 10, npix)
    params = (amp * (knots[:, None] / knots[0]) ** -2.5)[None, None]
    sky = jsky.PixelSky(jnp.asarray(params), rime.sky.angs_np,
                        jhp.nside2pixarea(k["nside"]),
                        R=jsky.PixelSkyResponse(knots, freq_mode="channel"))
    sky.freq_interp(freqs)
    beam = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bl.beam_model.AiryResponse(), pol="e",
                        powerbeam=True, fov=180.0)
    jr = bl.RIME(sky, T, beam, arr, rime.sim_bls, np.asarray(
        rime.sim_times), freqs, pix_chunk=k["pix_chunk"])
    t = tp.target[0]
    tgt = bl.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.sim_bls, np.asarray(rime.sim_times), freqs,
                   pol="ee", data=jnp.asarray(_np(t.data)),
                   icov=jnp.asarray(_np(t.icov)))
    return bl.inference.LogProb(jr, tgt)


def _jax_minibatched(jp, batches, freqs):
    """The JAX package's composition of the same minibatches: before
    each, RIME.setup_freqs, the sky response's set_freq_index and the
    beam's freq_interp, and the target's channels selected."""
    rime = jp.model
    loss, grads = 0.0, None
    for idx in batches:
        rime.setup_freqs(freqs[idx])
        rime.sky.R.set_freq_index(idx)
        rime.beam.freq_interp(freqs[idx])
        tgt = jp.target[0].select(freq_inds=idx, inplace=False)
        tgt.set_cov(None, None, icov=tgt.icov)
        v, g = bl.inference.LogProb(rime, tgt).value_and_grad()
        loss += float(v)
        g = {k: np.asarray(x) for k, x in g.items()}
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
    return loss, grads


def test_hera_fmb_minibatches_match_full_band_and_jax():
    """chip_smoke.build_fmb at hex-2, 16 channels in four contiguous
    minibatches and in four strided ones: each set's summed loss and
    gradients equal one full-band
    evaluation (the chi^2 and its normalisation add over channels) and
    the JAX package's same composition, at 1e-9; after each pass the
    RIME is back at the whole band."""
    tp, _ = cs.build_fmb(bt, **FMB_SMALL, **T64)
    jp = _fmb_jax(tp)
    freqs = np.asarray(tp.model.freqs)
    assert _relerr(_np(tp.model.sky.params), jp.model.sky.params) <= 1e-12
    batches = [np.arange(i * 4, (i + 1) * 4) for i in range(4)]
    probs = cs.fmb_probs(bt, tp, batches)
    pdict = tp.collect_main_params()
    loss, grads, _ = cs.fmb_value_and_grad(tp, probs, batches, pdict, freqs)
    assert np.array_equal(tp.model.freqs, freqs)
    fl, fg = tp.value_and_grad()
    assert abs(float(loss) - float(fl)) <= 1e-9 * abs(float(fl))
    for k in fg:
        assert _relerr(_np(grads[k]), _np(fg[k])) <= 1e-9, k
    jl, jg = _jax_minibatched(jp, batches, freqs)
    assert abs(float(loss) - jl) <= 1e-9 * abs(jl)
    assert set(jg) == set(grads.keys())
    for k in jg:
        assert _relerr(_np(grads[k]), jg[k]) <= 1e-9, k
    # the four strided minibatches (every 4th channel from each offset,
    # regular grids), as chip_smoke's phase 24 runs them: summed, the
    # full band again, and the JAX package's same composition
    strided = [np.arange(j, 16, 4) for j in range(4)]
    sl, sg, _ = cs.fmb_value_and_grad(tp, cs.fmb_probs(bt, tp, strided),
                                      strided, pdict, freqs)
    assert abs(float(sl) - float(fl)) <= 1e-9 * abs(float(fl))
    jsl, jsg = _jax_minibatched(jp, strided, freqs)
    assert abs(float(sl) - jsl) <= 1e-9 * abs(jsl)
    for k in jsg:
        assert _relerr(_np(sg[k]), _np(fg[k])) <= 1e-9, k
        assert _relerr(_np(sg[k]), jsg[k]) <= 1e-9, k
