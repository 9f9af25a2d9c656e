"""The port's beam models (models/beam.py) against the JAX package at
float64 (1e-9 relative): the pointing offset and edge tapers, every
response (Gauss, Airy with a taper, uniform, pixelized on healpix and
rect grids), PixelBeam's model pairs and apply_beam in every Npol x
Nvec x powerbeam case with one and several beam models, and the
standalone single-time forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.models import beam as jbeam
from bayeslim_tpu.models import telescope as jtel
from bayeslim_tpu.models.sky import PixelSky as JPixelSky
from bayeslim_tpu_torch.models import beam as tbeam
from bayeslim_tpu_torch.models.sky import PixelSky as TPixelSky
from bayeslim_tpu_torch.models.telescope import TelescopeModel
from bayeslim_tpu_torch.utils import healpix as hp

LOC = (21.428305555, -30.72152777, 1073.0)
T64 = dict(device="cpu", dtype=torch.float64)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _angles(seed, n=250):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 100, n), rng.uniform(0, 360, n)


@pytest.mark.parametrize("tx,ty", [(0.0, 0.0), (0.02, 0.0), (-0.03, 0.05)])
def test_pointing_offset_matches_jax(tx, ty):
    zen, az = _angles(0)
    jz, ja = jbeam.pointing_offset(zen * np.pi / 180, az * np.pi / 180,
                                   tx, ty)
    nz, na = tbeam.pointing_offset(zen * np.pi / 180, az * np.pi / 180,
                                   tx, ty)
    tz, ta = tbeam.pointing_offset(torch.as_tensor(zen * np.pi / 180),
                                   torch.as_tensor(az * np.pi / 180), tx, ty)
    for got in ((nz, na), (tz.numpy(), ta.numpy())):
        assert _relerr(got[0], jz) <= 1e-12 and _relerr(got[1], ja) <= 1e-12
    # PixelBeam folds it into degree-valued angles
    tb = tbeam.PixelBeam(np.ones((1, 1, 1, 1, 1)), [1e8], **T64)
    jb = jbeam.PixelBeam(jnp.ones((1, 1, 1, 1, 1)), [1e8])
    tb.set_pointing_offset(tx, ty)
    jb.set_pointing_offset(tx, ty)
    for g, j in zip(tb.apply_pointing(zen, az), jb.apply_pointing(zen, az)):
        assert _relerr(g, j) <= 1e-12


@pytest.mark.parametrize("kw", [dict(mode="gauss"),
                                dict(mode="gauss", mu=60.0, sigma=5.0),
                                dict(mode="gauss", zen_start=70.0),
                                dict(mode="tukey"),
                                dict(mode="tukey", fov=120.0, alpha=0.4)])
def test_beam_edge_taper_matches_jax(kw):
    zen = np.concatenate([np.linspace(-95, 95, 401), [90.0, 60.0, 85.0]])
    j = jbeam.beam_edge_taper(jnp.asarray(zen), **kw)
    t = tbeam.beam_edge_taper(torch.as_tensor(zen), **kw)
    assert _relerr(t.numpy(), j) <= 1e-12


def _responses():
    """(name, torch response, JAX response, params (numpy), freqs)."""
    rng = np.random.default_rng(1)
    freqs = np.linspace(100e6, 200e6, 5)
    tk = dict(mode="gauss", mu=70.0, sigma=4.0)
    out = []
    for pb in (True, False):
        p = rng.uniform(0.3, 0.6, (1, 1, 2, len(freqs), 2))
        out.append((f"gauss powerbeam={pb}", tbeam.GaussResponse(pb),
                    jbeam.GaussResponse(pb), p, freqs))
    p = np.array([13.5, 14.7]).reshape(1, 1, 1, 1, 2)
    for pb in (True, False):
        out.append((f"airy taper powerbeam={pb}",
                    tbeam.AiryResponse(powerbeam=pb, taper_kwargs=tk),
                    jbeam.AiryResponse(powerbeam=pb, taper_kwargs=tk), p,
                    freqs))
    for kw in (dict(brute_force=True), dict(brute_force=True, Ntau=300,
                                            freq_ratio=1.1, powerbeam=False),
               dict(freq_ratio=0.9)):
        out.append((f"airy {kw}", tbeam.AiryResponse(**kw),
                    jbeam.AiryResponse(**kw), p, freqs))
    out.append(("uniform", tbeam.UniformResponse(),
                jbeam.UniformResponse(), np.ones((2, 1, 3, 1, 1)), freqs))
    out.append(("uniform tukey", tbeam.UniformResponse(
        dict(mode="tukey", alpha=0.3)), jbeam.UniformResponse(
        dict(mode="tukey", alpha=0.3)), np.ones((1, 1, 1, 1, 1)), freqs))
    return out


@pytest.mark.parametrize("case", range(9))
def test_analytic_responses_match_jax(case):
    name, tr, jr, p, freqs = _responses()[case]
    zen, az = _angles(2)
    j = jr(jnp.asarray(p), jnp.asarray(zen), jnp.asarray(az), freqs)
    pt = torch.as_tensor(p).requires_grad_(True)
    t = tr(pt, torch.as_tensor(zen), torch.as_tensor(az),
           torch.as_tensor(freqs))
    assert t.shape == j.shape
    assert _relerr(t.detach().numpy(), j) <= 1e-9, name
    if name.startswith("uniform"):
        return
    jg = jax.grad(lambda q: jnp.sum(jr(q, jnp.asarray(zen), jnp.asarray(az),
                                       freqs) ** 2))(jnp.asarray(p))
    (tg,) = torch.autograd.grad(torch.sum(t ** 2), pt)
    assert _relerr(tg.numpy(), jg) <= 1e-9, name


_PIX_CASES = [
    dict(pixtype="healpix"),
    dict(pixtype="healpix", powerbeam=False, realbeam=False, cplx=True),
    dict(pixtype="healpix", comp_params=True, realbeam=False,
         powerbeam=False),
    dict(pixtype="healpix", log=True, norm_pix=0),
    dict(pixtype="healpix", beam0=0.5, taper=True),
    dict(pixtype="rect", interp_mode="cubic", powerbeam=False),
    dict(pixtype="rect", interp_mode="quadratic,linear", cplx=True),
]


@pytest.mark.parametrize("case", range(len(_PIX_CASES)))
@pytest.mark.parametrize("with_ctx", [True, False])
def test_pixel_response_matches_jax(case, with_ctx):
    c = dict(_PIX_CASES[case])
    cplx, taper = c.pop("cplx", False), c.pop("taper", False)
    pixtype = c.pop("pixtype")
    rng = np.random.default_rng(4)
    freqs = np.linspace(100e6, 120e6, 3)
    if pixtype == "healpix":
        grid, npix = dict(nside=8), hp.nside2npix(8)
    else:
        tg, pg = np.linspace(0, 90, 31), np.linspace(0, 354, 60)
        grid, npix = dict(theta_grid=tg, phi_grid=pg), 31 * 60
    shape = (2, 2, 1, len(freqs), npix)
    if c.get("comp_params"):
        shape = shape + (2,)
    p = 1 + 0.1 * rng.standard_normal(shape)
    if cplx:
        p = p + 0.1j * rng.standard_normal(shape)
    if "beam0" in c:
        c["beam0"] = np.full(shape, c["beam0"])
    if taper:
        c["taper_kwargs"] = dict(mode="gauss", mu=60.0)
    tr = tbeam.PixelResponse(freqs, pixtype, **grid, **c)
    jr = jbeam.PixelResponse(freqs, pixtype, **grid, **c)
    zen, az = rng.uniform(0, 88, 200), rng.uniform(-5, 365, 200)
    jctx = jr.precompute(zen, az)
    j = jr(jnp.asarray(p), jnp.asarray(zen), jnp.asarray(az), freqs,
           ctx=jctx)
    ctx = tuple(torch.as_tensor(x) for x in tr.precompute(zen, az)) \
        if with_ctx else None
    pt = torch.as_tensor(p).requires_grad_(True)
    t = tr(pt, torch.as_tensor(zen), torch.as_tensor(az), None, ctx=ctx)
    assert t.shape == j.shape and t.is_complex() == np.iscomplexobj(j)
    assert _relerr(t.detach().numpy(), j) <= 1e-9
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(jr(
        q, jnp.asarray(zen), jnp.asarray(az), freqs, ctx=jctx)) ** 2))(
        jnp.asarray(p))
    (tg,) = torch.autograd.grad(torch.sum(torch.abs(t) ** 2), pt)
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= 1e-9


def test_pixel_response_linear_freq_mode_raises():
    """The 'linear' frequency mode (it raised before LinearModel was
    ported): freq_LM maps each grid pixel's coefficients to channels,
    after beam0; values and gradients against the JAX package."""
    from bayeslim_tpu.models import linear_model as jlm
    from bayeslim_tpu_torch.models import linear_model as tlm
    rng = np.random.default_rng(5)
    freqs = np.linspace(100e6, 120e6, 5)
    npix = hp.nside2npix(4)
    p = 1 + 0.1 * rng.standard_normal((1, 1, 1, 3, npix))
    kw = dict(x=freqs, Ndeg=3, basis="legendre", whiten=True)
    tr = tbeam.PixelResponse(freqs, "healpix", nside=4, freq_mode="linear",
                             freq_LM=tlm.LinearModel(
                                 "poly", dim=3, dtype=torch.float64,
                                 device="cpu", **kw), beam0=0.1 * p)
    jr = jbeam.PixelResponse(freqs, "healpix", nside=4, freq_mode="linear",
                             freq_LM=jlm.LinearModel("poly", dim=3, **kw),
                             beam0=0.1 * p)
    zen, az = rng.uniform(0, 88, 50), rng.uniform(0, 360, 50)
    ctx = jr.precompute(zen, az)
    j = jr(jnp.asarray(p), jnp.asarray(zen), jnp.asarray(az), freqs,
           ctx=ctx)
    pt = torch.as_tensor(p).requires_grad_(True)
    t = tr(pt, torch.as_tensor(zen), torch.as_tensor(az), None,
           ctx=tuple(torch.as_tensor(x) for x in ctx))
    assert t.shape == j.shape == (1, 1, 1, 5, 50)
    assert _relerr(t.detach().numpy(), j) <= 1e-12
    jg = jax.grad(lambda q: jnp.sum(jr(q, jnp.asarray(zen), jnp.asarray(az),
                                       freqs, ctx=ctx) ** 2))(jnp.asarray(p))
    (tg,) = torch.autograd.grad(torch.sum(t ** 2), pt)
    assert _relerr(tg.numpy(), jg) <= 1e-12


def _beam_pair(npol, nvec, powerbeam, nmodel, seed):
    rng = np.random.default_rng(seed)
    shape = (npol, nvec, nmodel, 3, 40)
    beam = rng.standard_normal(shape)
    if not powerbeam:
        beam = beam + 1j * rng.standard_normal(shape)
    ants = list(range(6))
    ant2beam = {a: a % nmodel for a in ants}
    p = np.ones((npol, nvec, nmodel, 1, 1))
    tb = tbeam.PixelBeam(p, [1e8], ant2beam=ant2beam, powerbeam=powerbeam,
                         **T64)
    jb = jbeam.PixelBeam(jnp.asarray(p), [1e8], ant2beam=ant2beam,
                         powerbeam=powerbeam)
    bls = [(a, b) for a in ants for b in ants if a < b]
    return tb, jb, beam, bls


@pytest.mark.parametrize("npol,nvec,powerbeam", [
    (1, 1, True), (1, 1, False), (1, 2, False), (2, 1, True),
    (2, 2, False)])
@pytest.mark.parametrize("nmodel", [1, 3])
def test_apply_beam_matches_jax(npol, nvec, powerbeam, nmodel):
    tb, jb, beam, bls = _beam_pair(npol, nvec, powerbeam, nmodel, 5)
    rng = np.random.default_rng(6)
    sky = rng.standard_normal((nvec, nvec, 3, 40))
    if nvec == 2:
        sky = sky + 1j * rng.standard_normal(sky.shape)
    tp, jp = tb.modelpairs(bls), jb.modelpairs(bls)
    for a, b in zip(tp, jp):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (tp[2] is None) == (nmodel == 1)
    m1, m2 = tb.modelpair_index(bls)
    for fn, i1, i2 in (("apply_beam", m1, m2), ("apply_beam_mp", tp[0],
                                                tp[1])):
        j = getattr(jb, fn)(jnp.asarray(beam), i1, i2, jnp.asarray(sky))
        t = getattr(tb, fn)(torch.as_tensor(beam), torch.as_tensor(i1),
                            torch.as_tensor(i2), torch.as_tensor(sky))
        assert t.shape == j.shape == (npol, npol, len(i1), 3, 40)
        assert _relerr(t.numpy(), j) <= 1e-9, fn


def test_expand_2pol_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 1, 4, 3, 5))
    np.testing.assert_array_equal(
        tbeam._expand_2pol(torch.as_tensor(x)).numpy(),
        np.asarray(jbeam._expand_2pol(jnp.asarray(x))))


@pytest.mark.parametrize("response", ["gauss", "pixel"])
def test_standalone_forward_matches_jax(response):
    """PixelBeam.forward at one time: host eq2top, FOV cut, ctx, beam."""
    nside, freqs = 8, np.linspace(100e6, 120e6, 3)
    npix = hp.nside2npix(nside)
    th, ph = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([ph * 180 / np.pi, 90 - th * 180 / np.pi])
    rng = np.random.default_rng(9)
    sp = rng.uniform(1, 2, (1, 1, len(freqs), npix))
    if response == "gauss":
        p = np.ones((1, 1, 2, len(freqs), 2)) * np.array([0.4, 0.5])
        tr, jr = tbeam.GaussResponse(), jbeam.GaussResponse()
    else:
        p = 1 + 0.1 * rng.standard_normal((1, 1, 2, len(freqs), npix))
        tr = tbeam.PixelResponse(freqs, "healpix", nside=nside)
        jr = jbeam.PixelResponse(freqs, "healpix", nside=nside)
    ant2beam = {0: 0, 1: 1, 2: 0}
    bls = [(0, 1), (0, 2), (1, 2)]
    tb = tbeam.PixelBeam(p, freqs, R=tr, ant2beam=ant2beam, fov=120.0,
                         **T64)
    jb = jbeam.PixelBeam(jnp.asarray(p), freqs, R=jr, ant2beam=ant2beam,
                         fov=120.0)
    for b in (tb, jb):
        b.set_pointing_offset(0.01, -0.02)
    tsky = TPixelSky(sp, angs, hp.nside2pixarea(nside),
                     R=_channel(freqs), **T64)()
    jsky = JPixelSky(jnp.asarray(sp), angs, hp.nside2pixarea(nside))()
    jout = jb.forward(jsky, jtel.TelescopeModel(LOC), 2458168.3, bls)
    tout = tb.forward(tsky, TelescopeModel(LOC), 2458168.3, bls)
    np.testing.assert_array_equal(tout["cut"], jout["cut"])
    np.testing.assert_array_equal(tout["mask"], jout["mask"])
    assert _relerr(tout["zenaz"].numpy(), jout["zenaz"]) <= 1e-9
    # jsky's px_area multiplies; the port's PixelSky does the same
    assert _relerr(tout["sky"].detach().numpy(), jout["sky"]) <= 1e-9


def _channel(freqs):
    from bayeslim_tpu_torch.models.sky import PixelSkyResponse
    return PixelSkyResponse(freqs, **T64)
