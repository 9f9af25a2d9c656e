"""The port's Ylm beam (models/beam_ylm.py) and the linear models' host
helpers (models/linear_model.py) against the JAX package at float64 on
the CPU (1e-9 relative, gradients included):

- whiten_xarr, prep_xarr and gen_poly_A in every basis;
- YlmResponse in interpolate mode on a HEALPix grid and on a rect grid
  (separable or not), with and without a precomputed ctx, with
  powerbeam, realbeam, log, beam0, norm_pix, the edge taper and
  comp_params; in generate mode from a ctx (gen_grid_Ylm) and from
  setup_Ylm; lm_poly_setup / lm_poly_forward / lm_poly_fit; AlmBeam;
- the Ylm beam inside the RIME as tests/test_sph_harm.py builds it: the
  visibilities and the beam's gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import beam_ylm as jby
from bayeslim_tpu.models import linear_model as jlm
from bayeslim_tpu.ops import sph_harm as jsh
from bayeslim_tpu_torch.models import beam_ylm as tby
from bayeslim_tpu_torch.models import linear_model as tlm

T64 = dict(device="cpu", dtype=torch.float64)
YK = dict(method="sphere", high_prec=False)
FREQS = np.linspace(100e6, 120e6, 3)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("kw", [dict(), dict(x0=3.0), dict(dx=2.5),
                                dict(x0=1.0, dx=0.0)])
def test_whiten_and_prep_xarr_match_jax(kw):
    x = np.linspace(2.0, 9.0, 11)
    for a, b in zip(tlm.whiten_xarr(x, **kw), jlm.whiten_xarr(x, **kw)):
        np.testing.assert_array_equal(a, b)
    for pk in (dict(), dict(d0=2.0, logx=True), dict(whiten=True, **kw)):
        for a, b in zip(tlm.prep_xarr(x, **pk), jlm.prep_xarr(x, **pk)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("basis", ["direct", "legendre", "chebyshevt",
                                   "chebyshevu", "laguerre"])
@pytest.mark.parametrize("kw", [dict(), dict(qr=True),
                                dict(whiten=False, d0=10.0, logx=True)])
def test_gen_poly_A_matches_jax(basis, kw):
    x = np.linspace(1.0, 24.0, 12)
    got = tlm.gen_poly_A(x, 4, basis=basis, **kw, **T64)
    want = jlm.gen_poly_A(x, 4, basis=basis, **kw)
    assert got.dtype == torch.float64 and got.shape == (12, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NameError):
        tlm.gen_poly_A(x, 2, basis="hermite", **T64)


def _params(l, nfreq=3, seed=0, pairs=False, nmodel=1):
    rng = np.random.default_rng(seed)
    shape = (1, 1, nmodel, nfreq, len(l))
    p = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    p = p / (np.asarray(l) + 1.0)
    p[..., np.asarray(l) == 0] += 2.0
    return np.stack([p.real, p.imag], -1) if pairs else p


_INTERP_CASES = [
    dict(pixtype="healpix"),
    dict(pixtype="healpix", powerbeam=False, realbeam=False),
    dict(pixtype="healpix", log=True, powerbeam=False),
    dict(pixtype="healpix", beam0=True, norm_pix=0, comp_params=True),
    dict(pixtype="healpix", taper=True, interp_mode="linear"),
    dict(pixtype="rect"),
    dict(pixtype="rect", separable=False, powerbeam=False),
    dict(pixtype="rect", interp_mode="cubic", realbeam=False,
         powerbeam=False),
    dict(pixtype="healpix", linear=True, beam0=True),
]


def _interp_pair(c, l, m):
    c = dict(c)
    pixtype = c.pop("pixtype")
    taper = c.pop("taper", False)
    yk = dict(YK)
    if "separable" in c:
        yk["separable"] = c.pop("separable")
    if pixtype == "healpix":
        grid = dict(nside=4)
    else:
        grid = dict(theta_grid=np.linspace(0, 90, 10),
                    phi_grid=np.linspace(0, 340, 18))
    if c.pop("beam0", False):
        c["beam0"] = 0.1 * _params(l, seed=9)
    if taper:
        c["taper_kwargs"] = dict(mode="gauss", mu=60.0)
    tk, jk = {}, {}
    if c.pop("linear", False):
        # 3 Legendre coefficients a mode over the 3 channels
        lkw = dict(dim=3, x=FREQS, Ndeg=3, basis="legendre", whiten=True)
        tk = dict(freq_mode="linear",
                  freq_LM=tlm.LinearModel("poly", **lkw, **T64))
        jk = dict(freq_mode="linear",
                  freq_LM=jlm.LinearModel("poly", **lkw))
    kw = dict(mode="interpolate", pixtype=pixtype, **grid, **c)
    tr = tby.YlmResponse(l, m, FREQS, Ylm_kwargs=dict(yk), **kw, **tk,
                         **T64)
    jr = jby.YlmResponse(l, m, FREQS, Ylm_kwargs=dict(yk), **kw, **jk)
    return tr, jr


@pytest.mark.parametrize("case", range(len(_INTERP_CASES)))
@pytest.mark.parametrize("with_ctx", [True, False])
def test_ylm_response_interpolate_matches_jax(case, with_ctx):
    l, m = jsh.gen_lm(4)
    c = _INTERP_CASES[case]
    tr, jr = _interp_pair(c, l, m)
    p = _params(l, pairs=c.get("comp_params", False))
    rng = np.random.default_rng(1)
    zen, az = rng.uniform(0, 85, 120), rng.uniform(0, 360, 120)
    jctx = jr.precompute(zen, az)
    want = jr(jnp.asarray(p), jnp.asarray(zen), jnp.asarray(az), FREQS,
              ctx=jctx)
    ctx = tuple(torch.as_tensor(x) for x in tr.precompute(zen, az)) \
        if with_ctx else None
    pt = torch.as_tensor(p).requires_grad_(True)
    got = tr(pt, torch.as_tensor(zen), torch.as_tensor(az), None, ctx=ctx)
    assert got.shape == want.shape
    assert got.is_complex() == np.iscomplexobj(want)
    assert _relerr(got.detach().numpy(), want) <= 1e-9
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(jr(
        q, jnp.asarray(zen), jnp.asarray(az), FREQS, ctx=jctx)) ** 2))(
        jnp.asarray(p))
    (tg,) = torch.autograd.grad(torch.sum(torch.abs(got) ** 2), pt)
    want_g = np.asarray(jg) if not np.iscomplexobj(p) else np.conj(jg)
    assert _relerr(tg.numpy(), want_g) <= 1e-9
    # the grid beam
    assert _relerr(tr.grid_beam(torch.as_tensor(p)).numpy(),
                   jr.grid_beam(jnp.asarray(p))) <= 1e-9


def test_ylm_response_rect_separable_keeps_the_pair():
    l, m = jsh.gen_lm(3)
    tr, _ = _interp_pair(dict(pixtype="rect"), l, m)
    assert tr.alm.separable and isinstance(tr.alm.Ylm, tuple)
    tn, _ = _interp_pair(dict(pixtype="rect", separable=False), l, m)
    assert not tn.alm.separable and tn.alm.Ylm.shape == (len(l), 180)


@pytest.mark.parametrize("how", ["ctx", "setup_Ylm"])
@pytest.mark.parametrize("opts", [dict(), dict(powerbeam=False),
                                  dict(log=True, realbeam=False,
                                       powerbeam=False),
                                  dict(taper=True)])
def test_ylm_response_generate_matches_jax(how, opts):
    """Generate mode outside the RIME (its precompute asserts interpolate
    mode), as tests/test_reference_parity.py's Ylm beam parity runs it."""
    opts = dict(opts)
    if opts.pop("taper", False):
        opts["taper_kwargs"] = dict(mode="tukey", fov=170.0)
    l, m = jsh.gen_lm(3)
    rng = np.random.default_rng(23)
    zen = np.sort(rng.uniform(0, 80, 40))
    az = rng.uniform(0, 360, 40)
    p = _params(l, seed=2)
    kw = dict(mode="generate", **opts)
    tr = tby.YlmResponse(l, m, FREQS, **kw, **T64)
    jr = jby.YlmResponse(l, m, FREQS, **kw)
    Y, am = tr.gen_grid_Ylm(zen, az, **YK)
    jY, _, jam = jsh.gen_sph2pix(np.radians(zen), np.radians(az), l, m, **YK)
    assert _relerr(Y.numpy(), jY) <= 1e-12
    if how == "ctx":
        jctx, ctx = (jY, jam), (Y, am)
    else:
        jr.setup_Ylm(jY, alm_mult=jam)
        tr.setup_Ylm(Y, alm_mult=am)
        jctx = ctx = None
    want = jr(jnp.asarray(p), jnp.asarray(zen), jnp.asarray(az), FREQS,
              ctx=jctx)
    pt = torch.as_tensor(p).requires_grad_(True)
    got = tr(pt, torch.as_tensor(zen), torch.as_tensor(az), None, ctx=ctx)
    assert got.shape == want.shape == (1, 1, 1, 3, 40)
    assert _relerr(got.detach().numpy(), want) <= 1e-9
    (tg,) = torch.autograd.grad(torch.sum(torch.abs(got) ** 2), pt)
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(jr(
        q, jnp.asarray(zen), jnp.asarray(az), FREQS, ctx=jctx)) ** 2))(
        jnp.asarray(p))
    assert _relerr(tg.numpy(), np.conj(jg)) <= 1e-9
    with pytest.raises(AssertionError):
        tr.precompute(zen, az)


def test_alm_beam_matches_jax():
    l, m = jsh.gen_lm(3)
    rng = np.random.default_rng(5)
    zen, az = rng.uniform(0, 80, 30), rng.uniform(0, 360, 30)
    p = _params(l, seed=3)
    tb = tby.AlmBeam(l, m, FREQS, **T64)
    jb = jby.AlmBeam(l, m, FREQS)
    want = jb(jnp.asarray(p), zen, az, FREQS, Ylm_kwargs=YK)
    got = tb(torch.as_tensor(p), zen, az, None, Ylm_kwargs=YK)
    assert _relerr(got.numpy(), want) <= 1e-9
    # an attached Ylm is used as it is
    Y, am = tb.R.gen_grid_Ylm(zen, az, **YK)
    tb.R.setup_Ylm(Y, alm_mult=am)
    assert _relerr(tb(torch.as_tensor(p), zen, az, None).numpy(), want) \
        <= 1e-9


@pytest.mark.parametrize("lm_kw", [
    dict(Ndeg=3),
    dict(Ndeg=2, basis="legendre"),
    # an entry a group: m = 0 kept as it is, m = 2 one weight
    {mm: dict(Ndeg=None) if mm == 0 else dict(Ndeg=1) if mm == 2
     else dict(Ndeg=2, basis="chebyshevt") for mm in range(6)},
])
def test_lm_poly_matches_jax(lm_kw):
    l, m = jsh.gen_lm(5)
    tr, jr = _interp_pair(dict(pixtype="healpix", powerbeam=False), l, m)
    tr.lm_poly_setup(lm_kw)
    jr.lm_poly_setup(lm_kw)
    assert tr._lm_poly_ncoeff_in == jr._lm_poly_ncoeff_in
    for mm, (li, pi, A) in jr.lm_poly_A.items():
        tli, tpi, tA = tr.lm_poly_A[mm]
        np.testing.assert_array_equal(tli, li)
        np.testing.assert_array_equal(tpi, pi)
        assert (A is None) == (tA is None)
        if A is not None:
            np.testing.assert_array_equal(tA.numpy(), np.asarray(A))
    rng = np.random.default_rng(6)
    nw = jr._lm_poly_ncoeff_in
    w = rng.standard_normal((1, 1, 1, 3, nw)) \
        + 1j * rng.standard_normal((1, 1, 1, 3, nw))
    assert _relerr(tr.lm_poly_forward(torch.as_tensor(w)).numpy(),
                   jr.lm_poly_forward(jnp.asarray(w))) <= 1e-12
    assert _relerr(tr.grid_beam(torch.as_tensor(w)).numpy(),
                   jr.grid_beam(jnp.asarray(w))) <= 1e-9
    full = _params(l, seed=7)
    got = tr.lm_poly_fit(torch.as_tensor(full))
    want = jr.lm_poly_fit(jnp.asarray(full))
    assert got.shape == want.shape
    assert _relerr(got.numpy(), want) <= 1e-9
    # the fit inverts the expansion where a group has as many l as
    # weights
    back = tr.lm_poly_fit(tr.lm_poly_forward(torch.as_tensor(w))).numpy()
    full_rank = np.concatenate([pi for li, pi, _ in tr.lm_poly_A.values()
                                if len(li) >= len(pi)])
    assert _relerr(back[..., full_rank], w[..., full_rank]) <= 1e-9


def test_lm_poly_off_and_linear_freq_mode_raises():
    """lm_poly_setup(None) leaves the a_lm as they are; the 'linear'
    frequency mode (it raised before LinearModel was ported) maps each
    mode's coefficients to channels after beam0, as the JAX response
    does, in generate mode too."""
    l, m = jsh.gen_lm(2)
    tr, _ = _interp_pair(dict(pixtype="healpix"), l, m)
    tr.lm_poly_setup(None)
    assert not tr._lm_poly
    lkw = dict(dim=3, x=FREQS, Ndeg=2, basis="legendre", whiten=True)
    p = _params(l, nfreq=2)
    b0 = 0.1 * _params(l, nfreq=2, seed=3)
    tr = tby.YlmResponse(l, m, FREQS, mode="generate", freq_mode="linear",
                         freq_LM=tlm.LinearModel("poly", **lkw, **T64),
                         beam0=b0, **T64)
    jr = jby.YlmResponse(l, m, FREQS, mode="generate", freq_mode="linear",
                         freq_LM=jlm.LinearModel("poly", **lkw), beam0=b0)
    got = tr._freq_transform(torch.as_tensor(p))
    assert got.shape == (1, 1, 1, 3, len(l))
    assert _relerr(got.numpy(), jr._freq_transform(jnp.asarray(p))) <= 1e-12


def _ylm_rime_pair():
    """tests/test_sph_harm.py::test_ylm_response_beam_in_rime in both
    packages: 3 point sources, a hex-2 array, an lmax-3 Ylm power beam
    on an nside-8 grid, 4 channels, 3 baselines, one time."""
    from tests.test_rime import (JD0, setup_Array, setup_PointSky,
                                 setup_Telescope)
    from bayeslim_tpu_torch.utils import AntposDict, make_hex
    T = setup_Telescope()
    sky, freqs = setup_PointSky(T, Nsource=3, Nfreqs=4)
    arr = setup_Array(N=2, freqs=freqs)
    l, m = jsh.gen_lm(3)
    params = np.zeros((1, 1, 1, 4, len(l)), dtype=complex)
    params[..., (m == 0)] = [1.0, 0.5, 0.2, 0.05]
    params = params + 0.05 * _params(l, nfreq=4, seed=11)
    kw = dict(mode="interpolate", pixtype="healpix", nside=8,
              powerbeam=True, Ylm_kwargs=YK)
    jbeam = bl.PixelBeam(jnp.asarray(params), freqs,
                         R=jby.YlmResponse(l, m, freqs, **kw), pol="e",
                         powerbeam=True, fov=180.0)
    bls = arr.get_bls(keep_autos=False)[:3]
    jr = bl.RIME(sky, T, jbeam, arr, bls, np.asarray([JD0]), freqs)

    sp = np.asarray(sky.params)
    tsky = bt.PointSky(sp, np.asarray(sky.angs), R=bt.PointSkyResponse(
        freqs, freq_mode="powerlaw", f0=freqs[0], **T64), **T64)
    tbeam = bt.PixelBeam(params, freqs, R=tby.YlmResponse(
        l, m, freqs, **kw, **T64), pol="e", powerbeam=True, fov=180.0,
        **T64)
    ants, av = make_hex(2, D=15.0)
    tarr = bt.ArrayModel(AntposDict(ants, av), freqs=freqs, **T64)
    tr = bt.RIME(tsky, bt.TelescopeModel(T.location), tbeam, tarr, bls,
                 np.asarray([JD0]), freqs)
    return jr, tr


def test_ylm_beam_in_the_rime_matches_jax():
    jr, tr = _ylm_rime_pair()
    want = jr.forward().data
    vd = tr()
    assert vd.data.shape == want.shape
    assert _relerr(vd.data.detach().numpy(), want) <= 1e-9
    assert np.abs(np.asarray(want)).max() > 0
    pd = bl.model2pdict(jr)
    jg = jax.grad(lambda p: jnp.sum(jnp.abs(
        jr.updated(p).forward().data) ** 2))(pd)["beam.params"]
    loss = torch.sum(torch.abs(tr().data) ** 2)
    (tg,) = torch.autograd.grad(loss, tr.beam.params)
    assert np.abs(np.asarray(jg)).max() > 0
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= 1e-9
