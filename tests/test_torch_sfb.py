"""The port's spherical Fourier-Bessel half of ops/sph_harm.py and the
'bessel' sky mode against the JAX package at float64 on the CPU.

- sph_bessel_func in both methods, every bc_type, with and without
  deriv and renorm (the same bits);
- sph_bessel_kln's roots, ball and shell, decimate and add_kzero (the
  same bits; the bar is 1e-12);
- gen_bessel2freq by its three ways in (cosmo, r=, kbins=);
- SFBModel: forward and gradient against jax.grad at unequal Nk per l,
  the batched product against the per-l plain loop, forward_gln,
  setup_gln and make_closure;
- sfb_binning in 1-D and 2-D;
- PixelSkyResponse(freq_mode='bessel') equal to the JAX SFBModel of the
  same gln, not to the JAX mode: ROADMAP queue C item 5, the JAX mode's
  zero m > 0 columns and its ValueError at unequal Nk, are shown, not
  pinned as expected values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.models import sky as jsky
from bayeslim_tpu.models.cosmology import Cosmology as JCosmology
from bayeslim_tpu.ops import sph_harm as jsh
from bayeslim_tpu_torch.models import sky as tsky
from bayeslim_tpu_torch.models.cosmology import Cosmology as TCosmology
from bayeslim_tpu_torch.ops import sph_harm as tsh
from bayeslim_tpu_torch.utils import healpix as hp

T64 = dict(device="cpu", dtype=torch.float64)
FREQS = np.linspace(150e6, 160e6, 8)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _r():
    return JCosmology().f2r(FREQS)


@pytest.mark.parametrize("method", ["ball", "shell"])
@pytest.mark.parametrize("bc_type", [1, 2, 3])
@pytest.mark.parametrize("deriv", [False, True])
@pytest.mark.parametrize("renorm", [False, True])
def test_sph_bessel_func_matches_jax(method, bc_type, deriv, renorm):
    r = _r()
    k = np.concatenate([[0.0], np.linspace(1e-3, 0.05, 9)])
    for l in (0.0, 2.0, [0.0, 1.0, 3.5]):
        kw = dict(method=method, r_crit=r.max(), deriv=deriv,
                  bc_type=bc_type, renorm=renorm)
        want = jsh.sph_bessel_func(l, k, r, **kw)
        got = tsh.sph_bessel_func(l, k, r, **kw)
        assert got.shape == (len(k), len(r))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l", [0.0, 1.0, 7.0, 2.5])
@pytest.mark.parametrize("bc_type", [1, 2, 3])
def test_sph_bessel_kln_ball_matches_jax(l, bc_type):
    r = _r()
    want = jsh.sph_bessel_kln(l, r.min(), r.max(), 0.06, bc_type=bc_type)
    got = tsh.sph_bessel_kln(l, r.min(), r.max(), 0.06, bc_type=bc_type)
    assert len(got) == len(want) > 150
    assert np.abs(got - want).max() <= 1e-12 * want.max()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l,bc_type", [(0.0, 2), (3.0, 1)])
def test_sph_bessel_kln_shell_matches_jax(l, bc_type):
    """The shell determinant (the JAX loop evaluates it point by point,
    so the grid is kept short: 4,000 points)."""
    want = jsh.sph_bessel_kln(l, 100.0, 200.0, 0.1, method="shell",
                              bc_type=bc_type)
    got = tsh.sph_bessel_kln(l, 100.0, 200.0, 0.1, method="shell",
                             bc_type=bc_type)
    assert len(got) == len(want) >= 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(decimate=True), dict(add_kzero=True),
                                dict(decimate=True, add_kzero=True)])
@pytest.mark.parametrize("l", [0.0, 1.0])
def test_sph_bessel_kln_decimate_kzero_match_jax(kw, l):
    want = jsh.sph_bessel_kln(l, 100.0, 200.0, 0.3, **kw)
    got = tsh.sph_bessel_kln(l, 100.0, 200.0, 0.3, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0.0) == (l == 0.0 and kw.get("add_kzero", False))


def test_sph_bessel_kln_empty_and_fine_grid_match_jax():
    """No root below kmax, a grid of one point, and a finer dk_factor
    (a coarse step of 0.5 rad is then 250 grid points)."""
    for kmax in (1e-3, 1.1e-6):
        want = jsh.sph_bessel_kln(2.0, 100.0, 200.0, kmax)
        got = tsh.sph_bessel_kln(2.0, 100.0, 200.0, kmax)
        assert len(want) == len(got) == 0
    want = jsh.sph_bessel_kln(1.0, 100.0, 200.0, 0.1, dk_factor=2e-3)
    got = tsh.sph_bessel_kln(1.0, 100.0, 200.0, 0.1, dk_factor=2e-3)
    np.testing.assert_array_equal(got, want)


def _gln_equal(got, want):
    (tg, tk), (jg, jk) = got, want
    assert list(tg) == list(jg) and list(tk) == list(jk)
    for k in jg:
        assert tg[k].dtype == torch.float64
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(tk[k], jk[k])


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("threads", [1, 4])
def test_gen_bessel2freq_three_ways_match_jax(renorm, threads, monkeypatch):
    monkeypatch.setattr(tsh, "SFB_THREADS", threads)
    ls = [0.0, 1.0, 2.0, 5.0, 1.0]
    kw = dict(kmax=0.02, renorm=renorm)
    want = jsh.gen_bessel2freq(ls, FREQS, cosmo=JCosmology(), **kw)
    got = tsh.gen_bessel2freq(ls, FREQS, cosmo=TCosmology(), **kw, **T64)
    _gln_equal(got, want)
    assert [want[0][k].shape[1] for k in (0.0, 1.0, 2.0)] == [58, 59, 58]
    # r= skips the cosmology; a default Cosmology when neither is given
    r = JCosmology().f2r(FREQS)
    _gln_equal(tsh.gen_bessel2freq(ls, r=r, **kw, **T64),
               jsh.gen_bessel2freq(ls, r=r, **kw))
    _gln_equal(tsh.gen_bessel2freq(ls, FREQS, **kw, **T64), want)
    # kbins= skips the root solve
    kb = {0.0: want[1][0.0][:5], 1.0: want[1][1.0][::7], 2.0: np.zeros(0),
          5.0: want[1][5.0][3:9]}
    _gln_equal(tsh.gen_bessel2freq(ls, FREQS, kbins=kb, **kw, **T64),
               jsh.gen_bessel2freq(ls, FREQS, kbins=kb, **kw))


def test_gen_bessel2freq_shell_matches_jax():
    r = np.linspace(200.0, 100.0, 6)
    kw = dict(kmax=0.075, method="shell", bc_type=2, r=r)
    _gln_equal(tsh.gen_bessel2freq([0.0, 2.0], **kw, **T64),
               jsh.gen_bessel2freq([0.0, 2.0], **kw))


def _sfb_case(lmax=2, kmax=0.02):
    """gen_lm(lmax) columns and gln of unequal Nk per l."""
    l, m = jsh.gen_lm(lmax)
    jg, jk = jsh.gen_bessel2freq(np.unique(l), FREQS, kmax=kmax)
    tg, tk = tsh.gen_bessel2freq(np.unique(l), FREQS, kmax=kmax, **T64)
    nn = max(g.shape[1] for g in jg.values())
    return l, m, (jg, jk), (tg, tk), nn


def test_sfb_forward_and_grad_match_jax():
    l, m, (jg, jk), (tg, tk), nn = _sfb_case()
    rng = np.random.default_rng(0)
    p = rng.standard_normal((2, nn, len(l)))
    w = rng.standard_normal((2, len(FREQS), len(l)))
    jm = jsh.SFBModel(l, m, jg, jk)
    tm = tsh.SFBModel(l, m, tg, tk)
    want = jm(jnp.asarray(p))
    pt = torch.as_tensor(p).requires_grad_(True)
    got = tm(pt)
    assert got.shape == (2, len(FREQS), len(l))
    assert _relerr(got.detach().numpy(), want) <= 1e-12

    def loss(out, w):
        return (out * w).sum() + (out ** 2).sum() / 7
    jgrad = jax.grad(lambda x: loss(jm(x), jnp.asarray(w)))(jnp.asarray(p))
    loss(got, torch.as_tensor(w)).backward()
    assert _relerr(pt.grad.numpy(), jgrad) <= 1e-12
    # rows past an l's Nk take no gradient
    assert not pt.grad[:, 58:, np.flatnonzero(l != 1)].any()


def test_sfb_complex_forward_and_grad_match_jax():
    """Complex t_lmn (and real pairs read as complex by the sky mode):
    the port's gradient is the conjugate of JAX's (ROADMAP queue C1)."""
    l, m, (jg, jk), (tg, tk), nn = _sfb_case()
    rng = np.random.default_rng(1)
    p = rng.standard_normal((nn, len(l))) + 1j * rng.standard_normal(
        (nn, len(l)))
    jm = jsh.SFBModel(l, m, jg, jk)
    tm = tsh.SFBModel(l, m, tg, tk)
    pt = torch.as_tensor(p).requires_grad_(True)
    got = tm(pt)
    assert got.is_complex()
    assert _relerr(got.detach().numpy(), jm(jnp.asarray(p))) <= 1e-12
    jgrad = jax.grad(lambda x: jnp.sum(jnp.abs(jm(x)) ** 2))(jnp.asarray(p))
    (got.abs() ** 2).sum().backward()
    assert _relerr(pt.grad.numpy(), np.conj(jgrad)) <= 1e-12


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("lmax", [0, 3])
def test_sfb_batched_equals_plain_loop(cplx, lmax):
    l, m, _, (tg, tk), nn = _sfb_case(lmax=lmax, kmax=0.02)
    rng = np.random.default_rng(2)
    shape = (3, 1, nn + 2, len(l))
    p = rng.standard_normal(shape)
    if cplx:
        p = p + 1j * rng.standard_normal(shape)
    tm = tsh.SFBModel(l, m, tg, tk)
    a = torch.as_tensor(p).requires_grad_(True)
    b = torch.as_tensor(p).requires_grad_(True)
    fa, fb = tm(a), tm.forward_plain(b)
    assert _relerr(fa.detach().numpy(), fb.detach().numpy()) <= 1e-12
    g = torch.as_tensor(rng.standard_normal(fa.shape))
    (fa.real * g).sum().backward()
    (fb.real * g).sum().backward()
    assert _relerr(a.grad.numpy(), b.grad.numpy()) <= 1e-12


def test_gln_product_gradcheck_and_no_tf32(monkeypatch):
    """The stacked product's own backward, p's gradient G^T g and G's
    (g p^T summed over p's leading dimensions, where G takes one), against
    finite differences; all three products run with TF32 off, whatever
    the global setting."""
    g = torch.Generator().manual_seed(0)
    p = torch.randn(2, 3, 4, 5, 6, dtype=torch.float64, generator=g,
                    requires_grad=True)
    G = torch.randn(4, 7, 5, dtype=torch.float64, generator=g,
                    requires_grad=True)
    assert torch.autograd.gradcheck(tsh._GlnProduct.apply, (p, G))
    seen = []
    real_matmul = torch.Tensor.__matmul__

    def spy(x, y):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_matmul(x, y)
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tsh._GlnProduct.apply(p, G).sum().backward()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False, False, False]


def test_sfb_column_of_no_gln_is_zero_and_LM_applies():
    """A column whose l has no g_ln gives 0, as in the JAX loop; LM acts
    on the params first."""
    l, m, (jg, jk), (tg, tk), nn = _sfb_case()
    del jg[2.0], tg[2.0]
    rng = np.random.default_rng(3)
    p = rng.standard_normal((nn, len(l)))
    jm = jsh.SFBModel(l, m, jg, jk, LM=lambda x: 2 * x)
    tm = tsh.SFBModel(l, m, tg, tk, LM=lambda x: 2 * x)
    got = tm(torch.as_tensor(p)).numpy()
    assert _relerr(got, jm(jnp.asarray(p))) <= 1e-12
    assert not got[:, l == 2].any()
    assert _relerr(tm.forward_plain(torch.as_tensor(p)).numpy(), got) <= 1e-12


def test_sfb_forward_gln_setup_gln_and_closure_match_jax():
    l, m, (jg, jk), (tg, tk), nn = _sfb_case()
    rng = np.random.default_rng(4)
    p = rng.standard_normal((nn, len(l)))
    jm = jsh.SFBModel(l, m, jg, jk)
    tm = tsh.SFBModel(l, m, tg, tk)
    jg2 = {k: 2 * v for k, v in jg.items()}
    tg2 = {k: 2 * v for k, v in tg.items()}
    assert _relerr(tm.forward_gln(torch.as_tensor(p), tg2).numpy(),
                   jm.forward_gln(jnp.asarray(p), jg2)) <= 1e-12
    # the attached gln are back
    assert _relerr(tm(torch.as_tensor(p)).numpy(), jm(jnp.asarray(p))) \
        <= 1e-12
    # setup_gln generates through gen_bessel2freq with r=
    r = JCosmology().f2r(FREQS)
    jm.setup_gln(l, r=r, kmax=0.015, m=m)
    tm.setup_gln(l, r=r, kmax=0.015, m=m)
    _gln_equal((tm.gln, tm.kbins), (jm.gln, jm.kbins))
    assert _relerr(tm(torch.as_tensor(p)).numpy(), jm(jnp.asarray(p))) \
        <= 1e-12
    tm.setup_gln(l, gln=tg, kln=tk, out_dtype=torch.float32)
    assert tm._G.dtype == torch.float32
    tgt = rng.standard_normal((len(FREQS), len(l)))
    jm.setup_gln(l, gln=jg, kln=jk)
    tm.setup_gln(l, gln=tg, kln=tk, out_dtype=torch.float64)

    def mse(a, b):
        return ((a - b) ** 2).sum()
    want = jm.make_closure(jnp.asarray(p), mse, jnp.asarray(tgt))()
    got = tm.make_closure(torch.as_tensor(p), mse, torch.as_tensor(tgt))()
    assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("opts", [dict(), dict(var=True, wgts=True)])
def test_sfb_binning_matches_jax(two_d, opts):
    rng = np.random.default_rng(5)
    n = 40
    k_arr = rng.uniform(0.0, 0.1, n)
    l_arr = rng.integers(0, 6, n)
    params = rng.standard_normal((2, n))
    kw = {}
    if opts.get("var"):
        kw["var"] = rng.uniform(0.5, 2.0, (2, n))
    if opts.get("wgts"):
        kw["wgts"] = rng.uniform(0.5, 2.0, n)
    if two_d:
        kw.update(l_arr=l_arr, lbins=np.asarray([0.0, 2.0, 4.0, 9.0]))
    kbins = np.asarray([0.01, 0.03, 0.05, 0.07, 0.2])
    want = jsh.sfb_binning(jnp.asarray(params), k_arr, kbins,
                           **{k: (jnp.asarray(v) if k in ("var", "wgts")
                                  else v) for k, v in kw.items()})
    got = tsh.sfb_binning(torch.as_tensor(params), k_arr, kbins,
                          **{k: (torch.as_tensor(v) if k in ("var", "wgts")
                                 else v) for k, v in kw.items()})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=0)
    # the last k bin (0.2) is empty
    assert not got[0][..., -1].any()


def _bessel_sky(common_nk):
    """The 'bessel' mode over an 'alm' spatial mode (lmax 2, nside 4) in
    both packages, with gln cut to a common Nk or not."""
    nside = 4
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    l, m, (jg, jk), (tg, tk), nn = _sfb_case()
    if common_nk:
        nn = min(g.shape[1] for g in jg.values())
        jg = {k: v[:, :nn] for k, v in jg.items()}
        tg = {k: v[:, :nn] for k, v in tg.items()}
    jm = jsh.AlmModel(l, m, real_output=False)
    jm.generate_Ylm(theta, phi, high_prec=False)
    tm = tsh.AlmModel(l, m, real_output=False, **T64)
    tm.generate_Ylm(theta, phi, high_prec=False)
    kw = dict(comp_params=True, spatial_mode="alm", freq_mode="bessel",
              transform_order=1, real_output=True)
    jr = jsky.PixelSkyResponse(FREQS, spat_LM=jm, gln=jg, kbins=jk,
                               cosmo=JCosmology(), **kw)
    tr = tsky.PixelSkyResponse(FREQS, spat_LM=tm, gln=tg, kbins=tk,
                               cosmo=TCosmology(), **kw, **T64)
    p = np.random.default_rng(6).standard_normal((1, 1, nn, len(l), 2))
    want = jm.forward_alm(jsh.SFBModel(l, m, jg, jk)(
        jnp.asarray(p[..., 0] + 1j * p[..., 1]))).real
    return jr, tr, p, want, l, m, jg, jk


@pytest.mark.parametrize("common_nk", [False, True])
def test_bessel_mode_equals_jax_sfb_model(common_nk):
    jr, tr, p, want, *_ = _bessel_sky(common_nk)
    pt = torch.as_tensor(p).requires_grad_(True)
    got = tr(pt)
    assert got.shape == want.shape == (1, 1, len(FREQS), 192)
    assert not got.is_complex()
    assert _relerr(got.detach().numpy(), want) <= 1e-12
    (got ** 2).sum().backward()
    assert pt.grad.abs().max() > 0


def test_queue_c5_jax_bessel_mode_zero_columns_and_valueerror():
    """ROADMAP queue C item 5, shown: at a common Nk the JAX mode gives
    each l one column by its rank among the unique l, so its a_lm(freq)
    at the m > 0 columns are exactly zero where SFBModel's are not; at
    unequal Nk it raises. The port's mode is held to SFBModel above."""
    jr, tr, p, want, l, m, jg, jk = _bessel_sky(True)
    pc = jnp.asarray(p[..., 0] + 1j * p[..., 1])
    alm_jax_mode = jr.freq_transform(pc)
    alm_sfb = jsh.SFBModel(l, m, jg, jk)(pc)
    assert not np.asarray(alm_jax_mode)[..., m > 0].any()
    assert np.abs(np.asarray(alm_sfb)[..., m > 0]).min() > 0
    alm_port = tr.freq_transform(torch.as_tensor(p))
    assert _relerr(alm_port.numpy(), alm_sfb) <= 1e-12
    jr2, *_ = _bessel_sky(False)
    nn = max(g.shape[1] for g in jr2.gln.values())
    with pytest.raises(ValueError):
        jr2.freq_transform(jnp.zeros((1, 1, nn, len(l)), dtype=complex))


def test_bessel_mode_needs_order_1_and_an_l():
    *_, l, m, jg, jk = _bessel_sky(False)
    tg = {k: torch.as_tensor(np.asarray(v)) for k, v in jg.items()}
    tm = tsh.AlmModel(l, m, **T64)
    tr = tsky.PixelSkyResponse(FREQS, spatial_mode="alm", spat_LM=tm,
                               freq_mode="bessel", gln=tg, kbins=jk,
                               transform_order=0, **T64)
    with pytest.raises(AssertionError, match="transform_order=1"):
        tr.freq_transform(torch.zeros((177, len(l)), dtype=torch.float64))
    with pytest.raises(ValueError, match="l and m"):
        tsky.PixelSkyResponse(FREQS, spatial_mode="pixel",
                              freq_mode="bessel", gln=tg, kbins=jk, **T64)


def test_bessel_mode_survives_a_mode_cut():
    """pixelsky_Ylm_cut trims the 'bessel' mode's SFBModel columns with
    the AlmModel's: the cut sky equals the uncut one's SFB transform of
    the kept modes."""
    nside = 4
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    l, m, _, (tg, tk), nn = _sfb_case()
    tm = tsh.AlmModel(l, m, real_output=False, **T64)
    tm.generate_Ylm(theta, phi, high_prec=False)
    R = tsky.PixelSkyResponse(FREQS, comp_params=True, spatial_mode="alm",
                              freq_mode="bessel", transform_order=1,
                              spat_LM=tm, gln=tg, kbins=tk, **T64)
    p = np.random.default_rng(7).standard_normal((1, 1, nn, len(l), 2))
    angs = np.stack([np.degrees(phi), 90 - np.degrees(theta)])
    sky = tsky.PixelSky(p, angs, hp.nside2pixarea(nside), R=R, **T64)
    keep = tsky.pixelsky_Ylm_cut(sky, mmax=1)
    assert list(keep) == list(np.flatnonzero(m <= 1))
    ref = tsh.SFBModel(l[keep], m[keep], tg, tk)(torch.complex(
        torch.as_tensor(p[..., keep, 0]), torch.as_tensor(p[..., keep, 1])))
    got = sky.R.freq_transform(sky.params.detach())
    assert _relerr(got.numpy(), ref.numpy()) <= 1e-12


# the small hera-sfb chain: hex-2, nside 8, lmax 23, 8 channels, 2 times,
# 8 k modes, a Ylm beam of lmax 8 on an nside-8 grid
SFB_SMALL = dict(hexN=2, nside=8, lmax=23, nfreq=8, fmax=120e6, ntime=2,
                 pix_chunk=512, beam_lmax=8, beam_nside=8, nn=8)


def _sfb_chain_jax(tp, info, target):
    """chip_smoke.build_sfb's chain through the JAX package: the same
    array, times and target; the sky's SFB transform by the JAX SFBModel
    of the same gln (as the response's LM, its real pairs read as complex
    first, then the 'channel' mode: the function the port's 'bessel' mode
    computes), its Ylm from the JAX fast path (finite at lmax 23); the
    YlmResponse beam; at the port's params."""
    import bayeslim_tpu as bl
    from bayeslim_tpu.models.beam_ylm import YlmResponse
    from bayeslim_tpu.utils import AntposDict as JAntposDict
    from bayeslim_tpu.utils import make_hex as jmake_hex
    from bayeslim_tpu.utils.dtypes import viewcomp as jviewcomp
    k = SFB_SMALL
    ants, antvecs = jmake_hex(k["hexN"], D=15.0)
    freqs = info["freqs"]
    T = bl.TelescopeModel((21.428305555, -30.72152777, 1073.0))
    arr = bl.ArrayModel(JAntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=False)
    theta, phi = info["theta"], info["phi"]
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    l, m = jsh.gen_lm(k["lmax"])
    alm = jsh.AlmModel(l, m)
    alm.generate_Ylm(theta, phi, method="sphere", high_prec=False)
    jg = {ll: jnp.asarray(g.numpy()) for ll, g in info["gln"].items()}
    sfb = jsh.SFBModel(l, m, jg, info["kbins"])
    R = jsky.PixelSkyResponse(freqs, comp_params=True, spatial_mode="alm",
                              freq_mode="channel", real_output=True,
                              spat_LM=alm, LM=lambda p: sfb(jviewcomp(p)))
    sky = jsky.PixelSky(jnp.asarray(tp.model.sky.params.detach().numpy()),
                        angs, hp.nside2pixarea(k["nside"]), R=R)
    lb, mb = jsh.gen_lm(k["beam_lmax"])
    BR = YlmResponse(lb, mb, freqs, mode="interpolate", pixtype="healpix",
                     nside=k["beam_nside"], powerbeam=True, realbeam=True,
                     comp_params=True,
                     Ylm_kwargs=dict(method="sphere", high_prec=False))
    beam = bl.PixelBeam(jnp.asarray(tp.model.beam.params.detach().numpy()),
                        freqs, R=BR, pol="e", powerbeam=True, fov=180.0,
                        parameter=True)
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    bls = [r[0] for r in reds]
    times = 2458168.3 + np.arange(k["ntime"]) * 5e-4
    rime = bl.RIME(sky, T, beam, arr, bls, times, freqs,
                   pix_chunk=k["pix_chunk"])
    tgt = bl.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=jnp.asarray(target),
                   icov=jnp.asarray(tp.target[0].icov.numpy()))
    return bl.inference.LogProb(rime, tgt)


def test_hera_sfb_chain_matches_jax():
    """The slice as a whole: chip_smoke.build_sfb at hex-2 (the 'bessel'
    sky and the Ylm beam through the RIME, icov = group counts) against
    the same chain in the JAX package: the loss and the t_lmn and beam
    gradients at the start; the truth sits lower than the start."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bayeslim_tpu_torch as bt
    from chip_smoke import build_sfb
    tp, truth, info = build_sfb(bt, device="cpu", dtype=torch.float64,
                                **SFB_SMALL)
    assert max(info["nk"].values()) == SFB_SMALL["nn"]
    assert len(set(info["nk"].values())) > 1
    jp = _sfb_chain_jax(tp, info, tp.target[0].data.numpy())
    tv, tg = tp.value_and_grad()
    jv, jg = jp.value_and_grad()
    assert abs(float(tv) - float(jv)) <= 1e-9 * abs(float(jv))
    assert set(tg.keys()) == {"sky.params", "beam.params"}
    for k in tg.keys():
        assert _relerr(tg[k].numpy(), jg[k]) <= 1e-9, k
    bt.load_numpy_pdict(tp.model, {"sky.params": truth["sky"],
                                   "beam.params": truth["beam"]})
    assert float(tp.value_and_grad()[0]) < float(tv)
