"""The port's filters against the JAX package: the covariance kernels
and gen_cov_modes, MatFilter under each option, GPFilter in every
inversion mode, LstSqFilter, WedgeFilter on a VisData and on tensors,
tests/test_config5.py's filter step rebuilt on both sides, and the
hera-filt chain of chip_smoke.py (RIME -> JonesModel with smooth
polynomial gains -> WedgeFilter) at hex-3: values and gradients.
Inputs come from numpy seeds; everything compares at float64, but for
the hex-2 chain's float32 gradient against its float64 one (ROADMAP
C10)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import filt as jfilt
from bayeslim_tpu_torch.models import filt as tfilt

T64 = dict(device="cpu", dtype=torch.float64)
N = 12
X = np.linspace(0.0, 1.0, N)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("fn,kw", [
    ("rbf_cov", dict(ls=0.2)), ("rbf_cov", dict(ls=0.3, amp=2.0)),
    ("exp_cov", dict(ls=0.1)), ("sinc_cov", dict(ls=0.25)),
    ("gauss_sinc_cov", dict(gauss_ls=0.4, sinc_ls=0.2, amp=0.5)),
    ("phasor_mat", dict(shift=3.0)), ("phasor_mat", dict(shift=2.0,
                                                         neg=False))])
@pytest.mark.parametrize("cross", [False, True])
def test_covariances_vs_jax(fn, kw, cross):
    x2 = np.linspace(0.1, 0.9, 5) if cross else None
    want = getattr(jfilt, fn)(X, x2=x2, **kw)
    got = getattr(tfilt, fn)(X, x2=x2, device="cpu", **kw)
    assert got.dtype == (torch.complex128 if fn == "phasor_mat"
                         else torch.float64)
    assert got.shape == want.shape
    assert _relerr(got.numpy(), want) <= 1e-14


@pytest.mark.parametrize("kw", [dict(), dict(N=4), dict(rcond=1e-6)])
def test_gen_cov_modes_vs_jax(kw):
    C = jfilt.rbf_cov(X, ls=0.2)
    jA, je = jfilt.gen_cov_modes(C, **kw)
    tA, te = tfilt.gen_cov_modes(torch.as_tensor(np.array(C)), **kw)
    assert tA.shape == jA.shape
    assert _relerr(te.numpy(), je) <= 1e-12
    # eigenvectors up to sign
    s = np.sign(np.sum(tA.numpy() * np.asarray(jA), axis=0))
    assert _relerr(tA.numpy() * s, jA) <= 1e-9


def _y(rng, shape, cplx=True):
    y = rng.standard_normal(shape)
    return y + 1j * rng.standard_normal(shape) if cplx else y


def _check_filter(jf, tf, y):
    """Forward values and the gradient of a real loss of the output."""
    rng = np.random.default_rng(9)
    want = jf(jnp.asarray(y))
    yt = torch.as_tensor(y).requires_grad_(True)
    got = tf(yt)
    assert tuple(got.shape) == want.shape
    assert got.is_complex() == np.iscomplexobj(want)
    assert _relerr(got.detach().numpy(), want) <= 1e-12
    w = rng.standard_normal(want.shape)

    def jloss(v):
        out = jf(v)
        return jnp.sum(jnp.real(out) * w) + jnp.sum(jnp.imag(out) * w)
    jg = jax.grad(jloss)(jnp.asarray(y))
    wt = torch.as_tensor(w)
    loss = torch.sum(got.real * wt) + (torch.sum(got.imag * wt)
                                       if got.is_complex() else 0.0)
    (tg,) = torch.autograd.grad(loss, yt)
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= 1e-12


# (G kind, MatFilter kwargs, data shape, complex data)
MATS = [("real", dict(), (2, 3, N), True),
        ("real", dict(), (2, 3, N), False),
        ("complex", dict(), (2, 3, N), True),
        ("complex", dict(), (2, 3, N), False),
        ("real", dict(dim=1, residual=True), (2, N, 3), True),
        ("rows", dict(input_idx=np.arange(2, 7)), (2, N), True),
        ("rows", dict(input_idx=np.arange(2, 7), residual=True), (2, N),
         True)]


@pytest.mark.parametrize("kind,kw,shape,cplx", MATS)
def test_mat_filter_vs_jax(kind, kw, shape, cplx):
    rng = np.random.default_rng(1)
    G = rng.standard_normal((5 if kind == "rows" else N, N)) / N
    if kind == "complex":
        G = G * np.asarray(jfilt.phasor_mat(X, 2.0))
    jf = jfilt.MatFilter(G=jnp.asarray(G), **kw)
    tf = tfilt.MatFilter(G=G, **kw, **T64)
    _check_filter(jf, tf, _y(rng, shape, cplx))


def test_mat_filter_G_idx_and_visdata_vs_jax():
    """set_G_idx sub-indexes G; a VisData in gives a VisData out."""
    rng = np.random.default_rng(2)
    G = rng.standard_normal((N, N)) / N
    jf = jfilt.MatFilter(G=jnp.asarray(G), residual=True)
    tf = tfilt.MatFilter(G=G, residual=True, **T64)
    idx = np.arange(1, 9)
    jf.set_G_idx(idx)
    tf.set_G_idx(idx)
    _check_filter(jf, tf, _y(rng, (2, 8)))
    jf.set_G_idx()
    tf.set_G_idx()
    y = _y(rng, (1, 1, 3, 2, N))
    bls, times = [(0, 1), (0, 2), (1, 2)], np.arange(2.0)
    jvd, tvd = bl.VisData(), bt.VisData()
    jvd.setup_data(bls, times, X, pol="ee", data=jnp.asarray(y))
    tvd.setup_data(bls, times, X, pol="ee", data=torch.as_tensor(y))
    got, want = tf(tvd), jf(jvd)
    assert isinstance(got, bt.VisData)
    assert _relerr(got.data.numpy(), want.data) <= 1e-12
    assert _relerr(tf.predict(tvd).data.numpy(),
                   jf.predict(jvd).data) <= 1e-12


# (Cs kind, GPFilter kwargs)
GPS = [("real", dict()), ("real", dict(inv="chol")),
       ("real", dict(inv="diag")), ("real", dict(eps=1e-3, rcond=1e-10)),
       ("real", dict(residual=True)), ("complex", dict()),
       ("complex", dict(inv="chol", residual=True)), ("cross", dict())]


@pytest.mark.parametrize("kind,kw", GPS)
def test_gp_filter_vs_jax(kind, kw):
    """The host float64 inversion (C, C_inv, G, V) and the filter."""
    rng = np.random.default_rng(3)
    Cs = np.asarray(jfilt.rbf_cov(X, ls=0.15))
    if kind == "complex":
        Cs = Cs * np.asarray(jfilt.phasor_mat(X, 2.0))
    Cn = np.eye(N) * 0.1
    if kind == "cross":
        x2 = np.linspace(0.05, 0.95, 7)
        kw = dict(kw, Cs_cross=np.asarray(jfilt.rbf_cov(X, 0.15, x2=x2)),
                  Cs_pred=np.asarray(jfilt.rbf_cov(x2, 0.15)))
    jf = jfilt.GPFilter(jnp.asarray(Cs), jnp.asarray(Cn),
                        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in kw.items()})
    tf = tfilt.GPFilter(Cs, Cn, **kw, **T64)
    for key in ("C", "C_inv", "G", "V"):
        assert _relerr(getattr(tf, key).numpy(), getattr(jf, key)) <= 1e-9, \
            key
    _check_filter(jf, tf, _y(rng, (3, N)))
    # set_GV recomputes from a new noise covariance
    tf.setup_filter(Cn=np.eye(N))
    jf.setup_filter(Cn=jnp.eye(N))
    assert _relerr(tf.G.numpy(), jf.G) <= 1e-9


def test_gp_filter_keeps_the_float64_inverse():
    """G is float64 by default, and a float32 filter holds the float64
    inverse's G rounded once; float32 data through the default filter
    come out float32, the product taken in float64."""
    Cs = tfilt.sinc_cov(np.linspace(100e6, 200e6, 64), ls=1 / (2 * 2e-7),
                        device="cpu")
    f64 = tfilt.GPFilter(Cs, np.eye(64) * 1e-9, residual=True,
                         device="cpu")
    f32 = tfilt.GPFilter(Cs, np.eye(64) * 1e-9, residual=True,
                         device="cpu", dtype=torch.float32)
    assert f32.G.dtype == torch.float32 and f64.G.dtype == torch.float64
    assert torch.equal(f32.G, f64.G.float())
    y = torch.randn(3, 64, dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(0))
    out = f64(y)
    assert out.dtype == torch.complex64
    assert torch.equal(out, f64(y.to(torch.complex128)).to(torch.complex64))
    assert f32(y).dtype == torch.complex64
    assert f64(y.real).dtype == torch.float32


@pytest.mark.parametrize("kw", [dict(), dict(Ninv="diag"), dict(G=True),
                                dict(residual=False)])
def test_lstsq_filter_vs_jax(kw):
    rng = np.random.default_rng(4)
    A = np.array(bl.models.linear_model.gen_poly_A(X, 3, basis="legendre"))
    jkw, tkw = {}, {}
    if kw.get("Ninv"):
        Ninv = np.diag(rng.uniform(0.5, 2.0, N))
        jkw["Ninv"], tkw["Ninv"] = jnp.asarray(Ninv), Ninv
    if kw.get("G"):
        G = A @ np.linalg.pinv(A.T @ A) @ A.T
        jkw["G"], tkw["G"] = jnp.asarray(G), G
    else:
        jkw["A"], tkw["A"] = jnp.asarray(A), A
    if "residual" in kw:
        jkw["residual"] = tkw["residual"] = kw["residual"]
    jf = jfilt.LstSqFilter(**jkw)
    tf = tfilt.LstSqFilter(**tkw, **T64)
    _check_filter(jf, tf, _y(rng, (2, N)))


BLS = [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)]
GROUPS = {0: [(0, 1), (2, 3)], 1: [(0, 3), (1, 2)]}


def _wedge_pair(bls=None):
    filters = []
    for pkg in (jfilt, tfilt):
        kw = {} if pkg is jfilt else T64
        fs = [pkg.GPFilter(np.asarray(jfilt.sinc_cov(X, ls)), np.eye(N)
                           * 1e-3, residual=True, **kw) for ls in (0.5, 0.2)]
        filters.append(pkg.WedgeFilter(fs, GROUPS, bls=bls))
    return filters


def test_wedge_filter_on_visdata_vs_jax():
    """Two groups of two baselines, two baselines in none (they pass
    through); values and the gradient through the data."""
    rng = np.random.default_rng(5)
    jw, tw = _wedge_pair()
    y = _y(rng, (1, 1, len(BLS), 2, N))
    times = np.arange(2.0)
    jvd = bl.VisData()
    jvd.setup_data(BLS, times, X, pol="ee", data=jnp.asarray(y))
    want = jw(jvd).data

    def tf(d):
        tvd = bt.VisData()
        tvd.setup_data(BLS, times, X, pol="ee", data=d)
        out = tw(tvd)
        assert isinstance(out, bt.VisData) and out.data is not d
        return out.data

    def jf(d):
        v = jvd.copy()
        v.data = d
        return jw(v).data
    yt = torch.as_tensor(y)
    got = tf(yt)
    assert _relerr(got.numpy(), want) <= 1e-12
    rest = [BLS.index(b) for b in BLS if not any(
        b in g for g in GROUPS.values())]
    assert torch.equal(got[:, :, rest], yt[:, :, rest])
    _check_filter(jf, tf, y)


def test_wedge_filter_on_tensors_vs_jax():
    rng = np.random.default_rng(6)
    jw, tw = _wedge_pair(bls=BLS)
    _check_filter(jw, tw, _y(rng, (1, 1, len(BLS), 2, N)))


def test_wedge_filter_refuses_overlapping_groups():
    f = tfilt.MatFilter(G=np.eye(N), **T64)
    tw = tfilt.WedgeFilter([f, f], {0: [(0, 1)], 1: [(0, 1), (1, 2)]},
                           bls=BLS)
    with pytest.raises(ValueError, match="overlap"):
        tw(torch.zeros(1, 1, len(BLS), 1, N))


# ---------------------------------------------- tests/test_config5.py :78-89
def _config5_port(ntime=8, hexN=3, nfreq=16, nside=16):
    """tests/test_config5.py's _build() through the port."""
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
    T = bt.TelescopeModel((21.428305555, -30.72152777, 1073.0))
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, 120e6, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, **T64)
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    rng = np.random.default_rng(0)
    params = np.zeros((1, 1, 2, npix))
    params[0, 0, 0] = rng.uniform(1, 10, npix)
    params[0, 0, 1] = -2.5
    R = bt.PixelSkyResponse(freqs, spatial_mode="pixel",
                            freq_mode="powerlaw", f0=float(freqs[0]), **T64)
    sky = bt.PixelSky(params, angs, hp.nside2pixarea(nside), R=R, **T64)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, **T64)
    bls = arr.get_bls(keep_autos=False)[:24]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    return bt.RIME(sky, T, beam, arr, bls, times, freqs, time_mode="vmap"), \
        freqs


def test_config5_filter_step_vs_jax():
    """The config #5 pipeline's delay-filter step (tests/test_config5.py
    :78-89) on both sides: the simulated visibilities, the Wiener filter
    of smooth spectral structure, and its suppression."""
    from tests.test_config5 import _build
    jrime, _, _, _, _, freqs, _ = _build()
    jvd = jrime.forward()
    trime, tfreqs = _config5_port()
    with torch.no_grad():
        tvd = trime()
    assert _relerr(tvd.data.numpy(), jvd.data) <= 1e-9
    x = (freqs - freqs[0]) / (freqs[-1] - freqs[0])
    jf = jfilt.GPFilter(jfilt.sinc_cov(x, ls=0.5),
                        jnp.eye(len(freqs)) * 1e-2, dim=-1, residual=True)
    tf = tfilt.GPFilter(tfilt.sinc_cov(x, ls=0.5, device="cpu"),
                        np.eye(len(freqs)) * 1e-2, dim=-1, residual=True,
                        **T64)
    jout, tout = jf.forward(jvd), tf.forward(tvd)
    assert tout.data.shape == tvd.data.shape
    assert _relerr(tout.data.numpy(), jout.data) <= 1e-9
    p_in = float(torch.sum(torch.abs(tvd.data) ** 2))
    p_out = float(torch.sum(torch.abs(tout.data) ** 2))
    assert p_out < 0.5 * p_in


# ------------------------------------------------ the hera-filt chain, hex-3
FILT_SMALL = dict(hexN=3, nside=8, nfreq=64, fmax=200e6, ntime=2,
                  pix_chunk=512)


def _filt_chain_jax(tp, info, target):
    """chip_smoke.build_filt's chain through the JAX package: the same
    array, sky, beam, times, linear-mode gains, filter bins and target,
    at the port's params."""
    from bayeslim_tpu.models.calibration import JonesModel, JonesResponse
    from bayeslim_tpu.models.linear_model import LinearModel
    from bayeslim_tpu.models.sky import PixelSky, PixelSkyResponse
    from bayeslim_tpu.utils import AntposDict as JAntposDict
    from bayeslim_tpu.utils import Sequential, make_hex as jmake_hex
    from bayeslim_tpu.utils import healpix as jhp
    k = FILT_SMALL
    seq = tp.model
    ants, antvecs = jmake_hex(k["hexN"], D=15.0)
    freqs = np.linspace(100e6, k["fmax"], k["nfreq"])
    T = bl.TelescopeModel((21.428305555, -30.72152777, 1073.0))
    arr = bl.ArrayModel(JAntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=True)
    npix = jhp.nside2npix(k["nside"])
    theta, phi = jhp.pix2ang(k["nside"], np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    R = PixelSkyResponse(freqs, spatial_mode="pixel", freq_mode="powerlaw",
                         f0=float(freqs[0]))
    sky = PixelSky(jnp.asarray(seq.rime.sky.params.detach().numpy()), angs,
                   jhp.nside2pixarea(k["nside"]), R=R, parameter=False)
    beam = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bl.beam_model.AiryResponse(), pol="e",
                        powerbeam=True, fov=180.0, parameter=False)
    rime = bl.RIME(sky, T, beam, arr, seq.rime.sim_bls, np.asarray(
        seq.rime.sim_times), freqs, data_bls=seq.rime.data_bls,
        pix_chunk=k["pix_chunk"])
    LM = LinearModel("poly", dim=4, x=freqs, Ndeg=seq.cal.params.shape[4],
                     basis="legendre", whiten=True)
    cal = JonesModel(jnp.asarray(seq.cal.params.detach().numpy()),
                     seq.cal.ants, refant=seq.cal.ants[0],
                     R=JonesResponse(param_type="com", freq_mode="linear",
                                     freq_LM=LM, freqs=freqs))
    Cn = jnp.eye(len(freqs)) * 1e-9
    filters = [jfilt.GPFilter(jfilt.sinc_cov(freqs, ls=1 / (2 * tau)), Cn,
                              dim=-1, residual=True)
               for tau in info["bins"]["tau"]]
    wedge = jfilt.WedgeFilter(filters, seq.filt.filt2bls)
    jseq = Sequential({"rime": rime, "cal": cal, "filt": wedge})
    tgt = bl.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(seq.rime.data_bls, np.asarray(seq.rime.sim_times), freqs,
                   pol="ee", data=jnp.asarray(target),
                   icov=jnp.ones(np.shape(target)))
    return bl.inference.LogProb(jseq, tgt)


def test_hera_filt_chain_matches_jax():
    """The slice as a whole: chip_smoke.build_filt at hex-3 (64 channels
    over 100-200 MHz, 16 Legendre coefficients a gain, 8 length bins)
    against the same chain in the JAX package: the loss and the antenna
    and gain gradients at the start and at a point between it and the
    truth; the truth sits lower than the start."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import build_filt
    tp, truth, info = build_filt(bt, device="cpu", dtype=torch.float64,
                                 **FILT_SMALL)
    assert len(info["bins"]["tau"]) > 2
    assert sum(info["bins"]["counts"]) == len(tp.model.rime.data_bls)
    jp = _filt_chain_jax(tp, info, tp.target[0].data.numpy())
    keys = ["models.cal.params", "models.rime.array.antvecs"]
    start = {k: dict(tp.model.named_parameters())[k].detach().numpy().copy()
             for k in keys}
    mid = {k: 0.5 * (start[k] + truth[k]) for k in keys}
    losses = []
    for point in (start, mid):
        bt.load_numpy_pdict(tp.model, point)
        jp.update(bl.ParamDict({k: jnp.asarray(v)
                                for k, v in point.items()}))
        tv, tg = tp.value_and_grad()
        jv, jg = jp.value_and_grad()
        losses.append(float(tv))
        assert abs(float(tv) - float(jv)) <= 1e-9 * abs(float(jv))
        assert set(tg.keys()) == set(keys)
        for k in keys:
            assert _relerr(tg[k].numpy(), jg[k]) <= 1e-9, k
    bt.load_numpy_pdict(tp.model, truth)
    assert float(tp.value_and_grad()[0]) < losses[1] < losses[0]


@pytest.mark.parametrize("suppression,tol", [(1e9, 0.1), (1e4, 1e-2)])
def test_hera_filt_float32_gradient_vs_float64(suppression, tol):
    """ROADMAP C10 on the CPU: chip_smoke.build_filt's chain at hex-2 (64
    channels, the filter's Cn = I / suppression) in float32 through the
    kernels' plain versions (use_kernel=True, the card's arithmetic)
    against the same chain in float64, at the same start and target,
    each gradient leaf's error as a share of its max. At 1e4, the
    suppression of chip_smoke.py phase 17's L-BFGS, within that phase's
    bar C10_ERR (1e-2; 1.3e-4 measured here). At config #5's own 1e9 no
    stage moved to float64 reaches that bar (scripts/c10_stages.py: on
    the card the antennas err by 0.22-0.39 with every stage), so none is
    kept and the tolerance is what float32 gives as built: 0.1, five
    times the 2.1e-2 measured here for the antennas (the gains 7.7e-4)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import build_filt
    size = dict(hexN=2, nside=8, nfreq=64, fmax=200e6, ntime=2,
                pix_chunk=512, noise=1.0 / suppression)
    p64, _, _ = build_filt(bt, device="cpu", dtype=torch.float64, **size)
    p32, _, _ = build_filt(bt, device="cpu", dtype=torch.float32, **size)
    p32.model.rime.use_kernel = True
    p32.target[0].data = p64.target[0].data.to(torch.complex64)
    g64, g32 = p64.value_and_grad()[1], p32.value_and_grad()[1]
    assert set(g32.keys()) == {"models.cal.params",
                               "models.rime.array.antvecs"}
    for k in g64:
        assert g32[k].dtype == torch.float32
        assert _relerr(g32[k].double().numpy(), g64[k].numpy()) <= tol, k
