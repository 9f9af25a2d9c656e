"""The port's delay FFT against the JAX package: gen_window for every
named window and edgecut, FFT both ways under each option (on tensors
and on a VisData; values and gradients), PeakDelay's Quinn estimate,
and vis_wedge's refusal. Inputs come from numpy seeds; everything
compares at float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import fft as jfft
from bayeslim_tpu_torch.models import fft as tfft

T64 = dict(device="cpu", dtype=torch.float64)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("window,kw", [
    ("none", {}), (None, {}), ("boxcar", {}), ("tophat", {}),
    ("blackmanharris", {}), ("bh", {}), ("bh4", {}),
    ("blackman-harris", {}), ("hann", {}), ("hanning", {}),
    ("tukey", dict(alpha=0.3)), ("gaussian", dict(alpha=4.0)),
    ("bh7", {}), ("blackmanharris-7term", {}), ("cs9", {}),
    ("cosinesum-9term", {}), ("cs11", {}), ("cosinesum-11term", {}),
    ("hamming", {}), ("bh", dict(edgecut=(3, 5))),
    ("tukey", dict(alpha=0.5, edgecut=(2, 0)))])
def test_gen_window_vs_jax(window, kw):
    want = jfft.gen_window(window, 40, **kw)
    got = tfft.gen_window(window, 40, **kw, **T64)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _relerr(got.numpy(), want) <= 1e-14
    if "edgecut" in kw:
        lo, hi = kw["edgecut"]
        assert not got[:lo].any() and not got[len(got) - hi:].any()


def test_gen_window_unknown_raises():
    for mod, kw in ((jfft, {}), (tfft, T64)):
        with pytest.raises(ValueError, match="unrecognized window"):
            mod.gen_window("no-such-window", 8, **kw)


# (FFT kwargs, forward kwargs)
FFTS = [
    (dict(dim=-1, N=16, dx=1e5), {}),
    (dict(dim=-1, N=16, dx=1e5, ndim=3, window="bh"), {}),
    (dict(dim=1, N=16, dx=1e5, ndim=3, window="tukey", alpha=0.2,
          edgecut=2, norm="ortho"), {}),
    (dict(dim=-1, N=16, fftshift=False, abs=True, peaknorm=True), {}),
    (dict(dim=-1, N=16, square=True, norm="forward"), {}),
    (dict(dim=-1, N=16, dx=1e5, ndim=3, window="hann", ifft=True), {}),
    (dict(dim=-1, N=16, dx=1e5), dict(ifft=True)),
    (dict(dim=-1, N=16, ifft=True, fftshift=False), dict(ifft=False)),
]


def _x(rng, shape, dim):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return np.moveaxis(x, -1, dim) if dim != -1 else x


@pytest.mark.parametrize("kw,fkw", FFTS)
def test_fft_vs_jax(kw, fkw):
    """Values and the gradient of a real loss of the output (torch's is
    the conjugate of JAX's for a complex input)."""
    rng = np.random.default_rng(0)
    x = _x(rng, (2, 3, 16), kw["dim"])
    jf, tf = jfft.FFT(**kw), tfft.FFT(**kw, **T64)
    if tf.freqs is not None:
        np.testing.assert_array_equal(tf.freqs, jf.freqs)
        assert tf.start == jf.start and tf.df == jf.df
    want = jf(jnp.asarray(x), **fkw)
    xt = torch.as_tensor(x).requires_grad_(True)
    got = tf(xt, **fkw)
    assert got.dtype == (torch.float64 if np.isrealobj(want)
                         else torch.complex128)
    assert _relerr(got.detach().numpy(), want) <= 1e-12
    w = rng.standard_normal(want.shape)

    def jloss(v):
        out = jf(v, **fkw)
        return jnp.sum(jnp.real(out) * w) + jnp.sum(jnp.imag(out) * w)
    jg = jax.grad(jloss)(jnp.asarray(x))
    wt = torch.as_tensor(w)
    loss = torch.sum(got.real * wt) + (torch.sum(got.imag * wt)
                                       if got.is_complex() else 0.0)
    (tg,) = torch.autograd.grad(loss, xt)
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= 1e-12


def test_fft_window_tensor_and_visdata_vs_jax():
    """A window given as an array, and a VisData in (a VisData out, its
    data transformed along the channels)."""
    rng = np.random.default_rng(1)
    bls = [(0, 1), (0, 2), (1, 2)]
    times = 2458168.3 + np.arange(2) * 5e-4
    freqs = np.linspace(100e6, 120e6, 16)
    x = rng.standard_normal((1, 1, 3, 2, 16)) \
        + 1j * rng.standard_normal((1, 1, 3, 2, 16))
    win = np.hanning(16)
    jf = jfft.FFT(dim=4, N=16, dx=freqs[1] - freqs[0], window=win)
    tf = tfft.FFT(dim=4, N=16, dx=freqs[1] - freqs[0], window=win, **T64)
    jvd, tvd = bl.VisData(), bt.VisData()
    jvd.setup_data(bls, times, freqs, pol="ee", data=jnp.asarray(x))
    tvd.setup_data(bls, times, freqs, pol="ee", data=torch.as_tensor(x))
    want, got = jf(jvd), tf(tvd)
    assert isinstance(got, bt.VisData) and got is not tvd
    assert _relerr(got.data.numpy(), want.data) <= 1e-12
    assert torch.equal(tvd.data, torch.as_tensor(x))


@pytest.mark.parametrize("kw", [dict(), dict(window="bh", ndim=3),
                                dict(abs=True), dict(fftshift=False)])
def test_peak_delay_vs_jax(kw):
    """Quinn's estimate of each spectrum's peak delay: tones between
    bins plus noise; values and the gradient of their sum."""
    rng = np.random.default_rng(2)
    nf, df = 64, 1e5
    f = np.arange(nf) * df
    tau = rng.uniform(-2e-6, 2e-6, (2, 5))
    x = np.exp(2j * np.pi * f * tau[..., None]) \
        + 0.05 * (rng.standard_normal((2, 5, nf))
                  + 1j * rng.standard_normal((2, 5, nf)))
    jp = jfft.PeakDelay(dim=-1, N=nf, dx=df, **kw)
    tp = tfft.PeakDelay(dim=-1, N=nf, dx=df, **kw, **T64)
    want = jp(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = tp(xt)
    assert got.shape == want.shape
    assert _relerr(got.detach().numpy(), want) <= 1e-9
    if not kw.get("fftshift", True):
        return
    if not kw:
        # on the bare complex spectra (what Quinn's estimator assumes)
        # it recovers the tones' delays to a fraction of a bin
        assert np.abs(got.detach().numpy() - tau).max() < 0.2 / (nf * df)
    jg = jax.grad(lambda v: jnp.sum(jp(v)))(jnp.asarray(x))
    (tg,) = torch.autograd.grad(got.sum(), xt)
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= 1e-9
    # on a container, the container's data holds the peaks
    vd = bt.VisData()
    vd.setup_data([(0, 1)], np.zeros(2), f, pol="ee",
                  data=torch.as_tensor(x))
    assert torch.equal(tp(vd).data, got.detach())


def test_vis_wedge_names_what_it_waits_for():
    """vis_wedge, once waiting on VisData.bl_average, averages over the
    redundant groups of the data's antpos and delay-transforms them as
    the JAX one does."""
    rng = np.random.default_rng(3)
    ants, antvecs = bt.utils.make_hex(2, D=15.0)
    bls = [(a, b) for i, a in enumerate(ants) for b in ants[i + 1:]]
    f = np.linspace(100e6, 120e6, 16)
    shape = (1, 1, len(bls), 2, len(f))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    out = []
    for pkg, conv in ((bl, jnp.asarray), (bt, torch.as_tensor)):
        vd = pkg.VisData()
        vd.setup_meta(antpos=pkg.utils.AntposDict(ants, antvecs))
        vd.setup_data(bls, np.arange(2.0), f, pol="ee", data=conv(x))
        mod = jfft if pkg is bl else tfft
        out.append(mod.vis_wedge(vd, window="bh"))
    (jw, jft), (tw, tft) = out
    assert tw.Nbls == jw.Nbls < len(bls)
    np.testing.assert_array_equal(tw.blnums, jw.blnums)
    assert _relerr(tw.data.numpy(), jw.data) <= 1e-9
    np.testing.assert_allclose(tft.freqs, jft.freqs, rtol=1e-12)
