"""The port's HEALPix ring math and pixel interpolation
(utils/healpix.py, utils/interp.py) against the JAX package, at float64:
the host weights bit for bit, the device gather to 1e-9 relative, for
real and complex maps, healpix and rect grids, degrees 0-3 and the phi
wrap."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.utils import healpix as jhp
from bayeslim_tpu.utils import interp as jinterp
from bayeslim_tpu_torch.utils import healpix as thp
from bayeslim_tpu_torch.utils import interp as tinterp


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _angles(seed, n=300):
    """Colatitudes over the whole sphere, both poles and the caps'
    edges included, and longitudes past 2 pi and below 0."""
    rng = np.random.default_rng(seed)
    theta = np.concatenate([rng.uniform(0, np.pi, n), [0.0, np.pi, 1e-3,
                                                        np.pi - 1e-3,
                                                        np.arccos(2 / 3)]])
    phi = rng.uniform(-np.pi, 3 * np.pi, len(theta))
    return theta, phi


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 32])
def test_healpix_ring_math_matches_jax(nside):
    theta, phi = _angles(nside)
    for t, j in zip(thp.ring_info(nside), jhp.ring_info(nside)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(thp.ang2pix(nside, theta, phi),
                                  jhp.ang2pix(nside, theta, phi))
    pix = np.arange(thp.nside2npix(nside))
    np.testing.assert_array_equal(thp.pix2vec(nside, pix),
                                  jhp.pix2vec(nside, pix))
    tp, tw = thp.get_interp_weights(nside, theta, phi)
    jp, jw = jhp.get_interp_weights(nside, theta, phi)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(tw.sum(0), 1.0, rtol=1e-12)
    assert thp.npix2nside(12 * nside ** 2) == nside
    assert thp.nside2resol(nside) == jhp.nside2resol(nside)


def _rect_grid():
    theta_grid = np.linspace(0.5, 89.5, 90)        # zenith angle [deg]
    phi_grid = np.linspace(0, 358, 180)            # azimuth [deg]
    return theta_grid, phi_grid


@pytest.mark.parametrize("pixtype,mode", [
    ("healpix", "linear"), ("rect", "nearest"), ("rect", "linear"),
    ("rect", "quadratic"), ("rect", "cubic"), ("rect", "cubic,linear"),
    ("rect", "nearest,quadratic")])
@pytest.mark.parametrize("complex_map", [False, True])
def test_pixinterp_matches_jax(pixtype, mode, complex_map):
    rng = np.random.default_rng(3)
    theta_grid, phi_grid = _rect_grid()
    kw = dict(nside=16) if pixtype == "healpix" else \
        dict(theta_grid=theta_grid, phi_grid=phi_grid)
    npix = thp.nside2npix(16) if pixtype == "healpix" \
        else len(theta_grid) * len(phi_grid)
    # azimuths across the wrap (past 358 deg and below 0)
    zen = rng.uniform(0.5, 89.5, 400)
    az = np.concatenate([rng.uniform(-10, 370, 396), [358.5, 359.9, 0.0,
                                                      -0.7]])
    m = rng.standard_normal((2, 3, npix))
    if complex_map:
        m = m + 1j * rng.standard_normal(m.shape)
    ti = tinterp.PixInterp(pixtype, interp_mode=mode, **kw)
    ji = jinterp.PixInterp(pixtype, interp_mode=mode, **kw)
    tinds, twgts = ti.precompute(zen, az)
    jinds, jwgts = ji.precompute(zen, az)
    np.testing.assert_array_equal(tinds, jinds)
    np.testing.assert_array_equal(twgts, jwgts)
    assert tinds.shape[1] == ti.nnearest == ji.nnearest
    jout = np.asarray(ji.interp(jnp.asarray(m), inds=jinds, wgts=jwgts))
    tout = ti.interp(torch.as_tensor(m), inds=torch.as_tensor(tinds),
                     wgts=torch.as_tensor(twgts))
    assert tout.shape == (2, 3, len(zen))
    assert _relerr(tout.numpy(), jout) <= 1e-9
    # on the fly from angles, and through the angle-keyed cache
    assert _relerr(ti.interp(torch.as_tensor(m), zen=zen, az=az).numpy(),
                   jout) <= 1e-9
    assert ti.get_interp(zen, az) is ti.get_interp(zen, az)
    ti.clear_cache()
    assert ti.interp_cache == {}


def test_bipoly_weights_reproduce_polynomials():
    """Degree-d weights reproduce a degree-d polynomial in each axis
    exactly (away from the clipped edge), as the JAX ones do."""
    xg, yg = np.arange(40.0), np.arange(30.0)
    rng = np.random.default_rng(5)
    xn, yn = rng.uniform(3, 36, 50), rng.uniform(3, 26, 50)
    X, Y = np.meshgrid(xg, yg)
    for deg in range(4):
        f = (1 + X) ** deg * (2 - 0.1 * Y) ** deg
        inds, wgts = tinterp.bipoly_interp_weights(xg, yg, xn, yn, deg, deg,
                                                   wrapx=False)
        jinds, jwgts = jinterp.bipoly_interp_weights(xg, yg, xn, yn, deg,
                                                     deg, wrapx=False)
        np.testing.assert_array_equal(inds, jinds)
        np.testing.assert_array_equal(wgts, jwgts)
        if deg:
            got = tinterp.interp_gather(torch.as_tensor(f.ravel()), inds,
                                        wgts).numpy()
            want = (1 + xn) ** deg * (2 - 0.1 * yn) ** deg
            assert _relerr(got, want) <= 1e-9


def test_interp_gather_grad_matches_jax():
    """The gather-sum's gradient in the map, real and complex."""
    import jax
    rng = np.random.default_rng(7)
    m = rng.standard_normal((2, 50)) + 1j * rng.standard_normal((2, 50))
    inds = rng.integers(0, 50, (20, 4))
    wgts = rng.uniform(0, 1, (20, 4))
    d = rng.standard_normal((2, 20))
    jg = jax.grad(lambda x: jnp.sum(jnp.abs(jinterp.interp_gather(
        x, inds, wgts) - d) ** 2))(jnp.asarray(m))
    t = torch.as_tensor(m).requires_grad_(True)
    loss = torch.sum(torch.abs(tinterp.interp_gather(t, inds, wgts)
                               - torch.as_tensor(d)) ** 2)
    (tg,) = torch.autograd.grad(loss, t)
    # PyTorch's gradient in a complex input is the conjugate of JAX's
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= 1e-9
