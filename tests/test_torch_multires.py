"""The port's multi-resolution HEALPix (utils/multires.py, over the
port's utils/healpix.py) against the JAX package's on the CPU: every
function, held exactly equal (host numpy on both sides)."""
import numpy as np
import pytest

from bayeslim_tpu.utils import healpix as jhp
from bayeslim_tpu.utils import multires as jmr
from bayeslim_tpu_torch.utils import healpix as thp
from bayeslim_tpu_torch.utils import multires as tmr


@pytest.mark.parametrize("nside", [1, 2, 8, 16])
def test_nest_ring_match_jax(nside):
    p = np.arange(12 * nside * nside)
    np.testing.assert_array_equal(tmr.nest2ring(nside, p),
                                  jmr.nest2ring(nside, p))
    np.testing.assert_array_equal(tmr.ring2nest(nside, p[::3]),
                                  jmr.ring2nest(nside, p[::3]))
    np.testing.assert_array_equal(tmr.ring2nest_sorted(nside),
                                  jmr.ring2nest_sorted(nside))
    t, ph = tmr._nest_pix2ang(nside, p)
    jt, jph = jmr._nest_pix2ang(nside, p)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(ph, jph)


def _map(nside=16, seed=0):
    npix = thp.nside2npix(nside)
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.5, 1.5, npix)
    th, ph = thp.pix2ang(nside, np.arange(npix))
    m[(np.abs(th - 1.0) < 0.3) & (np.abs(ph - 1.0) < 0.3)] *= 100.0
    return m


def _grid_equal(a, b):
    np.testing.assert_array_equal(a.nsides, b.nsides)
    np.testing.assert_array_equal(a.ipix, b.ipix)
    assert a.npix == b.npix and a.max_nside == b.max_nside
    np.testing.assert_array_equal(a.pixareas(), b.pixareas())
    np.testing.assert_array_equal(a.pix_rangesets(), b.pix_rangesets())
    np.testing.assert_array_equal(a.pix_rangesets(64), b.pix_rangesets(64))
    for x, y in zip(a.pix2ang(), b.pix2ang()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("nest", [False, True])
@pytest.mark.parametrize("base_nside", [1, 2])
def test_adaptive_mesh_and_multires_map_match_jax(nest, base_nside):
    m = _map()
    if nest:
        m = m[tmr.ring2nest_sorted(16)]
    got = tmr.adaptive_healpix_mesh(m, base_nside=base_nside, nest=nest)
    want = jmr.adaptive_healpix_mesh(m, base_nside=base_nside, nest=nest)
    _grid_equal(got[0], want[0])
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(x, y)
    w = np.random.default_rng(3).uniform(0.1, 1.0, m.shape)
    for weights in (None, w):
        np.testing.assert_array_equal(
            tmr.multires_map(np.stack([m, 2 * m]), got[0], weights=weights,
                             nest=nest),
            jmr.multires_map(np.stack([m, 2 * m]), want[0], weights=weights,
                             nest=nest))


def test_adaptive_mesh_custom_split_matches_jax():
    m = _map(seed=1)

    def split(vals):
        return np.std(vals) > 0.3
    got = tmr.adaptive_healpix_mesh(m, split_fun=split, base_nside=2)
    want = jmr.adaptive_healpix_mesh(m, split_fun=split, base_nside=2)
    _grid_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("kw", [
    dict(), dict(min_nside=4, max_nside=16),
    dict(ra_min_max=(60.0, 300.0), zen_sigma=3, ra_gamma=10)])
def test_nside_binning_matches_jax(kw):
    zen = np.linspace(0, 90, 192)
    ra = np.linspace(0, 360, 192)
    for x, y in zip(tmr.nside_binning(zen, ra, **kw),
                    jmr.nside_binning(zen, ra, **kw)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(target_nsides=np.full(48, 8)),
    dict(target_nsides=np.random.default_rng(0).choice([2, 4, 8], 48)),
    dict(sigma=0.2, bsky=_map(nside=8)),
    dict(sigma=0.2, bsky=_map(nside=8), target_nsides=np.full(48, 4))])
def test_dynamic_pixelization_matches_jax(kw):
    got = tmr.dynamic_pixelization(2, 8, **kw)
    want = jmr.dynamic_pixelization(2, 8, **kw)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    _grid_equal(got[2], want[2])


@pytest.mark.parametrize("cut", [
    dict(), dict(phi_min=0.5, phi_max=4.0),
    dict(theta_min=0.3, theta_max=2.5)])
def test_split_healpix_grid_matches_jax(cut):
    nside = 8
    th, ph = jhp.pix2ang(nside, np.arange(jhp.nside2npix(nside)))
    for x, y in zip(tmr.split_healpix_grid(th, ph, nside, **cut),
                    jmr.split_healpix_grid(th, ph, nside, **cut)):
        np.testing.assert_array_equal(x, y)
