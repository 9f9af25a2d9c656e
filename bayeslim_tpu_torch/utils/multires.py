"""
Multi-resolution (adaptive) HEALPix pixelization.

Counterpart of bayeslim_tpu/utils/multires.py (nest2ring :55, ring2nest
:82, MultiresGrid :97, adaptive_healpix_mesh :133, ring2nest_sorted
:177, multires_map :182, nside_binning :200, dynamic_pixelization :228,
split_healpix_grid :272), kept as its own copy over the port's
utils/healpix.py: host numpy only, no device code.

A multi-resolution pixelization is a `MultiresGrid`: per-pixel (nside,
NESTED index) pairs built by recursive subdivision from a base nside,
with the child pixel spans at a common higher nside (range sets) used to
area-average single-resolution maps onto the grid. The NESTED index
math is done here by bit interleaving (healpy and mhealpy are not
needed).
"""
from __future__ import annotations

import numpy as np
from scipy.special import voigt_profile

from . import healpix as hp

__all__ = [
    "nest2ring", "ring2nest", "MultiresGrid", "adaptive_healpix_mesh",
    "multires_map", "nside_binning", "dynamic_pixelization",
    "split_healpix_grid",
]

# face rows for xyf->ring conversion (HEALPix primer)
_JRLL = np.asarray([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.asarray([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _compress_bits(v):
    """Keep even-position bits of v, compressed (de-interleave)."""
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def _spread_bits(v):
    """Inverse of _compress_bits: spread bits to even positions."""
    v = v & 0x00000000FFFFFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def nest2ring(nside, p):
    """NESTED -> RING pixel index, vectorized (healpy.nest2ring equiv)."""
    n = int(nside)
    p = np.asarray(p, dtype=np.int64)
    npface = n * n
    face = p // npface
    pf = p % npface
    ix = _compress_bits(pf)
    iy = _compress_bits(pf >> 1)

    jr = _JRLL[face] * n - ix - iy - 1  # ring number 1..4n-1
    npix = 12 * n * n
    ncap = 2 * n * (n - 1)

    nr = np.where(jr < n, jr, np.where(jr > 3 * n, 4 * n - jr, n))
    n_before = np.where(
        jr < n, 2 * nr * (nr - 1),
        np.where(jr > 3 * n, npix - 2 * nr * (nr + 1),
                 ncap + (jr - n) * 4 * n))
    kshift = np.where((jr >= n) & (jr <= 3 * n), (jr - n) & 1, 0)

    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def ring2nest(nside, p):
    """RING -> NESTED pixel index (inverse permutation)."""
    n = int(nside)
    allnest = np.arange(12 * n * n, dtype=np.int64)
    ring_of = nest2ring(n, allnest)
    inv = np.empty_like(allnest)
    inv[ring_of] = allnest
    return inv[np.asarray(p, dtype=np.int64)]


def _nest_pix2ang(nside, p):
    """theta, phi of NESTED pixels."""
    return hp.pix2ang(nside, nest2ring(nside, p))


class MultiresGrid:
    """Multi-resolution healpix pixelization: per-pixel (nside, nested
    index) with child range-sets for downsampling."""

    def __init__(self, nsides, ipix_nest):
        self.nsides = np.asarray(nsides, dtype=np.int64)
        self.ipix = np.asarray(ipix_nest, dtype=np.int64)
        self.max_nside = int(self.nsides.max())

    @property
    def npix(self):
        return len(self.ipix)

    def pix2ang(self):
        """(theta, phi) [rad] of every multi-res pixel."""
        theta = np.empty(self.npix)
        phi = np.empty(self.npix)
        for ns in np.unique(self.nsides):
            m = self.nsides == ns
            t, ph = _nest_pix2ang(int(ns), self.ipix[m])
            theta[m], phi[m] = t, ph
        return theta, phi

    def pixareas(self):
        """Solid angle [sr] of each pixel."""
        return 4 * np.pi / (12 * self.nsides.astype(float) ** 2)

    def pix_rangesets(self, nside=None):
        """(start, stop) child-pixel spans at `nside` (default max) in
        NESTED ordering, one per multi-res pixel."""
        nside = nside or self.max_nside
        fac = (nside // self.nsides) ** 2
        start = self.ipix * fac
        return np.stack([start, start + fac], axis=1)


def adaptive_healpix_mesh(hp_map, split_fun=None, base_nside=1,
                          nest=False):
    """Convert a single-resolution healpix map (RING unless nest=True) to
    a multi-resolution grid by recursive splitting.

    split_fun(child_values) -> bool decides whether a pixel splits;
    default splits while any child exceeds the map mean.

    Returns (grid MultiresGrid, theta, phi [rad], values) where values
    are the mean map value per multi-res pixel.
    """
    hp_map = np.asarray(hp_map)
    npix = hp_map.shape[-1]
    nside = hp.npix2nside(npix)
    nest_map = hp_map if nest else hp_map[..., ring2nest_sorted(nside)]

    if split_fun is None:
        thresh = np.mean(np.abs(nest_map))

        def split_fun(vals):
            return np.max(np.abs(vals)) > thresh

    nsides, ipix, values = [], [], []

    def recurse(ns, ip):
        fac = (nside // ns) ** 2
        vals = nest_map[..., ip * fac:(ip + 1) * fac]
        if ns < nside and split_fun(vals):
            for c in range(4):
                recurse(ns * 2, ip * 4 + c)
        else:
            nsides.append(ns)
            ipix.append(ip)
            values.append(np.mean(vals, axis=-1))

    for ip in range(12 * base_nside ** 2):
        recurse(base_nside, ip)

    grid = MultiresGrid(nsides, ipix)
    theta, phi = grid.pix2ang()
    return grid, theta, phi, np.stack(values, axis=-1)


def ring2nest_sorted(nside):
    """Index array converting a RING-ordered map to NESTED ordering."""
    return nest2ring(nside, np.arange(12 * nside * nside))


def multires_map(hp_map, grid, weights=None, nest=False):
    """Average a single-res healpix map onto a MultiresGrid; hp_map's
    last axis is the sky pixels."""
    hp_map = np.asarray(hp_map)
    nside = hp.npix2nside(hp_map.shape[-1])
    if not nest:
        hp_map = hp_map[..., ring2nest_sorted(nside)]
        if weights is not None:
            weights = np.asarray(weights)[..., ring2nest_sorted(nside)]
    out = np.zeros(hp_map.shape[:-1] + (grid.npix,), dtype=hp_map.dtype)
    for i, (start, stop) in enumerate(grid.pix_rangesets(nside)):
        w = np.ones(stop - start) if weights is None \
            else weights[..., start:stop]
        out[..., i] = np.sum(hp_map[..., start:stop] * w, axis=-1) / \
            np.clip(np.sum(w, axis=-1), 1e-40, None)
    return out


def nside_binning(zen, ra, zen_sigma=5, zen_gamma=15, ra_sigma=5,
                  ra_gamma=15, ra_min_max=None, min_nside=32,
                  max_nside=256):
    """Voigt-profile nside resolution curve over the sky."""
    zen = np.asarray(zen, dtype=np.float64)
    ra = np.asarray(ra, dtype=np.float64)
    curve = voigt_profile(zen, zen_sigma, zen_gamma)
    curve = curve - curve.min()
    curve = curve / curve.max()
    if ra_min_max is not None:
        lo = ra < ra_min_max[0]
        if lo.any():
            c = voigt_profile(ra[lo] - ra_min_max[0], ra_sigma, ra_gamma)
            c = (c - c.min())
            curve[lo] *= c / c.max() if c.max() > 0 else c
        hi = ra > ra_min_max[1]
        if hi.any():
            c = voigt_profile(ra[hi] - ra_min_max[1], ra_sigma, ra_gamma)
            c = (c - c.min())
            curve[hi] *= c / c.max() if c.max() > 0 else c
    curve = curve * (max_nside - min_nside) + min_nside
    bins = 2 ** np.arange(int(np.log2(min_nside)),
                          int(np.log2(max_nside)) + 1)
    inds = np.argmin(np.abs(bins[None, :] - curve[:, None]), axis=1)
    return curve, bins[inds]


def dynamic_pixelization(base_nside, max_nside, sigma=None, bsky=None,
                         target_nsides=None):
    """Dynamic pixelization: split pixels
    where (1) the beam-weighted-sky std exceeds sigma, or (2) a manual
    per-base-pixel target nside demands it.

    Returns (theta, phi [rad], grid MultiresGrid, total_nsides at
    max_nside resolution)."""
    if bsky is not None:
        bn = hp.npix2nside(len(bsky))
        bsky_nest = np.asarray(bsky)[ring2nest_sorted(bn)]
    nsides, ipix = [], []

    def recurse(ns, ip, target):
        split = False
        if ns < max_nside:
            if target is not None and ns < target:
                split = True
            if sigma is not None and bsky is not None:
                fac = (bn // ns) ** 2
                vals = bsky_nest[ip * fac:(ip + 1) * fac]
                if np.std(vals) > sigma:
                    split = True
        if split:
            for c in range(4):
                recurse(ns * 2, ip * 4 + c, target)
        else:
            nsides.append(ns)
            ipix.append(ip)

    for i in range(12 * base_nside ** 2):
        target = target_nsides[i] if target_nsides is not None else None
        recurse(base_nside, i, target)

    grid = MultiresGrid(nsides, ipix)
    theta, phi = grid.pix2ang()
    # per-max_nside-pixel nside map (for plotting)
    total = np.zeros(12 * max_nside ** 2, dtype=np.int32)
    for (start, stop), ns in zip(grid.pix_rangesets(max_nside),
                                 grid.nsides):
        total[start:stop] = ns
    return theta, phi, grid, total


def split_healpix_grid(theta, phi, nside, phi_min=None, phi_max=None,
                       theta_min=None, theta_max=None):
    """Split a healpix map into south cap / two interleaved central
    grids / north cap index sets."""
    magic_dec = 41.84 * np.pi / 180
    theta = np.asarray(theta)
    phi = np.asarray(phi)
    dec = np.pi / 2 - theta
    idx = np.arange(len(theta))

    def select(th, ph):
        f = np.ones(len(th), dtype=bool)
        if phi_min:
            f &= ph >= phi_min
        if phi_max:
            f &= ph <= phi_max
        if theta_min:
            f &= th >= theta_min
        if theta_max:
            f &= th <= theta_max
        return f

    f = select(theta, phi)
    southern = np.where((dec < -magic_dec) & f)[0]
    northern = np.where((dec > magic_dec) & f)[0]
    s = (dec > -magic_dec) & (dec < magic_dec)
    th = theta[s].reshape(-1, nside * 4)
    ph = phi[s].reshape(-1, nside * 4)
    ii = idx[s].reshape(-1, nside * 4)
    c1 = ii[::2].ravel()[select(th[::2].ravel(), ph[::2].ravel())]
    c2 = ii[1::2].ravel()[select(th[1::2].ravel(), ph[1::2].ravel())]
    return southern, c1, c2, northern
