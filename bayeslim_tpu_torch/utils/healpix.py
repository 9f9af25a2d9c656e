"""
HEALPix ring-scheme pixel geometry (host numpy).

Counterpart of bayeslim_tpu/utils/healpix.py (:24-247): the port keeps
its own copy of the ring math (Gorski et al. 2005, ApJ 622, 759),
including the bilinear interpolation weights of the published HEALPix
`get_interpol` that the pixelized beam (utils/interp.py) needs. theta
is colatitude in [0, pi], phi longitude in [0, 2 pi), both radians;
pixel indices are RING ordered.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "nside2npix", "npix2nside", "nside2pixarea", "nside2resol",
    "pix2ang", "ang2pix", "pix2vec", "ring_info", "get_interp_weights",
]


def nside2npix(nside):
    return 12 * int(nside) ** 2


def npix2nside(npix):
    nside = int(round(np.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid healpix npix")
    return nside


def nside2pixarea(nside, degrees=False):
    area = 4 * np.pi / nside2npix(nside)
    if degrees:
        area *= (180 / np.pi) ** 2
    return area


def nside2resol(nside):
    """Approximate pixel resolution [radians] (sqrt of pixel area)."""
    return np.sqrt(nside2pixarea(nside))


def ring_info(nside):
    """Per-ring geometry for rings i = 1 .. 4*nside-1.

    Returns
    -------
    z : (Nring,) ring z = cos(theta), descending
    start : (Nring,) first RING pixel index of each ring
    npr : (Nring,) number of pixels in each ring
    shift : (Nring,) phi offset in pixel units:
        center_k = (k + shift) * 2pi/npr
    """
    n = int(nside)
    i = np.arange(1, 4 * n)  # ring index
    z = np.empty(i.shape, dtype=np.float64)
    npr = np.empty(i.shape, dtype=np.int64)
    shift = np.empty(i.shape, dtype=np.float64)

    north_cap = i < n
    eq = (i >= n) & (i <= 3 * n)
    south_cap = i > 3 * n

    ic = i[north_cap]
    z[north_cap] = 1.0 - ic.astype(np.float64) ** 2 / (3.0 * n * n)
    npr[north_cap] = 4 * ic
    shift[north_cap] = 0.5

    ie = i[eq]
    z[eq] = 4.0 / 3.0 - 2.0 * ie.astype(np.float64) / (3.0 * n)
    npr[eq] = 4 * n
    # rings with s = 1 are offset by half a pixel; s = 0 rings start at phi=0
    s = (ie - n + 1) % 2
    shift[eq] = s / 2.0

    isc = 4 * n - i[south_cap]
    z[south_cap] = -(1.0 - isc.astype(np.float64) ** 2 / (3.0 * n * n))
    npr[south_cap] = 4 * isc
    shift[south_cap] = 0.5

    start = np.concatenate([[0], np.cumsum(npr)[:-1]])
    return z, start, npr, shift


def pix2ang(nside, ipix):
    """RING pixel index -> (theta, phi) in radians. Vectorized."""
    n = int(nside)
    npix = nside2npix(n)
    p = np.asarray(ipix, dtype=np.int64)
    if np.any((p < 0) | (p >= npix)):
        raise ValueError("pixel index out of range")
    theta = np.empty(p.shape, dtype=np.float64)
    phi = np.empty(p.shape, dtype=np.float64)

    ncap = 2 * n * (n - 1)  # pixels in the north cap

    m = p < ncap
    if np.any(m):
        ph = (p[m] + 1) / 2.0
        i = (np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        j = p[m] + 1 - 2 * i * (i - 1)
        theta[m] = np.arccos(1.0 - i ** 2 / (3.0 * n * n))
        phi[m] = (np.pi / (2.0 * i)) * (j - 0.5)

    m = (p >= ncap) & (p < npix - ncap)
    if np.any(m):
        pp = p[m] - ncap
        i = pp // (4 * n) + n
        j = pp % (4 * n)
        s = (i - n + 1) % 2
        theta[m] = np.arccos(4.0 / 3.0 - 2.0 * i / (3.0 * n))
        phi[m] = (np.pi / (2.0 * n)) * (j + s / 2.0)

    m = p >= npix - ncap
    if np.any(m):
        ph = (npix - p[m]) / 2.0
        i = (np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        j = 4 * i + 1 - (npix - p[m] - 2 * i * (i - 1))
        theta[m] = np.arccos(-(1.0 - i ** 2 / (3.0 * n * n)))
        phi[m] = (np.pi / (2.0 * i)) * (j - 0.5)

    return theta, phi


def ang2pix(nside, theta, phi):
    """(theta, phi) in radians -> RING pixel index. Vectorized."""
    n = int(nside)
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2 * np.pi) * (2.0 / np.pi)  # in [0, 4)
    pix = np.empty(z.shape, dtype=np.int64)

    # equatorial region
    m = za <= 2.0 / 3.0
    if np.any(m):
        t1 = n * (0.5 + tt[m])
        t2 = n * 0.75 * z[m]
        jp = (t1 - t2).astype(np.int64)  # ascending edge line
        jm = (t1 + t2).astype(np.int64)  # descending edge line
        ir = n + 1 + jp - jm             # ring number 1..2n+1 (in belt coords)
        kshift = 1 - (ir & 1)
        ip = (jp + jm - n + kshift + 1) // 2
        ip = np.mod(ip, 4 * n)
        pix[m] = 2 * n * (n - 1) + (ir - 1) * 4 * n + ip

    # polar caps
    m = ~m
    if np.any(m):
        tp = tt[m] - np.floor(tt[m])
        tmp = n * np.sqrt(3.0 * (1.0 - za[m]))
        jp = (tp * tmp).astype(np.int64)
        jm = ((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1
        ip = (tt[m] * ir).astype(np.int64)
        ip = np.mod(ip, 4 * ir)
        north = z[m] > 0
        pnorth = 2 * ir * (ir - 1) + ip
        psouth = nside2npix(n) - 2 * ir * (ir + 1) + ip
        pix[m] = np.where(north, pnorth, psouth)

    return pix if pix.shape else int(pix)


def pix2vec(nside, ipix):
    """RING pixel index -> unit vectors (x, y, z), shape (..., 3)."""
    theta, phi = pix2ang(nside, ipix)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)],
                    axis=-1)


def get_interp_weights(nside, theta, phi):
    """Bilinear interpolation: 4 neighbor pixels + weights per target angle.

    Exact vectorized port of the published HEALPix `get_interpol`
    algorithm (healpix_base; what healpy.get_interp_weights calls, used
    by the reference's PixInterp, bayeslim/utils.py:765): the two
    phi-adjacent pixels on the ring above and below, blended linearly in
    THETA (not z). In the polar caps the missing ring is replaced by the
    polar ring's opposite-side pixels — all four polar-ring pixels share
    (1-wtheta)/4 — so the interpolant is continuous and equals the
    4-pixel ring average at the pole.

    Returns
    -------
    pix : (4, Nangles) int64 RING pixel indices
    wgts : (4, Nangles) float64 weights summing to 1
    """
    n = int(nside)
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    z = np.cos(theta)
    npix = nside2npix(n)

    zr, start, npr, shift = ring_info(n)
    nring = len(zr)  # 4n - 1
    theta_ring = np.arccos(np.clip(zr, -1.0, 1.0))

    # ring_above(z): 1-based index of the ring above z (0 = polar cap)
    az = np.abs(z)
    ir_eq = (n * (2.0 - 1.5 * z)).astype(np.int64)
    ir_pc = (n * np.sqrt(3.0 * (1.0 - az))).astype(np.int64)
    ir1 = np.where(az <= 2.0 / 3.0, ir_eq,
                   np.where(z > 0, ir_pc, 4 * n - ir_pc - 1))
    ir2 = ir1 + 1
    north = ir1 == 0
    south = ir2 == 4 * n

    def ring_neighbors(iring, ph):
        """Two phi-adjacent pixels + fractional weight on ring (0-based)."""
        npx = npr[iring]
        x = ph * npx / (2 * np.pi) - shift[iring]
        k0 = np.floor(x)
        w1 = x - k0
        k0i = np.mod(k0.astype(np.int64), npx)
        k1i = np.mod(k0i + 1, npx)
        return start[iring] + k0i, start[iring] + k1i, w1

    pa0, pa1, wa = ring_neighbors(np.clip(ir1 - 1, 0, nring - 1), phi)
    pb0, pb1, wb = ring_neighbors(np.clip(ir2 - 1, 0, nring - 1), phi)

    # vertical blend in theta; virtual rings at the poles (theta 0 / pi)
    theta1 = np.where(north, 0.0, theta_ring[np.clip(ir1 - 1, 0, nring - 1)])
    theta2 = np.where(south, np.pi, theta_ring[np.clip(ir2 - 1, 0, nring - 1)])
    wt = (theta - theta1) / (theta2 - theta1)

    pix = np.stack([pa0, pa1, pb0, pb1])
    wgts = np.stack([
        (1 - wt) * (1 - wa), (1 - wt) * wa,
        wt * (1 - wb), wt * wb,
    ])

    if np.any(north):
        # ring 1 has exactly 4 pixels (global indices 0..3): the "ring
        # above" is its opposite side, each polar pixel gains fac
        fac = 0.25 * (1 - wt[north])
        pix[0, north] = (pix[2, north] + 2) & 3
        pix[1, north] = (pix[3, north] + 2) & 3
        wgts[0, north] = fac
        wgts[1, north] = fac
        wgts[2, north] += fac
        wgts[3, north] += fac
    if np.any(south):
        # last ring: global indices npix-4 .. npix-1 (npix-4 is a
        # multiple of 4, so the &3 opposite trick applies)
        fac = 0.25 * wt[south]
        pix[2, south] = ((pix[0, south] + 2) & 3) + npix - 4
        pix[3, south] = ((pix[1, south] + 2) & 3) + npix - 4
        wgts[0, south] += fac
        wgts[1, south] += fac
        wgts[2, south] = fac
        wgts[3, south] = fac
    return pix, wgts
