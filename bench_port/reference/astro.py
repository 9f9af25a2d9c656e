"""
Geometry of the plain reference, in numpy float64: the hexagonal array,
its redundant groups, HEALPix RING pixel centres, and the ICRS ->
topocentric transform that gives each pixel's zenith angle and azimuth.

Nothing here imports the program. The array layout, the groups and the
pixel centres are worked out from their definitions. ``eq2top`` is a
frozen copy of the ephemeris both packages share (IAU 1976 precession,
IAU 1980 nutation's principal terms, annual aberration, sidereal time on
the Earth rotation angle): the directions must agree with the program's
to far below a float32 rounding, and a second ephemeris (astropy's, say)
differs from this one by arcseconds, which would move a 300 m baseline's
fringe by ~1e-2 rad at 200 MHz.
"""
from __future__ import annotations

import numpy as np

C_MS = 2.99792458e8          # speed of light [m/s]
D2R = np.pi / 180.0
LOCATION = (21.428305555, -30.72152777, 1073.0)   # HERA: lon, lat [deg], alt [m]


def make_hex(n, spacing):
    """A hexagon of antennas with n on a side, rows of n .. 2n-1 .. n
    antennas spaced by `spacing` [m], numbered row by row from the
    bottom; centred on the mean. Returns (Nants, 3) ENU positions [m]."""
    pos = []
    for row in range(2 * n - 1):
        width = 2 * n - 1 - abs(row - (n - 1))
        x0 = -(width - 1) / 2.0
        for j in range(width):
            pos.append((x0 + j, row * np.sqrt(3.0) / 2.0))
    pos = np.asarray(pos, dtype=np.float64)
    pos -= pos.mean(axis=0)
    return np.column_stack([pos * spacing, np.zeros(len(pos))])


def redundant_groups(antpos, tol_m=1e-3):
    """Cross baselines (i, j), i < j, grouped by their vector to tol_m.

    Returns (a1, a2, group, rep1, rep2): every baseline's antenna
    indices and group number, and each group's representative, the
    lexicographically smallest (i, j) in it. Groups are numbered in the
    order of their representatives."""
    na = len(antpos)
    i, j = np.triu_indices(na, k=1)
    key = np.round((antpos[j] - antpos[i]) / tol_m).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    # triu_indices is in lexicographic order: a group's first baseline is
    # its smallest; renumber the groups by that baseline
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    group = rank[inv]
    rep = first[order]
    return i, j, group, i[rep], j[rep]


def healpix_centres(nside):
    """(theta, phi) [rad] of every RING-ordered pixel of a HEALPix map
    (Gorski et al. 2005, ApJ 622, 759): 4 nside - 1 iso-latitude rings,
    4i pixels on polar ring i, 4 nside on each equatorial ring, the
    equatorial rings' pixels shifted by half a pixel on alternate rings."""
    n = int(nside)
    rings = np.arange(1, 4 * n)
    polar = np.minimum(rings, 4 * n - rings)
    count = np.where(polar < n, 4 * polar, 4 * n)
    z = np.where(rings < n, 1 - rings ** 2 / (3.0 * n * n),
                 np.where(rings > 3 * n,
                          -(1 - (4 * n - rings) ** 2 / (3.0 * n * n)),
                          4.0 / 3.0 - 2.0 * rings / (3.0 * n)))
    theta, phi = [], []
    for r, c, zz, pr in zip(rings, count, z, polar):
        j = np.arange(c)
        if pr < n:
            ph = np.pi / (2.0 * pr) * (j + 0.5)
        else:
            ph = np.pi / (2.0 * n) * (j + ((r - n + 1) % 2) / 2.0)
        theta.append(np.full(c, np.arccos(zz)))
        phi.append(ph)
    return np.concatenate(theta), np.concatenate(phi)


# ---------------------------------------------------------------------------
# ICRS -> topocentric (frozen copy of the shared ephemeris)
# ---------------------------------------------------------------------------

_NUT = np.array([
    [0, 0, 0, 0, 1, -171996.0, -174.2, 92025.0, 8.9],
    [-2, 0, 0, 2, 2, -13187.0, -1.6, 5736.0, -3.1],
    [0, 0, 0, 2, 2, -2274.0, -0.2, 977.0, -0.5],
    [0, 0, 0, 0, 2, 2062.0, 0.2, -895.0, 0.5],
    [0, 1, 0, 0, 0, 1426.0, -3.4, 54.0, -0.1],
    [0, 0, 1, 0, 0, 712.0, 0.1, -7.0, 0.0],
    [-2, 1, 0, 2, 2, -517.0, 1.2, 224.0, -0.6],
    [0, 0, 0, 2, 1, -386.0, -0.4, 200.0, 0.0],
    [0, 0, 1, 2, 2, -301.0, 0.0, 129.0, -0.1],
    [-2, -1, 0, 2, 2, 217.0, -0.5, -95.0, 0.3],
    [-2, 0, 1, 0, 0, -158.0, 0.0, 0.0, 0.0],
    [-2, 0, 0, 2, 1, 129.0, 0.1, -70.0, 0.0],
    [0, 0, -1, 2, 2, 123.0, 0.0, -53.0, 0.0],
    [2, 0, 0, 0, 0, 63.0, 0.0, 0.0, 0.0],
    [0, 0, 1, 0, 1, 63.0, 0.1, -33.0, 0.0],
    [2, 0, -1, 2, 2, -59.0, 0.0, 26.0, 0.0],
    [0, 0, -1, 0, 1, -58.0, -0.1, 32.0, 0.0],
    [0, 0, 1, 2, 1, -51.0, 0.0, 27.0, 0.0],
    [-2, 0, 2, 0, 0, 48.0, 0.0, 0.0, 0.0],
    [0, 0, -2, 2, 1, 46.0, 0.0, -24.0, 0.0],
    [2, 0, 0, 2, 2, -38.0, 0.0, 16.0, 0.0],
    [0, 0, 2, 2, 2, -31.0, 0.0, 13.0, 0.0],
    [0, 0, 2, 0, 0, 29.0, 0.0, 0.0, 0.0],
    [-2, 0, 1, 2, 2, 29.0, 0.0, -12.0, 0.0],
    [0, 0, 0, 2, 0, 26.0, 0.0, 0.0, 0.0],
    [-2, 0, 0, 2, 0, -22.0, 0.0, 0.0, 0.0],
    [0, 0, -1, 2, 1, 21.0, 0.0, -10.0, 0.0],
    [0, 2, 0, 0, 0, 17.0, -0.1, 0.0, 0.0],
    [2, 0, -1, 0, 1, 16.0, 0.0, -8.0, 0.0],
    [-2, 2, 0, 2, 2, -16.0, 0.1, 7.0, 0.0],
    [0, 1, 0, 0, 1, -15.0, 0.0, 9.0, 0.0],
    [-2, 0, 1, 0, 1, -13.0, 0.0, 7.0, 0.0],
    [0, -1, 0, 0, 1, -12.0, 0.0, 6.0, 0.0],
    [0, 0, 2, -2, 0, 11.0, 0.0, 0.0, 0.0],
    [2, 0, -1, 2, 1, -10.0, 0.0, 5.0, 0.0],
])
_AS2R = np.pi / (180 * 3600)


def _centuries(jd):
    return (jd - 2451545.0) / 36525.0


def _gmst(jd):
    du = jd - 2451545.0
    era = np.mod(2 * np.pi * (du - np.floor(du) + 0.7790572732640
                              + 0.00273781191135448 * du), 2 * np.pi)
    t = _centuries(jd)
    poly = (0.014506 + 4612.156534 * t + 1.3915817 * t ** 2
            - 0.00000044 * t ** 3 - 0.000029956 * t ** 4)
    return np.mod(era + poly * _AS2R, 2 * np.pi)


def _nutation(jd):
    t = _centuries(jd)
    d2r = D2R
    args = np.array([
        297.85036 + 445267.111480 * t - 0.0019142 * t ** 2 + t ** 3 / 189474.0,
        357.52772 + 35999.050340 * t - 0.0001603 * t ** 2 - t ** 3 / 300000.0,
        134.96298 + 477198.867398 * t + 0.0086972 * t ** 2 + t ** 3 / 56250.0,
        93.27191 + 483202.017538 * t - 0.0036825 * t ** 2 + t ** 3 / 327270.0,
        125.04452 - 1934.136261 * t + 0.0020708 * t ** 2 + t ** 3 / 450000.0,
    ]) * d2r
    arg = _NUT[:, :5] @ args
    dpsi = np.sum((_NUT[:, 5] + _NUT[:, 6] * t) * np.sin(arg)) * 1e-4
    deps = np.sum((_NUT[:, 7] + _NUT[:, 8] * t) * np.cos(arg)) * 1e-4
    dpsi -= 0.29965 * t
    deps -= 0.02524 * t
    return dpsi * _AS2R, deps * _AS2R


def _obliquity(jd):
    t = _centuries(jd)
    return (84381.448 - 46.8150 * t - 0.00059 * t ** 2
            + 0.001813 * t ** 3) * _AS2R


def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    if axis == 1:
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def eq2top(jd, ra_deg, dec_deg, location=LOCATION):
    """Apparent topocentric (zenith angle, azimuth East of North) [deg]
    of ICRS directions at Julian date jd."""
    lon, lat = location[0], location[1]
    ra, dec = np.asarray(ra_deg) * D2R, np.asarray(dec_deg) * D2R
    v = np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                  np.sin(dec)])
    t = _centuries(jd)
    # annual aberration: the Earth's velocity / c
    L = (280.46646 + 36000.76983 * t) * D2R
    M = (357.52911 + 35999.05029 * t) * D2R
    lam = L + (1.914602 * np.sin(M) + 0.019993 * np.sin(2 * M)) * D2R
    e, kappa, eps = 0.016708634, 20.49552 * _AS2R, _obliquity(jd)
    vx = kappa * (np.sin(lam) + e * np.sin(L + np.pi))
    vy = -kappa * (np.cos(lam) + e * np.cos(L + np.pi))
    v = v + np.array([-vx, -vy * np.cos(eps), -vy * np.sin(eps)])[:, None]
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    # frame bias, precession (IAU 1976), nutation (IAU 1980)
    xi, eta, dra = -0.0166170 * _AS2R, -0.0068192 * _AS2R, -0.01460 * _AS2R
    bias = np.array([[1.0, dra, -xi], [-dra, 1.0, -eta], [xi, eta, 1.0]])
    zeta = (2306.2181 * t + 0.30188 * t ** 2 + 0.017998 * t ** 3) * _AS2R
    z = (2306.2181 * t + 1.09468 * t ** 2 + 0.018203 * t ** 3) * _AS2R
    th = (2004.3109 * t - 0.42665 * t ** 2 - 0.041833 * t ** 3) * _AS2R
    prec = _rot(2, -z) @ _rot(1, th) @ _rot(2, -zeta)
    dpsi, deps = _nutation(jd)
    nut = _rot(0, -(eps + deps)) @ _rot(2, -dpsi) @ _rot(0, eps)
    v = nut @ prec @ bias @ v
    last = _gmst(jd) + dpsi * np.cos(eps) + lon * D2R
    ha = last - np.arctan2(v[1], v[0])
    dec = np.arcsin(np.clip(v[2], -1, 1))
    lat = lat * D2R
    east = -np.cos(dec) * np.sin(ha)
    north = np.sin(dec) * np.cos(lat) - np.cos(dec) * np.cos(ha) * np.sin(lat)
    up = np.sin(dec) * np.sin(lat) + np.cos(dec) * np.cos(ha) * np.cos(lat)
    zen = np.arccos(np.clip(up, -1, 1)) / D2R
    az = np.mod(np.arctan2(east, north), 2 * np.pi) / D2R
    return zen, az


def sky_geometry(nside, times):
    """Per time, the pixels above the horizon (zenith angle < 90 deg) of
    an nside map and their unit pointing vectors (3, K) in ENU:
    [(index, s)], and the union of the indices over the times."""
    theta, phi = healpix_centres(nside)
    ra, dec = phi / D2R, 90.0 - theta / D2R
    out = []
    for jd in times:
        zen, az = eq2top(jd, ra, dec)
        idx = np.flatnonzero(zen < 90.0)
        z, a = zen[idx] * D2R, az[idx] * D2R
        out.append((idx, np.stack([np.sin(z) * np.sin(a),
                                   np.sin(z) * np.cos(a), np.cos(z)])))
    union = np.unique(np.concatenate([i for i, _ in out]))
    return out, union, theta, phi
