"""
Telescope location, ephemeris, redundant groups and the antenna array.

Counterpart of bayeslim_tpu/models/telescope.py (ephemeris :44-277,
top2eq :280, JD2LST / JD2RA :315-327, eq2top_m / top2eq_m :328-353,
vis_rephase :354, TelescopeModel :377 with hash, clear_cache and the
cached eq2top / top2eq :394-420, build_reds :441, ArrayModel :615
with set_freq_index :662, match_bl_len :675, gen_fringe :712 and
get_bls :750, match_red_blvec :788). The ephemeris
(sidereal time, IAU 1976 precession, IAU 1980 nutation, annual
aberration) is host numpy, copied from the JAX package so the port
needs no astropy and gives the same angles: it is a precompute stage
whose zen/az feed the device model as constant tensors. Gradients
with respect to antenna positions flow through tau = b.s/c on the
device.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops.phase import fringe_phasor
from ..utils.dtypes import C_MS, D2R, R2D, _float, resolve_device
from ..utils.indexing import AntposDict, ants2blnum
from ..utils.module import Module

__all__ = ["TelescopeModel", "ArrayModel", "build_reds", "eq2top",
           "top2eq", "JD2LST", "JD2RA", "gmst_rad", "vis_rephase",
           "eq2top_m", "top2eq_m", "match_red_blvec"]


# ---------------------------------------------------------------------------
# sidereal time, precession, nutation, aberration (host numpy)
# ---------------------------------------------------------------------------

def _era_rad(jd):
    """Earth rotation angle (IAU 2000), radians, from UT1 Julian date."""
    du = np.asarray(jd, dtype=np.float64) - 2451545.0
    f = du - np.floor(du)
    theta = 2 * np.pi * (f + 0.7790572732640 + 0.00273781191135448 * du)
    return np.mod(theta, 2 * np.pi)


def gmst_rad(jd):
    """Greenwich mean sidereal time [rad] (IAU 2006 polynomial on ERA)."""
    t = (np.asarray(jd, dtype=np.float64) - 2451545.0) / 36525.0
    # GMST = ERA + polynomial part [arcsec]
    poly = (0.014506 + 4612.156534 * t + 1.3915817 * t**2
            - 0.00000044 * t**3 - 0.000029956 * t**4)
    return np.mod(_era_rad(jd) + poly * np.pi / (180 * 3600), 2 * np.pi)


# IAU 1980 nutation series, principal terms (Meeus, Astronomical
# Algorithms 2nd ed., Table 22.A; amplitudes >= 0.0010"). Columns:
# multipliers of (D, M, M', F, Om), then dpsi sin-coefficient and its
# T-rate, deps cos-coefficient and its T-rate, in units of 0.0001".
# Truncation error ~0.003" over +-1 century of J2000; the IAU 2000
# precession-rate corrections (-0.29965 T, -0.02524 T arcsec) are added
# to match the IAU 2000A frame at the few-mas level.
_NUT_TABLE = np.array([
    #  D   M  M'  F  Om    psi      psi_t   eps     eps_t
    [0,  0,  0,  0,  1, -171996.0, -174.2, 92025.0,  8.9],
    [-2, 0,  0,  2,  2,  -13187.0,   -1.6,  5736.0, -3.1],
    [0,  0,  0,  2,  2,   -2274.0,   -0.2,   977.0, -0.5],
    [0,  0,  0,  0,  2,    2062.0,    0.2,  -895.0,  0.5],
    [0,  1,  0,  0,  0,    1426.0,   -3.4,    54.0, -0.1],
    [0,  0,  1,  0,  0,     712.0,    0.1,    -7.0,  0.0],
    [-2, 1,  0,  2,  2,    -517.0,    1.2,   224.0, -0.6],
    [0,  0,  0,  2,  1,    -386.0,   -0.4,   200.0,  0.0],
    [0,  0,  1,  2,  2,    -301.0,    0.0,   129.0, -0.1],
    [-2, -1, 0,  2,  2,     217.0,   -0.5,   -95.0,  0.3],
    [-2, 0,  1,  0,  0,    -158.0,    0.0,     0.0,  0.0],
    [-2, 0,  0,  2,  1,     129.0,    0.1,   -70.0,  0.0],
    [0,  0, -1,  2,  2,     123.0,    0.0,   -53.0,  0.0],
    [2,  0,  0,  0,  0,      63.0,    0.0,     0.0,  0.0],
    [0,  0,  1,  0,  1,      63.0,    0.1,   -33.0,  0.0],
    [2,  0, -1,  2,  2,     -59.0,    0.0,    26.0,  0.0],
    [0,  0, -1,  0,  1,     -58.0,   -0.1,    32.0,  0.0],
    [0,  0,  1,  2,  1,     -51.0,    0.0,    27.0,  0.0],
    [-2, 0,  2,  0,  0,      48.0,    0.0,     0.0,  0.0],
    [0,  0, -2,  2,  1,      46.0,    0.0,   -24.0,  0.0],
    [2,  0,  0,  2,  2,     -38.0,    0.0,    16.0,  0.0],
    [0,  0,  2,  2,  2,     -31.0,    0.0,    13.0,  0.0],
    [0,  0,  2,  0,  0,      29.0,    0.0,     0.0,  0.0],
    [-2, 0,  1,  2,  2,      29.0,    0.0,   -12.0,  0.0],
    [0,  0,  0,  2,  0,      26.0,    0.0,     0.0,  0.0],
    [-2, 0,  0,  2,  0,     -22.0,    0.0,     0.0,  0.0],
    [0,  0, -1,  2,  1,      21.0,    0.0,   -10.0,  0.0],
    [0,  2,  0,  0,  0,      17.0,   -0.1,     0.0,  0.0],
    [2,  0, -1,  0,  1,      16.0,    0.0,    -8.0,  0.0],
    [-2, 2,  0,  2,  2,     -16.0,    0.1,     7.0,  0.0],
    [0,  1,  0,  0,  1,     -15.0,    0.0,     9.0,  0.0],
    [-2, 0,  1,  0,  1,     -13.0,    0.0,     7.0,  0.0],
    [0, -1,  0,  0,  1,     -12.0,    0.0,     6.0,  0.0],
    [0,  0,  2, -2,  0,      11.0,    0.0,     0.0,  0.0],
    [2,  0, -1,  2,  1,     -10.0,    0.0,     5.0,  0.0],
], dtype=np.float64)


def _delaunay_args(t):
    """Fundamental (Delaunay) arguments [rad] (Meeus 22.1-22.5)."""
    d2r = np.pi / 180.0
    D = (297.85036 + 445267.111480 * t - 0.0019142 * t**2
         + t**3 / 189474.0) * d2r
    M = (357.52772 + 35999.050340 * t - 0.0001603 * t**2
         - t**3 / 300000.0) * d2r
    Mp = (134.96298 + 477198.867398 * t + 0.0086972 * t**2
          + t**3 / 56250.0) * d2r
    F = (93.27191 + 483202.017538 * t - 0.0036825 * t**2
         + t**3 / 327270.0) * d2r
    Om = (125.04452 - 1934.136261 * t + 0.0020708 * t**2
          + t**3 / 450000.0) * d2r
    return D, M, Mp, F, Om


def _nutation(jd, rate_corr=True):
    """IAU 1980 nutation (principal terms): (dpsi, deps) [rad].

    Meeus worked example: 1987 Apr 10 TD gives dpsi=-3.788",
    deps=+9.443". rate_corr adds the IAU 2000 precession-rate
    corrections so the frame tracks IAU 2000A at the few-mas level.
    """
    t = (np.asarray(jd, dtype=np.float64) - 2451545.0) / 36525.0
    D, M, Mp, F, Om = _delaunay_args(t)
    mult = _NUT_TABLE[:, :5]
    arg = (mult[:, 0, None] * np.atleast_1d(D)
           + mult[:, 1, None] * np.atleast_1d(M)
           + mult[:, 2, None] * np.atleast_1d(Mp)
           + mult[:, 3, None] * np.atleast_1d(F)
           + mult[:, 4, None] * np.atleast_1d(Om))
    tt = np.atleast_1d(t)
    dpsi = np.sum((_NUT_TABLE[:, 5, None] + _NUT_TABLE[:, 6, None] * tt)
                  * np.sin(arg), axis=0) * 1e-4
    deps = np.sum((_NUT_TABLE[:, 7, None] + _NUT_TABLE[:, 8, None] * tt)
                  * np.cos(arg), axis=0) * 1e-4
    if rate_corr:
        dpsi = dpsi - 0.29965 * tt
        deps = deps - 0.02524 * tt
    if np.ndim(jd) == 0:
        dpsi, deps = dpsi[0], deps[0]
    as2r = np.pi / (180 * 3600)
    return dpsi * as2r, deps * as2r


# ICRS pole/origin offsets w.r.t. the J2000 mean equator/equinox
# (IAU 2000 frame bias; SOFA bp00): xi0, eta0, d(alpha)0 [arcsec]
_BIAS_XI0 = -0.0166170
_BIAS_ETA0 = -0.0068192
_BIAS_DRA0 = -0.01460


def _frame_bias():
    """ICRS -> mean J2000 rotation matrix (first order; second-order
    terms are ~1e-19 and irrelevant)."""
    as2r = np.pi / (180 * 3600)
    xi, eta, dra = (_BIAS_XI0 * as2r, _BIAS_ETA0 * as2r, _BIAS_DRA0 * as2r)
    return np.array([
        [1.0,   dra,  -xi],
        [-dra,  1.0, -eta],
        [xi,    eta,  1.0],
    ])


def _obliquity(jd):
    """Mean obliquity of the ecliptic [rad] (IAU 1980, as used by the
    ERFA/SOFA IAU 2000 precession-nutation chain and the Meeus worked
    examples; the IAU 2006 constant differs by 0.042")."""
    t = (np.asarray(jd, dtype=np.float64) - 2451545.0) / 36525.0
    eps = 84381.448 - 46.8150 * t - 0.00059 * t**2 + 0.001813 * t**3
    return eps * np.pi / (180 * 3600)


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def _precession_matrix(jd):
    """IAU 1976 precession matrix J2000 -> mean of date."""
    t = (np.asarray(jd, dtype=np.float64) - 2451545.0) / 36525.0
    as2r = np.pi / (180 * 3600)
    zeta = (2306.2181 * t + 0.30188 * t**2 + 0.017998 * t**3) * as2r
    z = (2306.2181 * t + 1.09468 * t**2 + 0.018203 * t**3) * as2r
    theta = (2004.3109 * t - 0.42665 * t**2 - 0.041833 * t**3) * as2r
    return _rz(-z) @ _ry(theta) @ _rz(-zeta)


def _nutation_matrix(jd):
    dpsi, deps = _nutation(jd)
    eps = _obliquity(jd)
    return _rx(-(eps + deps)) @ _rz(-dpsi) @ _rx(eps)


def _earth_velocity(jd):
    """Earth heliocentric velocity / c in equatorial frame (annual aberration)."""
    t = (np.asarray(jd, dtype=np.float64) - 2451545.0) / 36525.0
    d2r = np.pi / 180.0
    L = (280.46646 + 36000.76983 * t) * d2r        # sun mean longitude
    M = (357.52911 + 35999.05029 * t) * d2r        # sun mean anomaly
    lam = L + (1.914602 * np.sin(M) + 0.019993 * np.sin(2 * M)) * d2r
    e = 0.016708634
    kappa = 20.49552 * np.pi / (180 * 3600)        # aberration constant [rad]
    eps = _obliquity(jd)
    # velocity direction is perpendicular to sun direction, in ecliptic plane
    vx = kappa * (np.sin(lam) + e * np.sin(L + np.pi))
    vy = -kappa * (np.cos(lam) + e * np.cos(L + np.pi))
    # rotate ecliptic -> equatorial
    return np.array([-vx, -vy * np.cos(eps), -vy * np.sin(eps)])


def _radec_to_vec(ra_deg, dec_deg):
    ra = np.atleast_1d(np.asarray(ra_deg, dtype=np.float64)) * D2R
    dec = np.atleast_1d(np.asarray(dec_deg, dtype=np.float64)) * D2R
    cd = np.cos(dec)
    return np.stack([cd * np.cos(ra), cd * np.sin(ra), np.sin(dec)], axis=0)


def eq2top(location, time, ra, dec, apparent=True):
    """ICRS (J2000) RA/Dec [deg] -> topocentric zenith angle & azimuth [deg].

    `location` is (lon_deg, lat_deg, alt_m). With apparent=True applies
    precession, nutation and annual aberration (~arcsec agreement with
    astropy); apparent=False applies only the Earth-rotation part.

    Returns zen, az in degrees; az is East of North.
    """
    lon, lat = location[0], location[1]
    v = _radec_to_vec(ra, dec)  # (3, N) J2000

    if apparent:
        # precession + nutation of the frame, aberration of positions
        vel = _earth_velocity(time)
        v = v + vel[:, None]
        v /= np.linalg.norm(v, axis=0, keepdims=True)
        M = _nutation_matrix(time) @ _precession_matrix(time) @ _frame_bias()
        v = M @ v
        dpsi, _ = _nutation(time)
        last = gmst_rad(time) + dpsi * np.cos(_obliquity(time)) + lon * D2R
    else:
        last = gmst_rad(time) + lon * D2R

    # hour angle of each source
    ra_date = np.arctan2(v[1], v[0])
    dec_date = np.arcsin(np.clip(v[2], -1, 1))
    H = last - ra_date

    lat_r = lat * D2R
    sd, cd = np.sin(dec_date), np.cos(dec_date)
    sl, cl = np.sin(lat_r), np.cos(lat_r)
    e = -cd * np.sin(H)
    n = sd * cl - cd * np.cos(H) * sl
    u = sd * sl + cd * np.cos(H) * cl
    zen = np.arccos(np.clip(u, -1, 1)) * R2D
    az = np.mod(np.arctan2(e, n), 2 * np.pi) * R2D
    return zen, az


def top2eq(location, time, zen, az, apparent=True):
    """Topocentric zen/az [deg] -> ICRS RA/Dec [deg] (inverse of eq2top)."""
    lon, lat = location[0], location[1]
    zen_r = np.atleast_1d(np.asarray(zen, dtype=np.float64)) * D2R
    az_r = np.atleast_1d(np.asarray(az, dtype=np.float64)) * D2R
    lat_r = lat * D2R
    # ENU -> (H, dec)
    e = np.sin(zen_r) * np.sin(az_r)
    n = np.sin(zen_r) * np.cos(az_r)
    u = np.cos(zen_r)
    sd = u * np.sin(lat_r) + n * np.cos(lat_r)
    dec_date = np.arcsin(np.clip(sd, -1, 1))
    # cd*cosH = u*cos(lat) - n*sin(lat); cd*sinH = -e
    H = np.arctan2(-e, u * np.cos(lat_r) - n * np.sin(lat_r))

    if apparent:
        dpsi, _ = _nutation(time)
        last = gmst_rad(time) + dpsi * np.cos(_obliquity(time)) + lon * D2R
    else:
        last = gmst_rad(time) + lon * D2R
    ra_date = np.mod(last - H, 2 * np.pi)

    cd = np.cos(dec_date)
    v = np.stack([cd * np.cos(ra_date), cd * np.sin(ra_date),
                  np.sin(dec_date)])
    if apparent:
        M = _nutation_matrix(time) @ _precession_matrix(time) @ _frame_bias()
        v = M.T @ v
        vel = _earth_velocity(time)
        v = v - vel[:, None]
        v /= np.linalg.norm(v, axis=0, keepdims=True)
    ra = np.mod(np.arctan2(v[1], v[0]), 2 * np.pi) * R2D
    dec = np.arcsin(np.clip(v[2], -1, 1)) * R2D
    return ra, dec


def JD2LST(jd, longitude):
    """JD -> local apparent sidereal time [rad]."""
    dpsi, _ = _nutation(jd)
    return np.mod(gmst_rad(jd) + dpsi * np.cos(_obliquity(jd))
                  + longitude * D2R, 2 * np.pi)


def JD2RA(location, jd):
    """JD -> ICRS RA [deg] of the zenith at the telescope."""
    ra, _ = top2eq(location, jd, 0.0, 0.0)
    return float(np.atleast_1d(ra)[0])


def _as64(x, device=None):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def eq2top_m(ha, dec):
    """(Nha, 3, 3) equatorial -> topocentric rotations of the hour
    angles ha [rad] at declination dec [rad] (float64 tensors on ha's
    device)."""
    ha = torch.atleast_1d(_as64(ha, getattr(ha, "device", None)))
    dec = torch.ones_like(ha) * dec
    sH, cH = torch.sin(ha), torch.cos(ha)
    sd, cd = torch.sin(dec), torch.cos(dec)
    zero = torch.zeros_like(ha)
    m = torch.stack([sH, cH, zero,
                     -sd * cH, sd * sH, cd,
                     cd * cH, -cd * sH, sd])
    return torch.movedim(m.reshape(3, 3, -1), 2, 0)


def top2eq_m(ha, dec):
    """(Nha, 3, 3) topocentric -> equatorial rotations (the inverse of
    eq2top_m)."""
    ha = torch.atleast_1d(_as64(ha, getattr(ha, "device", None)))
    dec = torch.ones_like(ha) * dec
    sH, cH = torch.sin(ha), torch.cos(ha)
    sd, cd = torch.sin(dec), torch.cos(dec)
    zero = torch.zeros_like(ha)
    m = torch.stack([sH, -cH * sd, cd * cH,
                     cH, sd * sH, -cd * sH,
                     zero, cd, sd])
    return torch.movedim(m.reshape(3, 3, -1), 2, 0)


def vis_rephase(dlst, lat, blvecs, freqs, device=None, dtype=None):
    """Drift-scan rephasing phasor (Nbls, Nlst, Nfreqs) of a zenith
    pointing moved by dlst [rad] at latitude lat [deg] (Zhang et al.
    2018 Eq 22). The phase 2 pi f b.ds / c is formed in float64 on the
    device (of blvecs if a tensor, else ``device``); the phasor is cast
    to ``dtype`` (complex; default complex128)."""
    if device is None:
        device = blvecs.device if isinstance(blvecs, torch.Tensor) \
            else torch.device("cpu")
    dlst = torch.atleast_1d(_as64(dlst, device))
    lat_r = lat * D2R
    t2e = top2eq_m(torch.zeros(1, dtype=torch.float64, device=device),
                   lat_r)                                     # (1, 3, 3)
    e2t = eq2top_m(-dlst, lat_r)                               # (Nlst, 3, 3)
    rot = e2t @ t2e
    s_zen = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=device)
    s_diff_over_c = (rot @ s_zen - s_zen) / C_MS                # (Nlst, 3)
    tau = _as64(blvecs, device) @ s_diff_over_c.T               # (Nbls, Nlst)
    ang = (2 * np.pi) * tau[..., None] * _as64(freqs, device)
    dtype = torch.complex128 if dtype is None else dtype
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    return torch.complex(torch.cos(ang).to(rdt), torch.sin(ang).to(rdt))


# ---------------------------------------------------------------------------
# TelescopeModel
# ---------------------------------------------------------------------------

class TelescopeModel(Module):
    """Earth location (lon_deg, lat_deg, alt_m) and the host-side
    RA/Dec <-> zen/az conversions, with a cache of conversions
    (conv_cache). Holds no tensors."""

    def __init__(self, location, name=None, apparent=True):
        super().__init__(name=name)
        self.location = tuple(float(x) for x in location)
        self.apparent = apparent
        self.conv_cache = {}

    @staticmethod
    def hash(time, arr):
        """Cache key of a conversion: the time and the angle array's
        first and last values and size."""
        a = np.atleast_1d(np.asarray(arr))
        return hash((float(time), float(a[0]), float(a[-1]), a.size))

    def clear_cache(self, key=None):
        """Drop one cached conversion (None: all)."""
        if key is None:
            self.conv_cache.clear()
        else:
            self.conv_cache.pop(key, None)

    def _cached(self, fn, time, a, b, store, key):
        key = key if key is not None else self.hash(
            np.atleast_1d(np.asarray(time))[0], a)
        if key in self.conv_cache:
            return self.conv_cache[key]
        out = fn(self.location, time, a, b, apparent=self.apparent)
        if store:
            self.conv_cache[key] = out
        return out

    def eq2top(self, time, ra, dec, store=False, key=None, **kwargs):
        """RA/Dec [deg] -> zen/az [deg] (host numpy). A conversion cached
        under key (default: hash(time, ra)) is returned from the cache;
        store=True caches this one."""
        return self._cached(eq2top, time, ra, dec, store, key)

    def top2eq(self, time, zen, az, store=False, key=None, **kwargs):
        """zen/az [deg] -> RA/Dec [deg] (host numpy), cached as eq2top
        (default key: hash(time, zen))."""
        return self._cached(top2eq, time, zen, az, store, key)

    def JD2RA(self, jd):
        return JD2RA(self.location, jd)

    def JD2LST(self, jd):
        return JD2LST(jd, self.location[0])


# ---------------------------------------------------------------------------
# redundancy
# ---------------------------------------------------------------------------

def build_reds(antpos, bls=None, red_bls=None, redtol=1.0, min_len=None,
               max_len=None, min_EW_len=None, exclude_reds=None,
               skip_reds=False, norm_vec=False, use_blnums=False,
               use_2d=False, fcluster=False, red_info=None):
    """Redundant baseline groups by quantizing baseline vectors onto a
    redtol lattice and merging neighbouring cells within redtol. The
    groups are sorted by length (angle breaking ties), or, with red_bls,
    in the order of the groups holding those baselines (either
    orientation).

    Cuts: min_len < |b| < max_len, |b_E| > min_EW_len, and no baseline
    within redtol of an exclude_reds baseline (either orientation).
    use_2d groups by the EN components alone; norm_vec by length alone
    (the vectors become (|b|, 0, 0)). skip_reds makes every baseline
    its own group (bl2red empty). use_blnums returns the groups and bls
    as baseline integers. fcluster (scipy's hierarchical clustering) is
    accepted: the lattice gives the same redtol partition. red_info, a
    previous result, is returned as it is.

    Returns (reds, redvecs, bl2red, bls, redlens, redangs, redtags).
    """
    if red_info is not None:
        return red_info
    ap = antpos if isinstance(antpos, AntposDict) else AntposDict(
        list(antpos.keys()), np.stack([np.asarray(v)
                                       for v in antpos.values()]))
    if bls is None:
        bls = [(a, a) for a in ap.ants] + \
            list(itertools.combinations(ap.ants, 2))
    bls = [tuple(bl) for bl in bls]

    antvecs = ap.asnumpy()
    raw_vecs = antvecs[ap.index([bl[1] for bl in bls])] - \
        antvecs[ap.index([bl[0] for bl in bls])]
    bl_vecs = raw_vecs[:, :2] if use_2d else raw_vecs
    bl_lens = np.linalg.norm(bl_vecs, axis=1)
    if norm_vec:
        bl_vecs = np.zeros_like(bl_vecs)
        bl_vecs[:, 0] = bl_lens
    keep = np.ones(len(bls), dtype=bool)
    if min_len is not None:
        keep &= bl_lens > min_len
    if max_len is not None:
        keep &= bl_lens < max_len
    if min_EW_len is not None:
        keep &= np.abs(bl_vecs[:, 0]) > min_EW_len
    if exclude_reds is not None:
        evecs = antvecs[ap.index([bl[1] for bl in exclude_reds])] - \
            antvecs[ap.index([bl[0] for bl in exclude_reds])]
        if use_2d:
            evecs = evecs[:, :2]
        for ev in evecs:
            keep &= np.linalg.norm(bl_vecs - ev, axis=1) > redtol
            keep &= np.linalg.norm(bl_vecs + ev, axis=1) > redtol
    bls = [bl for bl, k in zip(bls, keep) if k]
    bl_vecs = bl_vecs[keep]
    raw_vecs = raw_vecs[keep]
    blpos = {bl: i for i, bl in enumerate(bls)}

    if skip_reds:
        reds = [[bl] for bl in bls]
    else:
        cells = np.round(bl_vecs / max(redtol, 1e-12)).astype(np.int64)
        _, first_idx, groups = np.unique(cells, axis=0, return_index=True,
                                         return_inverse=True)
        groups = np.asarray(groups).reshape(-1)
        reps = bl_vecs[first_idx]
        # union-find over the 3^d - 1 neighbouring lattice cells: two
        # vectors within redtol sit in the same or an adjacent cell
        ng = len(reps)
        remap = np.arange(ng)
        if ng > 1:
            qcells = cells[first_idx]
            cell_map = {tuple(c): i for i, c in enumerate(qcells)}

            def _find(i):
                while remap[i] != i:
                    remap[i] = remap[remap[i]]
                    i = remap[i]
                return i

            for off in itertools.product((-1, 0, 1), repeat=qcells.shape[1]):
                if not any(off):
                    continue
                js = np.asarray([cell_map.get(tuple(c), -1)
                                 for c in qcells + np.asarray(off)])
                ii = np.nonzero(js >= 0)[0]
                jj = js[ii]
                d = np.linalg.norm(reps[ii] - reps[jj], axis=1)
                for a, b in zip(ii[d < redtol], jj[d < redtol]):
                    ra, rb = _find(a), _find(b)
                    if ra != rb:
                        remap[max(ra, rb)] = min(ra, rb)
            remap = np.asarray([_find(i) for i in range(ng)])
        uniq = np.unique(remap[groups])
        gid = {g: i for i, g in enumerate(uniq)}
        reds = [[] for _ in range(len(uniq))]
        for bl, g in zip(bls, groups):
            reds[gid[remap[g]]].append(bl)

    # representative vector = first baseline of the group
    reds = [sorted(r) for r in reds]
    rvec, lens, angs, tags = [], [], [], []
    for r in reds:
        v = raw_vecs[blpos[r[0]]].copy()
        if use_2d:
            v = v[:2]
        ln = np.linalg.norm(v)
        if norm_vec:
            v = np.zeros_like(v)
            v[0] = ln
        ang = np.arctan2(v[1], v[0]) * R2D
        if v[1] < 0:
            ang += 180.0
        if abs(v[1]) < redtol:
            ang = 0.0
        rvec.append(v)
        lens.append(float(ln))
        angs.append(float(ang))
        tags.append("{:03.0f}_{:03.0f}".format(ln, ang))

    # sort groups: by red_bls, else by length (+ angle tiebreak)
    if red_bls is not None:
        s = []
        for rbl in red_bls:
            rbl = tuple(rbl)
            for i, red in enumerate(reds):
                if rbl in red or (rbl[1], rbl[0]) in red:
                    s.append(i)
                    break
    else:
        s = np.argsort(np.asarray(lens) + np.asarray(angs) * redtol / 180)
    reds = [reds[i] for i in s]
    rvec = [rvec[i] for i in s]
    lens = [lens[i] for i in s]
    angs = [angs[i] for i in s]
    tags = [tags[i] for i in s]
    out_bls = [bl for red in reds for bl in red]
    bl2red = {bl: i for i, red in enumerate(reds) for bl in red}
    if skip_reds:
        bl2red = {}
    if use_blnums:
        reds = [list(ants2blnum(red)) for red in reds]
        out_bls = np.asarray(ants2blnum(out_bls))
    return reds, rvec, bl2red, out_bls, lens, angs, tags


# ---------------------------------------------------------------------------
# ArrayModel
# ---------------------------------------------------------------------------

class ArrayModel(Module):
    """Antenna layout on the device plus host baseline bookkeeping.

    antvecs (Nants, 3) [m] is a buffer, or a trainable nn.Parameter with
    parameter=True; its gradient flows through tau = b.s/c (on CUDA
    through the tau-cotangent kernel, csrc/rime_dtau.cu). Baseline
    bookkeeping (redundant groups, get_bls) uses the positions given at
    construction. cache_s, cache_depth, cache_f, cache_f_angs and
    interp_mode (the reference's run-time fringe and pointing caches)
    are accepted and stored, as in the JAX package: the angle work is
    precomputed once on the host (RIME.precompute), so nothing is
    cached at run time. red_kwargs go to build_reds.
    """

    def __init__(self, antpos, freqs=None, parameter=False, redtol=1.0,
                 name=None, device=None, dtype=None, cache_s=True,
                 cache_depth=None, cache_f=False, cache_f_angs=None,
                 interp_mode="bilinear", **red_kwargs):
        super().__init__(name=name)
        self.cache_s = cache_s
        self.cache_depth = cache_depth
        self.cache_f = cache_f
        self.cache_f_angs = cache_f_angs
        self.interp_mode = interp_mode
        if isinstance(antpos, dict):
            antpos = AntposDict(list(antpos.keys()),
                                np.stack([np.asarray(v)
                                          for v in antpos.values()]))
        self.ants = list(antpos.ants)
        self._ant_idx = {a: i for i, a in enumerate(self.ants)}
        self._antvecs_np = antpos.asnumpy()
        self.register_buffer("antvecs", torch.as_tensor(
            self._antvecs_np, dtype=dtype or _float(),
            device=resolve_device(device)))
        self.redtol = redtol
        if parameter:
            self.set_param("antvecs")
        self.set_freqs(freqs)
        (self.reds, self.redvecs, self.bl2red, self.bls, self.redlens,
         self.redangs, self.redtags) = build_reds(antpos, redtol=redtol,
                                                  **red_kwargs)

    def set_freqs(self, freqs):
        """The full frequency grid [Hz] (None: none); drops any index."""
        self._freqs_full = None if freqs is None \
            else np.asarray(freqs, dtype=np.float64)
        self.freqs = self._freqs_full
        self._freq_idx = None

    def set_freq_index(self, idx=None):
        """freqs becomes the full grid's channels idx; every call indexes
        the full grid, and None restores it."""
        if not hasattr(self, "_freqs_full"):
            # an array pickled before the index existed: its grid is full
            self._freqs_full = self.freqs
        self._freq_idx = None if idx is None else np.asarray(idx)
        self.freqs = self._freqs_full if idx is None \
            else self._freqs_full[self._freq_idx]

    def match_bl_len(self, bl, bls):
        """The first baseline of bls whose redundant group's length is
        within redtol of bl's: (its group's angle minus bl's [deg], that
        baseline), or (0, False) when none is."""
        match, ang = False, 0.0
        bllen = self.redlens[self.bl2red[bl]]
        blang = self.redangs[self.bl2red[bl]]
        for _bl in bls:
            i = self.bl2red[_bl]
            if np.isclose(bllen, self.redlens[i], atol=self.redtol):
                ang = self.redangs[i] - blang
                match = _bl
                break
        return ang, match

    def to_antpos(self):
        """The current (possibly trained) antenna positions."""
        return AntposDict(self.ants, self.antvecs)

    def get_antpos(self, ant):
        """Position(s) of one antenna or a list of them; differentiable."""
        if isinstance(ant, (int, np.integer)):
            return self.antvecs[self._ant_idx[int(ant)]]
        return self.antvecs[[self._ant_idx[int(a)] for a in ant]]

    def bl_index(self, bls):
        """(ant1_idx, ant2_idx) integer arrays for a list of bl tuples."""
        if isinstance(bls, tuple):
            bls = [bls]
        a1 = np.asarray([self._ant_idx[bl[0]] for bl in bls])
        a2 = np.asarray([self._ant_idx[bl[1]] for bl in bls])
        return a1, a2

    def get_blvecs(self, bls):
        """Baseline vectors ant2 - ant1 in ENU [m], (Nbls, 3);
        differentiable."""
        a1, a2 = self.bl_index(bls)
        return self.antvecs[a2] - self.antvecs[a1]

    def gen_fringe(self, blvecs, s=None, zen=None, az=None, conj=False,
                   freqs=None):
        """Fringe exp(2 pi i f b.s / c), (Nbls, Nfreqs, Npix), on blvecs'
        device in its precision (complex), through ops/phase.py's
        reduced phase; differentiable in blvecs.

        blvecs (Nbls, 3) [m]; s (3, Npix) unit pointing vectors (a tensor
        or an array), or zen, az (Npix,) [deg] from which s is formed on
        the device, (sin zen sin az, sin zen cos az, cos zen); conj
        conjugates; freqs [Hz] overrides the array's."""
        dev, rdt = blvecs.device, blvecs.dtype
        if s is None:
            zr = torch.as_tensor(zen, dtype=rdt, device=dev) * D2R
            ar = torch.as_tensor(az, dtype=rdt, device=dev) * D2R
            s = torch.stack([torch.sin(zr) * torch.sin(ar),
                             torch.sin(zr) * torch.cos(ar), torch.cos(zr)])
        else:
            s = torch.as_tensor(s, dtype=rdt, device=dev)
        f = self.freqs if freqs is None \
            else np.asarray(freqs, dtype=np.float64)
        tau = (blvecs @ s) / C_MS                   # (Nbls, Npix)
        return fringe_phasor(tau, f, conj=conj).movedim(-1, 1)

    @staticmethod
    def s_vector(zen, az):
        """Host unit pointing vectors (3, Npix) from zen/az [deg]:
        (sin zen sin az, sin zen cos az, cos zen), az East of North."""
        zr = np.asarray(zen, dtype=np.float64) * D2R
        ar = np.asarray(az, dtype=np.float64) * D2R
        return np.stack([np.sin(zr) * np.sin(ar),
                         np.sin(zr) * np.cos(ar),
                         np.cos(zr)])

    def get_bls(self, uniq_bls=False, keep_autos=True, min_len=None,
                max_len=None, min_EW=None, max_EW=None, min_NS=None,
                max_NS=None, min_deg=None, max_deg=None, xants=None):
        """Baselines, optionally one per redundant group, with cuts on
        length, |E| and |N| extent [m], angle [deg, 0-180) and excluded
        antennas."""
        source = [r[0] for r in self.reds] if uniq_bls else list(self.bls)
        a1, a2 = self.bl_index(source)
        v = self._antvecs_np[a2] - self._antvecs_np[a1]
        ln = np.linalg.norm(v, axis=1)
        keep = np.ones(len(source), dtype=bool)
        if not keep_autos:
            keep &= a1 != a2
        if xants is not None:
            xs = set(xants)
            keep &= np.asarray([bl[0] not in xs and bl[1] not in xs
                                for bl in source])
        for lo, hi, val in ((min_len, max_len, ln),
                            (min_EW, max_EW, np.abs(v[:, 0])),
                            (min_NS, max_NS, np.abs(v[:, 1]))):
            if lo is not None:
                keep &= val >= lo
            if hi is not None:
                keep &= val <= hi
        if min_deg is not None or max_deg is not None:
            ang = np.arctan2(v[:, 1], v[:, 0]) * R2D
            ang = np.where(v[:, 1] < 0, ang + 180.0, ang)
            if min_deg is not None:
                keep &= ang >= min_deg
            if max_deg is not None:
                keep &= ang <= max_deg
        return [bl for bl, k in zip(source, keep) if k]


def match_red_blvec(red_vecs, bl_vec, redtol=1.0, return_conj=False):
    """Index of the redundant group whose vector is within redtol of
    bl_vec, else None. return_conj=True also tries the negated vector
    and returns (index, conjugated), index -1 when neither matches."""
    red_vecs = np.asarray([np.asarray(v) for v in red_vecs])
    bl_vec = np.asarray(bl_vec)
    d = np.linalg.norm(red_vecs - bl_vec, axis=-1)
    i = int(np.argmin(d))
    if not return_conj:
        return i if d[i] <= redtol else None
    if d[i] <= redtol:
        return i, False
    d2 = np.linalg.norm(red_vecs + bl_vec, axis=-1)
    j = int(np.argmin(d2))
    if d2[j] <= redtol:
        return j, True
    return -1, False
