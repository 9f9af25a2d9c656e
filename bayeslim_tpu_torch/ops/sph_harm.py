"""
Spherical harmonics and spherical Fourier-Bessel transforms: the
Legendre bases, the Ylm design matrix and the a_lm -> map transform; the
radial Bessel bases and the t_lmn -> a_lm(freq) transform.

Counterpart of bayeslim_tpu/ops/sph_harm.py (gen_lm :41, legendre_func
:52, _bc_residual :85, compute_lm :112, gen_sph2pix :166, inflate_Ylm
:232, normalize_Ylm :239, write_Ylm :263, load_Ylm :293, AlmModel :403,
sph_bessel_func :672, sph_bessel_kln :709, gen_bessel2freq :758,
SFBModel :809, sfb_binning :886).

- The Legendre functions are host numpy in float64, computed once per
  unique colatitude (a HEALPix map has 4 nside - 1 rings). Integer
  degrees on the full sphere with high_prec=False take the orthonormal
  three-term recurrence (_sphere_legendre), which stays finite at any
  degree; everything else goes through special.Plm / Qlm as the JAX
  package does.
- The Ylm (Ncoeff, Npix) is assembled on the device, a block of rows at
  a time: the host sends the Legendre table H (Ncoeff, Nring) in float64,
  each pixel's ring and its phi; the device forms H[:, ring] e^{i m phi}
  in float64 and casts the block to the working dtype. No full-size
  complex128 array is made, on the host or on the device.
- AlmModel.forward_alm is one matrix product against the Ylm (two for a
  separable (Theta, Phi) pair), in true fp32 (TF32 off) forward and
  backward (_YlmProduct); the backward reads the Ylm transposed and
  makes no copy of it.
- The radial bases are host numpy in float64: sph_bessel_kln bisects
  every root of one l at once, with the scalar loop's midpoints and
  comparisons (the same bits); gen_bessel2freq builds one l's columns in
  one call and runs the l on threads. SFBModel.forward is one batched
  product against the zero-padded stack of the per-l matrices, in true
  fp32 both ways (_GlnProduct); forward_plain keeps the per-l loop.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.dtypes import _float, resolve_device, viewcomp
from ..utils.module import Module
from . import special
from .linalg import dual_active
from .rime_cuda import no_tf32

__all__ = [
    "gen_lm", "compute_lm", "legendre_func", "gen_sph2pix",
    "normalize_Ylm", "write_Ylm", "load_Ylm", "AlmModel", "inflate_Ylm",
    "gen_bessel2freq", "sph_bessel_func", "sph_bessel_kln", "SFBModel",
    "sfb_binning",
]

# float64 elements of one row block while the Ylm is assembled (each of
# the few temporaries of a block holds this many)
YLM_BLOCK_ELEMS = 1 << 24


def _cdtype(dtype):
    return torch.complex64 if dtype in (torch.float32, torch.complex64) \
        else torch.complex128


def _rdtype(dtype):
    return torch.float32 if dtype in (torch.float32, torch.complex64) \
        else torch.float64


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError("write_Ylm / load_Ylm need h5py") from err
    return h5py


def gen_lm(lmax, real_field=True):
    """(2, Ncoeff) array of (l, m) in healpy's a_lm order (m outer);
    m >= 0 only for a real field."""
    lms = []
    lowm = 0 if real_field else -lmax
    for m in range(lowm, lmax + 1):
        for l in range(lmax + 1):
            if abs(m) <= l:
                lms.append([l, m])
    return np.asarray(lms).T


def _sphere_legendre(l, m, x):
    """Orthonormal associated Legendre functions
    sqrt((2l+1)/(4pi) (l-|m|)!/(l+|m|)!) P_l^|m|(x), Condon-Shortley
    phase included, times (-1)^|m| for m < 0 (scipy.special.lpmv's
    convention times the orthonormalisation): (Ncoeff, Nx) float64 for
    integer l >= |m|.

    Per |m|: the sectoral seed P_m^m = (-1)^m sqrt((2m+1)/(4pi)
    prod_k (2k-1)/(2k)) s^m (s = sqrt(1 - x^2)) as a running product
    whose s^m is kept apart as a log scale, then P_{m+1}^m = x
    sqrt(2m+3) P_m^m, then P_l^m = a_lm (x P_{l-1}^m - P_{l-2}^m /
    a_{l-1,m}), a_lm = sqrt((4l^2-1)/(l^2-m^2)). The recurrence runs on
    the values divided by s^m, which stay below ~1e80 up to l = 383, and
    the scale is put back by exp(log|value| + m log s): a value below
    float64's range underflows to 0, nothing overflows. All |m| advance
    together, step k computing l = |m| + k.
    """
    l = np.asarray(l, dtype=np.int64).ravel()
    m = np.asarray(m, dtype=np.int64).ravel()
    am = np.abs(m)
    x = np.asarray(x, dtype=np.float64).ravel()
    if np.any(am > l):
        raise ValueError("need |m| <= l")
    out = np.zeros((len(l), len(x)))
    if len(l) == 0:
        return out
    ms = np.unique(am)
    L = int(l.max())
    mi = np.searchsorted(ms, am)
    # output rows by k = l - |m|
    kr = l - am
    order = np.argsort(kr, kind="stable")
    bounds = np.searchsorted(kr[order], np.arange(L + 2))
    s = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    with np.errstate(divide="ignore"):
        logs = np.log(s)
    mf = ms.astype(np.float64)[:, None]
    logscale = np.where(mf == 0, 0.0, mf * logs[None, :])
    # the sectoral seeds' mantissas
    kk = np.arange(1, ms.max() + 1, dtype=np.float64)
    prod = np.concatenate([[1.0], np.cumprod((2 * kk - 1) / (2 * kk))])
    seed = (-1.0) ** ms * np.sqrt((2 * ms + 1) / (4 * np.pi) * prod[ms])
    p_prev = np.zeros((len(ms), len(x)))
    p_cur = np.repeat(seed[:, None], len(x), axis=1)

    def emit(k, vals):
        rows = order[bounds[k]:bounds[k + 1]]
        if len(rows):
            j = mi[rows]
            with np.errstate(divide="ignore", under="ignore"):
                out[rows] = np.sign(vals[j]) * np.exp(
                    np.log(np.abs(vals[j])) + logscale[j])
    emit(0, p_cur)
    for k in range(1, L + 1 - int(ms.min())):
        lv = ms.astype(np.float64)[:, None] + k
        if k == 1:
            nxt = x[None, :] * np.sqrt(2 * mf + 3) * p_cur
        else:
            a = np.sqrt((4 * lv ** 2 - 1) / (lv ** 2 - mf ** 2))
            a1 = np.sqrt((4 * (lv - 1) ** 2 - 1) / ((lv - 1) ** 2 - mf ** 2))
            nxt = a * (x[None, :] * p_cur - p_prev / a1)
        nxt[ms + k > L] = 0.0
        p_prev, p_cur = p_cur, nxt
        emit(k, p_cur)
    neg = (m < 0) & (am % 2 == 1)
    out[neg] *= -1.0
    return out


def legendre_func(x, l, m, method, x_crit=None, high_prec=True, bc_type=2,
                  deriv=False):
    """The Legendre basis H = P (+ A Q for a stripe), before the e^{i m
    phi} phase. For 'stripe' the coefficient A is set by the boundary
    condition at x_crit (bc_type 1: H = 0; 2: dH/dtheta = 0), and the
    (1-x^2)^{-m/2} factor is left out of the P + A Q sum (cancellation)
    and put back after."""
    P = special.Plm(l, m, x, high_prec=high_prec, keepdims=True, deriv=deriv,
                    sq_norm=method != "stripe")
    if method != "stripe":
        return P
    assert x_crit is not None
    Q = special.Qlm(l, m, x, high_prec=high_prec, keepdims=True, deriv=deriv,
                    sq_norm=False)
    A = -special.Plm(l, m, x_crit, high_prec=high_prec, keepdims=True,
                     deriv=bc_type == 2, sq_norm=False) \
        / special.Qlm(l, m, x_crit, high_prec=high_prec, keepdims=True,
                      deriv=bc_type == 2, sq_norm=False)
    H = P + A * Q
    # zero what is left of a catastrophic cancellation
    H2 = np.abs(P) + np.abs(A * Q)
    with np.errstate(divide="ignore", invalid="ignore"):
        H[np.abs(H / H2) < 1e-10] = 0.0
    m_arr = np.atleast_1d(np.asarray(m, dtype=float))
    if m_arr.ndim == 1:
        m_arr = m_arr[:, None]
    return H * (1 - x ** 2).clip(1e-40) ** (-m_arr / 2)


def _bc_residual(l, m, theta_min, theta_max, method, bc_type, high_prec):
    """Boundary-condition residual at the far boundary for degree l."""
    if method == "cap":
        x = np.cos(np.atleast_1d(theta_max))
        # bc_type 1 still takes the derivative condition for m == 0
        deriv = bc_type == 2 or np.isclose(float(np.asarray(m).flat[0]), 0)
        if deriv:
            return special.Plm(l, m, x, deriv=True, high_prec=high_prec,
                               keepdims=True)[:, 0]
        return special.Plm(l, m, x, high_prec=high_prec, keepdims=True)[:, 0]
    # stripe: the Wronskian form P(x_min) Q(x_max) - P(x_max) Q(x_min),
    # which has no poles where Q(x_min) = 0 (the A form does, and a
    # bracketing search takes a pole's sign flip for a root)
    x_min = np.cos(np.atleast_1d(theta_min))
    x = np.cos(np.atleast_1d(theta_max))
    kw = dict(high_prec=high_prec, keepdims=True, sq_norm=False,
              deriv=bc_type == 2)
    res = (special.Plm(l, m, x_min, **kw) * special.Qlm(l, m, x, **kw)
           - special.Plm(l, m, x, **kw) * special.Qlm(l, m, x_min, **kw))
    return res[:, 0]


def compute_lm(phi_max, mmax, theta_min, theta_max, lmax, dl=0.1, mmin=0,
               high_prec=True, add_mono=True, add_sectoral=True, bc_type=2,
               real_field=True, Nrefine_iter=30, refine_dl=None, **kwargs):
    """Non-integer degrees l that meet the polar boundary conditions of a
    spherical cap (theta_min == 0) or stripe.

    Azimuthal continuity Phi(0) = Phi(phi_max) quantises m = 2 pi k /
    phi_max. For each m, l is scanned over [m, lmax] in steps of dl, sign
    changes of the boundary residual are bracketed and refined by
    bisection. Returns (l, m) float arrays sorted by (m, l).
    """
    method = "cap" if np.isclose(theta_min, 0) else "stripe"
    dm = 2 * np.pi / phi_max
    ms = np.arange(max(mmin, 0), mmax + 1e-9, dm)

    out_l, out_m = [], []
    for m in ms:
        lgrid = np.arange(max(m, 1e-3), lmax + dl, dl)
        if len(lgrid) < 2:
            continue
        res = _bc_residual(lgrid[:, None], np.full((len(lgrid), 1), m),
                           theta_min, theta_max, method, bc_type, high_prec)
        sign_change = np.where(np.sign(res[:-1]) * np.sign(res[1:]) < 0)[0]
        for i in sign_change:
            lo, hi = lgrid[i], lgrid[i + 1]
            flo = res[i]
            for _ in range(Nrefine_iter):
                mid = 0.5 * (lo + hi)
                fmid = _bc_residual(np.asarray([[mid]]), np.asarray([[m]]),
                                    theta_min, theta_max, method, bc_type,
                                    high_prec)[0]
                if np.sign(fmid) == np.sign(flo):
                    lo, flo = mid, fmid
                else:
                    hi = mid
                if hi - lo < 1e-9:
                    break
            out_l.append(0.5 * (lo + hi))
            out_m.append(m)
    if add_mono and mmin == 0:
        out_l.insert(0, 0.0)
        out_m.insert(0, 0.0)
    if add_sectoral:
        for m in ms:
            if m > 0 and not np.any(np.isclose(out_m, m) &
                                    np.isclose(out_l, m)):
                out_l.append(float(m))
                out_m.append(float(m))
    order = np.lexsort((out_l, out_m))
    return np.asarray(out_l)[order], np.asarray(out_m)[order]


def _assemble(H, ring, m, phi, real, device, dtype):
    """H[:, ring] e^{i m phi} (its real part if real) as a (Ncoeff, Npix)
    tensor of dtype (real) or its complex counterpart on device, formed
    in float64 on the device a block of rows at a time."""
    ncoeff, npix = H.shape[0], len(ring)
    Hd = torch.as_tensor(H, dtype=torch.float64, device=device)
    ringd = torch.as_tensor(ring, dtype=torch.int64, device=device)
    phid = torch.as_tensor(phi, dtype=torch.float64, device=device)
    md = torch.as_tensor(m, dtype=torch.float64, device=device)
    Y = torch.empty((ncoeff, npix), device=device,
                    dtype=_rdtype(dtype) if real else _cdtype(dtype))
    Yr = Y if real else torch.view_as_real(Y)
    rows = max(1, YLM_BLOCK_ELEMS // max(npix, 1))
    for r0 in range(0, ncoeff, rows):
        r1 = min(r0 + rows, ncoeff)
        Hc = Hd[r0:r1].index_select(1, ringd)
        ang = md[r0:r1, None] * phid[None, :]
        if real:
            Yr[r0:r1] = Hc * torch.cos(ang)
        else:
            Yr[r0:r1, :, 0] = Hc * torch.cos(ang)
            Yr[r0:r1, :, 1] = Hc * torch.sin(ang)
    return Y


def gen_sph2pix(theta, phi, l, m, separable=False, method="sphere",
                theta_crit=None, high_prec=True, bc_type=2, real=False,
                m_phasor=False, renorm=False, device=None, dtype=None,
                **norm_kwargs):
    """Spherical-harmonic design matrix Ylm (Ncoeff, Npix) at colatitudes
    theta and azimuths phi [rad]:

        Y_lm = sqrt((2l+1)/(4pi) (l-m)!/(l+m)!) e^{i m phi}
               (P + A Q)(cos theta).

    method 'sphere' with integer modes and high_prec=False takes the
    orthonormal recurrence (finite at any degree); 'cap' / 'stripe' and
    non-integer degrees take special.Plm / Qlm (mpmath when high_prec).
    real: the real part (a real basis); m_phasor: an extra e^{i phi};
    renorm: rows normalised by normalize_Ylm(**norm_kwargs). The matrix
    is a tensor of dtype (default float32) or its complex counterpart on
    device (default CUDA).

    Returns (Ylm, norm, alm_mult): if separable, theta and phi are the
    axes of a grid and Ylm = (Theta (Ncoeff, Ntheta), Phi (Ncoeff,
    Nphi)); alm_mult doubles the m > 0 modes of an m >= 0 basis (the
    missing -m half of a real map), and m = 0 too with m_phasor.
    """
    device = resolve_device(device)
    dtype = dtype or _float()
    l = np.atleast_1d(np.asarray(l, dtype=float))[:, None]
    m = np.atleast_1d(np.asarray(m, dtype=float))[:, None]
    theta = np.atleast_1d(np.asarray(theta, dtype=float))
    phi = np.atleast_1d(np.asarray(phi, dtype=float))

    unq_theta, unq_idx = np.unique(theta, return_inverse=True)
    x = np.cos(unq_theta)
    if method == "sphere" and theta_crit is None:
        theta_crit = np.pi
    assert theta_crit is not None
    x_crit = np.cos(theta_crit)

    if method == "sphere" and not high_prec and \
            np.allclose(l % 1, 0) and np.allclose(m % 1, 0):
        H = _sphere_legendre(np.rint(l), np.rint(m), x)
    else:
        H = legendre_func(x, l, m, method, x_crit=x_crit,
                          high_prec=high_prec, bc_type=bc_type)
    mph = m[:, 0] + (1.0 if m_phasor else 0.0)

    if separable:
        T = torch.as_tensor(H[:, unq_idx], device=device,
                            dtype=_rdtype(dtype) if real else _cdtype(dtype))
        Y = (T, _assemble(np.ones((len(mph), 1)), np.zeros(len(phi), int),
                          mph, phi, real, device, dtype))
    else:
        Y = _assemble(H, unq_idx.ravel(), mph, phi, real, device, dtype)

    if renorm:
        norm_kwargs.setdefault("theta", theta)
        Y, norm = normalize_Ylm(Y, **norm_kwargs)
    else:
        norm = torch.ones(len(l), dtype=_rdtype(dtype), device=device)

    alm_mult = np.ones(len(l))
    if not np.any(m < 0) and not real:
        alm_mult[m.ravel() > 0] *= 2
    if m_phasor and not real:
        alm_mult[np.isclose(m.ravel(), 0)] *= 2
    return Y, norm, torch.as_tensor(alm_mult, dtype=_rdtype(dtype),
                                    device=device)


def inflate_Ylm(Ylm):
    """Separable (Theta, Phi) pair -> the full Ylm (Ncoeff,
    Ntheta * Nphi)."""
    T, P = Ylm
    return (T[:, :, None] * P[:, None, :]).reshape(T.shape[0], -1)


def normalize_Ylm(Ylm, norm=None, theta=None, dtheta=None, dphi=None,
                  hpix=True, pxarea=None, renorm_idx=None):
    """Normalise the Ylm rows by their numerical inner product
    sum |Y|^2 w over the pixels (renorm_idx: those pixels only), w the
    pixel area (hpix) or sin(theta) dtheta dphi. Returns (Ylm, norm)."""
    sep = isinstance(Ylm, (list, tuple))
    if norm is None:
        Y = inflate_Ylm(Ylm) if sep else Ylm
        rdt = _rdtype(Y.dtype)
        if renorm_idx is None:
            renorm_idx = slice(None)
        if hpix:
            w = torch.as_tensor(pxarea if pxarea is not None else 1.0,
                                dtype=rdt, device=Y.device)
        elif theta is not None and dtheta is not None and dphi is not None:
            if sep:
                theta = np.repeat(np.atleast_1d(theta)[:, None],
                                  Ylm[1].shape[1], 1).ravel()
            w = torch.as_tensor(np.sin(theta) * dtheta * dphi, dtype=rdt,
                                device=Y.device)
        else:
            w = torch.ones((), dtype=rdt, device=Y.device)
        norm = torch.sqrt(torch.sum((torch.abs(Y) ** 2 * w)[:, renorm_idx],
                                    dim=1))
    if sep:
        return (Ylm[0] / norm[:, None], Ylm[1]), norm
    return Ylm / norm[:, None], norm


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_Ylm(fname, Ylm, angs, l, m, norm=None, alm_mult=None,
              overwrite=False, **extra):
    """Store a Ylm (or a separable (Theta, Phi) pair) with its angles and
    modes in an HDF5 file, the JAX package's layout: datasets Ylm (or
    Theta and Phi), angs, l, m, optional norm and alm_mult; extra
    arrays as datasets, extra scalars as attributes."""
    h5py = _h5py()
    if os.path.exists(fname) and not overwrite:
        raise FileExistsError(fname)
    with h5py.File(fname, "w") as f:
        if isinstance(Ylm, (list, tuple)):
            f.create_dataset("Theta", data=_host(Ylm[0]))
            f.create_dataset("Phi", data=_host(Ylm[1]))
        else:
            f.create_dataset("Ylm", data=_host(Ylm))
        f.create_dataset("angs", data=_host(angs))
        f.create_dataset("l", data=_host(l))
        f.create_dataset("m", data=_host(m))
        if norm is not None:
            f.create_dataset("norm", data=_host(norm))
        if alm_mult is not None:
            f.create_dataset("alm_mult", data=_host(alm_mult))
        for k, v in extra.items():
            if v is None:
                continue
            if np.ndim(v) == 0 and not isinstance(v, np.ndarray):
                f.attrs[k] = v
            else:
                f.create_dataset(k, data=_host(v))


def load_Ylm(fname, lmin=None, lmax=None, discard=None, cast=None,
             colat_min=None, colat_max=None, az_min=None, az_max=None,
             discard_sectoral=False, discard_mono=False, decimate_m=None,
             read_data=True, to_real=False, device=None):
    """Load a stored Ylm with mode and sky cuts. Returns a dict: Ylm
    (a tensor, or a (Theta, Phi) pair), angs, l, m (numpy), and alm_mult
    / norm / D / Dinv / pxarea when stored, info (the attributes) and idx
    (the kept modes).

    Mode cuts: lmin / lmax, discard ((2, Nlm) modes to drop),
    discard_sectoral (l == m > 0), discard_mono (l == m == 0),
    decimate_m (keep m % decimate_m == 0). Sky cuts (a dense Ylm only):
    colat / az ranges [deg] on angs = (colat, az). to_real keeps the real
    part of a complex Ylm and resets alm_mult to 1; cast is a numpy
    dtype for the matrices. Arrays other than l and m become tensors on
    device (default CUDA)."""
    h5py = _h5py()
    device = resolve_device(device)
    out = {}
    with h5py.File(fname, "r") as f:
        for k in f:
            out[k] = np.asarray(f[k][:])
        out["info"] = {p: f.attrs[p] for p in f.attrs}

    l, m = np.asarray(out["l"], float), np.asarray(out["m"], float)
    keep = np.ones(len(l), dtype=bool)
    if lmin is not None:
        keep &= l >= lmin
    if lmax is not None:
        keep &= l <= lmax + 1e-5
    if discard is not None:
        cut_l, cut_m = discard
        for cl, cm in zip(np.atleast_1d(cut_l), np.atleast_1d(cut_m)):
            keep &= ~(np.isclose(l, cl, atol=1e-6)
                      & np.isclose(m, cm, atol=1e-6))
    if discard_sectoral:
        keep &= ~((l == m) & (l > 0))
    if discard_mono:
        keep &= ~((l == 0) & (m == 0))
    if decimate_m is not None:
        keep &= (m.astype(int) % decimate_m) == 0
    idx = np.where(keep)[0]
    out["l"], out["m"] = l[idx], m[idx]
    for k in ("alm_mult", "norm", "Ylm", "Theta", "Phi"):
        if k in out:
            out[k] = out[k][idx]
    for k in ("D", "Dinv"):
        if k in out:
            out[k] = out[k][np.ix_(idx, idx)]

    if "angs" in out and "Theta" not in out:
        colat, az = np.asarray(out["angs"][0]), np.asarray(out["angs"][1])
        pkeep = np.ones(len(colat), dtype=bool)
        if colat_min is not None:
            pkeep &= colat >= colat_min
        if colat_max is not None:
            pkeep &= colat <= colat_max
        if az_min is not None:
            pkeep &= az >= az_min
        if az_max is not None:
            pkeep &= az <= az_max
        if not pkeep.all():
            out["angs"] = np.stack([colat[pkeep], az[pkeep]])
            if "Ylm" in out:
                out["Ylm"] = out["Ylm"][:, pkeep]
            if "pxarea" in out and np.ndim(out["pxarea"]) > 0:
                out["pxarea"] = out["pxarea"][pkeep]

    if to_real:
        for k in ("Ylm", "Theta", "Phi"):
            if k in out and np.iscomplexobj(out[k]):
                out[k] = out[k].real.copy()
        if "alm_mult" in out:
            out["alm_mult"] = np.ones_like(np.real(out["alm_mult"]))

    if not read_data:
        for k in ("Ylm", "Theta", "Phi", "D", "Dinv"):
            out.pop(k, None)
    if cast is not None:
        for k in ("Ylm", "Theta", "Phi", "D", "Dinv", "pxarea"):
            if k in out:
                out[k] = np.asarray(out[k]).astype(cast)
    out = {k: (torch.as_tensor(v, device=device)
               if isinstance(v, np.ndarray) and k not in ("l", "m") else v)
           for k, v in out.items()}
    if "Theta" in out:
        out["Ylm"] = (out.pop("Theta"), out.pop("Phi"))
    out["idx"] = idx
    return out


def _cubic_interp1d(xs, ys, xq):
    """Cubic (Catmull-Rom) interpolation of ys on the uniform grid xs at
    xq, on the host; the end values are repeated beyond the grid."""
    xs, ys, xq = map(np.asarray, (xs, ys, xq))
    dx = xs[1] - xs[0]
    t = np.clip((xq - xs[0]) / dx, 0, len(xs) - 1)
    i = np.clip(t.astype(int), 0, len(xs) - 2)
    f = t - i
    yp = np.pad(ys, 1, mode="edge")
    y0, y1, y2, y3 = yp[i], yp[i + 1], yp[i + 2], yp[i + 3]
    a = -0.5 * y0 + 1.5 * y1 - 1.5 * y2 + 0.5 * y3
    b = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    c = 0.5 * (y2 - y0)
    return ((a * f + b) * f + c) * f + y1


class AlmModel(Module):
    """a_lm -> map transform: forward_alm(params (..., Ncoeff)) ->
    (..., Npix), one matrix product against the Ylm (Ncoeff, Npix), or
    two against a separable (Theta, Phi) pair. Several grids can be
    evaluated and concatenated along Npix (add_grid /
    setup_multigrid_forward).

    The Ylm and alm_mult are buffers (the Ylm property reads the pair of
    a separable one). Generated Ylm are cached by the content of their
    theta and phi. device / dtype: where and in what precision
    generate_Ylm builds the Ylm (default CUDA, float32).
    """

    def __init__(self, l, m, real_output=False, LM=None, name=None,
                 device=None, dtype=None):
        super().__init__(name=name)
        self.l = np.asarray(l)
        self.m = np.asarray(m)
        self.real_output = real_output
        self.LM = LM
        self.device = device
        self.dtype = dtype
        self.register_buffer("_Ylm", None)
        self.register_buffer("_Ylm_phi", None)
        self.register_buffer("alm_mult", None)
        self.separable = False
        self.grids = None          # list of (Ylm, alm_mult, separable)
        self.grid_idx = None       # optional reindex after the concat
        self._grid_idx_dev = None
        self._ylm_cache = {}

    @property
    def Ncoeff(self):
        return len(self.l)

    @property
    def Ylm(self):
        if self._Ylm_phi is not None:
            return (self._Ylm, self._Ylm_phi)
        return self._Ylm

    @Ylm.setter
    def Ylm(self, Y):
        if isinstance(Y, (list, tuple)):
            self._Ylm, self._Ylm_phi = Y[0], Y[1]
        else:
            self._Ylm, self._Ylm_phi = Y, None

    def _set_alm_mult(self, alm_mult):
        if alm_mult is not None and not torch.is_tensor(alm_mult):
            ref = self._Ylm
            alm_mult = torch.as_tensor(
                np.asarray(alm_mult), device=None if ref is None
                else ref.device, dtype=None if ref is None
                else _rdtype(ref.dtype))
        self.alm_mult = alm_mult

    @staticmethod
    def setup_angs(theta, phi, separable=False):
        """The grid's points (theta, phi), flattened, if separable."""
        if separable:
            phi_arr, theta_arr = np.meshgrid(phi, theta, copy=False)
            return theta_arr.ravel(), phi_arr.ravel()
        return theta, phi

    def setup_Ylm(self, Ylm_or_theta, phi=None, Ylm=None, alm_mult=None,
                  separable=None, generate=False, cache=True, h=None,
                  **kwargs):
        """Attach a transform matrix: setup_Ylm(Ylm, alm_mult=...) with a
        tensor or a (Theta, Phi) pair, or setup_Ylm(theta, phi, Ylm=None,
        generate=True, cache=True, h=None, **gen_kwargs) with angles in
        degrees, which generates the Ylm when none is given (through the
        cache) and stores it in the cache."""
        if phi is None:
            self.Ylm = Ylm_or_theta
            self._set_alm_mult(alm_mult)
            self.separable = isinstance(Ylm_or_theta, (list, tuple)) \
                if separable is None else separable
            return
        theta = np.asarray(Ylm_or_theta, dtype=np.float64)
        phi = np.asarray(phi, dtype=np.float64)
        sep = bool(separable)
        if sep:
            self.theta_grid, self.phi_grid = theta, phi
            self.theta, self.phi = self.setup_angs(theta, phi, True)
        else:
            self.theta, self.phi = theta, phi
        if Ylm is None and generate:
            Ylm, alm_mult = self.get_Ylm(theta, phi, separable=sep, h=h,
                                         **kwargs)
        self.Ylm = Ylm
        self._set_alm_mult(alm_mult)
        self.separable = sep
        if cache and Ylm is not None:
            self.set_Ylm(Ylm, (theta, phi), alm_mult=self.alm_mult, h=h)

    # --- the Ylm cache, keyed by the content of theta and phi --------
    @staticmethod
    def _ang_hash(theta, phi, h=None):
        if h is not None:
            return h
        return hash((np.asarray(theta, dtype=np.float64).tobytes(),
                     np.asarray(phi, dtype=np.float64).tobytes()))

    def set_Ylm(self, Ylm, angs, alm_mult=None, h=None):
        """Store a Ylm under its angles angs = (theta, phi) [deg]."""
        self._ylm_cache[self._ang_hash(angs[0], angs[1], h)] = (Ylm, alm_mult)

    def get_Ylm(self, theta, phi, separable=False, h=None, **kwargs):
        """(Ylm, alm_mult) of these angles [deg] from the cache;
        generated (gen_sph2pix(**kwargs)), attached and cached on a
        miss."""
        key = self._ang_hash(theta, phi, h)
        if key not in self._ylm_cache:
            self.generate_Ylm(np.radians(theta), np.radians(phi),
                              separable=separable, **kwargs)
            self._ylm_cache[key] = (self.Ylm, self.alm_mult)
        return self._ylm_cache[key]

    def clear_Ylm_cache(self):
        """Drop the Ylm cache."""
        self._ylm_cache.clear()

    def select(self, lm=None, lmin=None, lmax=None, mmin=None, mmax=None,
               other=None, atol=1e-10):
        """Keep a subset of the modes, in place: l, m, the attached Ylm
        (separable or not, and every grid's) and alm_mult. Returns the
        boolean mask over the modes before the cut."""
        s = np.ones(len(self.l), dtype=bool)
        if other is not None:
            s &= np.asarray(other)
        if lm is not None:
            keep = []
            for _l, _m in zip(self.l, self.m):
                keep.append(any(np.isclose(_l, l2, atol=atol)
                                and np.isclose(_m, m2, atol=atol)
                                for l2, m2 in zip(*lm)))
            s &= np.asarray(keep)
        if lmin is not None:
            s &= self.l >= lmin
        if lmax is not None:
            s &= self.l <= lmax
        if mmin is not None:
            s &= self.m >= mmin
        if mmax is not None:
            s &= self.m <= mmax
        idx = np.where(s)[0]

        def rows(Y):
            if Y is None:
                return None
            if isinstance(Y, (tuple, list)):
                return (rows(Y[0]), rows(Y[1]))
            return Y.index_select(0, torch.as_tensor(idx, device=Y.device))

        self.l = self.l[s]
        self.m = self.m[s]
        self.Ylm = rows(self.Ylm)
        self.alm_mult = rows(self.alm_mult)
        if self.grids is not None:
            self.grids = [(rows(Y), rows(am), sep)
                          for Y, am, sep in self.grids]
        return s

    def generate_Ylm(self, theta, phi, separable=False, **kwargs):
        """Generate (gen_sph2pix) and attach the Ylm of angles [rad] on
        this model's device and dtype. Returns (Ylm, norm, alm_mult)."""
        kwargs.setdefault("device", self.device)
        kwargs.setdefault("dtype", self.dtype)
        Y, norm, am = gen_sph2pix(theta, phi, self.l, self.m,
                                  separable=separable, **kwargs)
        self.setup_Ylm(Y, alm_mult=am, separable=separable)
        return Y, norm, am

    def add_grid(self, Ylm, alm_mult=None):
        """Append a grid to evaluate (outputs concatenated along Npix)."""
        if self.grids is None:
            self.grids = []
        self.grids.append((Ylm, alm_mult, isinstance(Ylm, (list, tuple))))

    def set_grid_index(self, idx):
        """Reindex the concatenated grids' output (None: no reindex)."""
        self.grid_idx = None if idx is None else np.asarray(idx)
        self._grid_idx_dev = None

    def setup_multigrid_forward(self, thetas, phis, Ylms, alm_mults,
                                idx=None):
        """Attach several Ylm at distinct (theta, phi) [deg] grids:
        forward_alm evaluates each and concatenates them along Npix, then
        reindexes by idx. Each grid is also cached."""
        self.grids = []
        for th, ph, Y, a in zip(thetas, phis, Ylms, alm_mults):
            self.add_grid(Y, alm_mult=a)
            self.set_Ylm(Y, (np.asarray(th), np.asarray(ph)), alm_mult=a)
        self.set_grid_index(idx)

    def clear_multigrid(self):
        """Drop the grids."""
        self.grids = None
        self.set_grid_index(None)

    def forward_alm(self, params, Ylm=None, alm_mult=None, ignoreLM=False):
        """a_lm (..., Ncoeff) -> map (..., Npix); real pairs (...,
        Ncoeff, 2) are read as complex against a complex Ylm."""
        if self.LM is not None and not ignoreLM:
            params = self.LM(params)

        if Ylm is None and self.grids is not None:
            out = torch.cat([self.forward_alm(params, Ylm=Y, alm_mult=am,
                                              ignoreLM=True)
                             for (Y, am, _) in self.grids], dim=-1)
            if self.grid_idx is not None:
                if self._grid_idx_dev is None \
                        or self._grid_idx_dev.device != out.device:
                    self._grid_idx_dev = torch.as_tensor(
                        self.grid_idx, device=out.device)
                out = out.index_select(-1, self._grid_idx_dev)
            return out

        if Ylm is None:
            Ylm, alm_mult = self.Ylm, self.alm_mult
        separable = isinstance(Ylm, (list, tuple))
        ref = Ylm[1] if separable else Ylm
        if ref.is_complex() and not params.is_complex():
            if params.shape[-1] == self.Ncoeff:
                params = params.to(_cdtype(params.dtype))
            else:
                params = viewcomp(params)
        if alm_mult is not None:
            params = params * alm_mult

        if separable:
            Theta, Phi = Ylm
            t = params[..., None, :] * _match(Theta, params).T
            out = _product(t, _match(Phi, params))
            out = out.reshape(out.shape[:-2] + (-1,))
        else:
            out = _product(params, _match(Ylm, params))
        if self.real_output:
            out = out.real
        return out

    def forward(self, params, **kwargs):
        return self.forward_alm(params, **kwargs)

    def taper_alm(self, alm, taper, comp_params=False, **kwargs):
        """Taper the a_lm with an l-dependent window: the window taper
        (models/fft.gen_window, kwargs) over 2 Ncoeff samples, its
        decaying half interpolated (Catmull-Rom) onto l / l_max,
        multiplies the last axis, or the one before it when a complex
        alm comes as real pairs (comp_params)."""
        from ..models.fft import _window
        N = len(self.l)
        win = _window(taper, N * 2, **kwargs)[N:]
        lfrac = np.asarray(self.l, dtype=float)
        lfrac = lfrac / lfrac.max() if lfrac.max() > 0 else lfrac
        w = _cubic_interp1d(np.linspace(0.0, 1.0, N, endpoint=True), win,
                            lfrac)
        w = torch.as_tensor(w, dtype=alm.real.dtype, device=alm.device)
        if comp_params and not alm.is_complex():
            return alm * w[:, None]
        return alm * w

    def make_closure(self, params, loss_fn, target, real=True):
        """loss() = loss_fn(forward_alm(params), target) (the real parts
        if real); loss(p) evaluates at other params p."""
        def closure(p=None):
            out = self.forward_alm(params if p is None else p)
            tgt = target
            if real:
                out, tgt = out.real, tgt.real
            return loss_fn(out, tgt)
        return closure

    def least_squares(self, y, Ninv=None, **kwargs):
        """Invert a map y (..., Npix) to a_lm by least squares against
        the Ylm (ops/linalg.least_squares), divided by alm_mult."""
        from .linalg import least_squares as _lsq
        Ylm = inflate_Ylm(self.Ylm) if self.separable else self.Ylm
        x, _ = _lsq(Ylm.T, y, dim=-1, Ninv=Ninv, **kwargs)
        if self.alm_mult is not None:
            x = x / self.alm_mult
        return x


def _match(Y, params):
    """Y in params' precision (a no-op on the main path, where both are
    float32 / complex64)."""
    want = _rdtype(params.dtype)
    if _rdtype(Y.dtype) == want:
        return Y
    return Y.to(_cdtype(want) if Y.is_complex() else want)


def _ylm_mm(a, Y):
    """a @ Y in true fp32."""
    with no_tf32():
        return a @ Y


def _ylm_mm_grad(g, Y):
    """a's gradient g Y^H of a @ Y, as conj(conj(g) @ Y^T) in true fp32:
    Y^T is a transposed view of Y, so no copy of Y is made."""
    with no_tf32():
        if Y.is_complex():
            return (g.conj() @ Y.T).conj()
        return g @ Y.T


class _YlmProduct(torch.autograd.Function):
    """a @ Y in true fp32 both ways (torch.matmul's own backward would
    run outside forward_alm's no_tf32 block): a's gradient g Y^H with no
    copy of Y, and Y's, a^H g summed over a's leading dimensions, only
    where Y takes one. The backward is itself differentiable; jvp is the
    product rule (both operands kept under forward-mode AD)."""

    @staticmethod
    def forward(ctx, a, Y):
        ctx.save_for_backward(a if Y.requires_grad else None, Y)
        if dual_active():
            ctx.save_for_forward(a, Y)
        return _ylm_mm(a, Y)

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, ta, tY):
        a, Y = ctx.saved_tensors
        out = None if ta is None else _ylm_mm(ta, Y)
        if tY is not None:
            o = _ylm_mm(a, tY)
            out = o if out is None else out + o
        return out

    @staticmethod
    def backward(ctx, g):
        a, Y = ctx.saved_tensors
        ga = _ylm_mm_grad(g, Y) if ctx.needs_input_grad[0] else None
        gY = None
        if ctx.needs_input_grad[1]:
            with no_tf32():
                gY = a.reshape(-1, a.shape[-1]).conj().T \
                    @ g.reshape(-1, g.shape[-1])
        return ga, gY


def _product(a, Y):
    """a @ Y; a complex a against a real Y as two real products (no
    complex copy of Y)."""
    if a.is_complex() and not Y.is_complex():
        return torch.complex(_product(a.real, Y), _product(a.imag, Y))
    if Y.is_complex() and not a.is_complex():
        a = a.to(Y.dtype)
    return _YlmProduct.apply(a, Y)


# ---------------------------------------------------------------------------
# spherical Fourier-Bessel (radial) transforms
# ---------------------------------------------------------------------------

# threads of gen_bessel2freq's per-l work (scipy's Bessel functions
# release the GIL while they run over an array)
SFB_THREADS = min(8, os.cpu_count() or 1)
# sph_bessel_kln scans its k grid at a coarse step first: at most this
# much of the functions' phase (k r_max for the ball, k (r_max - r_min)
# for the shell; the grid steps dk_factor of it), where their zeros lie
# ~pi apart
KLN_COARSE_RAD = 0.5


def sph_bessel_func(l, k, r, method="ball", kbin=None, r_crit=None,
                    deriv=False, bc_type=2, renorm=False):
    """Radial basis g_l(k r), (Nk, Nr): row i at k[i] and l[min(i, Nl -
    1)], all rows at once.

    method 'ball': g = j_l(kr); 'shell': g = j_l(kr) + A y_l(kr) for k >
    0, with A set by the boundary condition at r_crit: bc_type 1
    (Dirichlet, g = 0), 2 (Neumann, dg/dr = 0) or 3 (potential, l + 1
    modes); y_l is clipped below at -1e50. renorm scales each row so
    that the inner product of r g_l(k r) with itself is pi/2 k^-2.
    """
    l = np.atleast_1d(np.asarray(l, dtype=float))
    k = np.atleast_1d(np.asarray(k, dtype=float))
    r = np.atleast_1d(np.asarray(r, dtype=float))
    li = l[np.minimum(np.arange(len(k)), len(l) - 1)][:, None]
    kr = k[:, None] * r[None, :]
    g = special.jl(li, kr, deriv, keepdims=True)
    if method == "shell":
        assert r_crit is not None
        bderiv = bc_type == 2
        ell = li if bc_type < 3 else li + 1
        kc = k[:, None] * np.atleast_1d(r_crit)[0]
        with np.errstate(invalid="ignore", over="ignore"):
            yc = np.clip(special.yl(ell, kc, bderiv, keepdims=True),
                         -1e50, np.inf)
            A = -special.jl(ell, kc, bderiv, keepdims=True) / yc
            y = np.clip(special.yl(li, kr, deriv, keepdims=True), -1e50,
                        np.inf)
            g = np.where(k[:, None] > 0, g + A * y, g)
    if renorm:
        w = np.sqrt(np.pi / 2 * np.clip(k, 1e-4, None) ** -2
                    / np.sum(r ** 2 * np.abs(g) ** 2, axis=1))
        g = g * w[:, None]
    return g


def _kln_fn(r_min, r_max, method, bc_type):
    """The function f(l, k) whose roots in k sph_bessel_kln finds, of a
    2-D l against k element by element (special.jl's broadcasting)."""
    def jl(l, x):
        return special.jl(l, x, deriv=True, keepdims=True)

    def yl(l, x):
        return special.yl(l, x, deriv=True, keepdims=True)
    if method == "ball":
        return lambda l, k: special.jl(l, k * r_max, deriv=bc_type == 2,
                                       keepdims=True)

    def det(l, k):
        return (jl(l, k * r_min) * yl(l, k * r_max)
                - jl(l, k * r_max) * yl(l, k * r_min))
    return det


def _kln_roots(ls, r_min, r_max, kmax, method="ball", bc_type=2,
               dk_factor=5e-3):
    """sph_bessel_kln's roots of every l of ls, all at once: [(Nk,)].

    Each sign change of f(l, k) on the grid k = 1e-4 / r_max + i
    dk_factor / r_max is bisected 60 times, every sign change of every l
    at once, with the midpoints and comparisons of a scalar loop over
    them, so the roots are the same bits. The grid is scanned at a step
    of KLN_COARSE_RAD of phase first, then bisected by index inside each
    coarse interval whose ends differ in sign, down to the grid interval
    of the root: a scan of every point costs three Bessel functions a
    point, ~8e4 points an l at kmax r_max ~ 400.
    """
    ls = np.asarray(ls, dtype=float)
    kgrid = np.arange(1e-4 / r_max, kmax, dk_factor / r_max)
    n = len(kgrid)
    if n < 2:
        return [np.zeros(0) for _ in ls]
    f = _kln_fn(r_min, r_max, method, bc_type)
    step = max(1, int(KLN_COARSE_RAD / dk_factor))
    ci = np.unique(np.r_[np.arange(0, n, step), n - 1])
    fc = f(ls[:, None], kgrid[ci][None, :])
    # row-major: by l, then by k
    li, sc = np.where(np.sign(fc[:, :-1]) * np.sign(fc[:, 1:]) < 0)
    L, ia, ib, fa = ls[li], ci[sc], ci[sc + 1], fc[li, sc]
    keep = np.ones(len(ia), dtype=bool)
    while np.any(ib - ia > 1):
        act = np.where(ib - ia > 1)[0]
        im = (ia[act] + ib[act]) // 2
        fm = f(L[act, None], kgrid[im, None])[:, 0]
        # a grid value of exactly 0 is no sign change on either side
        keep[act[fm == 0]] = False
        left = np.sign(fm) == np.sign(fa[act])
        ia[act] = np.where(left, im, ia[act])
        fa[act] = np.where(left, fm, fa[act])
        ib[act] = np.where(left, ib[act], im)
    li, L = li[keep], L[keep]
    lo, hi, flo = kgrid[ia[keep]], kgrid[ia[keep] + 1], fa[keep]
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        # once mid equals lo or hi an interval keeps its ends
        act = np.where((mid != lo) & (mid != hi))[0]
        if not len(act):
            break
        fm = f(L[act, None], mid[act, None])[:, 0]
        same = np.sign(fm) == np.sign(flo[act])
        lo[act] = np.where(same, mid[act], lo[act])
        flo[act] = np.where(same, fm, flo[act])
        hi[act] = np.where(same, hi[act], mid[act])
    roots = 0.5 * (lo + hi)
    return [roots[li == i] for i in range(len(ls))]


def _kln_finish(l, k, decimate, add_kzero):
    if decimate:
        k = k[::2]
    if add_kzero and np.isclose(float(np.atleast_1d(l)[0]), 0, atol=1e-5):
        k = np.concatenate([[0.0], k])
    return k


def sph_bessel_kln(l, r_min, r_max, kmax, method="ball", bc_type=2,
                   dk_factor=5e-3, decimate=False, add_kzero=False):
    """Wavevectors k_ln that satisfy the radial boundary conditions:
    roots in k < kmax of d j_l(k r_max)/dr (ball, bc_type 2), of
    j_l(k r_max) (ball, bc_type 1 or 3) or of the shell determinant
    j_l'(k r_min) y_l'(k r_max) - j_l'(k r_max) y_l'(k r_min), found as
    _kln_roots says. decimate keeps every other root; add_kzero prepends
    k = 0 for l = 0."""
    k = _kln_roots([float(np.atleast_1d(l)[0])], r_min, r_max, kmax,
                   method, bc_type, dk_factor)[0]
    return _kln_finish(l, k, decimate, add_kzero)


def gen_bessel2freq(l, freqs=None, cosmo=None, kmax=0.5, method="ball",
                    bc_type=2, renorm=True, r_crit=None, r=None,
                    kbins=None, decimate=False, add_kzero=False,
                    device=None, dtype=None):
    """Radial SFB design matrices: per unique l, g_l(k_ln r) (Nfreqs,
    Nk) over the comoving distances r(f) of the 21 cm line (cosmo, a
    default Cosmology, or r= given), its columns at the roots of
    sph_bessel_kln (or at kbins[l] given), normalised by the square root
    of their radial inner product with |dr| if renorm. An l with no root
    below kmax is left out.

    Returns (gln {l: tensor (Nfreqs, Nk) of dtype (default float32) on
    device (default CUDA)}, kbins {l: numpy (Nk,)}). The unique l are
    dealt to SFB_THREADS threads; each solves the roots of its l at once
    (_kln_roots) and builds one l's columns in one sph_bessel_func call.
    """
    if r is None:
        if cosmo is None:
            from ..models.cosmology import Cosmology
            cosmo = Cosmology()
        freqs = np.asarray(freqs, dtype=np.float64)
        r = cosmo.comoving_distance(cosmo.f2z(freqs))
    else:
        r = np.asarray(r, dtype=np.float64)
    r_min, r_max = r.min(), r.max()
    dr = np.abs(np.gradient(r))

    def columns(ll, kln):
        g = np.ascontiguousarray(sph_bessel_func(
            float(ll), kln, r, method=method,
            r_crit=r_crit if r_crit is not None else r_max).T)
        if renorm:
            # |dr|: r decreases with frequency
            w = np.sqrt(np.sum(g ** 2 * (r ** 2 * dr)[:, None], axis=0))
            w[w == 0] = 1.0
            g = g / w
        return g

    def group(ls):
        if kbins is not None:
            ks = [np.asarray(kbins[float(ll)]) for ll in ls]
        else:
            ks = [_kln_finish(ll, k, decimate, add_kzero) for ll, k in zip(
                ls, _kln_roots(ls, r_min, r_max, kmax, method, bc_type))]
        return [(ll, k, columns(ll, k)) for ll, k in zip(ls, ks)
                if len(k)]

    lu = np.unique(np.asarray(l))
    nt = max(1, min(SFB_THREADS, len(lu)))
    if nt > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(nt) as ex:
            res = list(ex.map(group, [lu[i::nt] for i in range(nt)]))
    else:
        res = [group(lu)]
    dev, dt = resolve_device(device), dtype or _float()
    found = sorted((x for rs in res for x in rs), key=lambda x: x[0])
    gln = {float(ll): torch.as_tensor(g, dtype=dt, device=dev)
           for ll, _, g in found}
    return gln, {float(ll): k for ll, k, _ in found}


class _GlnProduct(torch.autograd.Function):
    """G @ p for the stacked radial matrices G (N_l, Nfreqs, Nn) and the
    gathered params p (..., N_l, Nn, C), in true fp32 both ways: p's
    gradient G^T g, and G's, g p^T summed over p's leading dimensions,
    only where G takes one. The backward is itself differentiable; jvp
    is the product rule (both operands kept under forward-mode AD)."""

    @staticmethod
    def forward(ctx, p, G):
        ctx.save_for_backward(p if G.requires_grad else None, G)
        if dual_active():
            ctx.save_for_forward(p, G)
        with no_tf32():
            return G @ p

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, tp, tG):
        p, G = ctx.saved_tensors
        out = None
        with no_tf32():
            if tp is not None:
                out = G @ tp
            if tG is not None:
                o = tG @ p
                out = o if out is None else out + o
        return out

    @staticmethod
    def backward(ctx, g):
        p, G = ctx.saved_tensors
        gp = gG = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                gp = G.transpose(-1, -2) @ g
            if ctx.needs_input_grad[1]:
                gG = (g @ p.transpose(-1, -2)).reshape(
                    (-1,) + tuple(G.shape)).sum(0)
        return gp, gG


class SFBModel(Module):
    """Spherical Fourier-Bessel radial transform t_lmn -> a_lm(freq):
    forward(params (..., Nn, Ncoeff)) -> (..., Nfreqs, Ncoeff), each
    column c the product of its l's g_ln (Nfreqs, Nk(l)) with the
    column's first Nk(l) rows; a column whose l has no g_ln is 0.

    forward is one batched product: the g_ln stacked zero-padded to
    (N_l, Nfreqs, Nn_max) (a buffer), the params' columns gathered per l
    into (..., N_l, Nn_max, M_max) by an index built once on the host,
    one matmul in true fp32 (_GlnProduct), and a gather back to the
    columns; the zero padding reproduces the first-Nk(l)-rows slice.
    forward_plain is the per-l loop (a product and an indexed add an l).

    gln: {l: (Nfreqs, Nk)} tensors or arrays (gen_bessel2freq), kbins
    their k. device / dtype: of the stacked g_ln (default: those of the
    gln tensors, else CUDA and float32).
    """

    def __init__(self, l, m, gln, kbins, LM=None, name=None, device=None,
                 dtype=None):
        super().__init__(name=name)
        self.l = np.asarray(l)
        self.m = np.asarray(m)
        self.kbins = dict(kbins)
        self.LM = LM
        self.device = device
        self.dtype = dtype
        self.register_buffer("_G", None)
        self._set_gln(gln)

    @property
    def l_unique(self):
        return np.unique(self.l)

    def _set_gln(self, gln):
        """Attach gln: stack it on the device and build the column
        index."""
        self.gln = dict(gln)
        g0 = next(iter(self.gln.values()))
        if self.device is not None:
            dev = resolve_device(self.device)
        else:
            dev = g0.device if torch.is_tensor(g0) else resolve_device(None)
        dt = self.dtype or (g0.dtype if torch.is_tensor(g0)
                            and g0.is_floating_point() else _float())
        gs = [torch.as_tensor(g).to(device=dev, dtype=dt)
              for g in self.gln.values()]
        nl, nf = len(gs), gs[0].shape[0]
        nmax = max(g.shape[1] for g in gs)
        G = torch.zeros((nl, nf, nmax), dtype=dt, device=dev)
        for i, g in enumerate(gs):
            G[i, :, :g.shape[1]] = g
        self._G = G
        self._nk = [g.shape[1] for g in gs]
        self._cols = [np.where(np.isclose(self.l, ll))[0]
                      for ll in self.gln]
        M = max(1, max(len(c) for c in self._cols))
        nc = len(self.l)
        # the params' column of each (l, slot), the zero column nc where
        # the l has fewer columns than M
        gidx = np.full((nl, M), nc, dtype=np.int64)
        # each column's place in the (l, slot) layout; nl * M (a zero
        # slot) for a column of no l in gln
        inv = np.full(nc, nl * M, dtype=np.int64)
        for i, c in enumerate(self._cols):
            gidx[i, :len(c)] = c
            inv[c] = i * M + np.arange(len(c))
        self._index = (gidx.ravel(), inv, M)
        self._index_dev = None

    def _dev_index(self, device):
        if self._index_dev is None or self._index_dev[0].device != device:
            gidx, inv, _ = self._index
            self._index_dev = (torch.as_tensor(gidx, device=device),
                               torch.as_tensor(inv, device=device))
        return self._index_dev

    def setup_gln(self, l, gln=None, kln=None, out_dtype=None, r=None,
                  m=None, **gln_kwargs):
        """(Re)attach the radial matrices, generated by gen_bessel2freq
        (r= comoving distances, **gln_kwargs, on the device and in the
        dtype of the matrices attached now) when gln is None; m sets the m
        modes; out_dtype casts the matrices."""
        self.l = np.asarray(l)
        if m is not None:
            self.m = np.asarray(m)
        if gln is None:
            gln_kwargs.setdefault("device", self._G.device)
            gln_kwargs.setdefault("dtype", self._G.dtype)
            gln, kln = gen_bessel2freq(self.l_unique, r=r, **gln_kwargs)
        if out_dtype is not None:
            self.dtype = out_dtype
        self._set_gln(gln)
        if kln is not None:
            self.kbins = dict(kln)

    def forward_gln(self, params, gln=None):
        """forward with these gln in place of the attached ones."""
        if gln is None:
            return self.forward(params)
        saved = (self.gln, self._G, self._nk, self._cols, self._index,
                 self._index_dev)
        self._set_gln(gln)
        try:
            return self.forward(params)
        finally:
            (self.gln, self._G, self._nk, self._cols, self._index,
             self._index_dev) = saved

    def make_closure(self, params, loss_fn, target, real=False):
        """loss() = loss_fn(forward(params), target) (the real parts if
        real); loss(p) evaluates at other params p."""
        def closure(p=None):
            out = self.forward(params if p is None else p)
            tgt = target
            if real:
                out, tgt = out.real, tgt.real
            return loss_fn(out, tgt)
        return closure

    def _G_for(self, params):
        return self._G.to(device=params.device, dtype=_rdtype(params.dtype))

    def forward(self, params, **kwargs):
        if self.LM is not None:
            params = self.LM(params)
        G = self._G_for(params)
        nl, nf, nn = G.shape
        gidx, inv = self._dev_index(params.device)
        M = self._index[2]
        lead = params.shape[:-2]
        cplx = params.is_complex()
        p = torch.view_as_real(params) if cplx else params[..., None]
        q = p.shape[-1]
        # rows past the largest Nk(l) are read by no l
        p = torch.nn.functional.pad(p[..., :nn, :, :], (0, 0, 0, 1))
        p = p.index_select(-2, gidx).reshape(lead + (nn, nl, M * q))
        out = _GlnProduct.apply(p.movedim(-2, -3), G)
        out = out.movedim(-3, -2).reshape(lead + (nf, nl * M, q))
        out = torch.nn.functional.pad(out, (0, 0, 0, 1)).index_select(-2,
                                                                       inv)
        return torch.view_as_complex(out) if cplx else out[..., 0]

    def forward_plain(self, params):
        """The per-l loop: for each l, its g_ln times its columns' first
        Nk(l) rows, added at those columns."""
        if self.LM is not None:
            params = self.LM(params)
        G = self._G_for(params)
        out = torch.zeros(params.shape[:-2] + (G.shape[1], params.shape[-1]),
                          dtype=params.dtype, device=params.device)
        with no_tf32():
            for i, (cols, nk) in enumerate(zip(self._cols, self._nk)):
                c = torch.as_tensor(cols, device=params.device)
                g = G[i, :, :nk].to(params.dtype)
                block = params[..., :nk, :].index_select(-1, c)
                out = out.index_add(-1, c, torch.einsum("fn,...nc->...fc",
                                                        g, block))
        return out


def sfb_binning(params, k_arr, kbins, var=None, wgts=None, l_arr=None,
                lbins=None):
    """Bin SFB coefficients (..., N) over their k (k_arr (N,)) into kbins
    (bin centres; edges halfway between them, the last bin as wide as the
    one before), and over l (l_arr, lbins) too if lbins is given: the
    weighted mean of params (weights wgts, default ones, normalised in
    each bin) and the variance var (default ones) times the squared
    weights. Returns (params (..., Nk) or (..., Nl, Nk), var likewise);
    an empty bin is 0."""
    params = torch.as_tensor(params)
    dev = params.device
    k_arr = np.asarray(k_arr)
    kbins = np.asarray(kbins, dtype=np.float64)
    kdiff = np.diff(kbins)
    kdiff = np.concatenate([kdiff, kdiff[-1:]])
    kinds = np.digitize(k_arr, kbins + kdiff / 2)
    Nk = len(kbins)
    if var is None:
        var = torch.ones_like(params)
    var = torch.as_tensor(var, device=dev)
    if wgts is None:
        wgts = torch.ones(params.shape[-1], dtype=params.real.dtype,
                          device=dev)
    wgts = torch.as_tensor(wgts, device=dev).broadcast_to(params.shape)

    def mean(idx):
        if len(idx) == 0:
            return (torch.zeros(params.shape[:-1], dtype=params.dtype,
                                device=dev),
                    torch.zeros(var.shape[:-1], dtype=var.dtype, device=dev))
        t = torch.as_tensor(idx, device=dev)
        w = wgts.index_select(-1, t)
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-40)
        return (torch.sum(params.index_select(-1, t) * w, dim=-1)
                .to(params.dtype),
                torch.sum(var.index_select(-1, t) * w ** 2, dim=-1)
                .to(var.dtype))

    if lbins is None:
        outs = [mean(np.where(kinds == i)[0]) for i in range(Nk)]
        return (torch.stack([o[0] for o in outs], dim=-1),
                torch.stack([o[1] for o in outs], dim=-1))
    l_arr = np.asarray(l_arr)
    lbins = np.asarray(lbins, dtype=np.float64)
    ldiff = np.diff(lbins)
    ldiff = np.concatenate([ldiff, ldiff[-1:]])
    linds = np.digitize(l_arr, lbins + ldiff / 2)
    outs = [[mean(np.where((kinds == j) & (linds == i))[0])
             for j in range(Nk)] for i in range(len(lbins))]
    return (torch.stack([torch.stack([o[0] for o in row], dim=-1)
                         for row in outs], dim=-2),
            torch.stack([torch.stack([o[1] for o in row], dim=-1)
                         for row in outs], dim=-2))
