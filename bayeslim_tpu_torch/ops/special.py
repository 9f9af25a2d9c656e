"""
Special functions for cut-sky spherical harmonics, spherical Bessel
functions, Bessel J1 and softplus.

Counterpart of bayeslim_tpu/ops/special.py (log_legendre_norm :28,
pochln :34, hypF :68, Plm :133, Qlm :175, jl :224, yl :250,
j1_integral :266, j1 :282, softplus / Softplus :294-330).

The Legendre and spherical Bessel functions are host-side numpy: they
build design matrices once (the Ylm and the radial bases), and those
matrices are what goes to the device. hypF's exact route calls mpmath's
hyp2f1 once per element (arbitrary precision, stable to l = m ~ 800);
high_prec=False calls scipy's hyp2f1 instead. mpmath is imported only
when the exact route is asked for, and its absence raises an
ImportError that names it: the fast route is never taken in its place.

j1_integral, j1, softplus and Softplus act on torch tensors and are
differentiable.

Math: Ferrers functions of the first / second kind on -1 < x < 1,
DLMF 14.3.1 and 14.3.12, orthonormalised by
sqrt((2l+1)/(4pi) (l-m)!/(l+m)!); a hypergeometric c <= 0 goes through
DLMF 15.2.3_5 with log-space Pochhammer symbols (DLMF 5.2.6).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import gamma, gammaln, jv, jvp, yv, yvp

__all__ = ["Plm", "Qlm", "hypF", "pochln", "jl", "yl", "log_legendre_norm",
           "softplus", "Softplus", "j1", "j1_integral"]

HYPF_KWGS = {"zeroprec": 1000}


def _hyp2f1(high_prec):
    """(hyp2f1, its keyword arguments) of the asked-for route."""
    if not high_prec:
        from scipy.special import hyp2f1
        return hyp2f1, {}
    try:
        from mpmath import hyp2f1
    except ImportError as err:
        raise ImportError(
            "hypF(high_prec=True) needs mpmath (pass high_prec=False for "
            "scipy's hyp2f1)") from err
    return hyp2f1, HYPF_KWGS


def log_legendre_norm(l, m):
    """log of sqrt((2l+1)/(4pi) * (l-m)!/(l+m)!)."""
    return 0.5 * (np.log(2 * l + 1) - np.log(4 * np.pi)
                  + gammaln(l - m + 1) - gammaln(l + m + 1))


def pochln(a, n):
    """Signed log Pochhammer symbol (a)_n = Gamma(a+n)/Gamma(a)
    (DLMF 5.2.6). Returns (sign, log|(a)_n|) arrays."""
    a = np.atleast_1d(np.asarray(a, dtype=float))
    n = np.atleast_1d(np.asarray(n, dtype=float))
    a, n = np.broadcast_arrays(a, n)
    out = np.zeros(a.shape, dtype=float)
    sign = np.ones(a.shape, dtype=int)

    is_int = ((a % 1) == 0) & ((n % 1) == 0)
    neg_a = is_int & (a < 0)

    s1 = neg_a & (n < 0)
    out[s1] = -np.inf

    s3 = neg_a & (n > 0)
    if s3.any():
        # (a)_n = (-1)^n (-a-n+1)_n for a negative integer a
        sign[s3] = np.where(n[s3] % 2 == 0, 1, -1)
        out[s3] = pochln(-a[s3] - n[s3] + 1, n[s3])[1]

    s4 = ~(s1 | s3) & ~(neg_a & (n == 0))
    if s4.any():
        out[s4] = gammaln(a[s4] + n[s4]) - gammaln(a[s4])
        # sign flips of Gamma at negative arguments
        flip = s4 & (np.abs(a + n) % 2 < 1) & ((a + n) < 0)
        sign[flip] *= -1
        flip = s4 & (np.abs(a) % 2 < 1) & (a < 0)
        sign[flip] *= -1
    return sign, out


def hypF(a, b, c, z, high_prec=True, keepdims=False):
    """Doubly regularised Gauss hypergeometric 2F1(a, b; c; z) / (G(c)
    G(c+1)).

    The extra 1/Gamma(c+1) keeps large degrees from overflowing; Plm and
    Qlm multiply it back. A non-positive integer c goes through DLMF
    15.2.3_5. a, b, c broadcast as (Nmode, 1); z is (Nz,).
    """
    h21, kg = _hyp2f1(high_prec)
    a = np.atleast_2d(np.asarray(a, dtype=float))
    b = np.atleast_2d(np.asarray(b, dtype=float))
    c = np.atleast_2d(np.asarray(c, dtype=float))
    z = np.atleast_1d(np.asarray(z, dtype=float))
    nmode = max(a.shape[0], b.shape[0], c.shape[0])
    a = np.broadcast_to(a, (nmode, a.shape[1])).astype(float)
    b = np.broadcast_to(b, (nmode, b.shape[1])).astype(float)
    c = np.broadcast_to(c, (nmode, c.shape[1])).astype(float)

    f21_eval = np.frompyfunc(lambda *args: float(h21(*args, **kg)), 4, 1)

    F = np.zeros((nmode, len(z)), dtype=float)
    cneg = c.ravel() <= 0
    if cneg.any():
        # DLMF 15.2.3_5: F~(a, b; -n; z) = (a)_{n+1} (b)_{n+1} / (n+1)!
        #   z^{n+1} 2F1(a+n+1, b+n+1; n+2; z)
        A, B, n = a[cneg], b[cneg], -c[cneg]
        sgn = np.ones_like(n, dtype=int)
        lognorm = np.zeros_like(n, dtype=float)
        for inp in (A, B):
            s, p = pochln(inp, n + 1)
            sgn = sgn * s
            lognorm = lognorm + p
        lognorm = lognorm - gammaln(n + 2) - gammaln(n + 1)
        f21 = np.asarray(f21_eval(A + n + 1, B + n + 1, n + 2, z),
                         dtype=float)
        with np.errstate(divide="ignore", invalid="ignore"):
            logz = np.log(np.abs(z)) * (n + 1)
            F[cneg] = sgn * np.sign(f21) * np.sign(z) ** (n + 1) * \
                np.exp(np.log(np.abs(f21) + 1e-300) + logz + lognorm)
    if (~cneg).any():
        A, B, C = a[~cneg], b[~cneg], c[~cneg]
        f21 = np.asarray(f21_eval(A, B, C, z), dtype=float)
        F[~cneg] = f21 / gamma(C) / gamma(C + 1)

    if not keepdims and len(F) == 1:
        F = F[0]
    return F


def _prep_lm(l, m):
    l = np.atleast_1d(np.asarray(l, dtype=float))
    m = np.atleast_1d(np.asarray(m, dtype=float))
    if l.ndim == 1:
        l = l[:, None]
    if m.ndim == 1:
        m = m[:, None]
    return l, m


def Plm(l, m, x, deriv=False, dtheta=True, keepdims=False, high_prec=True,
        sq_norm=True):
    """Orthonormalised Ferrers function of the first kind (DLMF 14.3.1).

    P(x) = C ((1+x)/(1-x))^{m/2} F~(l+1, -l; 1-m; (1-x)/2), C =
    sqrt((2l+1)/(4pi) (l-m)!/(l+m)!). sq_norm=False withholds the
    (1-x^2)^{-m/2} factor (kept out of a P + A Q sum to avoid
    cancellation). deriv gives dP/dtheta (DLMF 14.10.5), x = cos(theta),
    or dP/dx with dtheta=False.
    """
    l, m = _prep_lm(l, m)
    assert np.all(m <= l + 1e-5)
    x = np.atleast_1d(np.asarray(x, dtype=float))

    if deriv:
        with np.errstate(divide="ignore", invalid="ignore"):
            pref = 1.0 / (1 - x ** 2)
        t1 = (m - l - 1) * Plm(l + 1, m, x, keepdims=True, sq_norm=sq_norm,
                               high_prec=high_prec)
        t1 = t1 * np.exp(log_legendre_norm(l, m) - log_legendre_norm(l + 1, m))
        t2 = (l + 1) * x * Plm(l, m, x, keepdims=True, sq_norm=sq_norm,
                               high_prec=high_prec)
        dPdx = t1 + t2
        fin = np.isfinite(pref)
        dPdx[:, fin] *= pref[fin]
        if dtheta:
            dPdx = dPdx * (-np.sin(np.arccos(x)))
        return _squeeze(dPdx, keepdims)

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        pref = ((1 + x) / (1 - x)) ** (m / 2)
    F = hypF(l + 1, -l, 1 - m, (1 - x) / 2, high_prec=high_prec,
             keepdims=True)
    fin = np.isfinite(pref)
    F[fin] *= pref[fin]
    # undo hypF's extra 1/Gamma(|c|+1) and orthonormalise
    F *= np.exp(log_legendre_norm(l, m) + gammaln(np.abs(1 - m) + 1))
    if not sq_norm:
        F = F / (1 - x ** 2) ** (-m / 2)
    return _squeeze(F, keepdims)


def Qlm(l, m, x, deriv=False, dtheta=True, keepdims=False, high_prec=True,
        sq_norm=True):
    """Orthonormalised Ferrers function of the second kind (DLMF
    14.3.12): Q = pi/2 [-sin((l+m)pi/2) w1 + cos((l+m)pi/2) w2] with w1 /
    w2 the even / odd hypergeometric solutions. Diverges at |x| = 1."""
    l, m = _prep_lm(l, m)
    x = np.atleast_1d(np.asarray(x, dtype=float))

    if deriv:
        with np.errstate(divide="ignore", invalid="ignore"):
            pref = 1.0 / (1 - x ** 2)
        t1 = (m - l - 1) * Qlm(l + 1, m, x, keepdims=True, sq_norm=sq_norm,
                               high_prec=high_prec)
        t1 = t1 * np.exp(log_legendre_norm(l, m) - log_legendre_norm(l + 1, m))
        t2 = (l + 1) * x * Qlm(l, m, x, keepdims=True, sq_norm=sq_norm,
                               high_prec=high_prec)
        dQdx = pref * (t1 + t2)
        if dtheta:
            dQdx = dQdx * (-np.sin(np.arccos(x)))
        return _squeeze(dQdx, keepdims)

    C = log_legendre_norm(l, m)
    w1 = 2 ** m * hypF((-l - m) / 2, (l - m + 1) / 2, 0.5, x ** 2,
                       high_prec=high_prec, keepdims=True)
    w1 = w1 * np.exp(C + gammaln((l + m + 1) / 2) - gammaln((l - m + 2) / 2)
                     + gammaln(1.5))
    w2 = 2 ** m * x * hypF((1 - l - m) / 2, (l - m + 2) / 2, 1.5, x ** 2,
                           high_prec=high_prec, keepdims=True)
    w2 = w2 * np.exp(C + gammaln((l + m + 2) / 2) - gammaln((l - m + 1) / 2)
                     + gammaln(2.5))
    Q = 0.5 * np.pi * (-np.sin(0.5 * (l + m) * np.pi) * w1
                       + np.cos(0.5 * (l + m) * np.pi) * w2)
    if sq_norm:
        Q = Q * (1 - x ** 2) ** (-m / 2)
    return _squeeze(Q, keepdims)


def _squeeze(arr, keepdims):
    if keepdims:
        return arr
    if 1 in arr.shape:
        arr = arr.ravel()
    if arr.size == 1:
        arr = arr.reshape(())[()]
    return arr


def jl(l, z, deriv=False, keepdims=False):
    """Spherical Bessel function of the first kind (DLMF 10.47.3), any
    real l: j_l(z) = sqrt(pi/(2z)) J_{l+1/2}(z). A 1-D l gives (Nl, Nz);
    a 2-D l broadcasts against z element by element (so does yl)."""
    l = np.atleast_1d(np.asarray(l, dtype=float))
    if l.ndim == 1:
        l = l[:, None]
    z = np.atleast_1d(np.asarray(z, dtype=float))
    nu = l + 0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        pref = np.sqrt(np.pi / (2 * z))
        if deriv:
            out = pref * (jvp(nu, z) - jv(nu, z) / (2 * z))
        else:
            out = pref * jv(nu, z)
    # the z = 0 limits
    z0 = np.isclose(z, 0)
    if z0.any():
        lim = np.where(np.isclose(l, 1), 1 / 3.0, 0.0) if deriv \
            else np.where(np.isclose(l, 0), 1.0, 0.0)
        out = np.where(z0, lim, out)
    return _squeeze(out, keepdims)


def yl(l, z, deriv=False, keepdims=False):
    """Spherical Bessel function of the second kind (DLMF 10.47.4)."""
    l = np.atleast_1d(np.asarray(l, dtype=float))
    if l.ndim == 1:
        l = l[:, None]
    z = np.atleast_1d(np.asarray(z, dtype=float))
    nu = l + 0.5
    with np.errstate(divide="ignore", invalid="ignore"):
        pref = np.sqrt(np.pi / (2 * z))
        if deriv:
            out = pref * (yvp(nu, z) - yv(nu, z) / (2 * z))
        else:
            out = pref * yv(nu, z)
    return _squeeze(out, keepdims)


def j1_integral(x, Ntau=100):
    """Bessel J1 by the trapezoid rule on J1(x) = (1/pi) int_0^pi
    cos(tau - x sin(tau)) dtau, with Ntau points; differentiable."""
    x = torch.as_tensor(x)
    t = torch.linspace(0.0, np.pi, Ntau, dtype=x.dtype, device=x.device)
    t = t.reshape((-1,) + (1,) * x.ndim)
    integrand = torch.cos(t - x[None] * torch.sin(t))
    wgts = torch.full((Ntau,), 2.0, dtype=x.dtype, device=x.device)
    wgts[0] = wgts[-1] = 1.0
    wgts = wgts.reshape((-1,) + (1,) * x.ndim)
    dt = np.pi / (Ntau - 1)
    return torch.sum(wgts * integrand, dim=0) * dt / 2.0 / np.pi


def j1(x, Ntau=100, brute_force=False):
    """Bessel J1: brute_force integrates the Bessel integral with Ntau
    trapezoid points; otherwise the A&S 9.4.4 / 9.4.6 polynomial of
    models/bessel.py. Both have a torch derivative."""
    if brute_force:
        return j1_integral(x, Ntau=Ntau)
    from ..models.bessel import j1 as _j1_poly
    return _j1_poly(torch.as_tensor(x))


def softplus(x, beta=1.0, threshold=20.0):
    """ln(1 + exp(beta x)) / beta, and x itself where beta x exceeds the
    threshold."""
    x = torch.as_tensor(x)
    out = torch.logaddexp(torch.zeros_like(x), beta * x) / beta
    return torch.where(beta * x > threshold, x, out)


class Softplus:
    """Callable softplus with a fixed beta and threshold, and its
    inverse f^-1(y) = y + ln(1 - exp(-beta y)) / beta (y itself above
    the threshold)."""

    def __init__(self, beta=1.0, threshold=20.0, inverted=False):
        self.beta = beta
        self.threshold = threshold
        self.set_inverted(inverted)

    def set_inverted(self, inverted):
        """If True, calling applies the inverse instead of the forward."""
        self.inverted = inverted

    def forward(self, x):
        return softplus(x, self.beta, self.threshold)

    def inverse(self, x):
        """log(exp(beta y) - 1) / beta in the stable form
        y + log(-expm1(-beta y)) / beta."""
        x = torch.as_tensor(x)
        out = x + torch.log(-torch.expm1(-self.beta * x)) / self.beta
        return torch.where(self.beta * x > self.threshold, x, out)

    def __call__(self, x):
        return self.inverse(x) if self.inverted else self.forward(x)
