"""
Float32-safe fringe phase: (f * tau) mod 1 in cycles.

Counterpart of bayeslim_tpu/ops/phase.py (mod1 :34, split_mul_mod1 :53,
fringe_cycles :76, fringe_phasor :114). The fringe phase 2 pi f tau reaches ~1e4 rad
(f ~ 2e8 Hz, tau ~ 1e-5 s), so a float32 product f * tau keeps only
~1e-3 of a cycle. Phases matter modulo one cycle, so the frequency is
split into parts whose products with tau are exact enough in float32
(f = a + b + lo with a a multiple of 4096, b < 4096 and lo the float32
rounding residual) and each product is reduced mod 1 before summing.
A regular grid f = f0 + k df then gives
cycles = mod1(mod1(f0 tau) + mod1(k mod1(df tau))). In float64 the
plain product is exact enough and is used directly.

``mod1`` has the derivative of the identity (torch.floor has a zero
derivative), so d cycles / d tau = f as for the unreduced phase.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["mod1", "split_mul_mod1", "fringe_cycles", "fringe_phasor",
           "regular_grid"]


def mod1(x):
    """x mod 1, with the derivative of the identity."""
    return x - torch.floor(x)


def _split_f32(f):
    """Split f into float32-valued (a, b, lo): a is a multiple of 4096,
    a + b == float32(f) exactly, lo = f - float32(f)."""
    f = float(f)
    hi = np.float32(f)
    a = np.float32(np.floor(np.float64(hi) / 4096.0) * 4096.0)
    b = np.float32(np.float64(hi) - np.float64(a))
    lo = np.float32(f - float(hi))
    return float(a), float(b), float(lo)


def split_mul_mod1(f, tau):
    """(f * tau) mod 1 for a host scalar f and a float tensor tau."""
    if tau.dtype == torch.float64:
        return mod1(float(f) * tau)
    a, b, lo = _split_f32(f)
    t = tau.to(torch.float32)
    return mod1(mod1(a * t) + mod1(b * t) + lo * t)


def regular_grid(freqs, rtol=1e-12, atol=1e-6):
    """(f0, df) if freqs = f0 + k df to tolerance, else None."""
    freqs = np.asarray(freqs, dtype=np.float64)
    if len(freqs) == 1:
        return float(freqs[0]), 0.0
    d = np.diff(freqs)
    if np.allclose(d, d[0], rtol=rtol, atol=atol):
        return float(freqs[0]), float(d[0])
    return None


def fringe_cycles(tau, freqs, f0=None, df=None):
    """Fringe phase in cycles, (f tau) mod 1 in [0, 1).

    tau : (...,) delay tensor [s]; freqs : (Nfreqs,) host array [Hz];
    f0, df : optional scalars declaring freqs = f0 + k df (found from
    freqs when not given; the part of freqs off that grid is added
    after the reduction). Returns (..., Nfreqs).
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    if tau.dtype == torch.float64:
        f = torch.as_tensor(freqs, dtype=tau.dtype, device=tau.device)
        return mod1(tau[..., None] * f)
    if f0 is None:
        grid = regular_grid(freqs)
        f0, df = grid if grid is not None else (float(freqs[0]), 0.0)
    f0, df = float(f0), float(df or 0.0)
    k = torch.arange(len(freqs), dtype=tau.dtype, device=tau.device)
    c0 = split_mul_mod1(f0, tau)
    c1 = split_mul_mod1(df, tau) if df else torch.zeros_like(tau)
    cyc = mod1(c0[..., None] + mod1(k * c1[..., None]))
    resid = freqs - (f0 + np.arange(len(freqs)) * df)
    if np.any(np.abs(resid) > 0):
        r = torch.as_tensor(resid, dtype=tau.dtype, device=tau.device)
        cyc = mod1(cyc + r * tau[..., None])
    return cyc


def fringe_phasor(tau, freqs, conj=False, f0=None, df=None):
    """exp(+-2 pi i f tau), (..., Nfreqs) complex, from the reduced
    phase of fringe_cycles; the sign is that of the RIME's fringe
    exp(+2 pi i f b.s / c), flipped by conj."""
    ang = (2 * np.pi) * fringe_cycles(tau, freqs, f0=f0, df=df)
    s = -1.0 if conj else 1.0
    return torch.complex(torch.cos(ang), s * torch.sin(ang))
