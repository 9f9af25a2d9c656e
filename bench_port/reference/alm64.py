"""
Plain reference of the alm64 configuration: a real sky map
sum_lm mult_m Re(a_lm Y_lm) (m >= 0, mult 2 for m > 0) per channel over
the pixels above the horizon, through a trainable elliptical Airy power
beam, simulated on each redundant group's representative (fixed antenna
positions), against a target under an inverse covariance of each
group's size.

Y_lm = N_lm P_l^m(cos theta) e^{i m phi} are worked out here: the
orthonormal associated Legendre functions (Condon-Shortley phase) by
the standard three-term recurrence in l at each of the map's HEALPix
rings, in float64 on the host, then assembled on the device over the
pixels that some time sees.
"""
from __future__ import annotations

import numpy as np
import torch

from . import astro
from .physics import ChannelBlocks, airy_power, reduce_pixels, round_tf32


def gen_lm(lmax):
    """(l, m) of the m >= 0 modes, m outer, l inner (healpy's order)."""
    lm = [(l, m) for m in range(lmax + 1) for l in range(m, lmax + 1)]
    return np.asarray(lm).T


def legendre(lmax, x):
    """sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) P_l^m(x), Condon-Shortley phase
    included, for gen_lm(lmax)'s modes: (Ncoeff, len(x)). Values below
    float64's range (high m near the poles, below 1e-280 there) are 0."""
    x = np.asarray(x, dtype=np.float64)
    s = np.sqrt(np.clip(1 - x * x, 0, None))
    out = []
    pmm = np.full_like(x, np.sqrt(1 / (4 * np.pi)))
    with np.errstate(under="ignore"):
        for m in range(lmax + 1):
            if m > 0:
                pmm = -np.sqrt((2 * m + 1) / (2.0 * m)) * s * pmm
            out.append(pmm)
            if m == lmax:
                break
            p1, p0 = np.sqrt(2 * m + 3.0) * x * pmm, pmm
            out.append(p1)
            for l in range(m + 2, lmax + 1):
                a = np.sqrt((4.0 * l * l - 1) / (l * l - m * m))
                b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1) ** 2 - 1))
                p0, p1 = p1, a * (x * p1 - b * p0)
                out.append(p1)
    return np.stack(out)


class Model(ChannelBlocks):
    """value_and_grad({'sky': (1, 1, F, Ncoeff, 2), 'beam': (1, 1, 1, 1,
    2)}) and forward(leaves) -> (T, F, G) complex in ``bls`` order."""

    leaves = ("sky", "beam")

    def __init__(self, cfg, inputs, device, dtype=torch.float64, tf32=False,
                 elems=64_000_000, ylm_rows=1024):
        self.dev, self.dt, self.tf32 = device, dtype, tf32
        pos = astro.make_hex(cfg["hex"], cfg["spacing_m"])
        _, _, group, r1, r2 = astro.redundant_groups(pos)
        self.bls = list(zip(r1.tolist(), r2.tolist()))
        t = lambda x, d=dtype: torch.as_tensor(x, dtype=d, device=device)
        self.blv = t(pos[r2] - pos[r1])
        self.icov = t(np.bincount(group))
        self.freqs = t(np.linspace(cfg["fmin_hz"], cfg["fmax_hz"], cfg["nfreq"]))
        times = cfg["time0_jd"] + np.arange(cfg["ntime"]) * cfg["dtime_jd"]
        geo, union, theta, phi = astro.sky_geometry(cfg["nside"], times)
        self.pix = [(t(s), t(np.searchsorted(union, idx), torch.long))
                    for idx, s in geo]
        self.px_area = 4 * np.pi / len(theta)
        l, m = gen_lm(cfg["lmax"])
        rings, ring = np.unique(theta[union], return_inverse=True)
        P = t(legendre(cfg["lmax"], np.cos(rings)))
        ring = t(ring.reshape(-1), torch.long)
        mphi = t(m.astype(np.float64))[:, None] * t(phi[union])[None, :]
        self.Yr = torch.empty((len(l), len(union)), dtype=dtype, device=device)
        self.Yi = torch.empty_like(self.Yr)
        for r0 in range(0, len(l), ylm_rows):
            r1_ = min(r0 + ylm_rows, len(l))
            Pr = P[r0:r1_].index_select(1, ring)
            self.Yr[r0:r1_] = Pr * torch.cos(mphi[r0:r1_])
            self.Yi[r0:r1_] = Pr * torch.sin(mphi[r0:r1_])
        del P, mphi
        self.mult = t(np.where(m > 0, 2.0, 1.0))
        if tf32:
            self.Yr, self.Yi = round_tf32(self.Yr), round_tf32(self.Yi)
        K = max(s.shape[1] for s, _ in self.pix)
        self.fb = max(1, min(elems // (len(r1) * K),
                             elems // (len(l) + len(union))))
        self.data = None

    def _block(self, leaves, f0, f1):
        """(T, F_b, G) complex: the visibilities of channels f0:f1."""
        f = self.freqs[f0:f1]
        a = leaves["sky"][0, 0, f0:f1] * self.mult[None, :, None]
        ar, ai = a[..., 0], a[..., 1]
        if self.tf32:
            ar, ai = round_tf32(ar), round_tf32(ai)
        sky = (ar @ self.Yr - ai @ self.Yi) * self.px_area     # (F_b, K_u)
        d = leaves["beam"].reshape(-1)
        out = []
        for s, pos in self.pix:
            psky = airy_power(f, s, d[0], d[1]) * sky[:, pos]
            out.append(reduce_pixels(psky, self.blv, s, f, self.tf32))
        return torch.stack(out)
