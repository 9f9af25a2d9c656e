"""
Differentiable Bessel J0 and J1 (Abramowitz & Stegun 9.4.1-9.4.6
rational approximations, |error| < ~1e-7).

Counterpart of bayeslim_tpu/models/bessel.py (j0 :19, j1 :43). The port keeps
this polynomial rather than torch.special.bessel_j1, which has no
derivative (and would differ from the JAX package's beam).
"""
from __future__ import annotations

import torch

__all__ = ["j0", "j1"]


def j0(x):
    """Bessel J0 via A&S 9.4.1/9.4.3."""
    ax = torch.abs(x)
    y = x * x
    p1 = (57568490574.0 + y * (-13362590354.0 + y * (651619640.7
          + y * (-11214424.18 + y * (77392.33017 + y * (-184.9052456))))))
    q1 = (57568490411.0 + y * (1029532985.0 + y * (9494680.718
          + y * (59272.64853 + y * (267.8532712 + y)))))
    small = p1 / q1
    z = 8.0 / torch.where(ax < 1e-30, torch.ones_like(ax), ax)
    y2 = z * z
    xx = ax - 0.785398164
    p2 = (1.0 + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4
          + y2 * (-0.2073370639e-5 + y2 * 0.2093887211e-6))))
    q2 = (-0.1562499995e-1 + y2 * (0.1430488765e-3 + y2 * (-0.6911147651e-5
          + y2 * (0.7621095161e-6 + y2 * (-0.934935152e-7)))))
    large = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * \
        (torch.cos(xx) * p2 - z * torch.sin(xx) * q2)
    return torch.where(ax < 8.0, small, large)


# j1's approximant, coefficients lowest order first (csrc/airy_psky.cu
# holds the same numbers): x J1_P(x^2) / J1_Q(x^2) for |x| < 8 (A&S
# 9.4.4); for |x| >= 8, with z = 8 / |x|, sign(x) sqrt(J1_K / |x|)
# (cos(|x| - J1_PHASE) J1_P2(z^2) - z sin(|x| - J1_PHASE) J1_Q2(z^2))
# (9.4.6)
J1_P = (72362614232.0, -7895059235.0, 242396853.1, -2972611.439,
        15704.48260, -30.16036606)
J1_Q = (144725228442.0, 2300535178.0, 18583304.74, 99447.43394,
        376.9991397, 1.0)
J1_P2 = (1.0, 0.183105e-2, -0.3516396496e-4, 0.2457520174e-5,
         -0.240337019e-6)
J1_Q2 = (0.04687499995, -0.2002690873e-3, 0.8449199096e-5, -0.88228987e-6,
         0.105787412e-6)
J1_K, J1_PHASE = 0.636619772, 2.356194491


def _horner(c, y):
    """c[0] + c[1] y + c[2] y^2 + ... by Horner's rule."""
    acc = c[-1]
    for a in reversed(c[:-1]):
        acc = a + y * acc
    return acc


def j1(x):
    """Bessel J1 via A&S 9.4.4/9.4.6."""
    ax = torch.abs(x)
    y = x * x
    small = x * _horner(J1_P, y) / _horner(J1_Q, y)
    z = 8.0 / torch.where(ax < 1e-30, torch.ones_like(ax), ax)
    y2 = z * z
    xx = ax - J1_PHASE
    large = torch.sqrt(J1_K / torch.clamp(ax, min=1e-30)) * \
        (torch.cos(xx) * _horner(J1_P2, y2)
         - z * torch.sin(xx) * _horner(J1_Q2, y2))
    large = large * torch.sign(x)
    return torch.where(ax < 8.0, small, large)
