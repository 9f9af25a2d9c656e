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


def j1(x):
    """Bessel J1 via A&S 9.4.4/9.4.6."""
    ax = torch.abs(x)
    y = x * x
    p1 = x * (72362614232.0 + y * (-7895059235.0 + y * (242396853.1
         + y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606))))))
    q1 = (144725228442.0 + y * (2300535178.0 + y * (18583304.74
          + y * (99447.43394 + y * (376.9991397 + y)))))
    small = p1 / q1
    z = 8.0 / torch.where(ax < 1e-30, torch.ones_like(ax), ax)
    y2 = z * z
    xx = ax - 2.356194491
    p2 = (1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4
          + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6)))))
    q2 = (0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5
          + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6))))
    large = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * \
        (torch.cos(xx) * p2 - z * torch.sin(xx) * q2)
    large = large * torch.sign(x)
    return torch.where(ax < 8.0, small, large)
