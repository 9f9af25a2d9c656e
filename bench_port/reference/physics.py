"""
The plain reference's forward model, in plain PyTorch: the Airy power
beam, the pixel reduction of the RIME, antenna gains and the Gaussian
chi^2. Every function takes tensors of one real dtype (float64 for the
reference, float32 for the control) and leaves differentiation to
autograd.

``tf32`` (the control): every operand of a matrix product (the delays
blvecs . s, the pixel reduction, the a_lm map) is first rounded to
TF32's 10-bit mantissa, the precision a float32 matmul on tensor cores
keeps; the rest is float32.
"""
from __future__ import annotations

import math

import torch

from .astro import C_MS


def round_tf32(x):
    """x (float32) with its mantissa rounded to 10 bits, to nearest."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real), round_tf32(x.imag))
    if x.dtype != torch.float32:
        raise TypeError("the TF32 control computes in float32")
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    # rounding is a straight-through step for the gradient
    return x + (r - x).detach()


class _J1(torch.autograd.Function):
    """Bessel J1 with its derivative J1'(x) = J0(x) - J1(x) / x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.special.bessel_j1(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.special.bessel_j0(x) - torch.special.bessel_j1(x) / x)


def airy_power(freqs, s, d_ew, d_ns):
    """[2 J1(x) / x]^2, x = pi f D sin(zen) / c, with the elliptical
    aperture D = d_ns + sin^2(az) (d_ew - d_ns): (F, K) for channels
    freqs (F,) and pixels of unit ENU pointing vectors s (3, K)."""
    sz2 = s[0] * s[0] + s[1] * s[1]
    sz = torch.sqrt(sz2)
    sin2_az = torch.where(sz2 > 0, s[0] * s[0] / torch.clamp(sz2, min=1e-300),
                          torch.zeros_like(sz2))
    diam = d_ns + sin2_az * (d_ew - d_ns)
    x = math.pi * freqs[:, None] * diam[None, :] * sz[None, :] / C_MS
    small = x < 1e-8
    xs = torch.where(small, torch.ones_like(x), x)
    b = torch.where(small, torch.ones_like(x), 2 * _J1.apply(xs) / xs)
    return b * b


def reduce_pixels(psky, blvecs, s, freqs, tf32=False):
    """V[f, b] = sum_k psky[f, k] exp(+2 pi i f tau[b, k]),
    tau = blvecs . s / c. psky (F, K) real, blvecs (B, 3), s (3, K),
    freqs (F,). Returns (F, B) complex. The phase is formed in cycles
    and reduced mod 1 before the cosine (2 pi f tau reaches ~1e3 rad)."""
    if tf32:
        blvecs, s = round_tf32(blvecs), round_tf32(s)
    tau = blvecs @ s / C_MS                                   # (B, K)
    cyc = freqs[:, None, None] * tau[None]                    # (F, B, K)
    cyc = cyc - torch.floor(cyc).detach()
    ang = 2 * math.pi * cyc
    cos, sin = torch.cos(ang), torch.sin(ang)
    ps = psky[:, None, :]
    if tf32:
        ps, cos, sin = round_tf32(ps), round_tf32(cos), round_tf32(sin)
    return torch.complex((ps * cos).sum(-1), (ps * sin).sum(-1))


def gains_complex(pairs, ref):
    """Complex gains from real pairs (..., 2) with the phase of antenna
    ref (axis -2 of the complex result's antenna axis 0) taken out."""
    g = torch.complex(pairs[..., 0], pairs[..., 1])
    gr = g[ref:ref + 1]
    return g * (gr.conj() / gr.abs())


def neg_log_like(model, data, icov, weight=None):
    """-log of a circular complex Gaussian likelihood of data (..., B)
    with a diagonal inverse covariance icov (B,): icov |model - data|^2
    plus the normalisation log pi - log icov, summed over the data, each
    baseline's terms times weight (B,) where given."""
    r = model - data
    per_bl = torch.sum(icov * (r.real * r.real + r.imag * r.imag),
                       dim=tuple(range(r.ndim - 1)))
    per_bl = per_bl + (math.log(math.pi) - torch.log(icov)) \
        * (data.numel() // data.shape[-1])
    return torch.sum(per_bl if weight is None else per_bl * weight)


class ChannelBlocks:
    """A reference model evaluated one block of ``fb`` channels at a time
    (the loss is a sum over channels), each block's backward run at once,
    so that no block's fringe outlives it. A subclass sets ``leaves``,
    ``freqs``, ``icov``, ``data`` (T, F, B), ``dev``, ``dt`` and ``fb`` and
    defines ``_block(leaves, f0, f1)`` -> (T, f1 - f0, B) complex."""

    def _leaves(self, leaves):
        return {k: leaves[k].detach().to(self.dev, self.dt).requires_grad_(True)
                for k in self.leaves}

    @torch.no_grad()
    def forward(self, leaves):
        x = {k: leaves[k].to(self.dev, self.dt) for k in self.leaves}
        F = len(self.freqs)
        return torch.cat([self._block(x, f0, min(f0 + self.fb, F))
                          for f0 in range(0, F, self.fb)], dim=1)

    def value_and_grad(self, leaves, weight=None):
        """The negative log likelihood (neg_log_like) of the baselines,
        each weighted by weight (B,), one by default, and its gradients."""
        x = self._leaves(leaves)
        F, loss = len(self.freqs), 0.0
        w = None if weight is None else weight.to(self.dev, self.dt)
        for f0 in range(0, F, self.fb):
            f1 = min(f0 + self.fb, F)
            c = neg_log_like(self._block(x, f0, f1), self.data[:, f0:f1],
                             self.icov, w)
            c.backward()
            loss += float(c.detach())
        return loss, {k: v.grad for k, v in x.items()}
