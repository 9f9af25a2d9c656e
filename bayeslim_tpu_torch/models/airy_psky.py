"""
The per-time sky times an Airy power beam in one CUDA pass each way:
``make_psky`` (models/rime.py) for an ``AiryResponse`` power beam.

Contract (shapes of the RIME's per-time pass): for the sky (1, 1, Nf,
Npix), the beam's angles zen, az [deg], its FOV cut (Ncut) and mask
(Ncut), the beam's diameters D (Nmodel, ncomp) (EW, and NS when ncomp is
2) and the model pairs' first models mp1 (Nmp),

    psky[0, 0, m, f, p] = mask[p] sky[0, 0, f, cut[p]] b(x)^2,
    b = 2 J1(x) / x (1 where x < 1e-8),
    x = 2 pi (freqs[f] ratio) (D_m(az_p) / 2) / c sin(zen_p),

sin(zen) taken as 1 below the horizon, D_m = Dns + sin^2(az) (Dew - Dns)
of model mp1[m] (Dew for a circular aperture), J1 models/bessel.py's
approximant: what ``airy_disk`` and ``apply_beam_mp`` compute, returned
as (1, 1, Nmp, Nf, Ncut).

``AiryPsky`` is the autograd Function: a CUDA tensor launches
``csrc/airy_psky.cu`` (float32 tensors only, anything else raises; the
backward takes dD's terms in double, since they cancel), a CPU tensor
runs the plain version (``airy_psky_plain``, the eager path itself, and
``airy_psky_bwd_ref``, the backward's formulas in plain PyTorch). It
saves only its inputs, which the RIME keeps alive anyway, so its caller
does not checkpoint it. The backward is first-order only, as the fused
RIME Functions' (``ops.rime_cuda._first_order``).

``fused_eligible`` is the dispatch predicate ``make_psky`` takes: a
float32 CUDA power beam of an ``AiryResponse`` without taper or brute
force, one polarization and one feed, a (1, 1, Nf, Npix) sky, outside
forward-mode AD and outside ``ops.rime_kernel.force_chunked``.
Everything else keeps the eager path, which is also the route for
second derivatives.

``launches`` and ``bwd_launches`` count the kernel calls (a backward
call is its kernel and its fixed-order sum).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.linalg import dual_active
from ..ops.rime_cuda import SECOND_ORDER_ERROR, _first_order, _lib
from ..ops.rime_kernel import chunked_forced
from ..utils.dtypes import C_MS, D2R
from .beam import AiryResponse, airy_disk, cut_sky_fov
from .bessel import J1_K, J1_P, J1_P2, J1_PHASE, J1_Q, J1_Q2

__all__ = ["AiryPsky", "airy_psky", "fused_eligible", "airy_psky_plain",
           "airy_psky_bwd_ref", "airy_b", "launches", "bwd_launches",
           "bytes_fwd", "bytes_bwd"]

# kernel calls (incremented once per call, nowhere else)
launches = 0
bwd_launches = 0

# csrc/airy_psky.cu's pixels a block and channels a thread
PX, FC = 256, 8

# argument types of the C launchers (pointers and the stream as
# c_void_p, so ctypes does not cut them to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 9 + [_I] * 5 + [_F, _P]
_BWD_ARGS = [_P] * 12 + [_I] * 6 + [ctypes.c_longlong, _F, _P]


def _on_card(t):
    """A float32 CUDA tensor: what the kernels take."""
    return t.is_cuda and t.dtype == torch.float32


def fused_eligible(beam, sky, zen):
    """True where make_psky takes the fused kernels (module docstring)."""
    R = beam.R
    return (isinstance(R, AiryResponse) and R.powerbeam and beam.powerbeam
            and not R.brute_force and R.taper_kwargs is None
            and beam.Npol == 1 and beam.Nvec == 1
            and sky.ndim == 4 and tuple(sky.shape[:2]) == (1, 1)
            and all(_on_card(t)
                    for t in (sky, zen, beam.params, beam._freqs_t))
            and not dual_active() and not chunked_forced())


def airy_psky(beam, sky, zen, az, cut, mask, mp1):
    """make_psky's result for a beam that fused_eligible takes, through
    AiryPsky: its params (plus p0), channels and priors as gen_beam
    takes them."""
    p = beam.params if beam.p0 is None else beam.params + beam.p0
    psky = AiryPsky.apply(sky, zen, az, cut, mask, p[0, 0, :, 0, :2], mp1,
                          beam._freqs_t, float(beam.R.freq_ratio))
    beam.eval_prior(None, inp_params=beam.params, out_params=None)
    return psky


def airy_psky_plain(sky, zen, az, cut, mask, D, mp1, freqs, ratio):
    """The eager path (the contract in the module docstring): airy_disk,
    the FOV cut and apply_beam_mp's product, as make_psky runs them."""
    Dew = D[:, 0:1][None, None]
    Dns = D[:, 1:2][None, None] if D.shape[1] > 1 else None
    b = airy_disk(zen * D2R, az * D2R, Dew, freqs, Dns, freq_ratio=ratio)
    return b.index_select(2, mp1) * (cut_sky_fov(sky, cut) * mask)[:, :, None]


def _horner_d(c, y):
    """c[0] + c[1] y + ... and its derivative in y, by Horner's rule."""
    p = torch.full_like(y, c[-1])
    d = torch.zeros_like(y)
    for a in reversed(c[:-1]):
        d = d * y + p
        p = p * y + a
    return p, d


def airy_b(x):
    """(b, db / dx) of b = 2 J1(x) / x with bessel.j1's approximant, as
    csrc/airy_psky.cu's airy_b: below 8 the quotient rule on 2 J1_P(y) /
    J1_Q(y), y = x^2; above it the chain rule through sqrt(J1_K / x) (cos
    P2 - z sin Q2); 1 and 0 where x < 1e-8."""
    small = x < 1e-8
    xs = torch.where(small, torch.ones_like(x), x)
    P, dP = _horner_d(J1_P, xs * xs)
    Q, dQ = _horner_d(J1_Q, xs * xs)
    b_lo = 2 * P / Q
    db_lo = 4 * xs * (dP * Q - P * dQ) / (Q * Q)
    xl = torch.clamp(xs, min=8.0)      # the other branch stays finite
    z = 8.0 / xl
    p2, dp2 = _horner_d(J1_P2, z * z)
    q2, dq2 = _horner_d(J1_Q2, z * z)
    sn, cs = torch.sin(xl - J1_PHASE), torch.cos(xl - J1_PHASE)
    A = torch.sqrt(J1_K / xl)
    T = cs * p2 - z * sn * q2
    dz = -z / xl
    dy2 = 2 * z * dz
    dT = -sn * p2 + cs * dp2 * dy2 - (dz * sn * q2 + z * cs * q2
                                      + z * sn * dq2 * dy2)
    J, dJ = A * T, A * (dT - T / (2 * xl))
    b_hi, db_hi = 2 * J / xl, 2 * (dJ - J / xl) / xl
    lo = xs < 8.0
    b = torch.where(small, torch.ones_like(x), torch.where(lo, b_lo, b_hi))
    db = torch.where(small, torch.zeros_like(x),
                     torch.where(lo, db_lo, db_hi))
    return b, db


def airy_psky_bwd_ref(g, sky, zen, az, cut, mask, D, mp1, freqs, ratio,
                      need_sky=True, need_D=True):
    """The backward's formulas in plain PyTorch (the kernel's twin): for
    psky's gradient g (1, 1, Nmp, Nf, Ncut), (dsky, dD) with

        dsky[0, 0, f, cut[p]] = mask[p] sum_m g[m, f, p] b^2,
        dD[n] = sum over m with mp1[m] = n, f, p of g mask sky 2 b b'
                dx/dD (dD/dDew = sin^2 az, dD/dDns = 1 - sin^2 az),

    b' from airy_b; None for a gradient not asked for."""
    zr = zen * D2R
    s = torch.where(zr > np.pi / 2, torch.ones_like(zr), torch.sin(zr))
    sa2 = torch.sin(az * D2R) ** 2
    Dm = D.index_select(0, mp1)                             # (Nmp, ncomp)
    if D.shape[1] > 1:
        hd = 0.5 * (Dm[:, 1:2] + sa2 * (Dm[:, 0:1] - Dm[:, 1:2]))
    else:
        hd = 0.5 * Dm[:, 0:1].expand(-1, zen.shape[0])
    kx = (2 * np.pi * (freqs * ratio) / C_MS)[:, None] * s  # (Nf, Ncut)
    b, db = airy_b(kx[None] * hd[:, None])                  # (Nmp, Nf, Ncut)
    g3 = g[0, 0]
    dsky = dD = None
    if need_sky:
        dsky = torch.zeros_like(sky).index_add_(
            -1, cut, (mask * (g3 * b * b).sum(0))[None, None])
    if need_D:
        csky = cut_sky_fov(sky[0, 0], cut) * mask
        t = (g3 * csky * b * db * kx).sum(1)   # 2 b b' dx/dD, dx/dD = kx / 2
        per = torch.stack([(t * sa2).sum(-1), (t * (1 - sa2)).sum(-1)], -1) \
            if D.shape[1] > 1 else t.sum(-1, keepdim=True)
        dD = torch.zeros_like(D).index_add_(0, mp1, per)
    return dsky, dD


def _prepared(name, g, sky, zen, az, cut, mask, D, mp1, freqs):
    """The kernel's inputs contiguous, after checking devices, dtypes and
    shapes (g None in the forward)."""
    floats = [t for t in (g, sky, zen, az, mask, D, freqs) if t is not None]
    if not all(t.is_cuda and t.device == sky.device
               for t in floats + [cut, mp1]):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in floats) \
            or cut.dtype != torch.int64 or mp1.dtype != torch.int64:
        raise TypeError(f"{name} kernel takes float32 tensors and int64 "
                        f"cut / mp1, got {[t.dtype for t in floats]}, "
                        f"{cut.dtype}, {mp1.dtype}")
    ncut = cut.shape
    if sky.ndim != 4 or tuple(sky.shape[:2]) != (1, 1) or cut.ndim != 1 \
            or freqs.shape != sky.shape[2:3] or D.ndim != 2 \
            or D.shape[1] not in (1, 2) or mp1.ndim != 1 \
            or any(t.shape != ncut for t in (zen, az, mask)) \
            or (g is not None and g.shape != (1, 1, mp1.shape[0],
                                              sky.shape[2], ncut[0])):
        raise ValueError(f"{name}: bad shapes sky {tuple(sky.shape)}, cut "
                         f"{tuple(cut.shape)}, D {tuple(D.shape)}, mp1 "
                         f"{tuple(mp1.shape)}, freqs {tuple(freqs.shape)}")
    return [None if t is None else t.contiguous()
            for t in (g, sky, zen, az, cut, mask, D, mp1, freqs)]


def airy_psky_fwd(sky, zen, az, cut, mask, D, mp1, freqs, ratio):
    """psky (the contract in the module docstring): the kernel on CUDA
    tensors, airy_psky_plain on CPU ones."""
    if not sky.is_cuda:
        return airy_psky_plain(sky, zen, az, cut, mask, D, mp1, freqs, ratio)
    global launches
    _, sky, zen, az, cut, mask, D, mp1, freqs = _prepared(
        "airy_psky", None, sky, zen, az, cut, mask, D, mp1, freqs)
    nf, npix = sky.shape[2:]
    ncut, nmp = cut.shape[0], mp1.shape[0]
    out = torch.empty((1, 1, nmp, nf, ncut), dtype=torch.float32,
                      device=sky.device)
    stream = torch.cuda.current_stream(sky.device).cuda_stream
    rc = _lib("airy_psky.cu", "airy_psky_fwd_launch", _FWD_ARGS)(
        sky.data_ptr(), zen.data_ptr(), az.data_ptr(), cut.data_ptr(),
        mask.data_ptr(), D.data_ptr(), mp1.data_ptr(), freqs.data_ptr(),
        out.data_ptr(), nf, npix, ncut, nmp, D.shape[1], float(ratio),
        stream)
    if rc != 0:
        raise RuntimeError(f"airy_psky kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def airy_psky_bwd(g, sky, zen, az, cut, mask, D, mp1, freqs, ratio,
                  need_sky=True, need_D=True):
    """(dsky, dD) of airy_psky_bwd_ref: the kernel and its fixed-order
    sum on CUDA tensors (bit-equal from call to call), the reference on
    CPU ones."""
    if not sky.is_cuda:
        return airy_psky_bwd_ref(g, sky, zen, az, cut, mask, D, mp1, freqs,
                                 ratio, need_sky, need_D)
    if not (need_sky or need_D):
        return None, None
    global bwd_launches
    g, sky, zen, az, cut, mask, D, mp1, freqs = _prepared(
        "airy_psky backward", g, sky, zen, az, cut, mask, D, mp1, freqs)
    nf, npix = sky.shape[2:]
    ncut, nmp = cut.shape[0], mp1.shape[0]
    nmodel, ncomp = D.shape
    dev = sky.device
    dsky = torch.zeros((1, 1, nf, npix), dtype=torch.float32, device=dev) \
        if need_sky else None
    # the kernel's per-block partial sums of dD (Nmp, blocks, 2)
    nparts = 2 * nmp * -(-ncut // PX) * -(-nf // FC)
    part = torch.empty(nparts, dtype=torch.float64, device=dev) \
        if need_D else None
    dD = torch.empty((nmodel, ncomp), dtype=torch.float32, device=dev) \
        if need_D else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib("airy_psky.cu", "airy_psky_bwd_launch", _BWD_ARGS)(
        g.data_ptr(), sky.data_ptr(), zen.data_ptr(), az.data_ptr(),
        cut.data_ptr(), mask.data_ptr(), D.data_ptr(), mp1.data_ptr(),
        freqs.data_ptr(), None if dsky is None else dsky.data_ptr(),
        None if part is None else part.data_ptr(),
        None if dD is None else dD.data_ptr(), nf, npix, ncut, nmp, nmodel,
        ncomp, nparts, float(ratio), stream)
    if rc != 0:
        raise RuntimeError(f"airy_psky backward kernel launch failed: CUDA "
                           f"error {rc}")
    bwd_launches += 1
    return dsky, dD


class AiryPsky(torch.autograd.Function):
    """psky of the module docstring's contract, differentiable in the sky
    and in D. Saves only its inputs. The backward computes only the
    gradients asked for, in one kernel call (CUDA) or by
    airy_psky_bwd_ref (CPU); it is first-order only: a second
    derivative, or forward-mode AD, raises SECOND_ORDER_ERROR, which
    names ops.rime_kernel.force_chunked."""

    @staticmethod
    def forward(ctx, sky, zen, az, cut, mask, D, mp1, freqs, ratio):
        ctx.save_for_backward(sky, zen, az, cut, mask, D, mp1, freqs)
        ctx.ratio = ratio
        return airy_psky_fwd(sky, zen, az, cut, mask, D, mp1, freqs, ratio)

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(SECOND_ORDER_ERROR)

    @staticmethod
    @_first_order
    def backward(ctx, g):
        sky, zen, az, cut, mask, D, mp1, freqs = ctx.saved_tensors
        need_sky, need_D = ctx.needs_input_grad[0], ctx.needs_input_grad[5]
        dsky, dD = airy_psky_bwd(g, sky, zen, az, cut, mask, D, mp1, freqs,
                                 ctx.ratio, need_sky, need_D)
        return dsky, None, None, None, None, dD, None, None, None


def bytes_fwd(nf, ncut, nmp=1):
    """Bytes the forward must move: the gathered sky read once and psky
    written once (the per-pixel and per-channel inputs left out)."""
    return 4 * nf * ncut * (1 + nmp)


def bytes_bwd(nf, npix, ncut, nmp=1):
    """Bytes a backward call must move: g and the gathered sky read
    once, the zeroed (Nf, Npix) sky gradient written once."""
    return 4 * (nf * ncut * (nmp + 1) + nf * npix)
