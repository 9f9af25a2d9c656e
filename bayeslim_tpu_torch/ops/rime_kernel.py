"""
The RIME pixel reduction: V[..., b, f] = sum_pix psky[..., mp(b), f, pix]
* exp(+-2 pi i f tau[b, pix]).

Counterpart of bayeslim_tpu/ops/rime_kernel.py (`_pallas_eligible` :59,
`_rime_fused_dispatch` :84, rime_reduce_ref :162, rime_reduce :223).

- ``rime_reduce_ref`` materialises the whole fringe (small problems,
  tests).
- ``rime_reduce`` reduces pixel chunk by chunk, each chunk a
  ``_ChunkReduce`` that keeps only its inputs: its backward recomputes
  the chunk's fringe instead of storing it (torch.utils.checkpoint's
  job, written out with explicit formulas so that forward-mode AD over
  it works on every torch release). Eligible problems (float32, a regular
  frequency grid, psky in model-pair space) go to the fused kernel
  instead: automatically on CUDA, or everywhere with use_kernel=True
  (on the CPU the fused Functions run the kernel's plain version).
  Leading (polarization) blocks stack as rows of one launch; with
  Nmp > 1 model pairs and a host baseline -> pair map the baselines are
  grouped by pair, one fused call a pair, and the result
  inverse-permuted; with a device map (a tensor) every pair runs over
  all the baselines and a mask selects each baseline's. Delays factored as blvecs @ s_c go through
  ``RimeFusedBS``, a given delay matrix tau through ``RimeFused``.
- ``force_chunked`` (the JAX package's ``force_xla`` :45-56) turns the
  fused dispatch off inside its block (and models/airy_psky.py's): the
  fused Functions' backward has no derivative of its own, and
  second-order differentiation (Hessians, Hessian-vector products) goes
  through the chunked path.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .phase import fringe_cycles
from .rime_cuda import no_tf32, rime_fused, rime_fused_bs

__all__ = ["rime_reduce", "rime_reduce_ref", "force_chunked",
           "chunked_forced"]

_FORCE_CHUNKED = [False]


@contextlib.contextmanager
def force_chunked():
    """Run every RIME reduction on the chunked PyTorch path inside the
    block, whatever its use_kernel, and the per-time sky and Airy beam
    on its eager path (models/airy_psky.py): every fused kernel's plain
    version (counterpart of the JAX package's ``force_xla``,
    ops/rime_kernel.py:45-56, which turns the Pallas dispatch off). The
    fused Functions' backward launches the kernels and is not itself
    differentiable; the chunked path is, at any order.
    ``inference.hessian.compute_hessian`` enters it; a second derivative
    taken through the fused Functions outside it raises an error that
    names it. Nothing enters it on its own when a kernel fails."""
    prev = _FORCE_CHUNKED[0]
    _FORCE_CHUNKED[0] = True
    try:
        yield
    finally:
        _FORCE_CHUNKED[0] = prev


def chunked_forced():
    """True inside a force_chunked block."""
    return _FORCE_CHUNKED[0]


def _kernel_eligible(psky, mp_idx, freqs, use_kernel, blvecs, tau=None):
    """float32, regular frequency grid, delays given (factored or as a
    matrix), psky in model-pair space (shared across baselines, or
    Nmp pairs with an mp_idx); on CUDA unless forced; never inside
    force_chunked."""
    if _FORCE_CHUNKED[0] or not use_kernel \
            or (blvecs is None and tau is None) or psky.ndim < 3:
        return False
    if mp_idx is None and psky.shape[-3] != 1:
        return False      # per-baseline psky: the kernel shares rows
    if psky.dtype not in (torch.float32, torch.complex64):
        return False
    if len(freqs) > 1:
        d = np.diff(freqs)
        if not np.allclose(d, d[0], rtol=1e-10):
            return False
    if use_kernel == "auto":
        return psky.is_cuda
    return True


def _rime_fused_dispatch(psky, freqs, conj, mp_idx, blvecs, s_c, tau):
    """Map the (..., Nmp, Nfreqs, Npix) contract onto the 2D stacked-row
    fused kernel: leading (polarization) blocks stack as rows; with
    Nmp > 1 and a host mp_idx the baselines are grouped by model pair,
    one fused call a pair on that pair's baselines, and the concatenated
    result is inverse-permuted. A device mp_idx (a tensor: the JAX
    package's branch :118-135) runs every pair over all the baselines,
    one fused call a pair, and selects each baseline's pair by a mask:
    Nmp x the kernel's triples, where the host grouping does 1x (the
    per-process sharding regroups its local baselines on the host
    instead, parallel/sharding.shard_rime)."""
    lead = psky.shape[:-3]
    nmp, nf, npx = psky.shape[-3:]
    nb = blvecs.shape[0] if blvecs is not None else tau.shape[0]
    f0 = float(freqs[0])
    df = float(freqs[1] - freqs[0]) if nf > 1 else 0.0

    def run(ps2d, sel=None):
        if blvecs is not None:
            bv = blvecs if sel is None else blvecs.index_select(0, sel)
            return rime_fused_bs(ps2d, bv, s_c, f0, df, nf, conj)
        t = tau if sel is None else tau.index_select(0, sel)
        return rime_fused(ps2d, t, f0, df, nf, conj)

    if mp_idx is None or nmp == 1:
        out = run(psky.reshape(-1, npx))                  # (L*nf, nb)
    elif isinstance(mp_idx, torch.Tensor):
        stack = torch.stack([run(psky[..., m, :, :].reshape(-1, npx))
                             for m in range(nmp)])        # (nmp, L*nf, nb)
        sel = mp_idx.to(psky.device)[None, None, :] == torch.arange(
            nmp, device=psky.device)[:, None, None]
        out = torch.sum(stack * sel.to(stack.real.dtype), dim=0)
    else:
        mp = np.asarray(mp_idx)
        dev = psky.device
        outs, order = [], []
        for m in range(nmp):
            idx = np.where(mp == m)[0]
            if len(idx) == 0:
                continue
            order.append(idx)
            outs.append(run(psky[..., m, :, :].reshape(-1, npx),
                            torch.as_tensor(idx, device=dev)))
        perm = np.concatenate(order)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        out = torch.cat(outs, dim=-1).index_select(
            -1, torch.as_tensor(inv, device=dev))
    out = out.reshape(lead + (nf, nb))
    return out.movedim(-2, -1)                            # (..., nb, nf)


def rime_reduce_ref(psky, tau, freqs, mp_idx=None, conj=False):
    """Reference reduction with the fringe materialised.

    psky : (..., Nmp, Nfreqs, Npix), or (..., Nbls, Nfreqs, Npix)
    tau : (Nbls, Npix) delays [s]; freqs : (Nfreqs,) host array [Hz]
    mp_idx : optional (Nbls,) baseline -> model-pair index
    Returns (..., Nbls, Nfreqs) complex.
    """
    ang = (2 * np.pi) * fringe_cycles(tau, freqs)          # (Nb, Np, Nf)
    s = -1.0 if conj else 1.0
    fr = torch.complex(torch.cos(ang), s * torch.sin(ang)).movedim(-1, -2)
    if mp_idx is not None:
        psky = psky.index_select(-3, torch.as_tensor(
            np.asarray(mp_idx), device=psky.device))
    return torch.sum(psky * fr, dim=-1)


def _fringe(tau_c, freqs, conj):
    """cos and sgn sin of 2 pi f tau for a chunk's delays: (Nb, C, F)."""
    ang = (2 * np.pi) * fringe_cycles(tau_c, freqs)
    return torch.cos(ang), (-torch.sin(ang) if conj else torch.sin(ang))


def _contract(ps, er, ei, shared):
    """sum_c ps[..., (b,) f, c] (er + i ei)[b, c, f] -> (re, im) planes of
    (..., Nb, F), true fp32 / fp64; ps real or complex, er / ei real."""
    spec = "...fc,bcf->...bf" if shared else "...bfc,bcf->...bf"

    def es(a, b):
        return torch.einsum(spec, a, b)
    with no_tf32():
        if ps.is_complex():
            return (es(ps.real, er) - es(ps.imag, ei),
                    es(ps.real, ei) + es(ps.imag, er))
        return es(ps, er), es(ps, ei)


def _per_bl(ps, mp):
    """ps (..., Nmp, F, C) gathered onto the baselines by the pair index
    mp (a device tensor); ps itself without one."""
    return ps if mp is None else ps.index_select(-3, mp)


def _chunk_body(ps, tau_c, freqs, conj, shared, out_dtype, mp=None):
    """Reduce one pixel chunk: ps (..., F, C) shared across baselines,
    (..., Nb, F, C) per baseline, or (..., Nmp, F, C) per model pair
    with the baseline -> pair index mp; returns (..., Nbls, Nfreqs)
    complex."""
    ps = _per_bl(ps, mp)
    cosf, sinf = _fringe(tau_c, freqs, conj)
    re, im = _contract(ps, cosf, sinf, shared)
    return torch.complex(re, im).to(out_dtype)


class _ChunkReduce(torch.autograd.Function):
    """_chunk_body keeping only its inputs. The backward recomputes the
    chunk's fringe E = exp(i sgn 2 pi f tau) and returns, with g the
    incoming gradient, dps = sum_b g conj(E) (its real part for a real
    ps) and dtau = Re(sum conj(g) ps E i sgn 2 pi f) over the leading
    dimensions and channels: torch.utils.checkpoint's memory with
    explicit formulas. Those formulas are plain differentiable tensor
    operations on the saved inputs, so a second derivative through them
    is exact, forward-over-reverse (compute_hessian) or reverse-over-
    reverse; jvp is the product rule. torch 2.11's checkpoint has no
    jvp, so forward-mode AD could not cross it there. With a model-pair
    index mp, ps is kept per pair (..., Nmp, F, C) and gathered onto the
    baselines inside each pass; dps is summed back over each pair's
    baselines (index_add), so no per-baseline sky outlives a pass."""

    @staticmethod
    def forward(ctx, ps, tau_c, freqs, conj, shared, out_dtype, mp=None):
        ctx.meta = (freqs, conj, shared)
        ctx.save_for_backward(ps, tau_c, mp)
        ctx.save_for_forward(ps, tau_c, mp)
        with torch.no_grad():
            return _chunk_body(ps, tau_c, freqs, conj, shared, out_dtype,
                               mp)

    @staticmethod
    def _dphase(tau_c, freqs, conj):
        """d(sgn 2 pi f tau) / d tau on the (Nb, C, F) layout."""
        w = (-2 * np.pi if conj else 2 * np.pi) * np.asarray(freqs)
        return torch.as_tensor(w, dtype=tau_c.dtype, device=tau_c.device)

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, tps, ttau, *_):
        # no graph: the tangent is not differentiated again, and a graph
        # would keep every chunk's fringe alive through it
        ps, tau_c, mp = ctx.saved_tensors
        freqs, conj, shared = ctx.meta
        cosf, sinf = _fringe(tau_c, freqs, conj)
        re = im = None
        if tps is not None:
            re, im = _contract(_per_bl(tps, mp), cosf, sinf, shared)
        if ttau is not None:
            # dE = E i w ttau
            d = _ChunkReduce._dphase(tau_c, freqs, conj) * ttau[..., None]
            r, i = _contract(_per_bl(ps, mp), -sinf * d, cosf * d, shared)
            re, im = (r, i) if re is None else (re + r, im + i)
        out_dtype = torch.complex128 if re.dtype == torch.float64 \
            else torch.complex64
        return torch.complex(re, im).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        ps, tau_c, mp = ctx.saved_tensors
        freqs, conj, shared = ctx.meta
        cosf, sinf = _fringe(tau_c, freqs, conj)
        E = torch.complex(cosf, sinf).to(g.dtype)          # (Nb, C, F)
        dps = dtau = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                spec = "...bf,bcf->...fc" if shared else "...bf,bcf->...bfc"
                dps = torch.einsum(spec, g, E.conj())
                dps = (dps if ps.is_complex() else dps.real).to(ps.dtype)
                if mp is not None:
                    dps = torch.zeros_like(ps).index_add(-3, mp, dps)
            if ctx.needs_input_grad[1]:
                spec = "...bf,...fc->bcf" if shared else "...bf,...bfc->bcf"
                P = torch.einsum(spec, g.conj(), _per_bl(ps, mp).to(g.dtype))
                w = _ChunkReduce._dphase(tau_c, freqs, conj)
                dtau = (-(P * E).imag * w).sum(-1).to(tau_c.dtype)
        return dps, dtau, None, None, None, None, None


def rime_reduce(psky, tau, freqs, mp_idx=None, conj=False, chunk=1024,
                remat=True, use_kernel="auto", blvecs=None, s_c=None):
    """Pixel-chunked RIME reduction (contract of rime_reduce_ref).

    tau may be None when (blvecs, s_c) are given: tau = blvecs @ s_c is
    then built inside the fused Function's passes, or here for the
    chunked path. mp_idx: a (Nbls,) baseline -> model-pair index, host
    array or device tensor (None: psky shared across baselines). use_kernel: "auto" takes the
    fused kernel for eligible problems on CUDA, True forces the fused
    Functions (their plain version on the CPU), False disables them.
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    if _kernel_eligible(psky, mp_idx, freqs, use_kernel, blvecs, tau):
        return _rime_fused_dispatch(psky, freqs, conj, mp_idx, blvecs, s_c,
                                    tau)
    if tau is None:
        with no_tf32():
            tau = blvecs @ s_c
    rdtype = torch.promote_types(psky.real.dtype, tau.dtype)
    out_dtype = torch.complex128 if rdtype == torch.float64 \
        else torch.complex64

    shared = mp_idx is None and psky.shape[-3] == 1
    ps = psky[..., 0, :, :] if shared else psky        # (..., [N,] F, Npix)
    # the pair index gathers psky onto the baselines a chunk at a time
    mp = None if mp_idx is None else torch.as_tensor(
        mp_idx, dtype=torch.int64, device=psky.device)
    out = None
    for i in range(0, psky.shape[-1], chunk):
        args = (ps[..., i:i + chunk], tau[..., i:i + chunk], freqs, conj,
                shared, out_dtype, mp)
        o = _ChunkReduce.apply(*args) if remat else _chunk_body(*args)
        out = o if out is None else out + o
    return out
