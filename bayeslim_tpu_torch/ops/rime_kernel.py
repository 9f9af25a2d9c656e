"""
The RIME pixel reduction: V[..., b, f] = sum_pix psky[..., mp(b), f, pix]
* exp(+-2 pi i f tau[b, pix]).

Counterpart of bayeslim_tpu/ops/rime_kernel.py (`_pallas_eligible` :59,
`_rime_fused_dispatch` :84, rime_reduce_ref :162, rime_reduce :223).

- ``rime_reduce_ref`` materialises the whole fringe (small problems,
  tests).
- ``rime_reduce`` reduces pixel chunk by chunk, each chunk under
  ``torch.utils.checkpoint`` so the backward recomputes the chunk's
  fringe instead of storing it. Eligible problems (float32, a regular
  frequency grid, psky in model-pair space) go to the fused kernel
  instead: automatically on CUDA, or everywhere with use_kernel=True
  (on the CPU the fused Functions run the kernel's plain version).
  Leading (polarization) blocks stack as rows of one launch; with
  Nmp > 1 model pairs and a host baseline -> pair map the baselines are
  grouped by pair, one fused call a pair, and the result
  inverse-permuted. Delays factored as blvecs @ s_c go through
  ``RimeFusedBS``, a given delay matrix tau through ``RimeFused``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .phase import fringe_cycles
from .rime_cuda import no_tf32, rime_fused, rime_fused_bs

__all__ = ["rime_reduce", "rime_reduce_ref"]


def _kernel_eligible(psky, mp_idx, freqs, use_kernel, blvecs, tau=None):
    """float32, regular frequency grid, delays given (factored or as a
    matrix), psky in model-pair space (shared across baselines, or
    Nmp pairs with an mp_idx); on CUDA unless forced."""
    if not use_kernel or (blvecs is None and tau is None) or psky.ndim < 3:
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
    Nmp > 1 the baselines are grouped by model pair (mp_idx is host
    metadata), one fused call a pair on that pair's baselines, and the
    concatenated result is inverse-permuted."""
    if isinstance(mp_idx, torch.Tensor):
        raise NotImplementedError(
            "a device mp_idx (baseline sharding: every pair over all "
            "baselines, mask-selected) waits for the multi-device port "
            "(parallel/sharding.py, ROADMAP queue A10); pass the baseline "
            "-> pair map as a host array")
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


def _chunk_body(psky_c, tau_c, freqs, mp_idx, conj, out_dtype):
    """Reduce one pixel chunk: returns (..., Nbls, Nfreqs) complex."""
    ang = (2 * np.pi) * fringe_cycles(tau_c, freqs)        # (Nb, C, F)
    cosf = torch.cos(ang)
    sinf = -torch.sin(ang) if conj else torch.sin(ang)
    if mp_idx is None and psky_c.shape[-3] == 1:
        ps = psky_c[..., 0, :, :]                          # (..., F, C)
        spec = "...fc,bcf->...bf"
    else:
        ps = psky_c if mp_idx is None else psky_c.index_select(
            -3, torch.as_tensor(np.asarray(mp_idx), device=psky_c.device))
        spec = "...bfc,bcf->...bf"

    def es(a, b):
        return torch.einsum(spec, a, b)
    with no_tf32():
        if ps.is_complex():
            re = es(ps.real, cosf) - es(ps.imag, sinf)
            im = es(ps.real, sinf) + es(ps.imag, cosf)
        else:
            re = es(ps, cosf)
            im = es(ps, sinf)
    return torch.complex(re, im).to(out_dtype)


def rime_reduce(psky, tau, freqs, mp_idx=None, conj=False, chunk=1024,
                remat=True, use_kernel="auto", blvecs=None, s_c=None):
    """Pixel-chunked RIME reduction (contract of rime_reduce_ref).

    tau may be None when (blvecs, s_c) are given: tau = blvecs @ s_c is
    then built inside the fused Function's passes, or here for the
    chunked path. mp_idx: a host (Nbls,) baseline -> model-pair index
    (None: psky shared across baselines). use_kernel: "auto" takes the
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

    def body(ps, tc):
        return _chunk_body(ps, tc, freqs, mp_idx, conj, out_dtype)

    out = None
    for i in range(0, psky.shape[-1], chunk):
        args = (psky[..., i:i + chunk], tau[..., i:i + chunk])
        o = checkpoint(body, *args, use_reentrant=False) if remat \
            else body(*args)
        out = o if out is None else out + o
    return out
