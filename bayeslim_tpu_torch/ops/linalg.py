"""
Linear algebra helpers: weighted least squares, matrix inversion
dispatch, diagonal-matrix shortcuts and complex conveniences.

Counterpart of bayeslim_tpu/ops/linalg.py (cholesky_inverse :79,
invert_matrix :100, least_squares :139, cov_get_diag :285). torch's
complex dtypes are native, so cmult / cdiv / cconj / ceinsum / cinv are
thin aliases there as here.

Pseudo-inverse cut-offs: ``torch.linalg.pinv`` keeps singular values
above ``rtol * s_max`` and defaults to ``rtol = max(M, N) * eps``; the
JAX package's ``jnp.linalg.pinv`` defaults to ``10 * max(M, N) * eps``.
Every pinv here passes its cut-off explicitly (``pinv_rtol`` gives the
JAX default).

``apply_along`` is the port's one contraction of a matrix along a
dimension (LinearModel, the filters of models/filt.py): torch.einsum in
true fp32 both ways, with the dtype promotion jnp.einsum does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.dtypes import viewcomp, viewreal
from .rime_cuda import no_tf32

__all__ = [
    "cmult", "cdiv", "cconj", "ceinsum", "cinv", "angle", "abs",
    "diag_matmul", "diag_inv", "invert_matrix", "cholesky_inverse",
    "least_squares", "apply_phasor", "project_out_phase", "cmatmul",
    "cov_get_diag", "pinv", "pinv_rtol", "apply_along",
]

_LETTERS = "ijklmnop"


def cmult(a, b):
    return a * b


def angle(a):
    """Complex phase [rad]."""
    return torch.angle(a)


def abs(a):
    """Complex magnitude."""
    return torch.abs(a)


def cdiv(a, b):
    return a / b


def cconj(a):
    return torch.conj(a)


def ceinsum(eq, *ops):
    return torch.einsum(eq, *ops)


def cinv(a):
    return torch.linalg.inv(a)


def pinv_rtol(A):
    """The JAX package's default pinv cut-off for A: 10 max(M, N) eps of
    A's real dtype."""
    return 10.0 * max(A.shape[-2:]) * torch.finfo(A.real.dtype).eps


def pinv(A, rtol=None, hermitian=False):
    """Pseudo-inverse with the JAX package's cut-off convention (rtol
    relative to the largest singular value; None: ``pinv_rtol(A)``)."""
    rtol = pinv_rtol(A) if rtol is None else rtol
    return torch.linalg.pinv(A, rtol=rtol, hermitian=hermitian)


def dual_active():
    """True inside a torch.autograd.forward_ad.dual_level (forward-mode
    AD, as compute_hessian runs it): the product Functions then keep
    both operands for their jvp."""
    import torch.autograd.forward_ad as fwAD
    return fwAD._current_level >= 0


class _Einsum(torch.autograd.Function):
    """torch.einsum(eq, a, b) in true fp32 both ways (torch.einsum's own
    backward would run outside the caller's no_tf32 block): a's gradient
    is the einsum of g and conj(b) onto a's subscripts, b's that of
    conj(a) and g onto b's; each operand is saved only where the other
    takes a gradient. The backward is itself differentiable (a Hessian
    runs it under forward-mode AD, or differentiates it again), and jvp
    is the product rule (both operands kept under forward-mode AD)."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a if ctx.needs_input_grad[2] else None,
                              b if ctx.needs_input_grad[1] else None)
        if dual_active():
            ctx.save_for_forward(a, b)
        with no_tf32():
            return torch.einsum(eq, a, b)

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, _, ta, tb):
        a, b = ctx.saved_tensors
        out = None
        with no_tf32():
            if ta is not None:
                out = torch.einsum(ctx.eq, ta, b)
            if tb is not None:
                o = torch.einsum(ctx.eq, a, tb)
                out = o if out is None else out + o
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        ta, tb = ins.split(",")
        ga = gb = None
        with no_tf32():
            if ctx.needs_input_grad[1]:
                ga = torch.einsum(f"{out},{tb}->{ta}", g, b.conj())
            if ctx.needs_input_grad[2]:
                gb = torch.einsum(f"{ta},{out}->{tb}", a.conj(), g)
        return None, ga, gb


def apply_along(A, x, dim):
    """y = A x along dimension dim of x: A (Nout, Nin), or (..., Nout,
    Nin) batched over the dimensions of x just before dim. Operands are
    promoted to a common dtype as jnp.einsum does; a real A on a complex
    x is one real product over the real and imaginary planes taken as
    extra rows (half the operations of a complex product). True fp32
    both ways."""
    dim = dim % x.ndim
    t2 = list(_LETTERS[:x.ndim])
    t2[dim] = "b"
    t2 = "".join(t2)
    t1 = "ab" if A.ndim == 2 else t2[dim - A.ndim + 2:dim] + "ab"
    tout = t2.replace("b", "a")
    if x.is_complex() and not A.is_complex():
        rdt = torch.promote_types(x.real.dtype, A.dtype)
        planes = torch.stack((x.real, x.imag)).to(rdt)
        out = _Einsum.apply(f"{t1},z{t2}->z{tout}", A.to(rdt), planes)
        return torch.complex(out[0], out[1])
    dt = torch.promote_types(A.dtype, x.dtype)
    return _Einsum.apply(f"{t1},{t2}->{tout}", A.to(dt), x.to(dt))


def diag_matmul(a, b):
    """Multiply stacks of diagonal 1x1 or 2x2 (pol) matrices on the two
    leading axes, dropping off-diagonal terms."""
    if a.shape[0] == 1:
        return a * b
    if a.shape[0] == 2:
        c = torch.zeros_like(a * b)
        c[0, 0] = a[0, 0] * b[0, 0]
        c[1, 1] = a[1, 1] * b[1, 1]
        return c
    raise ValueError("only 1x1 or 2x2 tensors")


def diag_inv(a):
    """Invert stacks of diagonal 1x1 or 2x2 (pol) matrices on the two
    leading axes, dropping off-diagonals."""
    if a.shape[0] == 1:
        return 1.0 / a
    if a.shape[0] == 2:
        c = torch.zeros_like(a)
        c[0, 0] = 1.0 / a[0, 0]
        c[1, 1] = 1.0 / a[1, 1]
        return c
    raise ValueError("only 1x1 or 2x2 tensors")


def cholesky_inverse(A, check_errors=True):
    """Inverse of a positive-definite A from its Cholesky factor:
    returns (Ainv, L). 1-D input inverts elementwise with L = sqrt(A).
    check_errors raises np.linalg.LinAlgError when A is not positive
    definite (the JAX factor turns NaN there; without the check the
    result here is NaN as well). The inverse is Linv^H Linv."""
    A = torch.as_tensor(A)
    if A.ndim == 1:
        return 1.0 / A, torch.sqrt(A)
    L, info = torch.linalg.cholesky_ex(A)
    if check_errors and bool(torch.any(info != 0)):
        raise np.linalg.LinAlgError("matrix is not positive definite")
    if not check_errors:
        bad = (info != 0)[..., None, None]
        L = torch.where(bad, torch.full_like(L, float("nan")), L)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.conj().transpose(-2, -1) @ Linv, L


def invert_matrix(A, method="pinv", rcond=1e-15, eps=0.0, hermitian=False,
                  inv=None):
    """Matrix inversion dispatch.

    method: 'pinv' | 'chol' | 'lstsq' | 'diag' | 'inv' (``inv=`` is an
    alias of method).
    eps regularises the inv / pinv / chol / lstsq branches; 1-D input
    returns 1 / A; 'diag' inverts the diagonal only.
    """
    if inv is not None:
        method = inv
    if A.ndim == 1:
        return 1.0 / A
    if method == "diag":
        d = torch.diagonal(A, dim1=-2, dim2=-1)
        return torch.diag_embed(1.0 / d)
    if eps:
        A = A + eps * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    if method == "pinv":
        return torch.linalg.pinv(A, rtol=rcond, hermitian=hermitian)
    if method == "chol":
        return cholesky_inverse(A, check_errors=False)[0]
    if method == "lstsq":
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        return _lstsq(A, eye, rcond)
    if method == "inv":
        return torch.linalg.inv(A)
    raise ValueError(f"unknown inversion method {method}")


def _lstsq(A, B, rcond):
    """Minimum-norm least-squares solution of A X = B with singular
    values below rcond * s_max dropped (the SVD solver jnp.linalg.lstsq
    uses), on any device."""
    P, B = _promoted(torch.linalg.pinv(A, rtol=rcond), B)
    return P @ B


def _promoted(a, b):
    """a and b in their common dtype (a real design matrix against
    complex data, as jnp promotes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _moveaxis_for_dim(y, dim):
    """Move ``dim`` of y to the last axis; return it and the inverse."""
    return y.movedim(dim, -1), lambda x: x.movedim(-1, dim)


def least_squares(A, y, dim=-1, Ninv=None, D=None, pinv=True, rcond=1e-15,
                  eps=0.0, hermitian=True, return_D=True, mode="matrix",
                  norm="inv", preconj=False, pretran=False, Ndiag=None):
    """Generalised weighted least squares x = D A^H Ninv y along
    dimension ``dim`` of y.

    A: (Nsamples, Nfeatures) design matrix; Ninv: None, a diagonal
    (a vector, or y's shape) or an (Nsamples, Nsamples) matrix; D: a
    precomputed normalisation (A^H Ninv A)^-1; mode 'matrix' (normal
    equations) or 'lstsq' (an SVD solve); norm None (D = identity),
    'inv' / 'pinv' / 'chol' (invert A^H Ninv A) or 'diag' (invert its
    diagonal); preconj / pretran: A arrives conjugated / transposed;
    Ndiag forces the diagonal (True) or matrix (False) reading of Ninv.

    Returns x (x.shape[dim] == Nfeatures) and, if return_D, D (None for
    norm None and for mode 'lstsq').
    """
    A = torch.as_tensor(A)
    y = torch.as_tensor(y)
    if pretran:
        A = A.T
    if preconj:
        A = A.conj()
    if A.is_complex() and not y.is_complex():
        y = y.to(A.dtype)

    y2, undo = _moveaxis_for_dim(y, dim)
    if Ndiag is None:
        Ndiag = Ninv is None or Ninv.ndim == 1 or Ninv.shape == y.shape
    if Ninv is not None and not Ndiag and A.is_complex():
        Ninv = Ninv.to(A.dtype)

    if mode == "lstsq":
        Aw, yw = A, y2
        if Ninv is not None:
            if Ndiag:
                w = torch.sqrt(Ninv if Ninv.ndim == 1
                               else _moveaxis_for_dim(Ninv, dim)[0])
                Aw = A * (w[:, None] if w.ndim == 1 else 1.0)
                yw = y2 * w
            else:
                L = torch.linalg.cholesky(Ninv)
                Aw = L.conj().T @ A
                yw = torch.einsum("sk,...k->...s", L.conj().T, y2)
        x = _lstsq(Aw, yw.reshape(-1, yw.shape[-1]).T, rcond).T
        x = undo(x.reshape(y2.shape[:-1] + (A.shape[-1],)))
        return (x, None) if return_D else x

    if mode != "matrix":
        raise ValueError(f"unknown mode {mode}")
    if Ninv is None:
        AhN = A.conj().T
        AhNA = A.conj().T @ A
    elif Ndiag:
        if Ninv.ndim == 1:
            AhN = A.conj().T * Ninv
        else:
            w, _ = _moveaxis_for_dim(Ninv, dim)
            AhN = A.conj().T[..., None, :, :] * w[..., None, :]
        AhNA = torch.einsum("...fs,sg->...fg", AhN, A)
        x = torch.einsum("...fs,...s->...f", *_promoted(AhN, y2))
        if norm is None:
            return (undo(x), None) if return_D else undo(x)
        if D is None:
            D = _lsq_norm(AhNA, norm, pinv, rcond, eps, hermitian)
        x = undo(_apply_D(D, x, norm))
        return (x, D) if return_D else x
    else:
        AhN = A.conj().T @ Ninv
        AhNA = AhN @ A

    x = torch.einsum("fs,...s->...f", *_promoted(AhN, y2))
    if norm is None:
        return (undo(x), None) if return_D else undo(x)
    if D is None:
        D = _lsq_norm(AhNA, norm, pinv, rcond, eps, hermitian)
    x = undo(_apply_D(D, x, norm))
    return (x, D) if return_D else x


def _lsq_norm(AhNA, norm, pinv, rcond, eps, hermitian):
    """Normalisation matrix of least_squares for ``norm``."""
    if norm == "diag":
        d = torch.diagonal(AhNA, dim1=-2, dim2=-1)
        return 1.0 / (d + eps if eps else d)
    method = norm if norm in ("pinv", "chol") else \
        ("pinv" if pinv else "inv")
    return invert_matrix(AhNA, method, rcond=rcond, eps=eps,
                         hermitian=hermitian)


def _apply_D(D, x, norm):
    if norm == "diag":
        return D * x
    return torch.einsum("...fg,...g->...f", *_promoted(D, x))


def apply_phasor(z, phi):
    """z times exp(i phi), for complex z or real pairs (trailing dim
    2)."""
    phi = torch.as_tensor(phi, device=z.device)
    if z.is_complex():
        return z * torch.exp(1j * phi)
    return viewreal(viewcomp(z) * torch.exp(1j * phi))


def project_out_phase(z, avg_axis=None, select=None):
    """Rotate z by minus its phase, taken after an optional mean along
    avg_axis and an optional index ``select``."""
    zc = viewcomp(z)
    za = zc.mean(dim=avg_axis, keepdim=True) if avg_axis is not None \
        else zc
    if select is not None:
        za = za[tuple(select)]
    return apply_phasor(z, -torch.angle(za))


def cmatmul(a, b):
    """1x1 or 2x2 complex matrix product along the two leading axes."""
    if not (a.shape[0] == a.shape[1] == b.shape[0] == b.shape[1]
            and a.shape[0] in (1, 2)):
        raise ValueError("cmatmul needs 1x1 or 2x2 leading axes")
    return torch.einsum("ab...,bc...->ac...", a, b)


def cov_get_diag(cov, cov_axis, mode="vis", shape=None):
    """Diagonal of a structured covariance in the data's shape (the
    cov_axis conventions of inference.prob.apply_icov)."""
    if cov_axis is None:
        return cov
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)
    if cov_axis == "full":
        if shape is None:
            raise ValueError("cov_axis 'full' needs shape")
        return diag.reshape(shape)
    if cov_axis == "bl":        # (Np,Np,Nt,Nf,Nbl) -> (Np,Np,Nbl,Nt,Nf)
        return diag.movedim(-1, 2)
    if cov_axis == "time":      # (Np,Np,Nbl,Nf,Nt) -> (Np,Np,Nbl,Nt,Nf)
        return diag.movedim(-1, 3)
    if cov_axis == "freq":
        if mode == "vis":
            return diag
        return diag.movedim(-1, -2)
    if cov_axis == "pix":
        return diag
    raise ValueError(cov_axis)
