"""
Matrix-free structured operators: HMC mass matrices, the optimizers'
inverse-Hessian estimates and hierarchical (HODLR) solves.

Counterpart of bayeslim_tpu/inference/hmat.py (_wrap_ref_kwargs :28,
BaseMat :71, DenseMat :158, DiagMat :184, HadamardMat :218, TriangMat
:244, SparseMat :281, ZeroMat :351, OneMat :371, TransposedMat :395,
SolveMat :424, PartitionedMat :457, MatDict :490, HierMat :517,
MatColumn :633, MatRow :661, MatSum :689, SolveHierMat :730, make_hodlr
:877). Every operator acts on torch tensors on their own device.

- The JAX package transposes a matvec with ``jax.linear_transpose``;
  here ``BaseMat.t_mat_vec_mul`` asks autograd for the vector-Jacobian
  product of the (linear) matvec, which is A^H u, and conjugates around
  it to get A^T v. Operators with a closed form override it.
- ``least_squares`` runs the conjugate-gradient iteration of
  ``jax.scipy.sparse.linalg.cg`` step for step (x0 = 0, the stop test
  |r|^2 <= max(tol^2 |b|^2, atol^2), at most 10 n iterations).
- ZeroMat and OneMat hold no tensor: their dense forms take the dtype
  and device given at construction (default: the package's default real
  dtype and device); their products follow the operand.
"""
from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from ..utils.dtypes import _float, resolve_device
from ..utils.paramdict import ParamDict

__all__ = [
    "BaseMat", "DenseMat", "DiagMat", "HadamardMat", "TriangMat",
    "SparseMat", "ZeroMat", "OneMat", "TransposedMat", "PartitionedMat",
    "SolveMat", "MatDict", "MatColumn", "MatRow", "MatSum",
    "HierMat", "SolveHierMat", "make_hodlr",
]


def _promote(a, b):
    """a and b in their common dtype (torch does not promote matmul or
    triangular-solve operands, jnp does)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mm(a, b):
    a, b = _promote(a, b)
    return a @ b


def _trisolve(L, v, lower):
    """L^-1 v for triangular L; v (n,) or (n, k)."""
    L, v = _promote(L, v)
    vec = v.ndim == 1
    out = torch.linalg.solve_triangular(L, v[:, None] if vec else v,
                                        upper=not lower)
    return out[:, 0] if vec else out


def _wrap_ref_kwargs(name, f):
    """Give an operator method the reference's (transpose=, out=)
    surface: transpose applies the conjugate transpose; out is added to
    the result, which is returned (nothing is written in place).
    Methods that take transpose themselves keep their own handling."""
    if "transpose" in inspect.signature(f).parameters:
        @functools.wraps(f)
        def method(self, *args, out=None, **kwargs):
            res = f(self, *args, **kwargs)
            return res if out is None else out + res

        method._ref_kwargs = True
        return method

    @functools.wraps(f)
    def method(self, *args, transpose=False, out=None, **kwargs):
        if not transpose:
            res = f(self, *args, **kwargs)
        elif name == "to_dense":
            res = f(self, *args, **kwargs).conj().T
        elif name == "mat_vec_mul":
            res = self.h_mat_vec_mul(args[0])
        else:
            res = torch.stack([self.h_mat_vec_mul(c) for c in args[0].T],
                              dim=1)
        return res if out is None else out + res

    method._ref_kwargs = True
    return method


class BaseMat:
    """Operator interface: mat_vec_mul (A v), t_mat_vec_mul (A^T v),
    h_mat_vec_mul (A^H v), mat_mat_mul, to_dense, diagonal,
    least_squares, to_transpose, ``A @ v`` and ``A(v)``."""

    shape = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        for name in ("mat_vec_mul", "mat_mat_mul", "to_dense"):
            f = cls.__dict__.get(name)
            if f is not None and not getattr(f, "_ref_kwargs", False):
                setattr(cls, name, _wrap_ref_kwargs(name, f))

    def _meta(self):
        """(dtype, device) of the first tensor this operator holds."""
        for v in vars(self).values():
            if isinstance(v, torch.Tensor):
                return v.dtype, v.device
            if isinstance(v, BaseMat):
                return v._meta()
            if isinstance(v, (list, tuple)):
                for m in v:
                    for x in (m if isinstance(m, (list, tuple)) else [m]):
                        if isinstance(x, BaseMat):
                            return x._meta()
        raise ValueError(f"{type(self).__name__} holds no tensor")

    def h_mat_vec_mul(self, v):
        """A^H v (conjugate transpose; the reference's transpose=True)."""
        return self.t_mat_vec_mul(v.conj()).conj()

    def mat_vec_mul(self, v):
        raise NotImplementedError

    def t_mat_vec_mul(self, v):
        """A^T v without densifying: autograd's vector-Jacobian product
        of the linear matvec is A^H u, so A^T v = conj(A^H conj(v))."""
        x = torch.zeros(self.shape[1], dtype=v.dtype, device=v.device,
                        requires_grad=True)
        with torch.enable_grad():
            y = self.mat_vec_mul(x)
        if not y.requires_grad:
            return torch.zeros_like(x).detach()
        (g,) = torch.autograd.grad(y, x, grad_outputs=v.conj(),
                                   allow_unused=True)
        return torch.zeros_like(x).detach() if g is None else g.conj()

    def mat_mat_mul(self, M):
        return torch.stack([self.mat_vec_mul(c) for c in M.T], dim=1)

    def to_dense(self):
        dtype, device = self._meta()
        return self.mat_mat_mul(torch.eye(self.shape[1], dtype=dtype,
                                          device=device))

    def diagonal(self):
        return torch.diagonal(self.to_dense())

    def scalar_mul(self, a):
        raise NotImplementedError

    def least_squares(self, y, Ninv=None, tol=1e-10, maxiter=None):
        """Matrix-free weighted least squares, argmin_x ||A x - y||_Ninv,
        by conjugate gradients on the normal equations (A^T Ninv A) x =
        A^T Ninv y. Ninv: None, a vector (diagonal weights) or a
        BaseMat."""
        def wmul(r):
            if Ninv is None:
                return r
            if isinstance(Ninv, BaseMat):
                return Ninv.mat_vec_mul(r)
            return torch.as_tensor(Ninv, device=r.device) * r

        def normal_op(x):
            return self.t_mat_vec_mul(wmul(self.mat_vec_mul(x)))

        b = self.t_mat_vec_mul(wmul(y))
        return _cg(normal_op, b, tol=tol, maxiter=maxiter)

    def to_transpose(self):
        """The lazy transposed operator (no densification)."""
        return TransposedMat(self)

    def mat_vec_mult(self, v):
        """The reference's (misspelled) alias of mat_vec_mul."""
        return self.mat_vec_mul(v)

    def __call__(self, v):
        return self.mat_vec_mul(v) if v.ndim == 1 else self.mat_mat_mul(v)

    def __matmul__(self, v):
        return self(v)


for _n in ("mat_vec_mul", "mat_mat_mul", "to_dense"):
    setattr(BaseMat, _n, _wrap_ref_kwargs(_n, BaseMat.__dict__[_n]))
del _n


def _vdot_real(a, b):
    return torch.sum((a.conj() * b).real)


def _cg(A, b, tol=1e-5, atol=0.0, maxiter=None):
    """jax.scipy.sparse.linalg.cg without a preconditioner, from x0 = 0."""
    maxiter = 10 * b.numel() if maxiter is None else maxiter
    atol2 = max(tol ** 2 * float(_vdot_real(b, b)), atol ** 2)
    x = torch.zeros_like(b)
    r = b - A(x)
    p = r
    gamma = _vdot_real(r, r).to(b.dtype)
    k = 0
    while float(gamma.real) > atol2 and k < maxiter:
        Ap = A(p)
        alpha = gamma / _vdot_real(p, Ap).to(b.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = _vdot_real(r, r).to(b.dtype)
        p = r + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    return x


class DenseMat(BaseMat):
    """Dense matrix operator."""

    def __init__(self, A):
        self.A = torch.as_tensor(A)
        self.shape = tuple(self.A.shape)

    def mat_vec_mul(self, v):
        return _mm(self.A, v)

    def t_mat_vec_mul(self, v):
        return _mm(self.A.T, v)

    def mat_mat_mul(self, M):
        return _mm(self.A, M)

    def to_dense(self):
        return self.A

    def diagonal(self):
        return torch.diagonal(self.A)

    def scalar_mul(self, a):
        return DenseMat(self.A * a)


class DiagMat(BaseMat):
    """Diagonal (or scalar) operator stored as a vector; a scalar matrix
    is a length-1 diagonal with size. LBFGS takes one for H0 and reports
    its running starting inverse Hessian as one (LBFGS.H)."""

    def __init__(self, d, size=None):
        d = torch.atleast_1d(torch.as_tensor(d))
        if size is not None and d.numel() == 1:
            d = d.expand(int(size)).clone()
        self.d = d
        self.shape = (len(d), len(d))

    @property
    def diag(self):
        return self.d

    def mat_vec_mul(self, v):
        return self.d * v

    def t_mat_vec_mul(self, v):
        return self.d * v

    def mat_mat_mul(self, M):
        return self.d[:, None] * M

    def to_dense(self):
        return torch.diag(self.d)

    def diagonal(self):
        return self.d

    def scalar_mul(self, a):
        return DiagMat(self.d * a)


class HadamardMat(BaseMat):
    """Elementwise (Hadamard) product with H on a matrix-shaped state."""

    def __init__(self, H):
        self.H = torch.as_tensor(H)
        self.shape = tuple(self.H.shape)

    def mat_vec_mul(self, v, transpose=False):
        return self.mat_mat_mul(v, transpose=transpose)

    def mat_mat_mul(self, M, transpose=False, square=False):
        """H * M; transpose applies H^H, square multiplies by H**2."""
        H = self.H.conj().T if transpose else self.H
        if square:
            H = H ** 2
        return H * M

    def to_dense(self, transpose=False):
        return self.H.conj().T if transpose else self.H

    def scalar_mul(self, a):
        return HadamardMat(self.H * a)


class TriangMat(BaseMat):
    """Triangular operator: a 2D input keeps only its lower (upper)
    triangle; a 1D input is the raveled triangle (row-major
    tril_indices / triu_indices order)."""

    def __init__(self, L, lower=True):
        L = torch.as_tensor(L)
        if L.ndim == 1:
            n = int(round((np.sqrt(8 * L.shape[0] + 1) - 1) / 2))
            idx = np.tril_indices(n) if lower else np.triu_indices(n)
            full = torch.zeros((n, n), dtype=L.dtype, device=L.device)
            full[tuple(torch.as_tensor(i, device=L.device) for i in idx)] = L
            L = full
        else:
            L = torch.tril(L) if lower else torch.triu(L)
        self.L = L
        self.lower = lower
        self.shape = tuple(self.L.shape)

    def mat_vec_mul(self, v):
        return _mm(self.L, v)

    def t_mat_vec_mul(self, v):
        return _mm(self.L.T, v)

    def mat_mat_mul(self, M):
        return _mm(self.L, M)

    def to_dense(self):
        return self.L

    def scalar_mul(self, a):
        return TriangMat(self.L * a, lower=self.lower)


class SparseMat(BaseMat):
    """Low rank plus diagonal, A = U V^T + diag(d).

    - ``SparseMat(U, V=None, d=None)``: U (Nrows, Nmodes), V (Ncols,
      Nmodes), V = U when omitted;
    - ``SparseMat(shape, U, V=None, Hdiag=None, hermitian=False)``, the
      reference's form: A = U V with V of row-modes (Nmodes, Ncols) and
      a possibly partial diagonal (only the first len(Hdiag) rows get
      Hdiag * v); hermitian takes V = U^H.
    """

    def __init__(self, U, V=None, d=None, Hdiag=None, hermitian=False):
        if isinstance(U, (tuple, list)) and len(U) == 2 \
                and all(isinstance(s, (int, np.integer)) for s in U):
            U, refV = torch.as_tensor(V), d
            if hermitian:
                self.V = U.conj()
            else:
                if refV is None:
                    raise ValueError("reference-form SparseMat needs V or "
                                     "hermitian=True")
                self.V = torch.as_tensor(refV).T
            d = Hdiag
        else:
            U = torch.as_tensor(U)
            self.V = U if V is None else torch.as_tensor(V)
            if d is None:
                d = Hdiag
        self.U = U
        self.d = None if d is None else torch.as_tensor(d)
        self.shape = (self.U.shape[0], self.V.shape[0])

    def _add_diag(self, out, v):
        if self.d is None:
            return out
        n = self.d.shape[0]
        if n == out.shape[0] == v.shape[0]:
            return out + self.d * v
        return torch.cat([out[:n] + self.d * v[:n], out[n:]])

    def mat_vec_mul(self, v):
        return self._add_diag(_mm(self.U, _mm(self.V.T, v)), v)

    def t_mat_vec_mul(self, v):
        return self._add_diag(_mm(self.V, _mm(self.U.T, v)), v)

    def to_dense(self):
        out = self.U @ self.V.T
        if self.d is not None:
            n = self.d.shape[0]
            i = torch.arange(n, device=out.device)
            out[i, i] += self.d
        return out

    def diagonal(self):
        out = torch.sum(self.U * self.V, dim=1)
        if self.d is not None:
            n = self.d.shape[0]
            out = torch.cat([out[:n] + self.d, out[n:]])
        return out

    def scalar_mul(self, a):
        return SparseMat(self.U * a, self.V,
                         None if self.d is None else self.d * a)


class ZeroMat(BaseMat):
    """Zero operator; dtype and device are those of its dense form."""

    def __init__(self, shape, dtype=None, device=None):
        self.shape = tuple(shape)
        self.dtype, self.device = dtype, device

    def _meta(self):
        return (self.dtype or _float()), resolve_device(self.device)

    def mat_vec_mul(self, v):
        return torch.zeros(self.shape[0], dtype=v.dtype, device=v.device)

    def t_mat_vec_mul(self, v):
        return torch.zeros(self.shape[1], dtype=v.dtype, device=v.device)

    def mat_mat_mul(self, M):
        return torch.zeros((self.shape[0], M.shape[1]), dtype=M.dtype,
                           device=M.device)

    def to_dense(self):
        dtype, device = self._meta()
        return torch.zeros(self.shape, dtype=dtype, device=device)

    def scalar_mul(self, a):
        return self


class OneMat(BaseMat):
    """Constant operator (every entry value; the reference names it
    scalar, and both spellings are accepted)."""

    def __init__(self, shape, value=1.0, scalar=None, dtype=None,
                 device=None):
        self.shape = tuple(shape)
        self.value = value if scalar is None else scalar
        self.dtype, self.device = dtype, device

    @property
    def scalar(self):
        return self.value

    def _meta(self):
        return (self.dtype or _float()), resolve_device(self.device)

    def mat_vec_mul(self, v):
        return torch.sum(v) * self.value * torch.ones(
            self.shape[0], dtype=v.dtype, device=v.device)

    def to_dense(self):
        dtype, device = self._meta()
        return torch.full(self.shape, self.value, dtype=dtype, device=device)

    def scalar_mul(self, a):
        return OneMat(self.shape, self.value * a, dtype=self.dtype,
                      device=self.device)


class TransposedMat(BaseMat):
    """Lazy transpose of another operator: its matvec is the wrapped
    operator's transposed matvec (no densification)."""

    def __init__(self, mat):
        self.mat = mat
        self.shape = (mat.shape[1], mat.shape[0])

    def mat_vec_mul(self, v):
        return self.mat.t_mat_vec_mul(v)

    def t_mat_vec_mul(self, v):
        return self.mat.mat_vec_mul(v)

    def to_dense(self):
        return self.mat.to_dense().T

    def diagonal(self):
        return self.mat.diagonal()

    def scalar_mul(self, a):
        return TransposedMat(self.mat.scalar_mul(a))

    def to_transpose(self):
        return self.mat


class SolveMat(BaseMat):
    """Inverse as a solve: A^-1 v by two triangular solves with the
    Cholesky factor (given, or of A)."""

    def __init__(self, A=None, chol=None, lower=True):
        if chol is None:
            if A is None:
                raise ValueError("SolveMat needs A or chol")
            chol = torch.linalg.cholesky(torch.as_tensor(A))
        self.L = torch.as_tensor(chol)
        self.lower = lower
        self.shape = tuple(self.L.shape)

    def mat_vec_mul(self, v):
        return self.back_sub(self.forward_sub(v))

    def mat_mat_mul(self, M):
        return self.back_sub(self.forward_sub(M))

    def forward_sub(self, v):
        """L^-1 v (forward substitution)."""
        return _trisolve(self.L, v, self.lower)

    def back_sub(self, v):
        """L^-H v (back substitution)."""
        return _trisolve(self.L.conj().T, v, not self.lower)

    def to_dense(self):
        return self.mat_mat_mul(torch.eye(self.shape[0], dtype=self.L.dtype,
                                          device=self.L.device))

    def scalar_mul(self, a):
        return SolveMat(chol=self.L / np.sqrt(a), lower=self.lower)


class PartitionedMat(BaseMat):
    """Block-partitioned operator: blocks[i][j] are BaseMats; the matvec
    sums each block row over the column blocks."""

    def __init__(self, blocks):
        self.blocks = blocks
        rows = sum(b[0].shape[0] for b in blocks)
        self._col_sizes = [blocks[0][j].shape[1]
                           for j in range(len(blocks[0]))]
        self.shape = (rows, sum(self._col_sizes))

    def mat_vec_mul(self, v):
        vs = torch.split(v, self._col_sizes)
        out = []
        for row in self.blocks:
            acc = None
            for j, blk in enumerate(row):
                y = blk.mat_vec_mul(vs[j])
                acc = y if acc is None else acc + y
            out.append(acc)
        return torch.cat(out)

    def to_dense(self):
        return torch.cat([torch.cat([b.to_dense() for b in row], dim=1)
                          for row in self.blocks], dim=0)

    def scalar_mul(self, a):
        return PartitionedMat([[b.scalar_mul(a) for b in row]
                               for row in self.blocks])


class MatDict:
    """Operators keyed by parameter name, acting on ParamDicts (each
    value raveled, multiplied and reshaped; keys without an operator
    pass through)."""

    def __init__(self, mats):
        self.mats = dict(mats)

    def __getitem__(self, k):
        return self.mats[k]

    def __contains__(self, k):
        return k in self.mats

    def mat_vec_mul(self, pdict):
        out = {}
        for k, v in pdict.items():
            if k in self.mats:
                out[k] = self.mats[k].mat_vec_mul(v.reshape(-1)).reshape(
                    v.shape)
            else:
                out[k] = v
        return ParamDict(out)

    def __call__(self, pdict):
        return self.mat_vec_mul(pdict)


class HierMat(BaseMat):
    """Recursive 2x2 HODLR block operator: A00 upper and A11 lower
    diagonal blocks (HierMat or dense), A01 / A10 off-diagonals (low rank
    SparseMat for SolveHierMat). Raw tensors are wrapped as DenseMat;
    sym=True mirrors a single off-diagonal ((U V^T)^T = V U^T for a
    SparseMat, a lazy transpose otherwise); scalar multiplies the
    output."""

    def __init__(self, A00, A11, A01=None, A10=None, sym=False,
                 scalar=None):
        def wrap(x):
            return DenseMat(torch.as_tensor(x)) \
                if x is not None and not isinstance(x, BaseMat) else x
        A00, A11, A01, A10 = wrap(A00), wrap(A11), wrap(A01), wrap(A10)
        if sym:
            def mirror(x):
                return SparseMat(x.V, x.U) if isinstance(x, SparseMat) \
                    and x.d is None else TransposedMat(x)
            if A01 is None and A10 is not None:
                A01 = mirror(A10)
            if A10 is None and A01 is not None:
                A10 = mirror(A01)
        self.A00, self.A11, self.A01, self.A10 = A00, A11, A01, A10
        self.sym = sym
        self.scalar = scalar
        self.shape = (A00.shape[0] + A11.shape[0],
                      A00.shape[1] + A11.shape[1])

    def _scaled(self, out):
        return out if self.scalar is None else out * self.scalar

    def mat_vec_mul(self, v):
        n1 = self.A00.shape[1]
        v1, v2 = v[:n1], v[n1:]
        o1 = self.A00.mat_vec_mul(v1)
        o2 = self.A11.mat_vec_mul(v2)
        if self.A01 is not None:
            o1 = o1 + self.A01.mat_vec_mul(v2)
        if self.A10 is not None:
            o2 = o2 + self.A10.mat_vec_mul(v1)
        return self._scaled(torch.cat([o1, o2]))

    def t_mat_vec_mul(self, v):
        n1 = self.A00.shape[0]
        v1, v2 = v[:n1], v[n1:]
        o1 = self.A00.t_mat_vec_mul(v1)
        o2 = self.A11.t_mat_vec_mul(v2)
        if self.A10 is not None:
            o1 = o1 + self.A10.t_mat_vec_mul(v2)
        if self.A01 is not None:
            o2 = o2 + self.A01.t_mat_vec_mul(v1)
        return self._scaled(torch.cat([o1, o2]))

    def to_dense(self):
        d00, d11 = self.A00.to_dense(), self.A11.to_dense()
        n1, n2 = d00.shape[0], d11.shape[0]

        def off(blk, shape):
            return blk.to_dense() if blk is not None else torch.zeros(
                shape, dtype=d00.dtype, device=d00.device)
        top = torch.cat([d00, off(self.A01, (n1, d11.shape[1]))], dim=1)
        bot = torch.cat([off(self.A10, (n2, d00.shape[1])), d11], dim=1)
        return self._scaled(torch.cat([top, bot], dim=0))

    def diagonal(self, return_tensor=True):
        """The diagonal: one vector, or the per-leaf-block list with
        return_tensor=False."""
        diag = []
        for blk in (self.A00, self.A11):
            if isinstance(blk, HierMat):
                diag.extend(blk.diagonal(return_tensor=False))
            else:
                diag.append(blk.diagonal())
        if self.scalar is not None:
            diag = [d * self.scalar for d in diag]
        return torch.cat(diag) if return_tensor else diag

    def scalar_mul(self, a):
        sc = a if self.scalar is None else self.scalar * a
        return HierMat(self.A00, self.A11, self.A01, self.A10,
                       sym=self.sym, scalar=sc)

    def to_SolveHierMat(self, lower=True, trans_solve=True):
        """Hierarchical Cholesky of this SPD operator as a SolveHierMat:
        trans_solve=True gives A^-1 v, False the forward substitution
        chol(A)^-1 v. Only lower=True is supported."""
        if not lower:
            raise NotImplementedError("only lower-triangular factors")
        return SolveHierMat(self, trans_solve=trans_solve)


class MatColumn(BaseMat):
    """Vertical stack of operators sharing Ncols: A = [M1; M2; ...]."""

    def __init__(self, mats):
        self.mats = list(mats)
        ncol = self.mats[0].shape[1]
        if any(m.shape[1] != ncol for m in self.mats):
            raise ValueError("MatColumn operators differ in Ncols")
        self.shape = (sum(m.shape[0] for m in self.mats), ncol)

    def mat_vec_mul(self, v):
        return torch.cat([m.mat_vec_mul(v) for m in self.mats])

    def t_mat_vec_mul(self, v):
        out, i = None, 0
        for m in self.mats:
            y = m.t_mat_vec_mul(v[i:i + m.shape[0]])
            out = y if out is None else out + y
            i += m.shape[0]
        return out

    def to_dense(self):
        return torch.cat([m.to_dense() for m in self.mats], dim=0)

    def scalar_mul(self, a):
        return MatColumn([m.scalar_mul(a) for m in self.mats])


class MatRow(BaseMat):
    """Horizontal stack of operators sharing Nrows: A = [M1, M2, ...]."""

    def __init__(self, mats):
        self.mats = list(mats)
        nrow = self.mats[0].shape[0]
        if any(m.shape[0] != nrow for m in self.mats):
            raise ValueError("MatRow operators differ in Nrows")
        self.shape = (nrow, sum(m.shape[1] for m in self.mats))

    def mat_vec_mul(self, v):
        out, i = None, 0
        for m in self.mats:
            y = m.mat_vec_mul(v[i:i + m.shape[1]])
            out = y if out is None else out + y
            i += m.shape[1]
        return out

    def t_mat_vec_mul(self, v):
        return torch.cat([m.t_mat_vec_mul(v) for m in self.mats])

    def to_dense(self):
        return torch.cat([m.to_dense() for m in self.mats], dim=1)

    def scalar_mul(self, a):
        return MatRow([m.scalar_mul(a) for m in self.mats])


class MatSum(BaseMat):
    """Lazy sum of same-shape operators."""

    def __init__(self, mats):
        self.mats = list(mats)
        self.shape = self.mats[0].shape
        if any(m.shape != self.shape for m in self.mats):
            raise ValueError("MatSum operators differ in shape")

    def _sum(self, f):
        out = None
        for m in self.mats:
            y = f(m)
            out = y if out is None else out + y
        return out

    def mat_vec_mul(self, v):
        return self._sum(lambda m: m.mat_vec_mul(v))

    def t_mat_vec_mul(self, v):
        return self._sum(lambda m: m.t_mat_vec_mul(v))

    def diagonal(self):
        return self._sum(lambda m: m.diagonal())

    def to_dense(self):
        return self._sum(lambda m: m.to_dense())

    def scalar_mul(self, a):
        return MatSum([m.scalar_mul(a) for m in self.mats])


class SolveHierMat(BaseMat):
    """Hierarchical Cholesky solve of a symmetric positive-definite
    HODLR operator.

    A = [[A00, U V^T], [V U^T, A11]] = L L^T with L = [[L11, 0],
    [W, L22]], W = V (L11^-1 U)^T (low rank) and L22 = chol(A11 - W W^T).
    The rank-r downdate passes down the recursion as a pending (C, M)
    pair, A_eff = A - C M C^T, so only leaf-sized dense blocks and
    (n x rank) factors are ever formed. chol_mul (L v), forward_sub
    (L^-1 v), back_sub (L^-T v), mat_vec_mul (A^-1 v, or L^-1 v with
    trans_solve=False) and logdet. A positive scalar s on the HierMat
    scales each Cholesky action by sqrt(s) and adds n log s to logdet.
    Only the upper off-diagonal (A01) of each node is read.
    """

    def __init__(self, hier, trans_solve=True):
        self.shape = hier.shape
        self._scalar = getattr(hier, "scalar", None)
        if self._scalar is not None and not float(self._scalar) > 0:
            raise ValueError("SolveHierMat needs a positive scalar (an SPD "
                             "operator)")
        self.trans_solve = trans_solve
        self._root = self._factor(hier, None, None)

    def _meta(self):
        return _leaf_meta(self._root)

    def _factor(self, A, C, M):
        if not isinstance(A, HierMat):
            D = A.to_dense()
            if C is not None:
                D = D - C @ (M @ C.T)
            return {"leaf": True, "L": torch.linalg.cholesky(D),
                    "n": D.shape[0]}
        n1 = A.A00.shape[0]
        C1 = None if C is None else C[:n1]
        C2 = None if C is None else C[n1:]
        node1 = self._factor(A.A00, C1, M)
        if A.A01 is not None:
            if not isinstance(A.A01, SparseMat):
                raise TypeError("SolveHierMat needs low-rank (SparseMat) "
                                "off-diagonals")
            U, V = A.A01.U, A.A01.V
        else:
            dt, dev = _leaf_meta(node1)
            U = torch.zeros((n1, 0), dtype=dt, device=dev)
            V = torch.zeros((A.A11.shape[0], 0), dtype=dt, device=dev)
        if C is not None:
            U = torch.cat([U, C1], dim=1)
            V = torch.cat([V, -C2 @ M.T], dim=1)
        Ut = self._fsub(node1, U)
        Ms = Ut.T @ Ut
        if C is None:
            Cp, Mp = V, Ms
        else:
            Cp = torch.cat([C2, V], dim=1)
            Mp = torch.block_diag(M, Ms)
        node2 = self._factor(A.A11, Cp, Mp)
        return {"leaf": False, "L1": node1, "L2": node2, "V": V, "Ut": Ut,
                "n1": n1, "n": A.shape[0]}

    def _fsub(self, node, v):
        """L^-1 v for a factor node; v (n,) or (n, k)."""
        if node["leaf"]:
            return _trisolve(node["L"], v, True)
        n1 = node["n1"]
        y1 = self._fsub(node["L1"], v[:n1])
        w = v[n1:] - _mm(node["V"], _mm(node["Ut"].T, y1))
        return torch.cat([y1, self._fsub(node["L2"], w)], dim=0)

    def _bsub(self, node, v):
        """L^-T v."""
        if node["leaf"]:
            return _trisolve(node["L"].T, v, False)
        n1 = node["n1"]
        x2 = self._bsub(node["L2"], v[n1:])
        w = v[:n1] - _mm(node["Ut"], _mm(node["V"].T, x2))
        return torch.cat([self._bsub(node["L1"], w), x2], dim=0)

    def _lmul(self, node, v):
        """L v."""
        if node["leaf"]:
            return _mm(node["L"], v)
        n1 = node["n1"]
        y1 = self._lmul(node["L1"], v[:n1])
        y2 = _mm(node["V"], _mm(node["Ut"].T, v[:n1])) \
            + self._lmul(node["L2"], v[n1:])
        return torch.cat([y1, y2], dim=0)

    def forward_sub(self, v):
        out = self._fsub(self._root, v)
        return out if self._scalar is None else out / np.sqrt(self._scalar)

    def back_sub(self, v):
        out = self._bsub(self._root, v)
        return out if self._scalar is None else out / np.sqrt(self._scalar)

    def chol_mul(self, v):
        """L v (draws p ~ N(0, A) from white noise)."""
        out = self._lmul(self._root, v)
        return out if self._scalar is None else out * np.sqrt(self._scalar)

    def mat_vec_mul(self, v):
        """A^-1 v; with trans_solve=False the forward substitution
        L^-1 v only."""
        if not self.trans_solve:
            return self.forward_sub(v)
        return self.back_sub(self.forward_sub(v))

    def mat_mat_mul(self, M):
        return self.mat_vec_mul(M)

    def t_mat_vec_mul(self, v):
        return self.mat_vec_mul(v)

    def logdet(self):
        """log det A = 2 sum log diag(L)."""
        def rec(node):
            if node["leaf"]:
                return 2.0 * torch.sum(torch.log(torch.diagonal(node["L"])))
            return rec(node["L1"]) + rec(node["L2"])
        out = rec(self._root)
        if self._scalar is not None:
            out = out + self.shape[0] * np.log(self._scalar)
        return out

    def scalar_mul(self, a):
        raise NotImplementedError("rescale the HierMat, then refactor")


def _leaf_meta(node):
    """(dtype, device) of a factor node's first leaf."""
    while not node["leaf"]:
        node = node["L1"]
    return node["L"].dtype, node["L"].device


def make_hodlr(A, indices=None, min_size=64, rank=8, depth=None,
               trisolve=False, lower=True, Nrank=None, rcond=None,
               sparse_tol=None):
    """Compress a dense matrix into a HODLR HierMat by truncated SVDs of
    the off-diagonal blocks. indices lists the leaf blocks (slices or
    index arrays; default: halve until min_size), Nrank is rank's other
    name, rcond drops singular values below rcond * s_max, sparse_tol
    those below an absolute value, depth caps the recursion, trisolve
    returns the SolveHierMat of the (SPD) result."""
    A = torch.as_tensor(A)
    if Nrank is not None:
        rank = Nrank

    def starts(idx):
        return [s.start if isinstance(s, slice)
                else int(np.atleast_1d(np.asarray(s))[0]) for s in idx]

    def lowrank(B):
        U, s, Vt = torch.linalg.svd(B, full_matrices=False)
        r = min(rank, len(s))
        keep = s[:r].cpu().numpy()
        if rcond is not None:
            r = max(1, int(np.sum(keep > rcond * float(s[0]))))
        if sparse_tol is not None:
            r = max(1, int(np.sum(keep[:r] > sparse_tol)))
        return SparseMat(U[:, :r] * s[:r], Vt[:r].T)

    def build(A, idx, depth):
        n = A.shape[0]
        if (idx is not None and len(idx) <= 1) or \
                (idx is None and n <= min_size) or \
                (depth is not None and depth <= 0):
            return DenseMat(A)
        if idx is not None:
            half = len(idx) // 2
            base = starts(idx[:1])[0]
            off = starts(idx[half:])[0]
            h = off - base

            def shift(blocks, o):
                return [slice((s.start or 0) - o, s.stop - o)
                        if isinstance(s, slice) else np.asarray(s) - o
                        for s in blocks]
            i1, i2 = shift(idx[:half], base), shift(idx[half:], off)
        else:
            h = n // 2
            i1 = i2 = None
        d1 = None if depth is None else depth - 1
        return HierMat(build(A[:h, :h], i1, d1), build(A[h:, h:], i2, d1),
                       lowrank(A[:h, h:]), lowrank(A[h:, :h]))

    H = build(A, list(indices) if indices is not None else None, depth)
    if trisolve:
        return H.to_SolveHierMat(lower=lower) \
            if isinstance(H, HierMat) else SolveMat(H.to_dense())
    return H
