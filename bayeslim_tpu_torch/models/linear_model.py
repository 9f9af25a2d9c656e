"""
Linear models y = A x along one dimension of a tensor: the design
matrices (polynomial, Fourier, custom), LinearModel, and the chains of
them MultiLM and DictLM.

Counterpart of bayeslim_tpu/models/linear_model.py (whiten_xarr :30,
prep_xarr :45, gen_poly_A :61, gen_fourier_A :82, gen_linear_A :95,
LinearModel :118, MultiLM :218, DictLM :238). Design matrices are built
in float64 on the host and kept as a buffer on the model's device
(default CUDA) in dtype (default float32, or its complex counterpart
for a complex matrix). The product is ops/linalg.apply_along: the
einsum of the JAX forward, promoted as jnp.einsum promotes, in true
fp32 both ways.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import special as scispc

from ..ops import linalg
from ..utils.dtypes import _float, resolve_device
from ..utils.module import Module

__all__ = ["LinearModel", "MultiLM", "DictLM", "gen_linear_A", "gen_poly_A",
           "gen_fourier_A", "prep_xarr", "whiten_xarr"]


def whiten_xarr(x, x0=None, dx=None):
    """Whiten a monotonically increasing array to ~[-1, 1]: (x - x0) / dx
    with x0 its mean and dx its half range plus half a step unless given.
    Returns (xw, x0, dx)."""
    x = np.asarray(x, dtype=np.float64)
    x0 = float(x.mean()) if x0 is None else float(x0)
    xc = x - x0
    if dx is None:
        # range [-1+step/2, 1-step/2] for uniform sampling
        step = (x[-1] - x[0]) / max(len(x) - 1, 1)
        dx = float(xc.max() + step / 2)
    if dx == 0:
        dx = 1.0
    return xc / dx, x0, dx


def prep_xarr(x, d0=None, logx=False, whiten=False, x0=None, dx=None):
    """Prepare an independent variable: divide by d0, take its log, and
    whiten it (x -> (x - x0) / dx), each if asked. Returns (x, x0, dx)."""
    x = np.asarray(x, dtype=np.float64)
    if d0:
        x = x / d0
    if logx:
        x = np.log(x)
    if whiten:
        x, x0, dx = whiten_xarr(x, x0, dx)
    return x, x0, dx


def _poly_A(x, Ndeg, basis="direct", d0=None, logx=False, whiten=True,
            x0=None, dx=None, qr=False):
    """The float64 numpy polynomial design matrix of gen_poly_A."""
    x, _, _ = prep_xarr(x, d0=d0, logx=logx, whiten=whiten, x0=x0, dx=dx)
    if basis == "direct":
        A = np.vstack([x ** i for i in range(Ndeg)]).T
    elif basis == "legendre":
        A = np.vstack([scispc.eval_legendre(i, x) for i in range(Ndeg)]).T
    elif basis == "chebyshevt":
        A = np.vstack([scispc.eval_chebyt(i, x) for i in range(Ndeg)]).T
    elif basis == "chebyshevu":
        A = np.vstack([scispc.eval_chebyu(i, x) for i in range(Ndeg)]).T
    elif basis == "laguerre":
        A = np.vstack([scispc.eval_laguerre(i, x) for i in range(Ndeg)]).T
    else:
        raise NameError(f"unrecognized poly basis {basis}")
    if qr:
        A = np.linalg.qr(A)[0]
    return A


def _fourier_A(x, Ndeg=None, fft_norm="ortho"):
    """The complex128 numpy Fourier design matrix and mode frequencies
    of gen_fourier_A."""
    x = np.asarray(x, dtype=np.float64)
    N = len(x)
    A = np.fft.fftshift(np.fft.fft(np.eye(N), axis=-1, norm=fft_norm),
                        axes=-1)
    freqs = np.fft.fftshift(np.fft.fftfreq(N, x[1] - x[0]))
    if Ndeg is not None:
        n0 = N // 2 - Ndeg // 2
        A = A[:, n0:n0 + Ndeg]
        freqs = freqs[n0:n0 + Ndeg]
    return A, freqs


def _tensor(A, dtype, device):
    """A (numpy or tensor) on device in dtype; by default the default
    real dtype, or its complex counterpart for a complex A."""
    A = torch.as_tensor(A)
    if dtype is None:
        dtype = _float()
        if A.is_complex():
            dtype = torch.complex128 if dtype == torch.float64 \
                else torch.complex64
    return A.to(device=resolve_device(device), dtype=dtype)


def gen_poly_A(x, Ndeg, basis="direct", d0=None, logx=False, whiten=True,
               x0=None, dx=None, qr=False, device=None, dtype=None):
    """Polynomial design matrix (Nx, Ndeg) of x (prep_xarr'd) in the
    'direct' (x^i), 'legendre', 'chebyshevt', 'chebyshevu' or 'laguerre'
    basis; qr orthonormalises its columns. Built in float64 on the host,
    returned as a tensor of dtype (default float32) on device (default
    CUDA)."""
    return _tensor(_poly_A(x, Ndeg, basis=basis, d0=d0, logx=logx,
                           whiten=whiten, x0=x0, dx=dx, qr=qr), dtype, device)


def gen_fourier_A(x, Ndeg=None, fft_norm="ortho", device=None, dtype=None):
    """Complex Fourier design matrix (Nx, Ndeg): the fftshifted DFT of
    the identity over x's samples, its Ndeg central modes if given; and
    the modes' frequencies (numpy, the inverse units of x)."""
    A, freqs = _fourier_A(x, Ndeg=Ndeg, fft_norm=fft_norm)
    return _tensor(A, dtype, device), freqs


def gen_linear_A(linear_mode, A=None, x=None, d0=None, logx=False,
                 whiten=True, x0=None, dx=None, Ndeg=None, basis="direct",
                 qr=False, dtype=None, fft_norm="ortho", device=None,
                 **kwargs):
    """Design matrix (Nsamples, Nfeatures) of a linear_mode: 'poly'
    (gen_poly_A of x), 'custom' (A as given) or 'fourier' (gen_fourier_A
    of x). dtype casts it; by default a complex matrix stays complex
    (the JAX package keeps the complex Fourier matrix too, where its
    reference dropped the imaginary part)."""
    if linear_mode == "poly":
        A = _poly_A(x, Ndeg, basis=basis, d0=d0, logx=logx, whiten=whiten,
                    x0=x0, dx=dx, qr=qr)
    elif linear_mode == "custom":
        if A is None:
            raise ValueError("linear_mode 'custom' needs A")
    elif linear_mode == "fourier":
        A, _ = _fourier_A(x, Ndeg=Ndeg, fft_norm=fft_norm)
    else:
        raise NameError(f"linear_mode {linear_mode} not recognized")
    A = _tensor(A, dtype, device)
    return A.reshape(1) if A.ndim == 0 else A


class LinearModel(Module):
    """y = A x along dimension dim of the input.

    linear_mode and kwargs make A (gen_linear_A: 'poly', 'custom' or
    'fourier'; dtype is A's dtype), kept as a buffer on device. A may be
    batched, (..., Nout, Nin), over the input's dimensions just before
    dim. forward(params): params times coeff (if given), its entries idx
    along dim (if given), then A along dim (diag: A times params
    elementwise along dim); out_dtype casts, out_real keeps the real
    part, out_reshape reshapes the result. least_squares inverts it.
    """

    def __init__(self, linear_mode, dim=0, coeff=None, diag=False, idx=None,
                 out_dtype=None, out_reshape=None, out_shape=None,
                 out_real=False, meta=None, name=None, device=None,
                 **kwargs):
        super().__init__(name=name)
        dev = resolve_device(device)
        self.linear_mode = linear_mode
        self.dim = dim
        self.diag = diag
        self.idx = None if idx is None else np.asarray(idx)
        self.out_dtype = out_dtype
        self.out_reshape = out_reshape
        self.out_shape = out_shape
        self.out_real = out_real
        self.meta = meta if meta is not None else {}
        self.kwargs = dict(kwargs)
        if linear_mode == "poly" and kwargs.get("whiten", False):
            _, x0, dx = prep_xarr(kwargs.get("x"), d0=kwargs.get("d0"),
                                  logx=kwargs.get("logx", False), whiten=True,
                                  x0=kwargs.get("x0"), dx=kwargs.get("dx"))
            self.kwargs.setdefault("x0", x0)
            self.kwargs.setdefault("dx", dx)
        self.register_buffer("A", gen_linear_A(linear_mode, device=dev,
                                               **kwargs))
        self.freqs = None
        if linear_mode == "fourier":
            self.freqs = _fourier_A(kwargs.get("x"), Ndeg=kwargs.get("Ndeg"),
                                    fft_norm=kwargs.get("fft_norm",
                                                        "ortho"))[1]
        coeff = None if coeff is None else torch.as_tensor(coeff, device=dev)
        if coeff is not None:
            rdt = self.A.real.dtype
            coeff = coeff.to(torch.complex128 if rdt == torch.float64
                             else torch.complex64) if coeff.is_complex() \
                else coeff.to(rdt)
        self.register_buffer("coeff", coeff)
        self.register_buffer("_idx", None if idx is None else torch.as_tensor(
            self.idx, device=dev))
        self._D = None

    def forward(self, params, A=None, coeff=None, **kwargs):
        A = self.A if A is None else A
        coeff = self.coeff if coeff is None else coeff
        if coeff is not None:
            params = params * coeff
        if self._idx is not None:
            params = params.index_select(self.dim % params.ndim,
                                         self._idx.to(params.device))
        dim = self.dim % params.ndim
        if self.diag:
            shape = [1] * params.ndim
            shape[dim] = -1
            out = A.reshape(shape) * params
        else:
            out = linalg.apply_along(A, params, dim)
        if self.out_dtype is not None:
            out = out.to(self.out_dtype)
        if self.out_real:
            out = out.real
        if self.out_reshape is not None:
            out = out.reshape(self.out_reshape)
        return out

    def least_squares(self, y, out_shape=None, Ninv=None, cache_D=False,
                      **kwargs):
        """Solve y = A x for x (ops/linalg.least_squares along dim); y is
        reshaped to out_shape (or the model's) first. cache_D keeps the
        normalisation (A^H Ninv A)^-1 for the next call."""
        A = self.A
        if self.diag:
            n = y.shape[self.dim]
            A = torch.diag(A if A.shape[0] == n else A.expand(n))
        out_shape = out_shape if out_shape is not None else self.out_shape
        if out_shape is not None:
            y = y.reshape(out_shape)
        params, D = linalg.least_squares(A, y, dim=self.dim, Ninv=Ninv,
                                         D=self._D, **kwargs)
        if cache_D:
            self._D = D
        return params

    def generate_A(self, x, **interp_kwargs):
        """A at new sample values x: custom mode interpolates its rows
        (scipy's interp1d, interp_kwargs), the others rebuild it."""
        if self.linear_mode == "custom":
            from scipy.interpolate import interp1d
            f = interp1d(np.asarray(self.kwargs["x"]),
                         self.A.detach().cpu().numpy(), axis=0,
                         **interp_kwargs)
            return torch.as_tensor(f(np.asarray(x)), dtype=self.A.dtype,
                                   device=self.A.device)
        kw = dict(self.kwargs, x=x, device=self.A.device)
        return gen_linear_A(self.linear_mode, **kw)


class MultiLM(Module):
    """LinearModels chained on one tensor, params -> LM_n(... LM_1(params)),
    each typically along another dim; least_squares inverts them in the
    same order."""

    def __init__(self, LMs, name=None):
        super().__init__(name=name)
        self.LMs = torch.nn.ModuleList(LMs)

    def forward(self, params, **kwargs):
        for lm in self.LMs:
            params = lm(params, **kwargs)
        return params

    def least_squares(self, y, **kwargs):
        for lm in self.LMs:
            y = lm.least_squares(y, **kwargs)
        return y


class DictLM(Module):
    """A LinearModel per parameter name: forward(name, params) applies
    that name's model, and passes params of other names through (a
    LogProb's LM)."""

    def __init__(self, LMs, name=None):
        super().__init__(name=name)
        # parameter paths hold dots, which nn.ModuleDict keys may not
        self.LMs = dict(LMs)

    def forward(self, name, params, **kwargs):
        if name in self.LMs:
            return self.LMs[name](params, **kwargs)
        return params

    def least_squares(self, name, y, **kwargs):
        return self.LMs[name].least_squares(y, **kwargs)
