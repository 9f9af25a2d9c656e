"""
Host helpers of the linear models: whitening an independent variable and
the polynomial design matrix.

Counterpart of bayeslim_tpu/models/linear_model.py's whiten_xarr :30,
prep_xarr :47 and gen_poly_A :64, which YlmResponse.lm_poly_setup needs.
LinearModel, MultiLM, DictLM, gen_linear_A and gen_fourier_A are not
ported yet (ROADMAP queue A8).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import special as scispc

from ..utils.dtypes import _float, resolve_device

__all__ = ["whiten_xarr", "prep_xarr", "gen_poly_A"]


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


def gen_poly_A(x, Ndeg, basis="direct", d0=None, logx=False, whiten=True,
               x0=None, dx=None, qr=False, device=None, dtype=None):
    """Polynomial design matrix (Nx, Ndeg) of x (prep_xarr'd) in the
    'direct' (x^i), 'legendre', 'chebyshevt', 'chebyshevu' or 'laguerre'
    basis; qr orthonormalises its columns. Built in float64 on the host,
    returned as a tensor of dtype (default float32) on device (default
    CUDA)."""
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
    return torch.as_tensor(A, dtype=dtype or _float(),
                           device=resolve_device(device))
