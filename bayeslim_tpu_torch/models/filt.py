"""
Filters: matrix filters, Gaussian-process (Wiener) filters,
least-squares filters, baseline-dependent wedge filters, and the
covariance kernels they are built from.

Counterpart of bayeslim_tpu/models/filt.py (BaseFilter :221, MatFilter
:229, GPFilter :282, LstSqFilter :345, WedgeFilter :364, rbf_cov :406,
exp_cov :412, sinc_cov :418, gauss_sinc_cov :424, phasor_mat :431,
gen_cov_modes :439). The filters act on tensors or data containers
inside forward chains; their matrix G is a buffer on the filter's
device, and its product with the data is ops/linalg.apply_along (a real
G on complex data is one real product over the real and imaginary
planes). G is kept, and the product is taken, in float64 unless asked
otherwise, whatever the data's precision; the output takes the data's: a
residual delay filter leaves an out-of-band remnant of ~1e-4 of the
data, and a float32 product errs by ~1e-6 of each spectrum's peak
(float32 against float64 on the CPU, 1024 channels, a suppression of
1e9), 1 % of the remnant. GPFilter inverts its covariance once, on the
host in float64. WedgeFilter gathers each baseline group's block,
filters it, and puts the blocks back with one inverse permutation (the
JAX loop's per-group scatter would copy the whole cube once per group
under autograd).
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.containers import TensorData, VisData
from ..ops import linalg
from ..utils.dtypes import resolve_device
from ..utils.module import Module

__all__ = ["BaseFilter", "MatFilter", "GPFilter", "LstSqFilter",
           "WedgeFilter", "rbf_cov", "exp_cov", "sinc_cov", "gauss_sinc_cov",
           "phasor_mat", "gen_cov_modes"]


def _complex_of(dtype):
    return torch.complex128 if dtype in (torch.float64, torch.complex128) \
        else torch.complex64


def _host64(x):
    """x as a float64 (or complex128) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _like(out, y):
    """out in y's precision (complex if out is)."""
    prec = y.real.dtype
    return out.to(_complex_of(prec) if out.is_complex() else prec)


def _matrix(x, dtype, device):
    """A host matrix as a tensor on device in dtype (the complex
    counterpart for a complex matrix)."""
    x = torch.as_tensor(x)
    return x.to(device=device,
                dtype=_complex_of(dtype) if x.is_complex() else dtype)


class BaseFilter(Module):
    """Base 1D filter over dimension dim."""

    def __init__(self, dim=0, name=None):
        super().__init__(name=name)
        self.dim = dim


class MatFilter(BaseFilter):
    """y_filt = G y along dim; residual=True returns y - G y. input_idx:
    G acts on all of y and its rows replace (or, residual, are
    subtracted from) these entries of y along dim. G is a buffer on
    device (default CUDA) in dtype, the precision of the product
    (default float64; complex for a complex G); the output has the
    data's precision (complex if G or the data is)."""

    def __init__(self, G=None, dim=-1, residual=False, input_idx=None,
                 name=None, device=None, dtype=None):
        super().__init__(dim=dim, name=name)
        self._device = resolve_device(device)
        self._dtype = dtype or torch.float64
        self.residual = residual
        self.input_idx = None if input_idx is None else np.asarray(input_idx)
        self.register_buffer("_input_idx", None if input_idx is None else
                             torch.as_tensor(self.input_idx,
                                             device=self._device))
        self.register_buffer("G", None if G is None else
                             _matrix(G, self._dtype, self._device))
        self.set_G_idx()

    def setup_filter(self, G=None):
        if G is not None:
            self.G = _matrix(G, self._dtype, self._device)

    def set_G_idx(self, idx=None, rowidx=None):
        """Apply only G's columns idx and rows rowidx (default idx)."""
        self._idx = idx
        self._rowidx = rowidx if rowidx is not None else idx

    def _G(self):
        if self._idx is None:
            return self.G
        return self.G[torch.as_tensor(np.asarray(self._rowidx),
                                      device=self.G.device)[:, None],
                      torch.as_tensor(np.asarray(self._idx),
                                      device=self.G.device)]

    def predict(self, y, **kwargs):
        if isinstance(y, TensorData):
            out = y.copy()
            out.data = self.predict(out.data)
            return out
        return _like(linalg.apply_along(self._G(), y, self.dim), y)

    def forward(self, y, **kwargs):
        if isinstance(y, TensorData):
            out = y.copy()
            out.data = self.forward(y.data, **kwargs)
            return out
        # G y, and y - G y, in the product's precision: cast to the data's
        # before the difference, G y would lose what the residual keeps
        y_filt = linalg.apply_along(self._G(), y, self.dim)
        yp = y.to(y_filt.dtype)
        if self._input_idx is not None:
            dim = self.dim % y.ndim
            idx = self._input_idx.to(y.device)
            out = yp.index_add(dim, idx, y_filt, alpha=-1) if self.residual \
                else yp.index_copy(dim, idx, y_filt)
        else:
            out = yp - y_filt if self.residual else y_filt
        return _like(out, y)


class GPFilter(MatFilter):
    """Gaussian-process (Wiener) filter G = Cs_cross [Cs + Cn (+ eps
    I)]^-1 with prediction variance V = Cs_pred - Cs_cross C^-1
    Cs_cross^H (Cs_cross and Cs_pred default to Cs). The inverse is
    taken once on the host in float64 (inv 'pinv' with rcond and
    hermitian, 'chol' a direct inverse, 'diag' the diagonal's; a
    float32 inverse with the default cut-off would amplify rather than
    filter), and C, C_inv, G and V are kept on device in dtype (default
    float64, MatFilter's). Cs and Cn keep the precision they are given
    in."""

    def __init__(self, Cs, Cn, Cs_cross=None, Cs_pred=None, dim=-1,
                 residual=False, input_idx=None, name=None, inv="pinv",
                 hermitian=True, rcond=1e-15, eps=0.0, device=None,
                 dtype=None):
        super().__init__(dim=dim, residual=residual, input_idx=input_idx,
                         name=name, device=device, dtype=dtype)
        self.Cs, self.Cn = Cs, Cn
        self.Cs_cross, self.Cs_pred = Cs_cross, Cs_pred
        self.inv = inv
        self.hermitian = hermitian
        self.rcond = rcond
        self.eps = eps
        for key in ("C", "C_inv", "V"):
            self.register_buffer(key, None)
        self.setup_filter()

    def setup_filter(self, Cs=None, Cn=None, Cs_pred=None, Cs_cross=None,
                     **kwargs):
        if Cs is not None:
            self.Cs = Cs
        if Cn is not None:
            self.Cn = Cn
        if Cs_pred is not None:
            self.Cs_pred = Cs_pred
        if Cs_cross is not None:
            self.Cs_cross = Cs_cross
        Cs64 = _host64(self.Cs)
        C64 = Cs64 + _host64(self.Cn).astype(Cs64.dtype)
        if self.eps:
            C64 = C64 + np.eye(C64.shape[-1], dtype=C64.dtype) * self.eps
        if self.inv == "chol":
            C_inv64 = np.linalg.inv(C64)
        elif self.inv == "diag":
            C_inv64 = np.diag(1.0 / np.diagonal(C64))
        else:
            C_inv64 = np.linalg.pinv(C64, rcond=self.rcond,
                                     hermitian=self.hermitian)
        cross = Cs64 if self.Cs_cross is None else \
            _host64(self.Cs_cross).astype(Cs64.dtype)
        pred = Cs64 if self.Cs_pred is None else \
            _host64(self.Cs_pred).astype(Cs64.dtype)
        G64 = cross @ C_inv64
        for key, val in (("C", C64), ("C_inv", C_inv64), ("G", G64),
                         ("V", pred - G64 @ cross.conj().T)):
            setattr(self, key, _matrix(val, self._dtype, self._device))

    def set_GV(self):
        """Recompute G and V from the current Cs, Cn, Cs_cross and
        Cs_pred."""
        self.setup_filter()


class LstSqFilter(MatFilter):
    """Least-squares filter G = A D A^H Ninv with D = (A^H Ninv A)^+
    (Ninv None: the identity), unless G is given; residual=True by
    default."""

    def __init__(self, G=None, A=None, Ninv=None, dim=-1, residual=True,
                 name=None, device=None, dtype=None, **lsq_kwargs):
        if G is None:
            if A is None:
                raise ValueError("LstSqFilter needs G or A")
            A = torch.as_tensor(A)
            if Ninv is None:
                AH = A.conj().T
                G = A @ linalg.pinv(AH @ A) @ AH
            else:
                Ninv = torch.as_tensor(Ninv, device=A.device)
                dt = torch.promote_types(A.dtype, Ninv.dtype)
                A, Ninv = A.to(dt), Ninv.to(dt)
                AH = A.conj().T
                G = A @ linalg.pinv(AH @ Ninv @ A) @ AH @ Ninv
        super().__init__(G=G, dim=dim, residual=residual, name=name,
                         device=device, dtype=dtype)


class WedgeFilter(Module):
    """A filter per group of baselines, e.g. baseline-dependent delay
    filters that cut a wedge: filters[i] acts on the baselines of
    filt2bls[i] (antenna-pair tuples). On a VisData the baselines are
    looked up in its blnums; on a tensor (baselines on axis -3) in bls,
    which is then needed. The groups must be disjoint; baselines in no
    group pass through unchanged."""

    def __init__(self, filters, filt2bls, bls=None, name=None):
        super().__init__(name=name)
        self.filters = torch.nn.ModuleList(filters)
        self.filt2bls = dict(filt2bls)
        self._bls2idx = {}
        if bls is not None:
            bls = list(bls)
            for i, _bls in self.filt2bls.items():
                self._bls2idx[i] = np.asarray([bls.index(bl) for bl in _bls])
        self._plans = {}

    def _plan(self, key, nbls, device, group_rows):
        """(permutation, its inverse, block sizes) of the baseline axis:
        the groups' rows (group_rows() -> {group: rows}) in group order,
        then the rows of no group. Cached by key and device."""
        pkey = (key, str(device))
        if pkey not in self._plans:
            idx = group_rows()
            rows = np.concatenate([idx[i] for i in self.filt2bls])
            if len(np.unique(rows)) != len(rows):
                raise ValueError("WedgeFilter's baseline groups overlap")
            rest = np.setdiff1d(np.arange(nbls), rows)
            perm = np.concatenate([rows, rest]).astype(np.int64)
            self._plans[pkey] = (
                torch.as_tensor(perm, device=device),
                torch.as_tensor(np.argsort(perm), device=device),
                [len(idx[i]) for i in self.filt2bls] + [len(rest)])
        return self._plans[pkey]

    def _apply(self, data, dim, plan):
        perm, inv, sizes = plan
        blocks = torch.split(data.index_select(dim, perm), sizes, dim=dim)
        out = [self.filters[i](b) for i, b in zip(self.filt2bls, blocks)]
        out.append(blocks[-1])
        return torch.cat(out, dim=dim).index_select(dim, inv)

    def forward(self, vd, **kwargs):
        if isinstance(vd, VisData):
            def group_rows():
                lut = vd._blnum_lookup()
                return {i: vd._bl2ind(list(bls), _lut=lut)
                        for i, bls in self.filt2bls.items()}
            plan = self._plan(vd.blnums.tobytes(), vd.Nbls, vd.data.device,
                              group_rows)
            out = vd.copy()
            out.data = self._apply(vd.data, 2, plan)
            return out
        nbls = vd.shape[-3]
        plan = self._plan("tensor", nbls, vd.device, lambda: self._bls2idx)
        return self._apply(vd, vd.ndim - 3, plan)


# ---------------------------------------------------------------------------
# covariance kernels: built in float64 on the host, returned as tensors of
# dtype (default float64; the complex counterpart for phasor_mat) on device
# (default CUDA)
# ---------------------------------------------------------------------------

def _pairwise(x, x2):
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    x2 = x if x2 is None else np.atleast_1d(np.asarray(x2, dtype=np.float64))
    return x2[:, None] - x[None, :]


def _cov(C, device, dtype):
    return _matrix(C, dtype or torch.float64, resolve_device(device))


def rbf_cov(x, ls, amp=1.0, x2=None, device=None, dtype=None):
    """Gaussian (RBF) covariance amp exp(-dx^2 / 2 ls^2), dx = x2 - x."""
    dx = _pairwise(x, x2)
    return _cov(amp * np.exp(-0.5 * dx ** 2 / ls ** 2), device, dtype)


def exp_cov(x, ls, amp=1.0, x2=None, device=None, dtype=None):
    """Exponential covariance amp exp(-|dx| / ls)."""
    dx = _pairwise(x, x2)
    return _cov(amp * np.exp(-np.abs(dx) / ls), device, dtype)


def sinc_cov(x, ls, amp=1.0, x2=None, device=None, dtype=None):
    """Sinc covariance amp sinc(dx / ls) (numpy's normalised sinc): a
    top-hat of half-width 1 / (2 ls) in the Fourier domain."""
    dx = _pairwise(x, x2)
    return _cov(amp * np.sinc(dx / ls), device, dtype)


def gauss_sinc_cov(x, gauss_ls, sinc_ls, amp=1.0, x2=None, device=None,
                   dtype=None):
    """The product of the Gaussian and the sinc kernels."""
    dx = _pairwise(x, x2)
    return _cov(amp * np.exp(-0.5 * dx ** 2 / gauss_ls ** 2)
                * np.sinc(dx / sinc_ls), device, dtype)


def phasor_mat(x, shift, neg=True, x2=None, device=None, dtype=None):
    """Phasor matrix exp(-+2j pi dx shift), which translates a kernel by
    shift in the Fourier domain."""
    dx = _pairwise(x, x2)
    s = -2j if neg else 2j
    return _cov(np.exp(s * np.pi * dx * shift), device, dtype)


def gen_cov_modes(C, N=None, rcond=None):
    """The top eigenmodes of a covariance C, largest first: the first N,
    or those above rcond times the largest. Returns (modes (Nsamples,
    Nmodes), eigenvalues), on C's device."""
    evals, evecs = torch.linalg.eigh(torch.as_tensor(C))
    evals = torch.flip(evals, (0,))
    evecs = torch.flip(evecs, (1,))
    if N is not None:
        evecs, evals = evecs[:, :N], evals[:N]
    elif rcond is not None:
        keep = evals > evals[0] * rcond
        evecs, evals = evecs[:, keep], evals[keep]
    return evecs, evals
