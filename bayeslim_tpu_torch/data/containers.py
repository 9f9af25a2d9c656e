"""
Data containers: TensorData, VisData, MapData (the slice's subset).

Counterpart of bayeslim_tpu/data/containers.py (TensorData :138, VisData
:306 with _blnum_lookup / _bl2ind :398-415, MapData :1048,
concat_VisData :1549; set_cov :160, compute_icov :192). Shapes follow
the JAX package:

- visibilities (Npol, Npol, Nbls, Ntimes, Nfreqs), complex
- sky maps     (Npol, 1, Nfreqs, Npix) with angs (2, Npix) [RA, Dec deg]

Covariances are diagonal (cov_axis None: cov / icov in the data's
shape) or structured along one axis ('full', 'bl', 'time', 'freq',
'pix'; the layouts of inference.prob.apply_icov).
"""
from __future__ import annotations

import copy as _copy

import numpy as np
import torch

from ..ops.linalg import invert_matrix
from ..utils.indexing import AntposDict, ants2blnum, blnum2ants

__all__ = ["TensorData", "VisData", "MapData", "concat_VisData"]


def _sum_log_real(x):
    if isinstance(x, torch.Tensor):
        return float(torch.sum(torch.log(x.real)))
    return float(np.sum(np.log(np.asarray(x).real)))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class TensorData:
    """Base container: data / flags / cov / icov."""

    def __init__(self):
        self.data = None
        self.flags = None
        self.cov = None
        self.icov = None
        self.cov_axis = None
        self.cov_ndim = None
        self.cov_logdet = None
        self.history = ""

    def setup_data(self, data=None, flags=None, cov=None, cov_axis=None,
                   icov=None, history=""):
        self.data = data
        self.flags = flags
        self.set_cov(cov, cov_axis, icov=icov)
        self.history = history

    def set_cov(self, cov, cov_axis, icov=None):
        """Set the covariance (or its inverse), the axis it models, its
        ndim and its log-determinant. A structured icov given without
        its cov carries logdet 0 and the data's size as ndim, as in the
        JAX package."""
        self.cov = cov
        self.icov = icov
        self.cov_axis = cov_axis
        if cov is not None:
            if cov_axis is None:
                self.cov_ndim = int(np.prod(np.shape(cov)))
                self.cov_logdet = _sum_log_real(cov)
            else:
                n = np.shape(cov)[-1]
                nblocks = int(np.prod(np.shape(cov)[:-2]))
                self.cov_ndim = nblocks * n
                _, logdet = np.linalg.slogdet(_host(cov))
                self.cov_logdet = float(np.sum(logdet))
        elif icov is not None:
            if cov_axis is None:
                self.cov_ndim = int(np.prod(np.shape(icov)))
                self.cov_logdet = -_sum_log_real(icov)
            else:
                self.cov_ndim = (int(np.prod(np.shape(self.data)))
                                 if self.data is not None else None)
                self.cov_logdet = 0.0
        else:
            self.cov_ndim = None
            self.cov_logdet = None

    def compute_icov(self, inv="pinv", **kwargs):
        """Compute and store icov from cov (ops.linalg.invert_matrix for
        a structured cov)."""
        if self.cov is None:
            raise ValueError("compute_icov needs cov")
        if self.cov_axis is None:
            self.icov = 1.0 / self.cov
        else:
            self.icov = invert_matrix(self.cov, method=inv, **kwargs)
        return self.icov

    def get_data(self, **kwargs):
        return self.data

    def get_icov(self, **kwargs):
        return self.icov

    def copy(self, copydata=False):
        """Shallow copy; copydata clones the data tensor."""
        new = _copy.copy(self)
        if copydata and self.data is not None:
            new.data = self.data.clone()
        return new


class VisData(TensorData):
    """Visibility container (Npol, Npol, Nbls, Ntimes, Nfreqs)."""

    def __init__(self):
        super().__init__()
        self.setup_meta()
        self.blnums = None
        self.times = None
        self.freqs = None
        self.pol = None

    def setup_meta(self, telescope=None, antpos=None):
        self.telescope = telescope
        self.antpos = antpos
        self.ants = antpos.ants if isinstance(antpos, AntposDict) else None

    def setup_data(self, bls, times, freqs, pol=None, data=None, flags=None,
                   cov=None, cov_axis=None, icov=None, history=""):
        if isinstance(bls, np.ndarray) and bls.ndim == 1:
            self.blnums = bls.astype(np.int64)
        else:
            self.blnums = np.asarray(ants2blnum(list(bls)), dtype=np.int64)
        self.times = np.asarray(times)
        self.freqs = np.asarray(freqs)
        if isinstance(pol, str):
            if pol.lower() not in ("ee", "nn"):
                raise ValueError("1pol mode needs pol 'ee'|'nn'")
            pol = pol.lower()
        self.pol = pol
        self.data = data
        self.flags = flags
        self.set_cov(cov, cov_axis, icov=icov)
        self.history = history

    @property
    def bls(self):
        return blnum2ants(self.blnums)

    @property
    def Nbls(self):
        return len(self.blnums)

    @property
    def Ntimes(self):
        return len(self.times)

    @property
    def Nfreqs(self):
        return len(self.freqs)

    @property
    def Npol(self):
        return 1 if self.pol is not None else 2

    def _blnum_lookup(self):
        """blnum -> row dict; build it once for a bulk lookup and pass it
        to _bl2ind as _lut."""
        return {int(b): i for i, b in enumerate(self.blnums)}

    def _bl2ind(self, bl, _lut=None):
        """Rows of baselines (an antenna-pair tuple, a list of them, or
        blnums) in the data; ValueError for one not in it."""
        if isinstance(bl, tuple):
            bl = [bl]
        if isinstance(bl, list) and len(bl) and isinstance(bl[0], tuple):
            nums = np.asarray(ants2blnum(bl))
        else:
            nums = np.atleast_1d(np.asarray(bl, dtype=np.int64))
        lookup = _lut if _lut is not None else self._blnum_lookup()
        try:
            return np.asarray([lookup[int(n)] for n in nums])
        except KeyError as e:
            raise ValueError(f"baseline {e} not found in data") from None

    @staticmethod
    def _squeeze(arr):
        """Drop the (1, 1) polarization axes, as the JAX get_data does
        with squeeze=True."""
        if arr is None:
            return None
        return arr[0, 0] if arr.shape[0] == 1 and arr.shape[1] == 1 else arr

    def get_data(self, squeeze=True, **kwargs):
        return self._squeeze(self.data) if squeeze else self.data

    def get_icov(self, squeeze=True, **kwargs):
        """icov, squeezed like the data when diagonal; a structured icov
        is returned as it is (apply_icov reads its layout)."""
        if self.cov_axis is not None:
            return self.icov
        return self._squeeze(self.icov) if squeeze else self.icov


class MapData(TensorData):
    """Sky-map container (Npol, 1, Nfreqs, Npix)."""

    def __init__(self):
        super().__init__()
        self.name = None
        self.angs = None
        self.freqs = None
        self.px_area = None

    def setup_meta(self, name=None):
        self.name = name

    def setup_data(self, freqs, data=None, angs=None, flags=None, cov=None,
                   cov_axis=None, icov=None, history="", px_area=None):
        self.freqs = np.asarray(freqs)
        self.data = data
        self.angs = angs
        self.flags = flags
        self.set_cov(cov, cov_axis, icov=icov)
        self.history = history
        self.px_area = px_area


def _cat(arrs, axis, interleave=False):
    """Concatenate tensors or arrays along axis; interleave round-robins
    them instead: out[i::n] = arrs[i] along axis."""
    torch_in = isinstance(arrs[0], torch.Tensor)
    out = torch.cat(arrs, dim=axis) if torch_in \
        else np.concatenate([np.asarray(a) for a in arrs], axis=axis)
    if not interleave:
        return out
    n, N = len(arrs), out.shape[axis]
    pos = [np.arange(i, N, n) for i in range(n)]
    if [len(p) for p in pos] != [a.shape[axis] for a in arrs]:
        raise ValueError("interleave: lengths along the axis do not "
                         "round-robin")
    inv = np.argsort(np.concatenate(pos))
    if torch_in:
        return out.index_select(axis, torch.as_tensor(inv,
                                                      device=out.device))
    return np.take(out, inv, axis=axis)


def concat_VisData(vds, axis, interleave=False, lazy=False):
    """Concatenate VisData along 'bl', 'time' or 'freq': data, flags and
    a diagonal icov (where every object has one) and the axis' metadata.
    interleave round-robins the entries along the axis. lazy=True (a
    CatTensor that concatenates on access) needs the rest of the data
    layer, which is not ported yet."""
    if lazy:
        raise NotImplementedError(
            "concat_VisData(lazy=True) needs CatTensor (ROADMAP queue A9), "
            "which is not ported yet")
    if isinstance(vds, VisData):
        return vds
    if len(vds) == 1:
        return vds[0]
    ax = {"bl": 2, "time": 3, "freq": 4}[axis]
    out = vds[0].copy()
    out.data = _cat([v.data for v in vds], ax, interleave)
    if all(v.flags is not None for v in vds):
        out.flags = _cat([v.flags for v in vds], ax, interleave)
    if all(v.icov is not None and v.cov_axis is None for v in vds):
        out.icov = _cat([v.icov for v in vds], ax, interleave)
    meta = {"bl": "blnums", "time": "times", "freq": "freqs"}[axis]
    setattr(out, meta, _cat([getattr(v, meta) for v in vds], 0, interleave))
    return out
