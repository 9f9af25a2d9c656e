"""
Data containers: TensorData, VisData, MapData (the slice's subset).

Counterpart of bayeslim_tpu/data/containers.py (TensorData :138, VisData
:306 with _set_bls :340, _blnum_lookup / _bl2ind :398-415, the
selections _time2ind ... get_inds :422-473, _index_arr :475 and select
:534, MapData :1048 with setup_data's df / pols / norm :1063,
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


def _take(arr, idx, axis):
    """arr indexed along axis by a slice or an integer array (tensors
    by index_select on their device, numpy arrays by np.take)."""
    if arr is None:
        return None
    if isinstance(idx, slice):
        sl = [slice(None)] * arr.ndim
        sl[axis] = idx
        return arr[tuple(sl)]
    if isinstance(arr, torch.Tensor):
        return arr.index_select(axis, torch.as_tensor(
            np.asarray(idx, dtype=np.int64), device=arr.device))
    return np.take(arr, idx, axis=axis)


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
        self.atol = 1e-10
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
        self._set_bls(bls)
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

    def _set_bls(self, bls):
        """Baselines as antenna-pair tuples or as blnums (a 1-D integer
        array)."""
        if isinstance(bls, np.ndarray) and bls.ndim == 1:
            self.blnums = bls.astype(np.int64)
        else:
            self.blnums = np.asarray(ants2blnum(list(bls)), dtype=np.int64)

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

    def _time2ind(self, time, atol=None):
        """Rows of times within atol (default self.atol) of the given
        ones, in their order."""
        atol = self.atol if atol is None else atol
        out = []
        for t in np.atleast_1d(np.asarray(time)):
            out.extend(np.where(np.isclose(self.times, t, atol=atol,
                                           rtol=0))[0].tolist())
        return np.asarray(out, dtype=np.int64)

    def _freq2ind(self, freq, atol=1.0):
        """Channels within atol [Hz] of the given frequencies."""
        out = []
        for f in np.atleast_1d(np.asarray(freq)):
            out.extend(np.where(np.isclose(self.freqs, f, atol=atol,
                                           rtol=0))[0].tolist())
        return np.asarray(out, dtype=np.int64)

    def _pol2ind(self, pol):
        pol = pol.lower()
        if self.Npol == 1:
            if pol != self.pol:
                raise ValueError(f"data is {self.pol}, asked for {pol}")
            return slice(0, 1), slice(0, 1)
        p = {"e": 0, "n": 1}
        return (slice(p[pol[0]], p[pol[0]] + 1),
                slice(p[pol[1]], p[pol[1]] + 1))

    def _resolve_inds(self, bl, times, freqs, bl_inds, time_inds,
                      freq_inds):
        """Integer *_inds selections as the values they select."""
        if bl_inds is not None:
            if bl is not None:
                raise ValueError("give bl or bl_inds, not both")
            bl = [self.bls[int(i)] for i in np.atleast_1d(bl_inds)]
        if time_inds is not None:
            if times is not None:
                raise ValueError("give times or time_inds, not both")
            times = np.asarray(self.times)[np.atleast_1d(time_inds)]
        if freq_inds is not None:
            if freqs is not None:
                raise ValueError("give freqs or freq_inds, not both")
            freqs = np.asarray(self.freqs)[np.atleast_1d(freq_inds)]
        return bl, times, freqs

    def get_inds(self, bl=None, times=None, freqs=None, pol=None,
                 bl_inds=None, time_inds=None, freq_inds=None, atol=None,
                 **kwargs):
        """Indices (pol1, pol2, bl, time, freq) of a selection: slices
        where an axis is not selected, integer arrays where it is."""
        bl, times, freqs = self._resolve_inds(bl, times, freqs, bl_inds,
                                              time_inds, freq_inds)
        p1 = p2 = slice(None)
        if pol is not None:
            p1, p2 = self._pol2ind(pol)
        kw = {} if atol is None else {"atol": atol}
        b = self._bl2ind(bl) if bl is not None else slice(None)
        t = self._time2ind(times, **kw) if times is not None \
            else slice(None)
        f = self._freq2ind(freqs, **kw) if freqs is not None \
            else slice(None)
        return p1, p2, b, t, f

    def _index_arr(self, arr, inds, squeeze=False):
        """arr (Npol, Npol, Nbls, Ntimes, Nfreqs) at get_inds' indices."""
        if arr is None:
            return None
        p1, p2, b, t, f = inds
        out = arr[p1][:, p2]
        out = _take(out, b, 2)
        out = _take(out, t, 3)
        out = _take(out, f, 4)
        return self._squeeze(out) if squeeze else out

    def select(self, bl=None, times=None, freqs=None, pol=None,
               bl_inds=None, time_inds=None, freq_inds=None, inplace=True,
               **kwargs):
        """Down-select baselines, times, frequencies or a polarization,
        in place by default: data, flags and a diagonal cov / icov (a
        structured one is kept as it is) with the metadata."""
        bl, times, freqs = self._resolve_inds(bl, times, freqs, bl_inds,
                                              time_inds, freq_inds)
        inds = self.get_inds(bl=bl, times=times, freqs=freqs, pol=pol)
        obj = self if inplace else self.copy()
        _, _, b, t, f = inds
        obj.data = self._index_arr(self.data, inds)
        obj.flags = self._index_arr(self.flags, inds)
        if self.cov is not None and self.cov_axis is None:
            obj.cov = self._index_arr(self.cov, inds)
        if self.icov is not None and self.cov_axis is None:
            obj.icov = self._index_arr(self.icov, inds)
        obj.blnums = self.blnums if isinstance(b, slice) else self.blnums[b]
        obj.times = self.times if isinstance(t, slice) else self.times[t]
        obj.freqs = self.freqs if isinstance(f, slice) else self.freqs[f]
        if pol is not None:
            obj.pol = pol.lower()
        return obj

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
        self.pols = None
        self.df = None
        self.norm = None
        self.px_area = None

    def setup_meta(self, name=None):
        self.name = name

    def setup_data(self, freqs, df=None, pols=None, data=None, angs=None,
                   flags=None, cov=None, cov_axis=None, icov=None,
                   norm=None, history="", px_area=None):
        """df: channel widths; pols: the polarizations of the leading
        axis; norm: the normalisation the map was made with (a
        VisMapper's D)."""
        self.freqs = np.asarray(freqs)
        self.df = df
        self.pols = pols
        self.norm = norm
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
