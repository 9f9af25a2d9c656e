"""
Data containers: TensorData, VisData, MapData, CalData, and the blocks
and functions that combine them (the in-memory data layer).

Counterpart of bayeslim_tpu/data/containers.py (TensorData :138, VisData
:306, MapData :1048, CalData :1227, the concatenations :1508-1600,
average_data :1626, CatTensor :1660, Difference / RedVisAvg /
RedVisInflate :1727-1777, average_TensorData :1778, caldata_from_visdata
:1798, pass_data :1813) with its HDF5 file layer (VisData.from_hdf5
:565, write_hdf5 / read_hdf5 :959-1047, :1176-1223, :1384-1458,
CalData.read_uvcal :1410, HDF5Tensor :1461, load_data :1601,
SelectedHDF5Tensor :1691, make_HDF5Tensor :1819). Shapes follow the
JAX package:

- visibilities (Npol, Npol, Nbls, Ntimes, Nfreqs), complex
- sky maps     (Npol, 1, Nfreqs, Npix) with angs (2, Npix) [RA, Dec deg]
- gains        (Npol, Npol, Nants, Ntimes, Nfreqs), complex

A container lives where its tensors live: every operation runs on the
data's device and builds its index tensors there. Flags and the
metadata (blnums, times, freqs, ants) are host numpy. Covariances are
diagonal (cov_axis None: cov / icov in the data's shape) or structured
along one axis ('full', 'bl', 'time', 'freq', 'pix'; the layouts of
inference.prob.apply_icov).

Averages over redundant groups (bl_average), time bins (time_average)
and index bins (average_data) sum their segments in a fixed order
(_Segments): the rows are gathered with the segments sorted by length,
each run of equal-length segments is viewed as (n, L) and summed over
L, and the sums are put back in segment order. No atomics are used, so a card
gives the same bits on every call.

Files: the HDF5 layout is the JAX package's, so each package reads the
other's files. h5py is imported in the functions that read or write a
file (the module imports without it); a read puts the data, cov and
icov on the device asked for (None: CUDA) and keeps flags and metadata
on the host. read_hdf5 works on the class (a new object) or on an
instance (filled in place and returned), as in the JAX package.
"""
from __future__ import annotations

import copy as _copy

import numpy as np
import torch

from ..ops.linalg import invert_matrix
from ..utils.dtypes import resolve_device
from ..utils.indexing import AntposDict, ants2blnum, blnum2ants, inflate_bls
from ..utils.module import Module

__all__ = ["TensorData", "VisData", "MapData", "CalData", "concat_VisData",
           "concat_MapData", "concat_CalData", "average_data", "CatTensor",
           "Difference", "RedVisAvg", "RedVisInflate", "average_TensorData",
           "caldata_from_visdata", "pass_data", "load_data", "HDF5Tensor",
           "SelectedHDF5Tensor", "make_HDF5Tensor"]

_LEAF_FIELDS = ("data", "flags", "cov", "icov")
# rows of a float64 sum of squares cast at a time (reduce_by_redundancy)
_ROWS64 = 2048


def _sum_log_real(x):
    if isinstance(x, torch.Tensor):
        return float(torch.sum(torch.log(x.real)))
    return float(np.sum(np.log(np.asarray(x).real)))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _idx(idx, device):
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


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
        return arr.index_select(axis, _idx(idx, arr.device))
    return np.take(arr, idx, axis=axis)


def _dev(x, device):
    """A host array read from a file as a tensor on device."""
    return torch.as_tensor(np.asarray(x), device=device)


def _exists(fname, overwrite):
    import os
    if os.path.exists(fname) and not overwrite:
        raise FileExistsError(fname)


def _telescope(attrs):
    if "tloc" not in attrs:
        return None
    from ..models.telescope import TelescopeModel
    return TelescopeModel(tuple(attrs["tloc"]))


def _cov_axis(attrs):
    cov_axis = attrs.get("cov_axis", None)
    return None if cov_axis in (None, "none") else str(cov_axis)


class _hybridmethod:
    """A method usable on the class (a new object is made and returned)
    or on an instance (filled in place and returned)."""

    def __init__(self, f):
        self.f = f

    def __get__(self, obj, cls):
        import functools
        return functools.partial(self.f, obj if obj is not None else cls())


def _wgts(wgts, like):
    """Weights as a real tensor of like's shape, on its device."""
    w = torch.as_tensor(wgts, device=like.device)
    if not w.is_floating_point():
        w = w.to(like.real.dtype)
    return torch.broadcast_to(w, like.shape)


class _Segments:
    """Segments of rows along one axis (a list of index arrays), summed
    in a fixed order; see the module docstring."""

    def __init__(self, idx_list):
        idx_list = [np.asarray(ix, dtype=np.int64).reshape(-1)
                    for ix in idx_list]
        self.lens = np.asarray([len(ix) for ix in idx_list], dtype=np.int64)
        order = np.argsort(self.lens, kind="stable")
        self.rows = np.concatenate([idx_list[i] for i in order]) \
            if len(order) else np.zeros(0, dtype=np.int64)
        # the segment of each gathered row
        self.seg = np.repeat(order, self.lens[order])
        Ls, counts = np.unique(self.lens[order], return_counts=True)
        self.blocks = [(int(n), int(L)) for L, n in zip(Ls, counts)]
        inv = np.argsort(order)
        self.inv = None if np.array_equal(inv, np.arange(len(inv))) else inv
        self.n = len(idx_list)

    def gather(self, x, dim):
        return x.index_select(dim, _idx(self.rows, x.device))

    def sum(self, g, dim):
        """Segment sums of g, whose axis dim holds the gathered rows."""
        out, start = [], 0
        for n, L in self.blocks:
            blk = g.narrow(dim, start, n * L)
            out.append(blk.reshape(blk.shape[:dim] + (n, L)
                                   + blk.shape[dim + 1:]).sum(dim + 1))
            start += n * L
        s = out[0] if len(out) == 1 else torch.cat(out, dim)
        return s if self.inv is None else s.index_select(
            dim, _idx(self.inv, s.device))

    def counts(self, dim, ndim, dtype, device):
        """The segments' lengths as a tensor along dim of ndim axes."""
        shape = [1] * ndim
        shape[dim] = self.n
        return torch.as_tensor(self.lens, dtype=dtype,
                               device=device).reshape(shape)

    def all_flags(self, flags, axis):
        """Host flags reduced over each segment: flagged only where every
        member is."""
        f_all = np.moveaxis(np.take(np.asarray(flags), self.rows, axis=axis),
                            axis, 0)
        fout = np.ones((self.n,) + f_all.shape[1:], dtype=bool)
        np.logical_and.at(fout, self.seg, f_all)
        return np.moveaxis(fout, 0, axis)


def _seg_mean(data, W, seg, dim, d_all=None):
    """Weighted segment mean along dim: (mean, weight sums, the gathered
    weights or None for unit weights). d_all, if given, is the data
    already gathered by seg (and rephased)."""
    if d_all is None:
        d_all = seg.gather(data, dim)
    if W is None:
        wsum = seg.counts(dim, data.ndim, data.real.dtype, data.device)
        return seg.sum(d_all, dim) / wsum, wsum, None
    w_all = seg.gather(W, dim)
    wsum = seg.sum(w_all, dim)
    return seg.sum(d_all * w_all, dim) / wsum, wsum, w_all


class TensorData:
    """Base container: data / flags / cov / icov, and arithmetic that
    propagates flags."""

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

    def get_flags(self, **kwargs):
        return self.flags

    def get_cov(self, **kwargs):
        return self.cov

    def get_icov(self, **kwargs):
        return self.icov

    def copy(self, copydata=False, copymeta=False, detach=False, **kwargs):
        """Shallow copy: copydata clones the data tensor, copymeta copies
        the metadata arrays (times, freqs, flags, blnums, angs, cov,
        icov, norm), detach detaches the copy's tensors. The JAX
        package's arrays carry no graph, so its copy never cuts one: by
        default neither does this."""
        new = _copy.copy(self)
        if detach:
            for k in _LEAF_FIELDS:
                v = getattr(new, k, None)
                if isinstance(v, torch.Tensor):
                    setattr(new, k, v.detach())
        if copydata and new.data is not None:
            new.data = new.data.clone()
        if copymeta:
            for k in ("times", "freqs", "flags", "blnums", "angs", "cov",
                      "icov", "norm"):
                v = getattr(new, k, None)
                if v is None:
                    continue
                setattr(new, k, v.clone() if isinstance(v, torch.Tensor)
                        else np.array(v) if isinstance(v, np.ndarray)
                        else _copy.deepcopy(v))
        return new

    @property
    def device(self):
        """The data tensor's device (None for host data)."""
        if isinstance(self.data, torch.Tensor):
            return self.data.device
        return None

    def _set_at(self, inds, val, arr="data"):
        """Assign val into the slice inds (a tuple of slices and integer
        arrays) of the attribute arr. A tensor that requires grad is
        cloned first (the assignment then enters its graph); others are
        written in place."""
        if arr not in ("data", "flags", "icov", "cov"):
            raise ValueError(f"cannot set {arr}")
        if arr in ("cov", "icov") and self.cov_axis is not None:
            raise ValueError("can only set cov/icov with cov_axis=None")
        cur = getattr(self, arr)
        if cur is None:
            raise ValueError(f"{arr} is not set")
        if isinstance(cur, torch.Tensor):
            idx = tuple(i if isinstance(i, slice) else _idx(i, cur.device)
                        for i in inds)
            if cur.requires_grad:
                cur = cur.clone()
            cur[idx] = torch.as_tensor(val, device=cur.device).to(cur.dtype)
        else:
            idx = tuple(i if isinstance(i, slice) else np.asarray(i)
                        for i in inds)
            cur[idx] = val
        setattr(self, arr, cur)

    @staticmethod
    def _propflags(a, b):
        fa = getattr(a, "flags", None)
        fb = getattr(b, "flags", None)
        if fa is None:
            return fb
        if fb is None:
            return fa
        return fa | fb

    def _binary(self, other, op):
        new = self.copy()
        if isinstance(other, TensorData):
            new.data = op(self.data, other.data)
            new.flags = self._propflags(self, other)
        else:
            new.data = op(self.data, other)
        return new

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def push(self, device, return_obj=False):
        """Move the data, cov and icov tensors to device (host flags stay
        on the host)."""
        for f in _LEAF_FIELDS:
            v = getattr(self, f, None)
            if isinstance(v, torch.Tensor):
                setattr(self, f, v.to(device))
        if return_obj:
            return self


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
        if antpos is not None and not isinstance(antpos, AntposDict):
            antpos = AntposDict(list(antpos.keys()),
                                np.stack([np.asarray(v)
                                          for v in antpos.values()]))
        self.telescope = telescope
        self.antpos = antpos
        self.ants = antpos.ants if antpos is not None else None

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

    def check(self):
        """Consistency of the data, flags and cov shapes and of the
        baselines' antennas; ValueError otherwise."""
        def need(ok, what):
            if not ok:
                raise ValueError(f"VisData.check: {what}")
        P, B, T, F = self.Npol, self.Nbls, self.Ntimes, self.Nfreqs
        if self.data is not None:
            need(tuple(self.data.shape[-3:]) == (B, T, F), "data shape")
            if self.flags is not None:
                need(tuple(self.flags.shape) == tuple(self.data.shape),
                     "flags shape")
        expect = {"bl": (P, P, T, F, B, B), "time": (P, P, B, F, T, T),
                  "freq": (P, P, B, T, F, F)}
        for arr in ("cov", "icov"):
            cov = getattr(self, arr, None)
            if cov is None:
                continue
            if self.cov_axis is None and self.data is not None:
                need(tuple(cov.shape) == tuple(self.data.shape),
                     f"{arr} shape")
            elif self.cov_axis in expect:
                need(tuple(cov.shape) == expect[self.cov_axis],
                     f"{arr} shape")
        if self.ants is not None:
            ants = set(self.ants)
            need(all(a1 in ants and a2 in ants for a1, a2 in self.bls),
                 "a baseline's antenna is not in antpos")

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

    def get_bl_vecs(self, bls=None):
        """Baseline vectors ant2 - ant1 [m] (Nbls, 3) from antpos: host
        float64 numpy, or a tensor when the positions are one."""
        ap = self.antpos
        if bls is None:
            a1, a2 = (ap.index(a) for a in blnum2ants(self.blnums,
                                                      separate=True))
        else:
            a1 = ap.index([bl[0] for bl in bls])
            a2 = ap.index([bl[1] for bl in bls])
        av = ap.antvecs
        if isinstance(av, torch.Tensor):
            return av[_idx(a2, av.device)] - av[_idx(a1, av.device)]
        return av[a2] - av[a1]

    def _blnum_lookup(self):
        """The sort order of blnums; build it once for a bulk lookup and
        pass it to _bl2ind as _lut."""
        return np.argsort(self.blnums, kind="stable")

    def _bl2ind(self, bl, _lut=None):
        """Rows of baselines (an antenna-pair tuple, a list of them, or
        blnums) in the data, looked up at once by a binary search;
        ValueError for one not in it."""
        if isinstance(bl, tuple):
            bl = [bl]
        if isinstance(bl, list) and len(bl) and isinstance(bl[0], tuple):
            nums = np.asarray(ants2blnum(bl), dtype=np.int64)
        else:
            nums = np.atleast_1d(np.asarray(bl, dtype=np.int64))
        order = _lut if _lut is not None else self._blnum_lookup()
        if not len(nums):
            return np.zeros(0, dtype=np.int64)
        pos = np.searchsorted(self.blnums, nums, sorter=order)
        rows = order[np.minimum(pos, len(order) - 1)]
        missing = self.blnums[rows] != nums
        if missing.any():
            raise ValueError(f"baseline {int(nums[missing][0])} not found "
                             "in data")
        return rows

    def _group_rows(self, groups):
        """Rows of each group of baselines (tuples or blnums), all looked
        up in one search."""
        flat = [b for g in groups for b in g]
        rows = self._bl2ind(flat)
        return np.split(rows, np.cumsum([len(g) for g in groups])[:-1])

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

    def get_data(self, bl=None, times=None, freqs=None, pol=None,
                 bl_inds=None, time_inds=None, freq_inds=None,
                 squeeze=True, data=None, **kwargs):
        """The data (or the array ``data`` laid out like it) at a
        selection; squeeze drops (1, 1) polarization axes and, for one
        baseline given as a tuple, the baseline axis."""
        arr = self.data if data is None else data
        inds = self.get_inds(bl=bl, times=times, freqs=freqs, pol=pol,
                             bl_inds=bl_inds, time_inds=time_inds,
                             freq_inds=freq_inds)
        out = self._index_arr(arr, inds, squeeze=squeeze)
        if squeeze and isinstance(bl, tuple) and out.ndim >= 3 \
                and out.shape[-3] == 1:
            out = out[..., 0, :, :]
        return out

    def get_flags(self, bl=None, **kwargs):
        kwargs.setdefault("data", self.flags)
        return self.get_data(bl=bl, **kwargs) \
            if self.flags is not None else None

    def _get_cov(self, arr, bl, kwargs):
        cov = getattr(self, arr)
        if cov is not None and self.cov_axis is not None:
            # a structured covariance is handed on as it is
            if bl is not None or any(v is not None
                                     for v in kwargs.values()):
                raise NotImplementedError(
                    f"selection on a structured (cov_axis) {arr} is not "
                    "supported; select the container first")
            return cov
        kwargs.setdefault("data", cov)
        return self.get_data(bl=bl, **kwargs) if cov is not None else None

    def get_cov(self, bl=None, **kwargs):
        return self._get_cov("cov", bl, kwargs)

    def get_icov(self, bl=None, **kwargs):
        """icov at a selection, squeezed like the data when diagonal; a
        structured icov is returned as it is (apply_icov reads its
        layout)."""
        return self._get_cov("icov", bl, kwargs)

    def __getitem__(self, bl):
        return self.get_data(bl)

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

    def set(self, bl, val, arr="data"):
        """Set the baseline(s) bl of the attribute arr to val."""
        self._set_at(self.get_inds(bl=bl), val, arr=arr)

    @staticmethod
    def _squeeze(arr):
        """Drop the (1, 1) polarization axes, as the JAX get_data does
        with squeeze=True."""
        if arr is None:
            return None
        return arr[0, 0] if arr.shape[0] == 1 and arr.shape[1] == 1 else arr

    # --- operations ---------------------------------------------------------
    def apply_cal(self, cd, undo=False, inplace=False, cal_2pol=False):
        """Apply (or with undo remove) a CalData's gains, g1 V g2^H per
        baseline, as models.calibration.apply_cal(self.data, self.bls,
        cd.data, cd.ants) does: 1-pol, 2-pol (cal_2pol), and the 4-pol
        2x2 Jones product, inverted for undo. The gains' time axis must
        be this data's or of length 1."""
        from ..models.calibration import _apply_cal
        lut = {int(a): i for i, a in enumerate(cd.ants)}
        a1, a2 = blnum2ants(self.blnums, separate=True)
        g1, g2 = (np.asarray([lut[a] for a in ax], dtype=np.int64)
                  for ax in (a1, a2))
        obj = self if inplace else self.copy()
        obj.data = _apply_cal(self.data, cd.data, g1, g2, undo=undo,
                              cal_2pol=cal_2pol)[0]
        return obj

    def chisq(self, other_vis=None, dof=None, icov=None, cov_axis=None,
              axis=None):
        """Chi-square of the residual against other_vis (default zero),
        weighted by icov (default this data's): elementwise unless summed
        over axis; a structured covariance goes through apply_icov."""
        from ..models.calibration import chisq as _chisq
        if icov is None:
            icov, cov_axis = self.icov, self.cov_axis
        other = other_vis.data if other_vis is not None \
            else torch.zeros_like(self.data)
        return _chisq(self.data, other, icov, axis=axis, dof=dof,
                      cov_axis=cov_axis)

    def get_bls(self, uniq_bls=False, keep_autos=True, min_len=None,
                max_len=None, min_EW=None, max_EW=None, min_NS=None,
                max_NS=None, min_deg=None, max_deg=None, redtol=1.0):
        """Baselines of this data passing cuts on length, |E|, |N| [m]
        and angle [deg]; uniq_bls keeps one a redundant group."""
        if uniq_bls:
            from ..models.telescope import ArrayModel
            arr = ArrayModel(self.antpos, freqs=self.freqs, bls=self.bls,
                             redtol=redtol, device="cpu")
            return arr.get_bls(uniq_bls=True, keep_autos=keep_autos,
                               min_len=min_len, max_len=max_len,
                               min_EW=min_EW, max_EW=max_EW,
                               min_NS=min_NS, max_NS=max_NS,
                               min_deg=min_deg, max_deg=max_deg)
        bls = self.bls
        v = np.asarray(_host(self.get_bl_vecs(bls)), dtype=np.float64)
        lens = np.linalg.norm(v, axis=1)
        angs = np.degrees(np.arctan2(v[:, 1], v[:, 0]))
        angs[v[:, 1] < 0] += 180.0
        angs[np.abs(v[:, 1]) < redtol] = 0.0
        keep = np.ones(len(bls), dtype=bool)
        if not keep_autos:
            keep &= lens > redtol
        for lo, hi, val in ((min_len, max_len, lens),
                            (min_EW, max_EW, np.abs(v[:, 0])),
                            (min_NS, max_NS, np.abs(v[:, 1])),
                            (min_deg, max_deg, angs)):
            if lo is not None:
                keep &= val >= lo
            if hi is not None:
                keep &= val <= hi
        return [tuple(b) for b, k in zip(bls, keep) if k]

    def _reds(self, reds, redtol):
        if reds is None:
            from ..models.telescope import build_reds
            if self.antpos is None:
                raise ValueError("building redundant groups needs antpos")
            reds = build_reds(self.antpos, bls=self.bls, redtol=redtol)[0]
        return reds

    def _average(self, obj, seg, dim, wgts, d_all=None):
        """Segment average along dim into obj: data, and, for diagonal
        noise, icov as the members' icov sum (no wgts, no cov) or the
        variance of the weighted mean sum w^2 c / (sum w)^2 (c: cov,
        else 1 / icov) as cov and / or icov, each where this data
        carried it. Weights: wgts, else icov."""
        diag = self.cov_axis is None
        W = self.icov if diag else None
        if wgts is not None:
            W = _wgts(wgts, self.data)
        obj.data, wsum, w_all = _seg_mean(self.data, W, seg, dim, d_all)
        if not diag or (self.cov is None and self.icov is None):
            return
        if wgts is None and self.cov is None:
            # exact: the general round trip reintroduces rounding for
            # c = 1 / w
            obj.icov, obj.cov = wsum, None
            return
        cov = self.cov if self.cov is not None \
            else 1.0 / torch.clamp(self.icov, min=1e-60)
        c_all = seg.gather(cov, dim)
        wc = c_all if w_all is None else w_all ** 2 * c_all
        avg_cov = seg.sum(wc, dim) / wsum ** 2
        obj.icov = 1.0 / torch.clamp(avg_cov, min=1e-60) \
            if self.icov is not None else None
        obj.cov = avg_cov if self.cov is not None else None

    def bl_average(self, reds=None, wgts=None, redtol=1.0, inplace=False):
        """Average over redundant groups (lists of baselines; default
        built from antpos at redtol [m]), weighted by wgts, else icov.
        The group keeps its first baseline's number; its flag is set
        only where every member's is; icov becomes the members' icov sum
        (without wgts or cov), else the propagated variance
        sum w^2 c / (sum w)^2 is kept as cov and / or icov."""
        reds = self._reds(reds, redtol)
        return self._bl_average(reds, _Segments(self._group_rows(reds)),
                                wgts, inplace)

    def _bl_average(self, reds, seg, wgts, inplace):
        """bl_average over reds whose rows seg already holds."""
        obj = self if inplace else self.copy()
        self._average(obj, seg, 2, wgts)
        obj.blnums = np.asarray([int(ants2blnum(tuple(r[0])))
                                 if isinstance(r[0], tuple) else int(r[0])
                                 for r in reds], dtype=np.int64)
        obj.flags = seg.all_flags(self.flags, 2) \
            if self.flags is not None else None
        return obj

    def reduce_by_redundancy(self, reds=None, redtol=1.0):
        """Reduce the data to its redundant-group sufficient statistics.

        For diagonal noise, sum_b w_b |V_g(b) - d_b|^2 =
        sum_g W_g |V_g - dbar_g|^2 + const, where dbar_g is the
        icov-weighted group mean and W_g = sum w_b: fitting the returned
        averaged VisData (icov = W_g; the member counts for data without
        icov) gives the gradients of the per-baseline likelihood at
        Nred / Nbls of its cost, and adding const gives its chi^2.
        const = sum w |d|^2 - sum W |dbar|^2, two sums that cancel, is
        summed in float64 on the device.

        Returns (averaged VisData, const float).
        """
        reds = self._reds(reds, redtol)
        seg = _Segments(self._group_rows(reds))
        avg = self._bl_average(reds, seg, None, False)
        ic = self.icov if (self.icov is not None and
                           self.cov_axis is None) else None
        if ic is None:
            # unit-weight data: the group weight is its baseline count
            counts = np.asarray([len(r) for r in reds], dtype=np.float64)
            shape = (1, 1, len(reds)) + tuple(avg.data.shape[-2:])
            avg.icov = torch.broadcast_to(torch.as_tensor(
                counts, dtype=avg.data.real.dtype,
                device=avg.data.device)[None, None, :, None, None], shape)
            avg.cov = 1.0 / avg.icov
        rows = seg.rows
        with torch.no_grad():
            term1 = torch.zeros((), dtype=torch.float64,
                                device=self.data.device)
            for i in range(0, len(rows), _ROWS64):
                ix = _idx(rows[i:i + _ROWS64], self.data.device)
                a2 = _abs2_64(self.data.index_select(2, ix))
                if ic is not None:
                    a2 = a2 * ic.index_select(2, ix).double()
                term1 = term1 + torch.sum(a2)
            term2 = torch.sum(avg.icov.double() * _abs2_64(avg.data))
        return avg, float(term1 - term2)

    def lst_rephase(self, dtime=None, dLST=None, inplace=False):
        """Rephase zenith drift-scan data by dLST [rad] (or dtime [days]
        of sidereal rotation, 2 pi / 0.9972696 rad a day): one value, or
        one a time. The phase is formed in float64 (vis_rephase)."""
        from ..models.telescope import vis_rephase
        if self.telescope is None or self.antpos is None:
            raise ValueError("lst_rephase needs telescope and antpos")
        if dLST is None:
            dLST = np.asarray(dtime) * 2 * np.pi / 0.9972696 / 1.0
        phs = vis_rephase(np.atleast_1d(_host(dLST)),
                          self.telescope.location[1], _host(
                              self.get_bl_vecs()), self.freqs,
                          device=self.data.device, dtype=self.data.dtype)
        obj = self if inplace else self.copy()
        obj.data = self.data * phs[None, None]
        return obj

    def time_average(self, time_inds=None, wgts=None, rephase=False,
                     inplace=False):
        """Average groups of times (time_inds: index arrays or slices,
        one an output time; default all times into one), weighted by
        wgts, else icov; rephase LST-rephases each input time onto its
        bin's mean time first (2 pi x 1.00273793 rad a day). Flags and
        covariances as in bl_average."""
        if time_inds is None:
            time_inds = [np.arange(self.Ntimes)]
        obj = self if inplace else self.copy()
        idx_list = [np.arange(self.Ntimes)[ix] if isinstance(ix, slice)
                    else np.atleast_1d(np.asarray(ix)) for ix in time_inds]
        seg = _Segments(idx_list)
        new_times = np.asarray([float(np.mean(self.times[ix]))
                                for ix in idx_list])
        d_all = seg.gather(self.data, 3)
        if rephase:
            from ..models.telescope import vis_rephase
            # each member rephased from its time to its bin's mean time
            dlst = (new_times[seg.seg] - self.times[seg.rows]) \
                * 2 * np.pi * 1.00273793
            phs = vis_rephase(dlst, self.telescope.location[1],
                              _host(self.get_bl_vecs()), self.freqs,
                              device=self.data.device, dtype=d_all.dtype)
            d_all = d_all * phs[None, None]
        self._average(obj, seg, 3, wgts, d_all=d_all)
        obj.times = new_times
        obj.flags = seg.all_flags(self.flags, 3) \
            if self.flags is not None else None
        return obj

    def time_nn_interp(self, lsts=None, rephase=True, inplace=True,
                       times=None):
        """Nearest-neighbour interpolation onto LST bins [rad] (or, with
        times=, onto JDs): each target takes the nearest integration,
        LST-rephased onto it."""
        if times is not None:
            times = np.atleast_1d(np.asarray(times, dtype=np.float64))
            idx = np.asarray([np.argmin(np.abs(self.times - t))
                              for t in times])
            dLST = (times - self.times[idx]) * 2 * np.pi * 1.00273793
        else:
            from ..models.telescope import JD2LST
            lsts = np.array(np.atleast_1d(lsts), dtype=np.float64)
            if lsts[-1] < lsts[0]:
                lsts[lsts < lsts[0]] += 2 * np.pi
            self_lsts = np.asarray(JD2LST(self.times,
                                          self.telescope.location[0]))
            if self_lsts[-1] < self_lsts[0]:
                self_lsts[self_lsts < self_lsts[0]] += 2 * np.pi
            if lsts[0] < self_lsts[0]:
                lsts = lsts + 2 * np.pi
            idx = np.argmin(np.abs(self_lsts - lsts[:, None]), axis=1)
            dLST = lsts - self_lsts[idx]
        obj = self if inplace else self.copy()
        obj.select(time_inds=idx, inplace=True)
        if rephase:
            obj.lst_rephase(dLST=dLST, inplace=True)
        if times is not None:
            obj.times = times
        return obj

    def _inflate_by_redundancy(self, new_bls, red_bl_inds):
        """Copy rows onto new_bls, row red_bl_inds[i] to baseline i:
        data, flags and a diagonal cov / icov."""
        idx = np.asarray(red_bl_inds, dtype=np.int64)
        obj = self.copy()
        obj.data = _take(self.data, idx, 2)
        if self.flags is not None:
            obj.flags = np.take(np.asarray(self.flags), idx, axis=2)
        if self.cov is not None and self.cov_axis is None:
            obj.cov = _take(self.cov, idx, 2)
        if self.icov is not None and self.cov_axis is None:
            obj.icov = _take(self.icov, idx, 2)
        obj._set_bls(new_bls)
        return obj

    def inflate_by_redundancy(self, bls=None, bl2red=None, red_bls=None,
                              **kwargs):
        """Copy each redundant group's visibility onto its baselines.

        This data holds one row a group. bls are the target baselines
        (default: every key of bl2red); bl2red maps a baseline to its
        group's row (default: build_reds(antpos, red_bls=self.bls,
        **kwargs)); or red_bls names each row's representative
        baseline."""
        if bl2red is None and red_bls is None:
            from ..models.telescope import build_reds
            bl2red = build_reds(self.antpos, red_bls=self.bls, **kwargs)[2]
        if bls is None:
            if bl2red is None:
                raise ValueError("give bls with red_bls")
            bls = list(bl2red.keys())
        if red_bls is not None:
            rep_idx = {tuple(b): i for i, b in enumerate(red_bls)}
            idx = [rep_idx[tuple(b)] for b in bls]
        else:
            bls, idx = inflate_bls(self.bls, bl2red, bls)
        return self._inflate_by_redundancy(bls, idx)

    # --- files ---------------------------------------------------------
    @classmethod
    def from_hdf5(cls, fname, axis=None, lazy_cat=False, interleave=False,
                  **kwargs):
        """A VisData from one HDF5 file, or from several: concatenated
        along axis ('bl', 'time', 'freq'), lazily (CatTensor of
        HDF5Tensors) with lazy_cat, round-robin with interleave; a list
        of VisData when axis is None."""
        if isinstance(fname, (list, tuple)):
            vds = [cls.read_hdf5(f, lazy=lazy_cat, **kwargs) for f in fname]
            return concat_VisData(vds, axis, interleave=interleave,
                                  lazy=lazy_cat) \
                if axis is not None else vds
        return cls.read_hdf5(fname, **kwargs)

    def write_hdf5(self, fname, overwrite=False):
        """Write to an HDF5 file in the JAX package's layout."""
        import h5py
        _exists(fname, overwrite)
        with h5py.File(fname, "w") as f:
            f.attrs["obj"] = "VisData"
            f.attrs["history"] = self.history or ""
            if self.pol is not None:
                f.attrs["pol"] = self.pol
            f.create_dataset("data", data=_host(self.data))
            if self.flags is not None:
                f.create_dataset("flags", data=_host(self.flags))
            if self.cov is not None:
                f.create_dataset("cov", data=_host(self.cov))
                f.attrs["cov_axis"] = self.cov_axis or "none"
            if self.icov is not None:
                f.create_dataset("icov", data=_host(self.icov))
            f.create_dataset("blnums", data=self.blnums)
            f.create_dataset("times", data=self.times)
            f.create_dataset("freqs", data=self.freqs)
            if self.antpos is not None:
                f.create_dataset("ants", data=np.asarray(self.antpos.ants))
                f.create_dataset("antvecs", data=self.antpos.asnumpy())
            if self.telescope is not None:
                f.attrs["tloc"] = np.asarray(self.telescope.location)

    @_hybridmethod
    def read_hdf5(obj, fname, read_data=True, bl=None, times=None,
                  freqs=None, pol=None, lazy=False, lazy_load=False,
                  bl_inds=None, time_inds=None, freq_inds=None,
                  suppress_nonessential=False, device=None):
        """Read an HDF5 file, whole or a selection (bl / times / freqs /
        pol or their *_inds), its tensors on device. lazy (lazy_load)
        leaves the data in the file as an HDF5Tensor; lazy,
        suppress_nonessential and read_data=False skip flags, cov and
        icov."""
        import h5py
        dev = resolve_device(device)
        lazy = lazy or lazy_load
        with h5py.File(fname, "r") as f:
            antpos = None
            if "ants" in f:
                antpos = AntposDict([int(a) for a in f["ants"][:]],
                                    f["antvecs"][:])
            elif "ants" in f.attrs:
                antpos = AntposDict([int(a) for a in f.attrs["ants"]],
                                    np.asarray(f.attrs["antvecs"]))
            obj.setup_meta(telescope=_telescope(f.attrs), antpos=antpos)
            data = None
            if lazy:
                data = HDF5Tensor(fname, "data", device=dev)
            elif read_data:
                data = _dev(f["data"][:], dev)
            aux = read_data and not lazy and not suppress_nonessential
            flags = np.asarray(f["flags"][:]) if "flags" in f and aux \
                else None
            cov = _dev(f["cov"][:], dev) if "cov" in f and aux else None
            icov = _dev(f["icov"][:], dev) if "icov" in f and aux else None
            obj.setup_data(f["blnums"][:], f["times"][:], f["freqs"][:],
                           pol=f.attrs.get("pol", None), data=data,
                           flags=flags, cov=cov, cov_axis=_cov_axis(f.attrs),
                           icov=icov,
                           history=str(f.attrs.get("history", "")))
        if bl_inds is not None:
            if bl is not None:
                raise ValueError("give bl or bl_inds, not both")
            bl = [obj.bls[int(i)] for i in np.atleast_1d(bl_inds)]
        if time_inds is not None:
            if times is not None:
                raise ValueError("give times or time_inds, not both")
            times = np.asarray(obj.times)[np.atleast_1d(time_inds)]
        if freq_inds is not None:
            if freqs is not None:
                raise ValueError("give freqs or freq_inds, not both")
            freqs = np.asarray(obj.freqs)[np.atleast_1d(freq_inds)]
        if any(x is not None for x in (bl, times, freqs, pol)):
            obj.select(bl=bl, times=times, freqs=freqs, pol=pol,
                       inplace=True)
        return obj


def _abs2_64(x):
    """|x|^2 in float64."""
    if x.is_complex():
        x = x.to(torch.complex128)
        return x.real ** 2 + x.imag ** 2
    return x.double() ** 2


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

    @property
    def Nfreqs(self):
        return len(self.freqs)

    @property
    def Npix(self):
        return self.data.shape[-1] if self.data is not None else (
            self.angs.shape[-1] if self.angs is not None else None)

    def _freq2ind(self, freq, atol=1.0):
        out = []
        for fq in np.atleast_1d(np.asarray(freq)):
            out.extend(np.where(np.isclose(self.freqs, fq, atol=atol,
                                           rtol=0))[0].tolist())
        return np.asarray(out, dtype=np.int64)

    def _resolve_inds(self, angs, freqs, pols, ang_inds, freq_inds,
                      pol_inds):
        if freq_inds is not None:
            if freqs is not None:
                raise ValueError("give freqs or freq_inds, not both")
            freqs = np.asarray(self.freqs)[np.atleast_1d(freq_inds)]
        if ang_inds is not None:
            if angs is not None:
                raise ValueError("give angs or ang_inds, not both")
            angs = _host(self.angs)[:, np.atleast_1d(ang_inds)]
        if pol_inds is not None:
            if pols is not None:
                raise ValueError("give pols or pol_inds, not both")
            pols = [self.pols[int(i)] for i in np.atleast_1d(pol_inds)]
        return angs, freqs, pols

    def get_inds(self, angs=None, freqs=None, pols=None, ang_inds=None,
                 freq_inds=None, pol_inds=None):
        """Indices (pol, freq, pixel) of a selection: pixels nearest
        (in |dRA| + |dDec|) to the given angs."""
        angs, freqs, pols = self._resolve_inds(angs, freqs, pols,
                                               ang_inds, freq_inds,
                                               pol_inds)
        p = slice(None)
        if pols is not None and self.pols is not None:
            p = np.asarray([list(self.pols).index(x)
                            for x in np.atleast_1d(pols)])
        f = self._freq2ind(freqs) if freqs is not None else slice(None)
        a = slice(None)
        if angs is not None:
            tgt = _host(angs)
            cur = _host(self.angs)
            a = np.asarray([int(np.argmin(np.abs(cur[0] - tgt[0, i])
                                          + np.abs(cur[1] - tgt[1, i])))
                            for i in range(tgt.shape[1])])
        return p, f, a

    def get_data(self, angs=None, freqs=None, pols=None, ang_inds=None,
                 freq_inds=None, pol_inds=None, squeeze=True, data=None,
                 **kwargs):
        arr = self.data if data is None else data
        p, f, a = self.get_inds(angs=angs, freqs=freqs, pols=pols,
                                ang_inds=ang_inds, freq_inds=freq_inds,
                                pol_inds=pol_inds)
        out = _take(arr, p, 0)
        out = _take(out, f, 2)
        return _take(out, a, 3)

    def select(self, angs=None, freqs=None, pols=None, ang_inds=None,
               freq_inds=None, pol_inds=None, inplace=True):
        """Down-select, in place by default: data, flags, norm and a
        diagonal cov / icov with the metadata."""
        angs, freqs, pols = self._resolve_inds(angs, freqs, pols,
                                               ang_inds, freq_inds,
                                               pol_inds)
        obj = self if inplace else self.copy()
        _, f, a = self.get_inds(angs=angs, freqs=freqs, pols=pols)
        kw = dict(angs=angs, freqs=freqs, pols=pols, squeeze=False)
        obj.data = self.get_data(**kw)
        if self.flags is not None:
            obj.flags = np.asarray(self.get_data(data=np.asarray(self.flags),
                                                 **kw))
        if self.norm is not None:
            obj.norm = self.get_data(data=self.norm, **kw)
        if self.cov_axis is None:
            if self.cov is not None:
                obj.cov = self.get_data(data=self.cov, **kw)
            if self.icov is not None:
                obj.icov = self.get_data(data=self.icov, **kw)
        elif self.cov is not None or self.icov is not None:
            raise NotImplementedError(
                "selection on a structured (cov_axis) MapData cov is not "
                "supported; select before set_cov")
        if self.df is not None and not isinstance(f, slice):
            obj.df = np.atleast_1d(self.df)[f] if np.ndim(self.df) \
                else self.df
        if not isinstance(f, slice):
            obj.freqs = self.freqs[f]
        if not isinstance(a, slice) and self.angs is not None:
            obj.angs = _take(self.angs, a, 1)
        if pols is not None:
            obj.pols = list(np.atleast_1d(pols))
        return obj

    def write_hdf5(self, fname, overwrite=False):
        """Write to an HDF5 file in the JAX package's layout."""
        import h5py
        _exists(fname, overwrite)
        with h5py.File(fname, "w") as f:
            f.attrs["obj"] = "MapData"
            f.attrs["history"] = self.history or ""
            if self.name:
                f.attrs["name"] = self.name
            f.create_dataset("data", data=_host(self.data))
            f.create_dataset("freqs", data=self.freqs)
            if self.df is not None:
                f.create_dataset("df", data=_host(self.df))
            if self.pols is not None:
                f.attrs["pols"] = [str(p) for p in self.pols]
            if self.angs is not None:
                f.create_dataset("angs", data=_host(self.angs))
            for k in ("flags", "norm", "cov"):
                if getattr(self, k) is not None:
                    f.create_dataset(k, data=_host(getattr(self, k)))
            if self.cov is not None:
                f.attrs["cov_axis"] = self.cov_axis or "none"
            if self.icov is not None:
                f.create_dataset("icov", data=_host(self.icov))

    @_hybridmethod
    def read_hdf5(obj, fname, read_data=True, device=None, **kwargs):
        """Read an HDF5 file, its data, cov, icov and norm on device
        (flags, freqs, df and angs on the host)."""
        import h5py
        dev = resolve_device(device)

        def ds(f, k):
            return _dev(f[k][:], dev) if k in f and read_data else None
        with h5py.File(fname, "r") as f:
            obj.setup_meta(name=f.attrs.get("name", None))
            obj.setup_data(
                f["freqs"][:], df=f["df"][:] if "df" in f else None,
                pols=list(f.attrs["pols"]) if "pols" in f.attrs else None,
                data=ds(f, "data"),
                angs=np.asarray(f["angs"][:]) if "angs" in f else None,
                flags=np.asarray(f["flags"][:])
                if "flags" in f and read_data else None,
                cov=ds(f, "cov"), cov_axis=_cov_axis(f.attrs),
                icov=ds(f, "icov"), norm=ds(f, "norm"),
                history=str(f.attrs.get("history", "")))
        return obj


class CalData(TensorData):
    """Gain container (Npol, Npol, Nants, Ntimes, Nfreqs)."""

    def __init__(self):
        super().__init__()
        self.setup_meta()
        self.ants = None
        self.times = None
        self.freqs = None
        self.pol = None

    def setup_meta(self, telescope=None, antpos=None):
        if antpos is not None and not isinstance(antpos, AntposDict):
            antpos = AntposDict(list(antpos.keys()),
                                np.stack([np.asarray(v)
                                          for v in antpos.values()]))
        self.telescope = telescope
        self.antpos = antpos

    def setup_data(self, ants, times, freqs, pol=None, data=None, flags=None,
                   cov=None, cov_axis=None, icov=None, history=""):
        self.ants = [int(a) for a in ants]
        self.times = np.asarray(times)
        self.freqs = np.asarray(freqs)
        self.pol = pol.lower() if isinstance(pol, str) else pol
        self.data = data
        self.flags = flags
        self.set_cov(cov, cov_axis, icov=icov)
        self.history = history

    @property
    def Nants(self):
        return len(self.ants)

    @property
    def Ntimes(self):
        return len(self.times)

    @property
    def Nfreqs(self):
        return len(self.freqs)

    @property
    def Npol(self):
        return 1 if self.pol is not None else 2

    def _ant2ind(self, ant):
        if isinstance(ant, (int, np.integer)):
            ant = [ant]
        lookup = {a: i for i, a in enumerate(self.ants)}
        return np.asarray([lookup[int(a)] for a in ant], dtype=np.int64)

    def get_inds(self, ant=None, times=None, freqs=None, pol=None):
        """Indices (antenna, time, freq) of a selection."""
        a = self._ant2ind(ant) if ant is not None else slice(None)
        t = slice(None)
        if times is not None:
            t = np.concatenate([np.where(np.isclose(
                self.times, x, atol=1e-10, rtol=0))[0]
                for x in np.atleast_1d(times)])
        f = slice(None)
        if freqs is not None:
            f = np.concatenate([np.where(np.isclose(
                self.freqs, x, atol=1.0, rtol=0))[0]
                for x in np.atleast_1d(freqs)])
        return a, t, f

    def get_data(self, ant=None, times=None, freqs=None, pol=None,
                 squeeze=True, data=None, **kwargs):
        arr = self.data if data is None else data
        a, t, f = self.get_inds(ant=ant, times=times, freqs=freqs, pol=pol)
        out = _take(arr, a, 2)
        out = _take(out, t, 3)
        out = _take(out, f, 4)
        if squeeze and isinstance(ant, (int, np.integer)):
            out = out[:, :, 0]
        return out

    def get_data_for_bls(self, bls):
        """Gain products g_p g_q* per baseline, (Npol, Npol, Nbls, Nt,
        Nf). The product is elementwise, also for 4-pol gains (not the
        2x2 Jones product): VisData.apply_cal does not use it."""
        a1 = self._ant2ind([bl[0] for bl in bls])
        a2 = self._ant2ind([bl[1] for bl in bls])
        return _take(self.data, a1, 2) * _take(self.data, a2, 2).conj()

    def select(self, ants=None, times=None, freqs=None, pol=None,
               inplace=True, **kwargs):
        """Down-select antennas, times or frequencies, in place by
        default: data, flags and a diagonal cov / icov with the
        metadata."""
        obj = self if inplace else self.copy()
        a, t, f = self.get_inds(ant=ants, times=times, freqs=freqs, pol=pol)

        def _sel(arr):
            if arr is None:
                return None
            return _take(_take(_take(arr, a, 2), t, 3), f, 4)

        obj.data = _sel(self.data)
        if self.flags is not None:
            obj.flags = np.asarray(_sel(np.asarray(self.flags)))
        if self.cov_axis is None:
            obj.cov = _sel(self.cov)
            obj.icov = _sel(self.icov)
        elif self.cov is not None or self.icov is not None:
            raise NotImplementedError(
                "selection on a structured (cov_axis) CalData cov is not "
                "supported; select before set_cov")
        if ants is not None:
            obj.ants = [int(x) for x in np.atleast_1d(ants)]
        if not isinstance(t, slice):
            obj.times = self.times[t]
        if not isinstance(f, slice):
            obj.freqs = self.freqs[f]
        return obj

    def set(self, ant, val, arr="data"):
        """Set the antenna(s) ant of the attribute arr to val."""
        a, t, f = self.get_inds(ant=ant)
        self._set_at((slice(None), slice(None), a, t, f), val, arr=arr)

    def redcal_degens(self, wgts=None):
        """The redcal degeneracies of these gains: (abs_amp (..., 1, Nt,
        Nf), phs_slope (..., 2, Nt, Nf))."""
        from ..models.calibration import compute_redcal_degen
        return compute_redcal_degen(self.data, self.ants, self.antpos,
                                    wgts=wgts)

    def redcal_degen_gains(self, wgts=None):
        """Gains holding only the redcal degeneracies of these gains."""
        from ..models.calibration import (compute_redcal_degen,
                                          redcal_degen_gains)
        abs_amp, phs_slope = compute_redcal_degen(
            self.data, self.ants, self.antpos, wgts=wgts)
        return redcal_degen_gains(abs_amp=abs_amp, phs_slope=phs_slope,
                                  ants=self.ants, antpos=self.antpos)

    def rephase_to_refant(self, refant, inplace=False):
        """Divide out the phase of a reference antenna."""
        obj = self if inplace else self.copy()
        i = int(self._ant2ind(refant)[0])
        phs = torch.angle(self.data[:, :, i:i + 1])
        obj.data = self.data * torch.exp(-1j * phs)
        return obj

    def inflate_to_4pol(self):
        """A 1-pol CalData as diagonal 4-pol gains."""
        if self.Npol != 1:
            raise ValueError("inflate_to_4pol needs 1-pol gains")
        obj = self.copy()
        z = torch.zeros_like(self.data)
        top = torch.cat([self.data, z], dim=1)
        bot = torch.cat([z, self.data], dim=1)
        obj.data = torch.cat([top, bot], dim=0)
        obj.pol = None
        return obj

    def write_hdf5(self, fname, overwrite=False):
        """Write to an HDF5 file in the JAX package's layout."""
        import h5py
        _exists(fname, overwrite)
        with h5py.File(fname, "w") as f:
            f.attrs["obj"] = "CalData"
            f.attrs["history"] = self.history or ""
            if self.pol is not None:
                f.attrs["pol"] = self.pol
            f.create_dataset("data", data=_host(self.data))
            f.create_dataset("ants", data=np.asarray(self.ants))
            f.create_dataset("times", data=self.times)
            f.create_dataset("freqs", data=self.freqs)
            for k in ("flags", "cov"):
                if getattr(self, k) is not None:
                    f.create_dataset(k, data=_host(getattr(self, k)))
            if self.cov is not None:
                f.attrs["cov_axis"] = self.cov_axis or "none"
            if self.icov is not None:
                f.create_dataset("icov", data=_host(self.icov))
            if self.antpos is not None:
                f.create_dataset("antvecs", data=self.antpos.asnumpy())
            if self.telescope is not None:
                f.attrs["tloc"] = np.asarray(self.telescope.location)

    @classmethod
    def read_uvcal(cls, fname, device=None, **kwargs):
        """Read a calfits / UVCal file through pyuvdata (imported here;
        ImportError without it). data/uvdata_interface.read_calfits
        reads calfits without pyuvdata."""
        try:
            from pyuvdata import UVCal
        except ImportError as e:
            raise ImportError("read_uvcal requires pyuvdata") from e
        uvc = UVCal()
        uvc.read_calfits(fname, **kwargs)
        obj = cls()
        gains = np.asarray(uvc.gain_array)
        if gains.ndim == 4:
            gains = np.moveaxis(gains, (0, 1, 2), (0, 2, 1))[None, None, ...,
                                                             0]
        obj.setup_data([int(a) for a in uvc.ant_array],
                       np.asarray(uvc.time_array),
                       np.asarray(uvc.freq_array).ravel(), pol="ee",
                       data=_dev(gains, resolve_device(device)))
        return obj

    @_hybridmethod
    def read_hdf5(obj, fname, read_data=True, ants=None, times=None,
                  freqs=None, pol=None, device=None, **kwargs):
        """Read an HDF5 file, whole or a selection, its data, cov and
        icov on device (flags on the host)."""
        import h5py
        dev = resolve_device(device)

        def ds(f, k):
            return _dev(f[k][:], dev) if k in f and read_data else None
        with h5py.File(fname, "r") as f:
            ant_list = [int(a) for a in f["ants"][:]]
            antpos = AntposDict(ant_list, np.asarray(f["antvecs"][:])) \
                if "antvecs" in f else None
            obj.setup_meta(telescope=_telescope(f.attrs), antpos=antpos)
            obj.setup_data(ant_list, f["times"][:], f["freqs"][:],
                           pol=f.attrs.get("pol", None), data=ds(f, "data"),
                           flags=np.asarray(f["flags"][:])
                           if "flags" in f and read_data else None,
                           cov=ds(f, "cov"), cov_axis=_cov_axis(f.attrs),
                           icov=ds(f, "icov"),
                           history=str(f.attrs.get("history", "")))
        if (ants, times, freqs, pol) != (None, None, None, None):
            obj.select(ants=ants, times=times, freqs=freqs, pol=pol,
                       inplace=True)
        return obj


# ---------------------------------------------------------------------------
# concatenation
# ---------------------------------------------------------------------------

def _interleave_concat(arrs, axis):
    """Concatenate round-robin along axis: out[i::n] = arrs[i]."""
    torch_in = isinstance(arrs[0], torch.Tensor)
    out = torch.cat(list(arrs), dim=axis) if torch_in \
        else np.concatenate([np.asarray(a) for a in arrs], axis=axis)
    n, N = len(arrs), out.shape[axis]
    pos = [np.arange(i, N, n) for i in range(n)]
    if [len(p) for p in pos] != [a.shape[axis] for a in arrs]:
        raise ValueError("interleave: lengths along the axis do not "
                         "round-robin")
    inv = np.argsort(np.concatenate(pos))
    return _take(out, inv, axis)


def _cat(arrs, axis, interleave=False, lazy=False):
    """Concatenate tensors or arrays along axis: lazily (a CatTensor),
    round-robin (interleave), or at once."""
    if lazy:
        return CatTensor(list(arrs), axis=axis)
    if interleave:
        return _interleave_concat(list(arrs), axis)
    if isinstance(arrs[0], torch.Tensor):
        return torch.cat(list(arrs), dim=axis)
    return np.concatenate([np.asarray(a) for a in arrs], axis=axis)


def _concat(objs, data_axis, interleave=False, lazy=False):
    """A copy of objs[0] with the data, flags (where every object has
    them) and a diagonal icov (likewise) concatenated."""
    out = objs[0].copy()
    out.data = _cat([o.data for o in objs], data_axis,
                    interleave=interleave, lazy=lazy)
    if all(o.flags is not None for o in objs):
        out.flags = _cat([np.asarray(o.flags) for o in objs], data_axis,
                         interleave=interleave, lazy=lazy)
    if all(o.icov is not None and o.cov_axis is None for o in objs):
        out.icov = _cat([o.icov for o in objs], data_axis,
                        interleave=interleave, lazy=lazy)
    return out


def concat_VisData(vds, axis, interleave=False, lazy=False):
    """Concatenate VisData along 'bl', 'time' or 'freq': data, flags and
    a diagonal icov (where every object has one) and the axis' metadata.
    interleave round-robins the entries along the axis; lazy wraps data,
    flags and icov in CatTensors (no interleave)."""
    if lazy and interleave:
        raise ValueError("lazy concat doesn't support interleave")
    if isinstance(vds, VisData):
        return vds
    if len(vds) == 1:
        return vds[0]
    ax = {"bl": 2, "time": 3, "freq": 4}[axis]
    out = _concat(vds, ax, interleave=interleave, lazy=lazy)
    meta = {"bl": "blnums", "time": "times", "freq": "freqs"}[axis]
    setattr(out, meta, _cat([np.asarray(getattr(v, meta)) for v in vds], 0,
                            interleave=interleave))
    return out


def concat_MapData(mds, axis="freq", interleave=False):
    """Concatenate MapData along 'freq' or 'pix' (angs along with it)."""
    ax = {"freq": 2, "pix": 3}[axis]
    out = _concat(mds, ax, interleave=interleave)
    if axis == "freq":
        out.freqs = _cat([np.asarray(m.freqs) for m in mds], 0,
                         interleave=interleave)
    else:
        out.angs = _cat([m.angs for m in mds], 1, interleave=interleave)
    return out


def concat_CalData(cds, axis, interleave=False):
    """Concatenate CalData along 'ant', 'time' or 'freq'."""
    ax = {"ant": 2, "time": 3, "freq": 4}[axis]
    out = _concat(cds, ax, interleave=interleave)
    if axis == "ant":
        out.ants = [a for c in cds for a in c.ants] if not interleave \
            else [int(a) for a in _cat([np.asarray(c.ants) for c in cds],
                                       0, interleave=True)]
    elif axis == "time":
        out.times = _cat([np.asarray(c.times) for c in cds], 0,
                         interleave=interleave)
    else:
        out.freqs = _cat([np.asarray(c.freqs) for c in cds], 0,
                         interleave=interleave)
    return out


class CatTensor:
    """Lazy concatenation of tensors (or arrays, or other lazy tensors)
    along an axis: it concatenates when loaded or indexed."""

    def __init__(self, tensors, axis=0):
        self.tensors = list(tensors)
        self.axis = axis
        self._sizes = [t.shape[axis] for t in self.tensors]

    @property
    def shape(self):
        s = list(self.tensors[0].shape)
        s[self.axis] = sum(self._sizes)
        return tuple(s)

    @property
    def ndim(self):
        return len(self.shape)

    def __getitem__(self, idx):
        return self.load()[idx]

    def load(self):
        parts = [t.load() if hasattr(t, "load") else t for t in self.tensors]
        if any(isinstance(p, torch.Tensor) for p in parts):
            dev = next(p.device for p in parts if isinstance(p, torch.Tensor))
            return torch.cat([torch.as_tensor(p, device=dev) for p in parts],
                             dim=self.axis)
        return np.concatenate([np.asarray(p) for p in parts], axis=self.axis)

    def numel(self):
        return int(np.prod(self.shape))

    def size(self, dim=None):
        return self.shape if dim is None else self.shape[dim]


class HDF5Tensor:
    """A dataset of an HDF5 file, read when indexed: the slice is read
    on the host (h5py indexing) and moved to device (None: CUDA), as
    dtype if given."""

    def __init__(self, fname, dset, dtype=None, device=None):
        import h5py
        self.fname = fname
        self.dset = dset
        self._dtype = dtype
        self.device = resolve_device(device)
        with h5py.File(fname, "r") as f:
            self._shape = f[dset].shape
            self._file_dtype = f[dset].dtype

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    def __len__(self):
        return self._shape[0]

    def _read(self, idx):
        import h5py
        with h5py.File(self.fname, "r") as f:
            return f[self.dset][idx]

    def _tensor(self, arr):
        t = torch.as_tensor(np.asarray(arr), device=self.device)
        return t if self._dtype is None else t.to(self._dtype)

    def __getitem__(self, idx):
        return self._tensor(self._read(idx))

    def load(self):
        return self[...]

    def numel(self):
        return int(np.prod(self.shape))

    def size(self, dim=None):
        return self.shape if dim is None else self.shape[dim]

    def __repr__(self):
        return f"HDF5Tensor({self.fname}:{self.dset}, shape={self._shape})"


class SelectedHDF5Tensor:
    """An HDF5Tensor with a fixed selection sel applied before each
    index: both are applied on the host, in that order, and the result
    moved to the device."""

    def __init__(self, fname, dset, sel=None, dtype=None, device=None):
        self.base = HDF5Tensor(fname, dset, dtype=dtype, device=device)
        self.sel = sel

    @property
    def shape(self):
        """The selected shape, from index arithmetic (nothing read)."""
        if self.sel is None:
            return self.base.shape
        sel = self.sel if isinstance(self.sel, tuple) else (self.sel,)
        out = []
        for ax, n in enumerate(self.base.shape):
            if ax >= len(sel):
                out.append(n)
                continue
            s = sel[ax]
            if isinstance(s, slice):
                out.append(len(range(*s.indices(n))))
            elif np.isscalar(s) or np.ndim(s) == 0:
                continue
            else:
                s = np.asarray(s)
                out.append(int(s.sum()) if s.dtype == bool else len(s))
        return tuple(out)

    def __getitem__(self, idx):
        full = self.base._read(self.sel if self.sel is not None
                               else slice(None))
        return self.base._tensor(np.asarray(full)[idx])


def make_HDF5Tensor(fname, dset="data", sel=None, idx=None, dtype=None,
                    device=None):
    """An HDF5Tensor, or a SelectedHDF5Tensor when sel (or its alias
    idx) is given."""
    sel = idx if sel is None else sel
    if sel is not None:
        return SelectedHDF5Tensor(fname, dset, sel=sel, dtype=dtype,
                                  device=device)
    return HDF5Tensor(fname, dset, dtype=dtype, device=device)


def load_data(fname, concat_ax=None, copy=False, device=None, **kwargs):
    """A VisData, MapData or CalData from an HDF5 file (the class from
    its 'obj' attribute), its tensors on device; a container is passed
    through. A list of files is concatenated along concat_ax (or
    returned as a list); copy deep-copies the result."""
    if isinstance(fname, (VisData, MapData, CalData)):
        out = fname
    elif isinstance(fname, (list, tuple)):
        dlist = [load_data(f, device=device, **kwargs) for f in fname]
        if concat_ax is not None:
            concat = {VisData: concat_VisData, MapData: concat_MapData,
                      CalData: concat_CalData}[type(dlist[0])]
            out = concat(dlist, concat_ax)
        else:
            out = dlist
    else:
        import h5py
        with h5py.File(fname, "r") as f:
            obj = f.attrs.get("obj", "VisData")
        cls = {"VisData": VisData, "MapData": MapData,
               "CalData": CalData}[obj]
        out = cls.read_hdf5(fname, device=device, **kwargs)
    if copy:
        out = _copy.deepcopy(out)
    return out


# ---------------------------------------------------------------------------
# averaging and chain blocks
# ---------------------------------------------------------------------------

def average_data(data, dim, index, N, wgts=None, cov=None, truncate=False):
    """Weighted segment average of a tensor along dim: index puts each
    element along dim into one of N bins (summed in a fixed order,
    _Segments). Returns (avg, sum of weights, 1 / sum of weights), the
    weights 1 / cov when cov is given, else ones; truncate drops the
    last bin."""
    data = torch.as_tensor(data)
    dim = int(np.arange(-data.ndim, 0)[dim])
    index = _host(index).astype(np.int64).reshape(-1)
    seg = _Segments([np.flatnonzero(index == k) for k in range(N)])
    d = torch.movedim(data, dim, -1)
    if wgts is not None:
        w = torch.movedim(torch.as_tensor(wgts, device=data.device), dim, -1)
    elif cov is not None:
        w = 1.0 / torch.movedim(torch.as_tensor(cov, device=data.device),
                                dim, -1)
    else:
        w = torch.ones_like(d.real)
    w = torch.broadcast_to(w, d.shape)
    last = d.ndim - 1
    wsum = seg.sum(seg.gather(w, last), last)
    num = seg.sum(seg.gather(d * w, last), last)
    avg = num / torch.clamp(wsum, min=1e-40)
    avg_cov = 1.0 / torch.clamp(wsum, min=1e-40)
    if truncate:
        avg, wsum, avg_cov = avg[..., :-1], wsum[..., :-1], avg_cov[..., :-1]
    return (torch.movedim(avg, -1, dim), torch.movedim(wsum, -1, dim),
            torch.movedim(avg_cov, -1, dim))


class Difference(Module):
    """params[idx1] - params[idx2] for tensors, or, for data containers
    (idx1, idx2 dicts of select arguments), select(**idx1) minus
    select(**idx2)."""

    def __init__(self, idx1, idx2, name=None):
        super().__init__(name=name)
        self.idx1 = idx1
        self.idx2 = idx2

    def forward(self, params, **kwargs):
        if isinstance(self.idx1, dict):
            p1 = params.select(**{**self.idx1, "inplace": False})
            p2 = params.select(**{**self.idx2, "inplace": False})
            p1.data = p1.data - p2.data
            return p1
        return params[self.idx1] - params[self.idx2]


class RedVisAvg(Module):
    """VisData.bl_average as a block of a model chain."""

    def __init__(self, reds=None, wgts=None, redtol=1.0, inplace=False,
                 name=None):
        super().__init__(name=name)
        self.reds = reds
        self.wgts = wgts
        self.redtol = redtol
        self.inplace = inplace

    def forward(self, vd, **kwargs):
        return vd.bl_average(reds=self.reds, wgts=self.wgts,
                             redtol=self.redtol, inplace=self.inplace)


class RedVisInflate(Module):
    """VisData.inflate_by_redundancy as a block of a model chain."""

    def __init__(self, new_bls, bl2red=None, red_bls=None, name=None):
        super().__init__(name=name)
        self.new_bls = new_bls
        self.bl2red = bl2red
        self.red_bls = red_bls

    def forward(self, vd, **kwargs):
        return vd.inflate_by_redundancy(self.new_bls, bl2red=self.bl2red,
                                        red_bls=self.red_bls)


def average_TensorData(objs, wgts=None):
    """Weighted mean of same-shape containers (weights: wgts, else each
    one's icov, else ones), with the icov sum as icov where every object
    has a diagonal one."""
    objs = list(objs)
    base = objs[0].copy()
    if wgts is None:
        wgts = [getattr(o, "icov", None) for o in objs]
    if any(w is None for w in wgts):
        wgts = [torch.ones_like(o.data.real) for o in objs]
    dev = objs[0].data.device
    wgts = [torch.as_tensor(w, device=dev) for w in wgts]
    wsum = sum(wgts)
    base.data = sum(o.data * w for o, w in zip(objs, wgts)) / wsum
    if all(getattr(o, "icov", None) is not None for o in objs) \
            and all(getattr(o, "cov_axis", None) is None for o in objs):
        base.icov = wsum
        base.cov = 1.0 / wsum
    return base


def caldata_from_visdata(vd):
    """An empty CalData with a VisData's metadata: its antennas, times,
    frequencies and (for 'ee' / 'nn' data) polarization."""
    from ..utils.indexing import flatten
    cd = CalData()
    cd.setup_meta(telescope=vd.telescope, antpos=vd.antpos)
    ants = sorted(set(flatten([list(bl) for bl in vd.bls])))
    pol = None
    if isinstance(vd.pol, str) and len(vd.pol) == 2 \
            and vd.pol[0] == vd.pol[1]:
        pol = vd.pol[0]
    cd.setup_data(ants, vd.times, vd.freqs, pol=pol)
    return cd


def pass_data(fname, copy=False, **kwargs):
    """The read function of an in-memory Dataset: the object itself (or
    a deep copy)."""
    return _copy.deepcopy(fname) if copy else fname
