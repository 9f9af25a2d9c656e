"""
Antenna cross-coupling of visibilities, first and second order.

Counterpart of bayeslim_tpu/models/coupling.py (gen_coupling_terms :34,
cut_bl :89, CouplingInflate :110, PartialRedVisInflate :144, VisCoupling
:212 with setup_coupling :247-292, RedVisCoupling :355).

With V the (Nant, Nant) visibility matrix of a time and channel and X
the coupling matrix, the coupled visibilities are Vc = E V E^H with E =
I + X (or I + X + X X, the double path); X carries the fixed
inter-antenna delay phasor exp(2 pi i (f - f0) |r_ij| / c). The
baselines <-> matrix index maps are host numpy (setup_coupling); on the
device each side of E V E^H is one batched complex product over (time,
channel), ``...patf,...aqtf->...pqtf``, run in true fp32 both ways
(``ops.linalg._Einsum``). These products are library calls: the JAX
package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import _Einsum, apply_along
from ..utils.dtypes import C_MS, _float, resolve_device, viewcomp
from ..utils.indexing import AntposDict
from ..utils.module import Module
from .calibration import VisModelResponse, _param_tensor

__all__ = ["VisCoupling", "RedVisCoupling", "CouplingInflate",
           "PartialRedVisInflate", "gen_coupling_terms", "cut_bl"]

LEFT = "...patf,...aqtf->...pqtf"       # X V
RIGHT = "...patf,...qatf->...pqtf"      # V X^H (X conjugated by the caller)


def _as_antpos(antpos):
    if isinstance(antpos, AntposDict):
        return antpos
    return AntposDict(list(antpos.keys()),
                      np.stack([np.asarray(v) for v in antpos.values()]))


def _items(antpos):
    """(antenna, host float64 position) pairs."""
    if isinstance(antpos, AntposDict):
        return list(zip(antpos.ants, antpos.asnumpy()))
    return [(a, np.asarray(v, dtype=np.float64)) for a, v in antpos.items()]


def gen_coupling_terms(antpos, min_len=None, max_len=None, max_EW=None,
                       max_NS=None, ants=None, no_auto_coupling=True,
                       compress_to_red=False, redtol=1.0):
    """The ant_i -> ant_j coupling terms that pass the geometric cuts.

    Returns (terms, coupling_idx {term: index}); with compress_to_red
    the terms are one a redundant group of separation vectors (within
    redtol) and the index maps every term onto its group's."""
    items = _items(antpos)
    terms = []
    for ai, vi in items:
        for aj, vj in items:
            if no_auto_coupling and ai == aj:
                continue
            if ants is not None and aj not in ants:
                continue
            vec = vj - vi
            vlen = np.linalg.norm(vec)
            if min_len is not None and vlen < min_len:
                continue
            if max_len is not None and vlen > max_len:
                continue
            if max_EW is not None and abs(vec[0]) > max_EW:
                continue
            if max_NS is not None and abs(vec[1]) > max_NS:
                continue
            terms.append((ai, aj))
    idx = {c: i for i, c in enumerate(terms)}
    if compress_to_red:
        ap = dict(items)
        red_vecs, red_grps, red_idx = [], [], []
        for ct in terms:
            vec = ap[ct[1]] - ap[ct[0]]
            match = None
            for k, rv in enumerate(red_vecs):
                if np.linalg.norm(rv - vec) < redtol:
                    match = k
                    break
            if match is None:
                red_idx.append(len(red_vecs))
                red_vecs.append(vec)
                red_grps.append([ct])
            else:
                red_grps[match].append(ct)
                red_idx.append(match)
        idx = {c: red_idx[i] for i, c in enumerate(terms)}
        terms = [g[0] for g in red_grps]
    return terms, idx


def cut_bl(bl, antpos, min_len=None, max_len=None, min_EW=None,
           max_EW=None, min_NS=None, max_NS=None):
    """True if the baseline fails a geometric cut."""
    ap = dict(_items(antpos))
    vec = ap[bl[1]] - ap[bl[0]]
    vlen = np.linalg.norm(vec)
    return bool((min_len is not None and vlen < min_len)
                or (max_len is not None and vlen > max_len)
                or (min_EW is not None and abs(vec[0]) < min_EW)
                or (max_EW is not None and abs(vec[0]) > max_EW)
                or (min_NS is not None and abs(vec[1]) < min_NS)
                or (max_NS is not None and abs(vec[1]) > max_NS))


def _cached(mod, name, arr, device, dtype=None):
    """A host array as a tensor on device, kept per device on mod."""
    cache = mod.__dict__.setdefault("_dev_cache", {})
    key = (name, str(device), dtype)
    if key not in cache:
        cache[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return cache[key]


class CouplingInflate(Module):
    """Unique coupling terms -> the (Nant, Nant) coupling matrix: params
    (..., Nterms, Ntimes, Nfreqs) -> (..., Nant, Nant, Ntimes, Nfreqs),
    absent pairs zero. coupling_idx maps each (ant_i, ant_j) to a term
    index (gen_coupling_terms)."""

    def __init__(self, ants, terms, coupling_idx=None, name=None):
        super().__init__(name=name)
        self.ants = [int(a) for a in ants]
        nant = len(self.ants)
        lut = {a: i for i, a in enumerate(self.ants)}
        if coupling_idx is None:
            coupling_idx = {c: i for i, c in enumerate(terms)}
        # term index + 1 for each matrix cell; 0 is the zero slot
        gidx = np.zeros(nant * nant, dtype=np.int64)
        for (ai, aj), t in coupling_idx.items():
            gidx[lut[ai] * nant + lut[aj]] = t + 1
        self.gidx = gidx
        self.Nant = nant

    def forward(self, params, **kwargs):
        z = torch.zeros(params.shape[:-3] + (1,) + params.shape[-2:],
                        dtype=params.dtype, device=params.device)
        padded = torch.cat([z, params], dim=-3)
        out = padded.index_select(padded.ndim - 3, _cached(
            self, "gidx", self.gidx, params.device))
        return out.reshape(params.shape[:-3] + (self.Nant, self.Nant)
                           + params.shape[-2:])


class PartialRedVisInflate(Module):
    """Per-redundant-group visibilities onto physical baselines with
    trainable mixing coefficients: bl2red maps each baseline of new_bls
    to one group index or to a list of them (which sum); the mixing
    matrix A (Nbls, Nred) holds the params at those cells (default
    1 / the number of groups summed), and the output VisData on new_bls
    holds A @ the input's data.

    With red_idx it is a fixed gather of one group a baseline, tensor in
    and tensor out."""

    def __init__(self, bl2red=None, new_bls=None, params=None, p0=None,
                 R=None, parameter=True, red_idx=None, name=None,
                 device=None, dtype=None):
        super().__init__(name=name)
        if red_idx is not None:
            self.red_idx = np.asarray(red_idx, dtype=np.int64)
            return
        self.red_idx = None
        rows, cols, nred = [], [], []
        for i, bl in enumerate(new_bls):
            red = bl2red[tuple(bl)]
            red = [red] if isinstance(red, (int, np.integer)) else list(red)
            rows.extend([i] * len(red))
            cols.extend(int(r) for r in red)
            nred.extend([len(red)] * len(red))
        self._rows = np.asarray(rows, dtype=np.int64)
        self._cols = np.asarray(cols, dtype=np.int64)
        self.Nred = np.asarray(nred, dtype=np.float64)
        self.Ashape = (len(new_bls), int(self._cols.max()) + 1)
        self.new_bls = [tuple(b) for b in new_bls]
        dev = resolve_device(device)
        if params is None:
            params = 1.0 / self.Nred
        self.register_buffer("params", torch.as_tensor(
            params, dtype=dtype or _float(), device=dev))
        self.p0 = None if p0 is None else torch.as_tensor(
            p0, dtype=self.params.dtype, device=dev)
        if parameter:
            self.set_param("params")
        self.R = R if R is not None else (lambda x: x)

    def _buildA(self, params):
        A = torch.zeros(self.Ashape, dtype=params.dtype,
                        device=params.device)
        return A.index_put((_cached(self, "rows", self._rows, params.device),
                            _cached(self, "cols", self._cols, params.device)),
                           params)

    def forward(self, vd, prior_cache=None, **kwargs):
        if self.red_idx is not None:
            return vd.index_select(2, _cached(self, "red_idx", self.red_idx,
                                              vd.device))
        params = self.params if self.p0 is None else self.params + self.p0
        params = self.R(params)
        self.eval_prior(prior_cache, inp_params=self.params,
                        out_params=params)
        data = apply_along(self._buildA(params), vd.data, dim=-3)
        from ..data.containers import VisData
        out = VisData()
        out.setup_meta(telescope=vd.telescope, antpos=vd.antpos)
        out.setup_data(self.new_bls, vd.times, vd.freqs, pol=vd.pol,
                       data=data, history=vd.history)
        return out


class VisCoupling(Module):
    """First / second-order antenna cross-coupling, Vc = E V E^H, of a
    single-pol VisData on the baselines bls.

    params (1, 1, Nant, Nant, Ntime_coeff, Nfreq_coeff) complex or real
    pairs, or the unique terms with R's LM a CouplingInflate. add_I, prod
    ('left', 'right', 'both') and double (E = I + X + X X) set the
    product; term_mask / term_mask2 (set by RedVisCoupling's
    setup_coupling) cut the first-order terms and the second-order
    factors.
    """

    def __init__(self, params, freqs, antpos, bls, R=None, parameter=True,
                 p0=None, name=None, add_I=True, prod="both", double=False,
                 device=None, dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        self.register_buffer("params", _param_tensor(params, dev, dtype))
        self.p0 = None if p0 is None else torch.as_tensor(
            p0, dtype=self.params.dtype, device=dev)
        if parameter:
            self.set_param("params")
        rdt = self.params.real.dtype
        self._cdtype = torch.complex128 if rdt == torch.float64 \
            else torch.complex64
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.Nfreqs = len(self.freqs)
        self.antpos = _as_antpos(antpos)
        self.Nants = len(self.antpos)
        self.bls = [tuple(b) for b in bls]
        self.add_I = add_I
        self.prod = prod
        self.double = double
        self.term_mask = None
        self.term_mask2 = None
        self.R = R if R is not None else VisModelResponse()
        self.setup_coupling()

    def setup_coupling(self, bls=None, min_dly=None, conj=True):
        """Host precompute: the inter-antenna delay phasor, and the maps
        between the baselines and the cells of the (Nant, Nant) matrix
        (each cell's baseline row, whether it is conjugated, whether it
        is absent; each baseline's cell)."""
        if bls is not None:
            self.bls = [tuple(b) for b in bls]
        sgn = 1 if conj else -1
        av = self.antpos.asnumpy()
        dist = np.linalg.norm(av[None, :, :] - av[:, None, :], axis=-1)
        if min_dly is not None:
            dist = np.clip(dist, min_dly, None)
        dfreqs = self.freqs - self.freqs[0]
        ph = np.exp(2j * np.pi * dfreqs / C_MS * dist[..., None] * sgn)
        self.dly = torch.as_tensor(ph[None, None, :, :, None, :],
                                   dtype=self._cdtype,
                                   device=self.params.device)
        nant = self.Nants
        ants = self.antpos.ants
        bl_lut = {b: i for i, b in enumerate(self.bls)}
        flat_idx = np.zeros(nant * nant, dtype=np.int64)
        flat_null = np.zeros(nant * nant, dtype=bool)
        flat_conj = np.zeros(nant * nant, dtype=bool)
        argsort_key = np.full(nant * nant, 2 ** 31 - 1, dtype=np.int64)
        k = 0
        for a1 in ants:
            for a2 in ants:
                if a2 >= a1:
                    idx = bl_lut.get((a1, a2))
                else:
                    idx = bl_lut.get((a2, a1))
                    flat_conj[k] = True
                if idx is None:
                    flat_null[k] = True
                    idx = 0
                elif not flat_conj[k]:
                    argsort_key[k] = idx
                flat_idx[k] = idx
                k += 1
        self.flat_idx = flat_idx
        self.flat_null = flat_null
        self.flat_conj = flat_conj
        self.bls_idx = np.argsort(argsort_key, kind="stable")[
            :len(self.bls)].astype(np.int64)
        self.__dict__.pop("_dev_cache", None)

    def _X(self, params=None):
        """The coupling terms R(params [+ p0]) as a complex tensor times
        the delay phasor."""
        p = self.params if params is None else params
        if self.p0 is not None:
            p = p + self.p0
        X = self.R(p)
        if not X.is_complex():
            X = viewcomp(X) if X.shape[-1] == 2 else X.to(self._cdtype)
        return X * self.dly

    def _mask(self, mask, X):
        if mask is None:
            return X
        return X * _cached(self, f"mask{id(mask)}", mask, X.device)

    def _coupling_matrix(self, params=None, add_I=None, prod=None,
                         double=None):
        X = self._X(params)
        X1 = self._mask(self.term_mask, X)
        if self.double if double is None else double:
            Xs = self._mask(self.term_mask2, X)
            X1 = X1 + _Einsum.apply(LEFT, Xs, Xs)
        X = X1
        if self.add_I if add_I is None else add_I:
            eye = torch.eye(self.Nants, dtype=X.dtype, device=X.device)
            X = X + eye[None, None, :, :, None, None]
        return X

    def _to_matrix(self, data):
        """The (..., Nbls, T, F) data on the (..., Nant, Nant, T, F)
        visibility matrix: lower-triangle cells conjugated, cells absent
        from bls zero."""
        dev = data.device
        flat = data.index_select(data.ndim - 3, _cached(
            self, "flat_idx", self.flat_idx, dev))
        flat = flat * _cached(self, "keep", ~self.flat_null, dev)[:, None,
                                                                  None]
        flat = torch.where(_cached(self, "conj", self.flat_conj, dev)[
            :, None, None], flat.conj(), flat)
        return flat.reshape(data.shape[:-3] + (self.Nants, self.Nants)
                            + data.shape[-2:])

    def _from_matrix(self, V, shape):
        """The baselines bls out of the (..., Nant, Nant, T, F) matrix."""
        flat = V.reshape(tuple(shape[:-3]) + (self.Nants * self.Nants,)
                         + tuple(shape[-2:]))
        return flat.index_select(flat.ndim - 3, _cached(
            self, "bls_idx", self.bls_idx, V.device))

    def forward(self, vd, prior_cache=None, add_I=None, prod=None,
                double=None, **kwargs):
        """Vc = E V E^H of vd; add_I / prod / double override the
        construction's values for this call (None: those)."""
        prod = self.prod if prod is None else prod
        E = self._coupling_matrix(add_I=add_I, double=double)
        self.eval_prior(prior_cache, inp_params=self.params, out_params=E)
        shape = vd.data.shape
        V = self._to_matrix(vd.data)
        if prod in ("left", "both"):
            V = _Einsum.apply(LEFT, E, V)
        if prod in ("right", "both"):
            V = _Einsum.apply(RIGHT, V, E.conj())
        vout = vd.copy()
        vout.data = self._from_matrix(V, shape)
        return vout


class RedVisCoupling(Module):
    """Coupling of redundantly compressed visibilities: the input holds
    one visibility a redundant group (bl2red: baseline -> the group's row
    of the input); it is inflated onto every baseline of the array with
    a group, coupled, and out_bls are selected (conjugated where out_bls
    has a baseline the other way round).

    By default the coupling is the expansion Vc = V + X1 V + V X1^H
    (+ X2 V X2^H with include_second_order), X1 and X2 cut separately by
    setup_coupling; without cuts it is the exact product. A constructor
    double=True, prod other than 'both' or add_I=False takes
    VisCoupling's exact-product path instead."""

    def __init__(self, params, freqs, antpos, red_bls, bl2red, out_bls,
                 R=None, parameter=True, p0=None, name=None, add_I=True,
                 prod="both", double=False, device=None, dtype=None):
        super().__init__(name=name)
        antpos = _as_antpos(antpos)
        ants = antpos.ants
        full_bls = [(a1, a2) for i, a1 in enumerate(ants)
                    for a2 in ants[i:]]
        full_bls = [bl for bl in full_bls if bl in bl2red
                    or (bl[1], bl[0]) in bl2red]
        red_idx = [bl2red[bl] if bl in bl2red else bl2red[(bl[1], bl[0])]
                   for bl in full_bls]
        self.inflate = PartialRedVisInflate(red_idx=red_idx)
        self.full_bls = full_bls
        self.out_bls = [tuple(b) for b in out_bls]
        self.include_second_order = True
        self.coupling = VisCoupling(params, freqs, antpos, full_bls, R=R,
                                    parameter=parameter, p0=p0, add_I=add_I,
                                    prod=prod, double=double, device=device,
                                    dtype=dtype)
        lut = {bl: i for i, bl in enumerate(full_bls)}
        self._out_idx = np.asarray(
            [lut[bl] if bl in lut else lut[(bl[1], bl[0])]
             for bl in self.out_bls], dtype=np.int64)
        self._out_conj = np.asarray([bl not in lut for bl in self.out_bls])

    def forward(self, vd, prior_cache=None, **kwargs):
        vfull = vd.copy()
        vfull.data = self.inflate(vd.data)
        vfull._set_bls(self.full_bls)
        vc = self.coupling
        if vc.double or vc.prod != "both" or not vc.add_I:
            coupled = vc.forward(vfull, prior_cache=prior_cache).data
        else:
            X = vc._X()
            X1 = vc._mask(vc.term_mask, X)
            vc.eval_prior(prior_cache, inp_params=vc.params, out_params=X1)
            shape = vfull.data.shape
            V = vc._to_matrix(vfull.data)
            out = V + _Einsum.apply(LEFT, X1, V) \
                + _Einsum.apply(RIGHT, V, X1.conj())
            if self.include_second_order:
                X2 = vc._mask(vc.term_mask2, X)
                VX2 = _Einsum.apply(RIGHT, V, X2.conj())
                out = out + _Einsum.apply(LEFT, X2, VX2)
            coupled = vc._from_matrix(out, shape)
        dev = coupled.device
        out = coupled.index_select(coupled.ndim - 3, _cached(
            self, "out_idx", self._out_idx, dev))
        out = torch.where(_cached(self, "out_conj", self._out_conj, dev)[
            :, None, None], out.conj(), out)
        vout = vd.copy()
        vout.data = out
        vout._set_bls(self.out_bls)
        return vout

    @property
    def params(self):
        return self.coupling.params

    def setup_coupling(self, use_reds=True, copydata=False, redtol=1.0,
                       include_second_order=None, min_len=None,
                       max_len=None, max_EW=None, max_NS=None,
                       second_max_len=None, second_max_EW=None,
                       second_max_NS=None, min_dly=None, **kwargs):
        """Which coupling-matrix cells take part: max_len / max_EW /
        max_NS (and min_len) cut the first-order terms, second_max_*
        (with the same min_len) the second-order factors, each order on
        its own; include_second_order toggles the X2 V X2^H term (not
        the double path). copydata is accepted and unused (the forward
        never changes its input). use_reds=False (physical baselines) is
        VisCoupling's job."""
        if not use_reds:
            raise NotImplementedError(
                "use_reds=False input is physical baselines: use "
                "VisCoupling directly")
        self.copydata = copydata
        self.redtol = redtol
        vc = self.coupling
        if include_second_order is not None:
            self.include_second_order = bool(include_second_order)
        if min_dly is not None:
            vc.setup_coupling(min_dly=min_dly)

        def build_mask(mn, mx, ew, ns):
            if mn is None and mx is None and ew is None and ns is None:
                return None
            ants = vc.antpos.ants
            m = np.ones((len(ants), len(ants)), dtype=bool)
            for i, a1 in enumerate(ants):
                for j, a2 in enumerate(ants):
                    m[i, j] = not cut_bl((a1, a2), vc.antpos, min_len=mn,
                                         max_len=mx, max_EW=ew, max_NS=ns)
            return m[None, None, :, :, None, None]

        vc.term_mask = build_mask(min_len, max_len, max_EW, max_NS)
        vc.term_mask2 = build_mask(min_len, second_max_len, second_max_EW,
                                   second_max_NS)
        vc.__dict__.pop("_dev_cache", None)
        return self

    def get_coupling_hits(self):
        """{term index: the coupling-matrix cells it feeds}, each doubled
        for prod 'both' and again for double."""
        vc = self.coupling
        lm = getattr(vc.R, "LM", None)
        inflate = lm if isinstance(lm, CouplingInflate) else (
            vc.R if isinstance(vc.R, CouplingInflate) else None)
        if inflate is not None:
            gidx = inflate.gidx
            nterms = max(int(gidx.max()), int(vc.params.shape[-3]))
            counts = np.bincount(gidx[gidx > 0] - 1, minlength=nterms)
        else:
            counts = np.ones(vc.Nants * vc.Nants, dtype=np.int64)
        mult = (2 if vc.prod == "both" else 1) * (2 if vc.double else 1)
        return {i: int(c) * mult for i, c in enumerate(counts)}

    def export_to_viscoupling(self):
        """The VisCoupling acting on every baseline of the array."""
        return self.coupling
