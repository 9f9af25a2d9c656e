"""
Direction-independent calibration: antenna gains, per-baseline and
per-redundant-group visibility models, and the redcal degeneracies.

Counterpart of bayeslim_tpu/models/calibration.py (IndexCache :37,
params2complex :120, BaseResponse :166 with its projection :192-217,
JonesResponse :234, JonesModel :270, VisModelResponse :422, VisModel
:426, RedVisModel :462, _apply_cal :527, apply_cal :571,
rephase_to_refant :584, compute_redcal_degen :617, redcal_degen_gains
:651, remove_redcal_degen :664, compute_redcal_degen_vis :685,
redcal_degen_vis :719, vis2JonesModel :744, vis2RedVisModel :775,
chisq :799). The freq/time modes are 'channel' (a value per channel
or time) and 'linear' (a LinearModel, freq_LM / time_LM, maps the
params' coefficients to channels or times); JonesModel.to_CalData
exports the gains as a CalData.

Index maps (data times / baselines onto the params' axes, baselines
onto antennas or redundant groups) are host numpy, built once per
distinct batch, and kept as device tensors beside it, so a forward
copies nothing from the host. The degeneracy projection's constants
(antenna positions, the phase-slope fit) are computed once on the host
in float64 and kept on each device they are used on: the projection
never synchronises the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.containers import CalData, VisData
from ..ops.linalg import pinv_rtol
from ..utils.dtypes import _float, resolve_device, viewcomp, viewreal
from ..utils.indexing import AntposDict, ants2blnum, blnum2ants, flatten
from ..utils.logging import span
from ..utils.module import Module

__all__ = ["params2complex", "complex2params", "BaseResponse",
           "JonesResponse", "JonesModel", "VisModelResponse", "VisModel",
           "RedVisModel", "IndexCache", "apply_cal", "_apply_cal",
           "rephase_to_refant", "compute_redcal_degen", "redcal_degen_gains",
           "remove_redcal_degen", "compute_redcal_degen_vis",
           "redcal_degen_vis", "vis2JonesModel", "vis2RedVisModel", "chisq"]

def _key(arr):
    """Exact cache key of an index array (the JAX package's arr_hash
    keys by its ends and length only, which two batches can share)."""
    a = np.ascontiguousarray(np.atleast_1d(np.asarray(arr)))
    return a.dtype.str, a.shape, a.tobytes()


class IndexCache:
    """Time / baseline minibatch index cache, a mixin of JonesModel,
    VisModel and RedVisModel: maps a data batch's times and blnums onto
    the params' time and baseline axes. Indices are host numpy, cached
    by the batch's content, with their device tensors beside them."""

    def _init_index_cache(self, times=None, bls=None, atol=1e-5):
        self._times = None if times is None else np.asarray(times)
        if bls is not None and not isinstance(bls, list):
            bls = np.asarray(bls)
        self._bls = bls
        self._atol = atol
        self.clear_cache()

    def clear_time_cache(self):
        self.cache_tidx = {}
        self._dev_tidx = {}

    def clear_bl_cache(self):
        self.cache_bidx = {}
        self._dev_bidx = {}

    def clear_cache(self):
        """Clear every index cache."""
        self.clear_time_cache()
        self.clear_bl_cache()

    def _on_device(self, dev_cache, key, idx, device):
        """The device copy of a cached host index (a tuple of arrays
        gives a tuple of tensors)."""
        dkey = (key, str(device))
        if dkey not in dev_cache:
            dev_cache[dkey] = tuple(torch.as_tensor(i, device=device)
                                    for i in idx) \
                if isinstance(idx, tuple) else torch.as_tensor(idx,
                                                               device=device)
        return dev_cache[dkey]

    def get_time_idx(self, times):
        """Indices of times in the params' time axis (isclose within
        atol, else the nearest); None without times."""
        if times is None or self._times is None:
            return None
        t = np.atleast_1d(np.asarray(times))
        k = _key(t)
        if k not in self.cache_tidx:
            idx = []
            for tt in t:
                w = np.where(np.isclose(self._times, tt, atol=self._atol,
                                        rtol=1e-15))[0]
                idx.append(int(w[0]) if len(w)
                           else int(np.argmin(np.abs(self._times - tt))))
            self.cache_tidx[k] = np.asarray(idx, dtype=np.int64)
        return self.cache_tidx[k]

    def get_bl_idx(self, bls):
        """Indices of bls (blnums or antenna-pair tuples) in the params'
        baseline axis; None without bls."""
        if bls is None or self._bls is None:
            return None
        own = self._bls
        if isinstance(own, list):
            own = np.asarray([int(ants2blnum(b)) for b in own])
        if isinstance(bls, list):
            q = np.asarray([int(ants2blnum(b)) for b in bls])
        else:
            q = np.asarray(bls)
        k = _key(q)
        if k not in self.cache_bidx:
            lut = {int(b): i for i, b in enumerate(own)}
            self.cache_bidx[k] = np.asarray([lut[int(b)] for b in q],
                                            dtype=np.int64)
        return self.cache_bidx[k]

    def index_params(self, params, times=None, bls=None):
        """Select params onto the batch's times / bls; a no-op where
        the index covers the whole axis in order."""
        tidx = self.get_time_idx(times)
        if tidx is not None and not (
                len(tidx) == params.shape[-2]
                and np.array_equal(tidx, np.arange(len(tidx)))):
            params = params.index_select(-2, self._on_device(
                self._dev_tidx, _key(tidx), tidx, params.device))
        bidx = self.get_bl_idx(bls)
        if bidx is not None and not (
                len(bidx) == params.shape[-3]
                and np.array_equal(bidx, np.arange(len(bidx)))):
            params = params.index_select(-3, self._on_device(
                self._dev_bidx, _key(bidx), bidx, params.device))
        return params


def _complex_of(dtype):
    return torch.complex128 if dtype in (torch.float64, torch.complex128) \
        else torch.complex64


def _like(x, ref):
    """x (numpy or tensor) as a real tensor on ref's device and dtype."""
    return torch.as_tensor(x, dtype=ref.real.dtype, device=ref.device)


def params2complex(params, param_type, freqs=None):
    """Complex gains from a params tensor of the given type:

    - 'com': already complex (or a real-pair view, trailing dim 2)
    - 'real': the real part only
    - 'amp': g = exp(params)
    - 'phs': g = exp(i params)
    - 'amp_phs': params (..., 2) holding (amp, phs): g = exp(amp + i phs)
    - 'dly': delays [ns]: g = exp(2 pi i f tau); needs freqs [Hz]
    """
    if param_type == "com":
        return viewcomp(params)
    if param_type == "real":
        return params.to(_complex_of(params.dtype))
    if param_type == "amp":
        return torch.exp(params).to(_complex_of(params.dtype))
    if param_type == "phs":
        return torch.exp(1j * params)
    if param_type == "amp_phs":
        return torch.exp(torch.complex(params[..., 0], params[..., 1]))
    if param_type == "dly":
        if freqs is None:
            raise ValueError("dly type needs freqs")
        return torch.exp(2j * np.pi * _like(freqs, params) * params * 1e-9)
    raise ValueError(f"unknown param_type {param_type}")


def complex2params(gains, param_type):
    """Inverse of params2complex where it is defined."""
    if param_type == "com":
        return gains
    if param_type == "real":
        return gains.real
    if param_type == "amp":
        return torch.log(torch.abs(gains))
    if param_type == "phs":
        return torch.angle(gains)
    if param_type == "amp_phs":
        return torch.stack([torch.log(torch.abs(gains)), torch.angle(gains)],
                           dim=-1)
    raise ValueError(f"cannot invert param_type {param_type}")


class BaseResponse(Module):
    """Maps a params tensor to complex (..., Ntimes, Nfreqs) values: an
    optional LM, then freq_LM ('linear' freq_mode) and time_LM ('linear'
    time_mode), param_type conversion, an optional fixed offset base0,
    then the projection (redcal degeneracies and / or the reference
    antenna's phase, setup_projection)."""

    def __init__(self, freq_mode="channel", time_mode="channel",
                 param_type="com", freq_LM=None, time_LM=None, freqs=None,
                 times=None, LM=None, base0=None, antpos=None, name=None,
                 **proj_kwargs):
        super().__init__(name=name)
        self.freq_mode = freq_mode
        self.time_mode = time_mode
        self.param_type = param_type
        self.freq_LM = freq_LM
        self.time_LM = time_LM
        self.freqs = None if freqs is None else np.asarray(freqs)
        self.times = None if times is None else np.asarray(times)
        self.LM = LM
        self.base0 = base0
        self.antpos = antpos
        self.setup_projection(**proj_kwargs)

    def setup_projection(self, abs_amp_gain=False, phs_slope_gain=False,
                         wgts_gain=None, refant_idx=None):
        """Post-response projection: divide out the redcal degeneracies
        (abs_amp_gain: the overall amplitude; phs_slope_gain: the E/N
        phase gradient over antpos; wgts_gain: per-antenna weights of
        their fit, computed on the detached response), then the
        reference antenna's phase (refant_idx)."""
        if phs_slope_gain and self.antpos is None:
            raise ValueError("phs_slope_gain needs antpos")
        self._proj_abs_amp = abs_amp_gain
        self._proj_phs_slope = phs_slope_gain
        self._proj_wgts = wgts_gain
        self._proj_refant_idx = refant_idx
        self._projection = bool(abs_amp_gain or phs_slope_gain
                                or refant_idx is not None)
        self._proj_consts = {}

    def projection(self, params):
        if not self._projection:
            return params
        if self._proj_abs_amp or self._proj_phs_slope:
            key = (str(params.device), params.dtype)
            if key not in self._proj_consts:
                ants = None if self.antpos is None else self.antpos.ants
                self._proj_consts[key] = _degen_consts(
                    params, params.shape[2], ants, self.antpos,
                    self._proj_wgts, self._proj_phs_slope)
            params = _remove_degen(params, self._proj_consts[key],
                                   self._proj_abs_amp,
                                   self._proj_phs_slope)[0]
        i = self._proj_refant_idx
        if i is not None:
            phs = torch.angle(params[:, :, i:i + 1].detach())
            params = params * torch.exp(-1j * phs)
        return params

    def _linear_modes(self, params):
        """The 'linear' freq and time modes' LinearModels."""
        if self.freq_mode == "linear":
            params = self.freq_LM(params)
        if self.time_mode == "linear":
            params = self.time_LM(params)
        return params

    def forward(self, params, **kwargs):
        if self.LM is not None:
            params = self.LM(params)
        if self.param_type == "com":
            params = viewcomp(params)
        params = self._linear_modes(params)
        if self.base0 is not None:
            params = params + torch.as_tensor(self.base0, dtype=params.dtype,
                                              device=params.device)
        params = params2complex(params, self.param_type, freqs=self.freqs)
        return self.projection(params)


class JonesResponse(BaseResponse):
    """Gain response; param_type additionally takes 'dly_slope' and
    'phs_slope': params (Npol, Npol, 2, Ntimes, Nfreqs) of EW/NS slopes,
    mapped onto antennas through antpos."""

    def __init__(self, vis_type="com", antpos=None, **kwargs):
        ptype = kwargs.get("param_type", "com")
        slope = ptype in ("dly_slope", "phs_slope")
        if slope:
            kwargs = dict(kwargs, param_type="com")
        super().__init__(antpos=antpos, **kwargs)
        self.vis_type = vis_type
        self.slope_type = ptype if slope else None
        if slope:
            self.param_type = ptype

    def forward(self, params, **kwargs):
        if self.slope_type is None:
            return super().forward(params, **kwargs)
        if self.LM is not None:
            params = self.LM(params)
        params = self._linear_modes(params)
        A = _like(self.antpos.antvecs[:, :2], params)
        slope = torch.einsum("ab,ijblm->ijalm", A, params)
        if self.slope_type == "dly_slope":
            return torch.exp(2j * np.pi * _like(self.freqs, params) * slope
                             * 1e-9)
        return torch.exp(1j * slope)


def _param_tensor(params, device, dtype):
    """params as a tensor on the device: complex params in the complex
    dtype of the real dtype (default: the package default)."""
    rdt = dtype or _float()
    cplx = params.is_complex() if isinstance(params, torch.Tensor) \
        else np.iscomplexobj(params)
    return torch.as_tensor(params, dtype=_complex_of(rdt) if cplx else rdt,
                           device=device)


class JonesModel(Module, IndexCache):
    """Antenna-based direction-independent gains, V_d = J_p V_m J_q^H.

    params (Npol, Npol, Nants, Ntimes, Nfreqs) complex, or real pairs
    with a trailing dim of 2 for param_type 'com'; trainable unless
    parameter=False. refant's phase is projected out of the gains. The
    gains' priors (set_priors) see the params and the response's gains.
    """

    def __init__(self, params, ants, p0=None, refant=None, R=None,
                 parameter=True, polmode="1pol", single_ant=False,
                 name=None, vis_type="com", atol=1e-5, device=None,
                 dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        self.register_buffer("params", _param_tensor(params, dev, dtype))
        self.p0 = None if p0 is None else torch.as_tensor(
            p0, dtype=self.params.dtype, device=dev)
        self.ants = [int(a) for a in ants]
        self.Nants = len(self.ants)
        if parameter:
            self.set_param("params")
        self.R = R if R is not None else JonesResponse()
        self.polmode = polmode
        self.single_ant = single_ant
        self.vis_type = vis_type
        self._g1_idx = None
        self._g2_idx = None
        self._init_index_cache(times=getattr(self.R, "times", None),
                               atol=atol)
        self.set_refant(refant)

    def set_refant(self, refant):
        """Record the reference antenna; its phase is projected out in
        get_jones, and zeroed on the current params here."""
        self.refant = refant
        self.refant_idx = None
        if refant is not None:
            if refant not in self.ants:
                raise ValueError("need a valid refant")
            self.refant_idx = self.ants.index(refant)
            if self.R.time_mode == "channel" and \
                    self.R.freq_mode == "channel":
                self.rephase_mode = "rephase"
            else:
                self.rephase_mode = "zero"
            self.fix_refant_phs()

    def fix_refant_phs(self):
        """Zero the reference antenna's phase on the current params, in
        place (e.g. after an optimizer step drifted it). No-op without a
        refant."""
        if self.refant_idx is None:
            return
        with torch.no_grad():
            new = rephase_to_refant(self.params, self.R.param_type,
                                    self.refant_idx, p0=self.p0,
                                    mode=self.rephase_mode)
            if not self.params.is_complex():
                new = viewreal(new)
            self.params.copy_(new)

    def ant_index(self, bls):
        """Host (g1_idx, g2_idx) into the Nants axis for baselines."""
        bls = blnum2ants(bls)
        if isinstance(bls, tuple):
            bls = [bls]
        if self.single_ant:
            z = np.zeros(len(bls), dtype=np.int64)
            return z, z
        lut = {a: i for i, a in enumerate(self.ants)}
        g1 = np.asarray([lut[int(bl[0])] for bl in bls], dtype=np.int64)
        g2 = np.asarray([lut[int(bl[1])] for bl in bls], dtype=np.int64)
        return g1, g2

    def set_bls(self, bls):
        """Pin the baseline -> antenna gain indices as device tensors;
        forward then uses them verbatim. Accepts tuples, an (N, 2) array
        or blnums."""
        if np.ndim(bls) == 2:
            bls = [tuple(int(a) for a in b) for b in bls]
        g1, g2 = self.ant_index(bls)
        dev = self.params.device
        self._g1_idx = torch.as_tensor(g1, device=dev)
        self._g2_idx = torch.as_tensor(g2, device=dev)
        return self

    def _ant_idx(self, blnums, device):
        """Device (g1, g2) gather indices for a VisData's blnums, built
        once per distinct baseline set (in the baseline cache)."""
        k = _key(blnums)
        if k not in self.cache_bidx:
            self.cache_bidx[k] = self.ant_index(np.asarray(blnums))
        return self._on_device(self._dev_bidx, k, self.cache_bidx[k], device)

    def get_jones(self, params=None):
        """Response-evaluated complex gains (Npol, Npol, Nants, Nt, Nf);
        the refant's phase is projected out, differentiably."""
        p = self.params if params is None else params
        if self.p0 is not None:
            p = p + self.p0
        jones = self.R(p)
        if self.refant_idx is not None:
            i = self.refant_idx
            jones = jones * torch.exp(-1j * torch.angle(jones[:, :, i:i + 1]))
        return jones

    def index_params(self, jones, times=None, bls=None):
        """Select the gain time axis onto the data's times (gains are
        antenna-indexed: baselines are selected in apply_cal)."""
        if times is None or self.R.times is None or \
                jones.shape[-2] == len(np.atleast_1d(times)):
            return jones
        if jones.shape[-2] == 1:
            return jones
        rt = np.asarray(self.R.times)
        if self._times is None or not np.array_equal(self._times, rt):
            self._times = rt
            self.clear_time_cache()
        return IndexCache.index_params(self, jones, times=times)

    @span("bl.jones")
    def forward(self, vd, undo=False, prior_cache=None, jones=None,
                **kwargs):
        """Apply the gains to a VisData; returns a new VisData."""
        if jones is None:
            jones = self.get_jones()
        self.eval_prior(prior_cache, inp_params=self.params,
                        out_params=jones)
        jones = self.index_params(jones, times=getattr(vd, "times", None))
        if self._g1_idx is not None:
            g1_idx, g2_idx = self._g1_idx, self._g2_idx
        else:
            g1_idx, g2_idx = self._ant_idx(vd.blnums, jones.device)
        vout = vd.copy()
        vout.data, _ = _apply_cal(vd.data, jones, g1_idx, g2_idx,
                                  cal_2pol=self.polmode == "2pol",
                                  vis_type=self.vis_type, undo=undo)
        return vout

    def to_CalData(self, freqs, times, pol=None, telescope=None,
                   antpos=None, flags=None, cov=None, cov_axis=None,
                   icov=None, history="", **kwargs):
        """The gains as a CalData, detached, on the gains' device."""
        cd = CalData()
        cd.setup_meta(telescope=telescope, antpos=antpos)
        with torch.no_grad():
            jones = self.get_jones().detach()
        cd.setup_data(ants=self.ants, times=times, freqs=freqs, pol=pol,
                      data=jones, flags=flags, cov=cov, cov_axis=cov_axis,
                      icov=icov, history=history)
        return cd


class VisModelResponse(BaseResponse):
    """Response of VisModel and RedVisModel."""


class VisModel(Module, IndexCache):
    """Per-baseline visibility model, vout = vd + R(params) (undo:
    minus). params (Npol, Npol, Nbls, Ntimes, Nfreqs), complex or real
    pairs; blnums (the params' baseline order) and R.times allow
    baseline and time minibatches: a VisData with a subset of either
    axis gets the matching params rows."""

    def __init__(self, params, R=None, p0=None, parameter=True,
                 blnums=None, name=None, atol=1e-5, device=None,
                 dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        self.register_buffer("params", _param_tensor(params, dev, dtype))
        self.p0 = None if p0 is None else torch.as_tensor(
            p0, dtype=self.params.dtype, device=dev)
        if parameter:
            self.set_param("params")
        self.R = R if R is not None else VisModelResponse()
        self._init_index_cache(times=getattr(self.R, "times", None),
                               bls=blnums, atol=atol)

    def forward(self, vd, undo=False, prior_cache=None, **kwargs):
        p = self.params if self.p0 is None else self.params + self.p0
        vis = self.R(p)
        self.eval_prior(prior_cache, inp_params=self.params, out_params=vis)
        times = bls = None
        if getattr(vd, "blnums", None) is not None \
                and vd.Nbls != vis.shape[-3]:
            bls = vd.blnums
        if getattr(vd, "times", None) is not None \
                and vd.Ntimes != vis.shape[-2]:
            times = vd.times
        vis = self.index_params(vis, times=times, bls=bls)
        vout = vd.copy()
        vout.data = vd.data - vis if undo else vd.data + vis
        return vout


class RedVisModel(Module, IndexCache):
    """Per-redundant-group visibility model expanded onto the data's
    baselines, vout = vd + R(params)[group of each baseline] (undo:
    minus). params (Npol, Npol, Nredvis, Ntimes, Nfreqs), complex or
    real pairs; bl2red maps each baseline (tuple) to its group. R.times
    allows time minibatches; the expansion index is built once per
    distinct baseline set (set_bls pins one)."""

    def __init__(self, params, bl2red, R=None, p0=None, parameter=True,
                 name=None, atol=1e-5, device=None, dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        self.register_buffer("params", _param_tensor(params, dev, dtype))
        self.p0 = None if p0 is None else torch.as_tensor(
            p0, dtype=self.params.dtype, device=dev)
        self.bl2red = dict(bl2red)
        self._red_idx = None
        if parameter:
            self.set_param("params")
        self.R = R if R is not None else VisModelResponse()
        self._init_index_cache(times=getattr(self.R, "times", None),
                               atol=atol)

    def red_index(self, bls):
        """Host group index of each baseline (blnums or tuples)."""
        k = _key(np.asarray(bls))
        if k not in self.cache_bidx:
            pairs = blnum2ants(bls)
            if isinstance(pairs, tuple):
                pairs = [pairs]
            self.cache_bidx[k] = np.asarray(
                [self.bl2red[tuple(int(a) for a in bl)] for bl in pairs],
                dtype=np.int64)
        return self.cache_bidx[k]

    def set_bls(self, bls):
        """Pin the baseline -> group expansion index as a device tensor;
        forward then uses it verbatim. Accepts tuples, an (N, 2) array
        or blnums."""
        if np.ndim(bls) == 2:
            bls = [tuple(int(a) for a in b) for b in bls]
        self._red_idx = torch.as_tensor(self.red_index(bls),
                                        device=self.params.device)
        return self

    def forward(self, vd, undo=False, prior_cache=None, **kwargs):
        p = self.params if self.p0 is None else self.params + self.p0
        redvis = self.R(p)
        self.eval_prior(prior_cache, inp_params=self.params,
                        out_params=redvis)
        if getattr(vd, "times", None) is not None \
                and vd.Ntimes != redvis.shape[-2]:
            redvis = self.index_params(redvis, times=vd.times)
        if self._red_idx is not None:
            idx = self._red_idx
        else:
            idx = self._on_device(self._dev_bidx, _key(vd.blnums),
                                  self.red_index(vd.blnums), redvis.device)
        expanded = redvis.index_select(2, idx)
        vout = vd.copy()
        vout.data = vd.data - expanded if undo else vd.data + expanded
        return vout


def _pols_last(x):
    return x.movedim(0, -1).movedim(0, -1)


def _pols_first(x):
    return x.movedim(-1, 0).movedim(-1, 0)


def _apply_cal(vis, gains, g1_idx, g2_idx, cal_2pol=False, cov=None,
               vis_type="com", undo=False):
    """V_out = g1 V g2^H per baseline.

    vis (Npol, Npol, Nbls, Nt, Nf), gains (Npol, Npol, Nants, Nt, Nf);
    g1_idx, g2_idx index the antennas of each baseline. Returns
    (vout, cov_out).
    """
    if vis.shape[:2] != gains.shape[:2]:
        raise ValueError("vis/gains Npol mismatch")
    polmode = "1pol" if tuple(vis.shape[:2]) == (1, 1) else "4pol"
    if cal_2pol and polmode == "4pol":
        polmode = "2pol"
    g1 = gains.index_select(2, torch.as_tensor(g1_idx, device=gains.device))
    g2 = gains.index_select(2, torch.as_tensor(g2_idx, device=gains.device))

    if polmode in ("1pol", "2pol"):
        if vis_type == "com":
            G = g1 * g2.conj()
            if undo:
                vout = vis / G
                cov_out = None if cov is None else cov / (G * G.conj()).real
            else:
                vout = vis * G
                cov_out = None if cov is None else cov * (G * G.conj()).real
        elif vis_type == "dly":
            vout = vis + (g2 - g1 if undo else g1 - g2)
            cov_out = cov
        else:
            raise ValueError(vis_type)
    else:
        if vis_type != "com":
            raise ValueError("4pol needs complex vis")
        if undo:
            # invert the 2x2 Jones of each antenna, pol axes moved last
            g1 = _pols_first(torch.linalg.inv(_pols_last(g1)))
            g2 = _pols_first(torch.linalg.inv(_pols_last(g2)))
        vout = torch.einsum("ab...,bc...,dc...->ad...", g1, vis, g2.conj())
        cov_out = cov
    return vout, cov_out


def apply_cal(vis, bls, gains, ants, cal_2pol=False, cov=None,
              vis_type="com", undo=False):
    """_apply_cal with baseline tuples (or blnums) and antenna numbers."""
    bls = blnum2ants(bls)
    if isinstance(bls, tuple):
        bls = [bls]
    lut = {int(a): i for i, a in enumerate(ants)}
    g1 = np.asarray([lut[int(bl[0])] for bl in bls])
    g2 = np.asarray([lut[int(bl[1])] for bl in bls])
    return _apply_cal(vis, gains, g1, g2, cal_2pol=cal_2pol, cov=cov,
                      vis_type=vis_type, undo=undo)


def rephase_to_refant(params, param_type, refant_idx, p0=None,
                      mode="rephase"):
    """Zero the reference antenna's phase.

    mode 'rephase': divide all antennas by the refant phasor ('com') or
    subtract the refant ('phs'/'dly'); mode 'zero': zero the refant's
    imaginary part / phase only.
    """
    if refant_idx is None:
        return params
    i = refant_idx
    if param_type == "com":
        params = viewcomp(params)
        full = params if p0 is None else params + p0
        if mode == "rephase":
            ang = torch.angle(full[:, :, i:i + 1])
            phs = torch.complex(torch.cos(ang), torch.sin(ang))
            return params / phs if p0 is None else (full / phs) - p0
        out = params.clone()
        out[:, :, i:i + 1] = params[:, :, i:i + 1].real.to(params.dtype)
        return out
    if param_type in ("phs", "dly"):
        full = params if p0 is None else params + p0
        if mode == "rephase":
            out = full - full[:, :, i:i + 1]
            return out if p0 is None else out - p0
        out = params.clone()
        out[:, :, i:i + 1] = 0.0
        return out
    return params


# ---------------------------------------------------------------------------
# redcal degeneracies
# ---------------------------------------------------------------------------

def _antvecs(antpos, ants):
    """Host float64 (len(ants), 3) positions of ants."""
    if isinstance(antpos, AntposDict):
        return antpos.asnumpy()[antpos.index(ants)]
    return np.stack([np.asarray(antpos[a], dtype=np.float64) for a in ants])


def _slope_proj(A, wgts):
    """(2, N) least-squares map from N phases to the E/N gradient over
    the rows of A (N, 2), float64 on the host; wgts (N,) weights it. The
    pinv cut-off is the JAX package's default."""
    A = torch.as_tensor(A, dtype=torch.float64)
    if wgts is None:
        AtA, rhs = A.T @ A, A.T
    else:
        W = torch.diag(torch.as_tensor(wgts, dtype=torch.float64)
                       / float(np.sum(wgts)))
        AtA, rhs = A.T @ W @ A, A.T @ W
    return torch.linalg.pinv(AtA, rtol=pinv_rtol(AtA)) @ rhs


def _degen_consts(ref, n, ants, antpos, wgts, phs_slope):
    """Constants of the degeneracy fit on ref's device and precision:
    (amplitude weights w, their sum, antenna E/N positions A, the slope
    projection)."""
    rdt, dev = ref.real.dtype, ref.device
    if wgts is None:
        w, wsum = 1.0, float(n)
    else:
        wgts = wgts.detach().cpu().numpy() if isinstance(wgts, torch.Tensor) \
            else np.asarray(wgts, dtype=np.float64)
        w = torch.as_tensor(wgts, dtype=rdt, device=dev)[:, None, None]
        wsum = float(np.sum(wgts))
    A = proj = None
    if antpos is not None and ants is not None:
        A_np = _antvecs(antpos, ants)[:, :2]
        A = torch.as_tensor(A_np, dtype=rdt, device=dev)
        if phs_slope:
            proj = _slope_proj(A_np, wgts).to(dtype=rdt, device=dev)
    return w, wsum, A, proj


def _compute_degen(gains, consts, abs_amp, phs_slope):
    w, wsum, _, proj = consts
    abs_amp_param = phs_slope_param = None
    if abs_amp:
        aa = torch.sum(torch.abs(gains) ** 2 * w, dim=2, keepdim=True) / wsum
        abs_amp_param = torch.log(torch.sqrt(aa))
    if phs_slope:
        phs_slope_param = torch.einsum("ab,ijblm->ijalm", proj,
                                       torch.angle(gains))
    return abs_amp_param, phs_slope_param


def _degen_gains(abs_amp, phs_slope, A):
    out = None
    if abs_amp is not None:
        out = torch.exp(abs_amp).to(_complex_of(abs_amp.dtype))
    if phs_slope is not None:
        g = torch.exp(1j * torch.einsum("ab,ijblm->ijalm", A, phs_slope))
        out = g if out is None else out * g
    return out


def _remove_degen(gains, consts, abs_amp, phs_slope, degen=None):
    rd = _compute_degen(gains.detach(), consts, abs_amp, phs_slope)
    degen_gains = _degen_gains(rd[0], rd[1], consts[2])
    if degen is not None:
        degen_gains = degen_gains / degen
    return gains / degen_gains, degen_gains


def compute_redcal_degen(gains, ants, antpos, wgts=None, abs_amp=True,
                         phs_slope=True):
    """Redcal degeneracies of gains (Npol, Npol, Nants, Nt, Nf): the
    overall amplitude log sqrt(mean |g|^2) (Npol, Npol, 1, Nt, Nf) and
    the E/N phase gradient [rad/m] (Npol, Npol, 2, Nt, Nf) over the
    antennas' positions, each weighted by wgts (Nants,) if given.

    As in the JAX package, with wgts None the amplitude is the mean of
    |g|^2 over antennas (the reference sums without normalising), which
    keeps remove_redcal_degen idempotent."""
    consts = _degen_consts(gains, gains.shape[2], ants, antpos, wgts,
                           phs_slope)
    return _compute_degen(gains, consts, abs_amp, phs_slope)


def redcal_degen_gains(abs_amp=None, phs_slope=None, ants=None,
                       antpos=None):
    """Complex gains of the degeneracy parameters: exp(abs_amp) times
    exp(i A phs_slope), A the antennas' E/N positions."""
    A = None
    if phs_slope is not None:
        A = torch.as_tensor(_antvecs(antpos, ants)[:, :2],
                            dtype=phs_slope.dtype, device=phs_slope.device)
    return _degen_gains(abs_amp, phs_slope, A)


def remove_redcal_degen(gains, ants, antpos, degen=None, wgts=None,
                        redvis=None, bls=None, abs_amp=True,
                        phs_slope=True):
    """Divide the redcal degeneracies out of gains, or replace them by
    the gains ``degen``. They are computed from the detached gains, so
    gradients pass through the division only. redvis (with its bls), if
    given, takes the degeneracies on.

    Returns (new_gains, new_vis, degen_gains)."""
    consts = _degen_consts(gains, gains.shape[2], ants, antpos, wgts,
                           phs_slope)
    new_gains, degen_gains = _remove_degen(gains, consts, abs_amp,
                                           phs_slope, degen=degen)
    new_vis = None
    if redvis is not None:
        new_vis = apply_cal(redvis, bls, degen_gains, ants, undo=False)[0]
    return new_gains, new_vis, degen_gains


def _bl_vecs(bls, antpos):
    a1, a2 = zip(*bls)
    return _antvecs(antpos, list(a1)) - _antvecs(antpos, list(a2))


def compute_redcal_degen_vis(vd, wgts=None, abs_amp=True, phs_slope=True,
                             bls=None, antpos=None):
    """Redcal degeneracies of visibilities (a VisData, or a tensor with
    its bls and antpos): the baseline-averaged log amplitude (Npol,
    Npol, 1, Nt, Nf) and the E/N phase gradient [rad/m] (Npol, Npol, 2,
    Nt, Nf), each weighted by wgts (Nbls,) if given."""
    data = vd.data if isinstance(vd, VisData) else vd
    if isinstance(vd, VisData):
        bls, antpos = vd.bls, vd.antpos
    rdt, dev = data.real.dtype, data.device
    if wgts is None:
        w, wsum = 1.0, data.shape[2]
    else:
        wgts = torch.as_tensor(wgts, dtype=rdt, device=dev)
        w, wsum = wgts[:, None, None], torch.sum(wgts)
    abs_amp_param = phs_slope_param = None
    if abs_amp:
        aa = torch.sum(torch.abs(data) * w, dim=2, keepdim=True) / wsum
        abs_amp_param = torch.log(aa)
    if phs_slope:
        proj = _slope_proj(_bl_vecs(bls, antpos)[:, :2],
                           None if wgts is None
                           else wgts.detach().cpu().numpy().astype(
                               np.float64))
        phs_slope_param = torch.einsum("ab,ijblm->ijalm",
                                       proj.to(dtype=rdt, device=dev),
                                       torch.angle(data))
    return abs_amp_param, phs_slope_param


def redcal_degen_vis(abs_amp=None, phs_slope=None, vd=None, bls=None,
                     antpos=None):
    """Visibilities that carry only the redcal degenerate modes,
    exp(abs_amp) exp(i b . phs_slope) per baseline vector b; a VisData
    shaped like vd when vd is given, else a tensor."""
    if vd is not None:
        bls, antpos = vd.bls, vd.antpos
    ref = abs_amp if abs_amp is not None else phs_slope
    amp = 1.0 if abs_amp is None else torch.exp(abs_amp)
    phs = torch.zeros((), dtype=ref.real.dtype, device=ref.device)
    if phs_slope is not None:
        A = torch.as_tensor(_bl_vecs(bls, antpos)[:, :2],
                            dtype=phs_slope.dtype, device=phs_slope.device)
        phs = torch.einsum("ba,ijalm->ijblm", A, phs_slope)
    data = amp * torch.exp(1j * phs)
    if vd is None:
        return data
    out = VisData()
    out.setup_meta(telescope=vd.telescope, antpos=vd.antpos)
    out.setup_data(vd.bls, vd.times, vd.freqs, pol=vd.pol,
                   data=torch.broadcast_to(data, vd.data.shape),
                   history="redcal degenerate visibilities")
    return out


def _tf_shape(vis, time_mode, freq_mode, time_LM, freq_LM):
    """The params' (time, freq) sizes: the data's times and channels, or
    the 'linear' modes' coefficients (the columns of their LM's A)."""
    return (len(vis.times) if time_mode == "channel"
            else time_LM.A.shape[-1],
            len(vis.freqs) if freq_mode == "channel"
            else freq_LM.A.shape[-1])


def vis2JonesModel(vis, param_type="com", freq_mode="channel",
                   time_mode="channel", freqs=None, freq_LM=None,
                   time_LM=None, refant=None, single_ant=False, device=None,
                   dtype=None):
    """JonesModel sized from a VisData: one gain per antenna of its
    baselines (or one for all with single_ant), time and channel (or
    coefficient of the 'linear' modes' LinearModels); unity ('com', as
    real pairs) or zero starting params."""
    R = JonesResponse(param_type=param_type, antpos=vis.antpos,
                      freq_mode=freq_mode, freq_LM=freq_LM, freqs=freqs,
                      time_mode=time_mode, time_LM=time_LM)
    ants = sorted(set(flatten([list(b) for b in vis.bls])))
    polmode = "1pol" if vis.Npol == 1 else "4pol"
    nants = len(ants)
    if "slope" in param_type:
        nants = 2
    elif single_ant:
        nants = 1
    shape = (vis.Npol, vis.Npol, nants) + _tf_shape(vis, time_mode, freq_mode,
                                                    time_LM, freq_LM)
    params = np.zeros(shape + ((2,) if param_type == "com" else ()))
    if param_type == "com":
        params[..., 0] = 1.0
    return JonesModel(params, ants=ants, R=R, refant=refant, polmode=polmode,
                      single_ant=single_ant, device=device, dtype=dtype)


def vis2RedVisModel(vis, param_type="com", freq_mode="channel",
                    time_mode="channel", freqs=None, freq_LM=None,
                    time_LM=None, redtol=1.0, device=None, dtype=None):
    """RedVisModel sized from a VisData: one value per redundant group
    of its baselines (groups within redtol [m]), time and channel (or
    coefficient of the 'linear' modes' LinearModels), starting at
    zero."""
    from .telescope import build_reds
    reds, _, bl2red = build_reds(vis.antpos, bls=vis.bls, redtol=redtol)[:3]
    R = VisModelResponse(param_type=param_type, freq_mode=freq_mode,
                         freqs=freqs, freq_LM=freq_LM, time_mode=time_mode,
                         time_LM=time_LM)
    shape = (vis.Npol, vis.Npol, len(reds)) + _tf_shape(
        vis, time_mode, freq_mode, time_LM, freq_LM)
    params = np.zeros(shape + ((2,) if param_type == "com" else ()))
    return RedVisModel(params, bl2red, R=R, device=device, dtype=dtype)


def chisq(raw_data, forward_model, wgts, axis=None, dof=None,
          cov_axis=None, mode="vis"):
    """Chi-square of raw_data against forward_model under the inverse
    covariance wgts (any structure of inference.prob.apply_icov):
    elementwise unless summed over axis, divided by dof if given."""
    from ..inference.prob import apply_icov
    out = apply_icov(raw_data - forward_model, wgts, cov_axis,
                     mode=mode).real
    if dof is not None:
        out = out / dof
    if axis is not None:
        out = torch.sum(out, dim=axis)
    return out
