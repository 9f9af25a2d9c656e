"""
Direction-independent antenna gains and their application to
visibilities.

Counterpart of bayeslim_tpu/models/calibration.py (params2complex
:120, BaseResponse :166, JonesResponse :234, JonesModel :270,
_apply_cal :527, apply_cal :571, rephase_to_refant :584). This slice
carries the channel freq/time modes only; the per-baseline visibility
models (VisModel, RedVisModel), the redcal degeneracy projections,
priors and CalData export are not ported yet (ROADMAP queue A).

Baseline -> antenna gather indices are built on the host once per
distinct baseline set and kept as device tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.dtypes import _float, resolve_device, viewcomp, viewreal
from ..utils.indexing import blnum2ants
from ..utils.module import Module

__all__ = ["params2complex", "complex2params", "BaseResponse",
           "JonesResponse", "JonesModel", "apply_cal", "_apply_cal",
           "rephase_to_refant"]


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
    """Maps a params tensor to complex (..., Ntimes, Nfreqs) values:
    param_type conversion, an optional fixed offset base0, then the
    reference-antenna projection. Only the 'channel' freq/time modes are
    carried; 'linear' needs LinearModel, which is not ported yet."""

    def __init__(self, freq_mode="channel", time_mode="channel",
                 param_type="com", freqs=None, times=None, base0=None,
                 antpos=None, name=None, **proj_kwargs):
        super().__init__(name=name)
        for mode in (freq_mode, time_mode):
            if mode != "channel":
                raise NotImplementedError(
                    f"{mode!r} freq/time mode needs LinearModel, which is "
                    f"not ported yet")
        self.freq_mode = freq_mode
        self.time_mode = time_mode
        self.param_type = param_type
        self.freqs = None if freqs is None else np.asarray(freqs)
        self.times = None if times is None else np.asarray(times)
        self.base0 = base0
        self.antpos = antpos
        self.setup_projection(**proj_kwargs)

    def setup_projection(self, abs_amp_gain=False, phs_slope_gain=False,
                         wgts_gain=None, refant_idx=None):
        """Post-response projection: the reference antenna's phase (the
        redcal-degeneracy projections are not ported yet)."""
        if abs_amp_gain or phs_slope_gain:
            raise NotImplementedError(
                "redcal degeneracy projections are not ported yet")
        self._proj_refant_idx = refant_idx

    def projection(self, params):
        i = self._proj_refant_idx
        if i is None:
            return params
        phs = torch.angle(params[:, :, i:i + 1].detach())
        return params * torch.exp(-1j * phs)

    def forward(self, params, **kwargs):
        if self.param_type == "com":
            params = viewcomp(params)
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
        A = _like(self.antpos.antvecs[:, :2], params)
        slope = torch.einsum("ab,ijblm->ijalm", A, params)
        if self.slope_type == "dly_slope":
            return torch.exp(2j * np.pi * _like(self.freqs, params) * slope
                             * 1e-9)
        return torch.exp(1j * slope)


class JonesModel(Module):
    """Antenna-based direction-independent gains, V_d = J_p V_m J_q^H.

    params (Npol, Npol, Nants, Ntimes, Nfreqs) complex, or real pairs
    with a trailing dim of 2 for param_type 'com'; trainable unless
    parameter=False. refant's phase is projected out of the gains.
    """

    def __init__(self, params, ants, p0=None, refant=None, R=None,
                 parameter=True, polmode="1pol", single_ant=False,
                 name=None, vis_type="com", atol=1e-5, device=None,
                 dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        rdt = dtype or _float()
        cplx = params.is_complex() if isinstance(params, torch.Tensor) \
            else np.iscomplexobj(params)
        pdt = _complex_of(rdt) if cplx else rdt
        self.register_buffer("params", torch.as_tensor(params, dtype=pdt,
                                                       device=dev))
        self.p0 = None if p0 is None else torch.as_tensor(p0, dtype=pdt,
                                                          device=dev)
        self.ants = [int(a) for a in ants]
        self.Nants = len(self.ants)
        if parameter:
            self.set_param("params")
        self.R = R if R is not None else JonesResponse()
        self.polmode = polmode
        self.single_ant = single_ant
        self.vis_type = vis_type
        self.atol = atol
        self._g1_idx = None
        self._g2_idx = None
        self._bl_cache = {}
        self._time_cache = {}
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

    def _bl_idx(self, blnums):
        """Device gather indices for a VisData's blnums, built once per
        distinct baseline set."""
        blnums = np.asarray(blnums)
        key = blnums.tobytes()
        if key not in self._bl_cache:
            dev = self.params.device
            self._bl_cache[key] = tuple(torch.as_tensor(g, device=dev)
                                        for g in self.ant_index(blnums))
        return self._bl_cache[key]

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

    def get_time_idx(self, times):
        """Indices of times in R.times (isclose within atol, else the
        nearest)."""
        t = np.atleast_1d(np.asarray(times))
        key = t.tobytes()
        if key not in self._time_cache:
            rt = np.asarray(self.R.times)
            idx = []
            for tt in t:
                w = np.where(np.isclose(rt, tt, atol=self.atol,
                                        rtol=1e-15))[0]
                idx.append(int(w[0]) if len(w)
                           else int(np.argmin(np.abs(rt - tt))))
            self._time_cache[key] = np.asarray(idx)
        return self._time_cache[key]

    def index_params(self, jones, times=None, bls=None):
        """Select the gain time axis onto the data's times (gains are
        antenna-indexed: baselines are selected in apply_cal)."""
        if times is None or self.R.times is None or \
                jones.shape[-2] == len(np.atleast_1d(times)):
            return jones
        if jones.shape[-2] == 1:
            return jones
        idx = torch.as_tensor(self.get_time_idx(times), device=jones.device)
        return jones.index_select(-2, idx)

    def forward(self, vd, undo=False, jones=None, **kwargs):
        """Apply the gains to a VisData; returns a new VisData."""
        if jones is None:
            jones = self.get_jones()
        jones = self.index_params(jones, times=getattr(vd, "times", None))
        if self._g1_idx is not None:
            g1_idx, g2_idx = self._g1_idx, self._g2_idx
        else:
            g1_idx, g2_idx = self._bl_idx(vd.blnums)
        vout = vd.copy()
        vout.data, _ = _apply_cal(vd.data, jones, g1_idx, g2_idx,
                                  cal_2pol=self.polmode == "2pol",
                                  vis_type=self.vis_type, undo=undo)
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
