"""
Sky models: point-source and pixelized skies with a frequency response,
several components, and the Stokes -> coherency conversion.

Counterpart of bayeslim_tpu/models/sky.py (DefaultResponse :33, SkyBase
:49, PointSky :108, PointSkyResponse :115, PixelSky :158,
PixelSkyResponse :178, CompositeModel :275, stokes2coherency :328,
Stokes2Coherency :363). Conventions kept: sky data (Nstokes, 1, Nfreqs,
Npix) or a (2, 2, Nfreqs, Npix) coherency; angs (2, Npix) equatorial
[RA, Dec] in degrees; PixelSky multiplies by the pixel solid angle so
the output is flux density. PixelSkyResponse carries the 'pixel'
spatial mode and the 'channel' and 'powerlaw' frequency modes.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..data.containers import MapData
from ..utils.dtypes import _float, resolve_device
from ..utils.module import Module

__all__ = ["SkyBase", "DefaultResponse", "PointSky", "PointSkyResponse",
           "PixelSky", "PixelSkyResponse", "CompositeModel",
           "Stokes2Coherency", "CoherencySky", "stokes2coherency"]


class DefaultResponse(Module):
    """Identity response."""

    def __init__(self, freqs=None):
        super().__init__()
        self.freqs = None if freqs is None else np.asarray(freqs)
        self.freq_mode = "channel"

    def forward(self, params):
        return params


class PointSkyResponse(Module):
    """Frequency response of a PointSky; params (Nstokes, 1, Ncoeff,
    Nsources).

    freq_mode 'channel': params pass through (Ncoeff = Nfreqs);
    'linear': freq_LM(params), any callable on tensors (LinearModel is
    not ported yet); 'powerlaw': params hold amplitude and spectral
    index, out = amp (f / f0) ** spix. log: the amplitude (powerlaw) or
    the output (channel, linear) is exp of the params. LM: an optional
    callable applied to the params first.
    """

    def __init__(self, freqs, freq_mode="channel", log=False, LM=None,
                 freq_LM=None, f0=None, device=None, dtype=None):
        super().__init__()
        if freq_mode not in ("channel", "linear", "powerlaw"):
            raise ValueError(f"unknown freq_mode {freq_mode}")
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.freq_mode = freq_mode
        self.log = log
        self.LM = LM
        self.freq_LM = freq_LM
        self.f0 = f0
        self.register_buffer("_freqs_arr", torch.as_tensor(
            self.freqs, dtype=dtype or _float(),
            device=resolve_device(device)))

    def forward(self, params):
        if self.LM is not None:
            params = self.LM(params)
        if self.freq_mode == "linear":
            params = self.freq_LM(params)
        elif self.freq_mode == "powerlaw":
            amp = params[..., 0:1, :]
            if self.log:
                amp = torch.exp(amp)
            return amp * (self._freqs_arr[:, None] / self.f0) \
                ** params[..., 1:2, :]
        return torch.exp(params) if self.log else params


class PixelSkyResponse(Module):
    """Frequency response of a PixelSky.

    freq_mode 'channel': params (Nstokes, 1, Nfreqs, Npix) pass through;
    'powerlaw': params (Nstokes, 1, 2, Npix) hold amplitude and spectral
    index, out = amp (f / f0) ** spix.
    """

    def __init__(self, freqs, spatial_mode="pixel", freq_mode="channel",
                 f0=None, device=None, dtype=None):
        super().__init__()
        if spatial_mode != "pixel":
            raise NotImplementedError(
                f"spatial_mode {spatial_mode!r} is not ported yet (alm: "
                f"ROADMAP queue A7; linear: A8)")
        if freq_mode not in ("channel", "powerlaw"):
            raise NotImplementedError(
                f"freq_mode {freq_mode!r} is not ported yet (linear: "
                f"ROADMAP queue A8; bessel: A7)")
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.Nfreqs = len(self.freqs)
        self.spatial_mode = spatial_mode
        self.freq_mode = freq_mode
        self.f0 = f0
        self.register_buffer("_freqs_arr", torch.as_tensor(
            self.freqs, dtype=dtype or _float(),
            device=resolve_device(device)))

    def forward(self, params):
        if self.freq_mode == "powerlaw":
            return params[..., 0:1, :] * \
                (self._freqs_arr[:, None] / self.f0) ** params[..., 1:2, :]
        return params


class SkyBase(Module):
    """Base sky block: output R(params + p0) with params trainable unless
    parameter=False, at angles angs (2, Nsources) [deg]."""

    def __init__(self, params, angs, R=None, name=None, parameter=True,
                 p0=None, device=None, dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        dt = dtype or _float()
        self.register_buffer("params", torch.as_tensor(params, dtype=dt,
                                                       device=dev))
        self.p0 = None if p0 is None else torch.as_tensor(p0, dtype=dt,
                                                          device=dev)
        self.R = R if R is not None else DefaultResponse()
        self.angs_np = np.asarray(angs, dtype=np.float64)
        if parameter:
            self.set_param("params")

    def _response(self):
        p = self.params if self.p0 is None else self.params + self.p0
        return self.R(p)

    def forward(self, prior_cache=None, **kwargs):
        sky = self._response()
        self.eval_prior(prior_cache, inp_params=self.params, out_params=sky)
        md = MapData()
        md.setup_meta(name=self.name)
        md.setup_data(freqs=self.R.freqs, data=sky, angs=self.angs_np)
        return md


class PointSky(SkyBase):
    """Point sources at fixed positions with variable flux: params
    (Nstokes, 1, Ncoeff, Nsources) through a PointSkyResponse."""


class PixelSky(SkyBase):
    """Pixelized sky brightness times the pixel solid angle px_area."""

    def __init__(self, params, angs, px_area, R, name=None, parameter=True,
                 p0=None, device=None, dtype=None):
        super().__init__(params, angs, R, name=name, parameter=parameter,
                         p0=p0, device=device, dtype=dtype)
        self.px_area = float(px_area)

    def forward(self, prior_cache=None, **kwargs):
        sky = self._response()
        self.eval_prior(prior_cache, inp_params=self.params, out_params=sky)
        md = MapData()
        md.setup_meta(name=self.name)
        md.setup_data(freqs=self.R.freqs, data=sky * self.px_area,
                      angs=self.angs_np, px_area=self.px_area)
        return md


class CompositeModel(Module):
    """Several sky components, summed or returned as a list.

    Without sum_output forward returns the components' MapData as a list
    (the RIME integrates each on its own grid). With sum_output they are
    summed into the first; index {model_key: (pred_index, this_index)}
    sums components of different grids: this_index gathers this
    component's pixels onto the accumulator's grid, pred_index selects
    the accumulator's pixels that receive it (repeated indices add).
    Either may be None.
    """

    def __init__(self, models, sum_output=False, index=None, name=None):
        super().__init__(name=name)
        self.models = nn.ModuleDict(
            dict(models) if isinstance(models, dict)
            else {m.name: m for m in models})
        self.sum_output = sum_output
        self.index = None
        if index is not None:
            self.index = {k: (None if pi is None else np.asarray(pi),
                              None if ti is None else np.asarray(ti))
                          for k, (pi, ti) in index.items()}
        self.eval_models = None

    def set_eval_models(self, models=None):
        """Restrict which components forward evaluates (None: all)."""
        self.eval_models = None if models is None else (
            [models] if isinstance(models, str) else list(models))

    def forward(self, **kwargs):
        keys = self.eval_models or list(self.models)
        outs = {k: self.models[k](**kwargs) for k in keys}
        if not self.sum_output:
            return list(outs.values())
        md = outs[keys[0]]
        data = md.data
        for k in keys[1:]:
            d = outs[k].data
            pi, ti = (None, None) if self.index is None \
                else self.index.get(k, (None, None))
            if ti is not None:
                d = d.index_select(-1, torch.as_tensor(ti, device=d.device))
            if pi is not None:
                data = data.index_add(data.ndim - 1, torch.as_tensor(
                    pi, device=data.device), d)
            else:
                data = data + d
        md.data = data
        return md


def stokes2coherency(S):
    """Stokes sky (Nstokes <= 4, 1, ...) or (2, 2, ...) -> the 2x2
    coherency in the linear feed basis, with the JAX package's
    conventions: the entries after I are fractional ([I, f_Q, f_U, f_V],
    Q = I f_Q etc.; a (2, 2, ...) input reads [[I, f_Q], [f_U, f_V]]),
    and

        B = [[I + Q, U - iV], [U + iV, I - Q]]

    with no 1/2 (the normalisation lives in the sky amplitude). A
    Stokes-I-only input is returned as it is."""
    if S.shape[:2] == (2, 2):
        I, fQ, fU, fV = S[0, 0], S[0, 1], S[1, 0], S[1, 1]
    else:
        ns = S.shape[0]
        if ns == 1:
            return S
        I, fQ = S[0, 0], S[1, 0]
        zero = torch.zeros_like(I)
        fU = S[2, 0] if ns > 2 else zero
        fV = S[3, 0] if ns > 3 else zero
    Q, U, V = I * fQ, I * fU, I * fV
    row0 = torch.stack([torch.complex(I + Q, torch.zeros_like(I)),
                        torch.complex(U, -V)])
    row1 = torch.stack([torch.complex(U, V),
                        torch.complex(I - Q, torch.zeros_like(I))])
    return torch.stack([row0, row1])


class Stokes2Coherency(Module):
    """Block converting a Stokes sky MapData (or a list of them) to
    coherency form."""

    def forward(self, sky_comp, **kwargs):
        if isinstance(sky_comp, list):
            return [self(s) for s in sky_comp]
        md = sky_comp.copy()
        md.data = stokes2coherency(sky_comp.data)
        return md


class CoherencySky(Module):
    """Trainable Stokes-parameter sky emitted as a 2x2 coherency: params
    (4, 1, Nfreqs, Npix) [I, f_Q, f_U, f_V] per pixel and channel, output
    stokes2coherency(params) on the angles angs (2, Npix) [deg] (the sky
    of __graft_entry__._build_production, no pixel-area factor)."""

    def __init__(self, params, angs, freqs, name=None, parameter=True,
                 device=None, dtype=None):
        super().__init__(name=name)
        self.register_buffer("params", torch.as_tensor(
            params, dtype=dtype or _float(), device=resolve_device(device)))
        self.angs_np = np.asarray(angs, dtype=np.float64)
        self.freqs = np.asarray(freqs, dtype=np.float64)
        if parameter:
            self.set_param("params")

    def forward(self, **kwargs):
        md = MapData()
        md.setup_meta(name=self.name)
        md.setup_data(self.freqs, data=stokes2coherency(self.params),
                      angs=self.angs_np)
        return md
