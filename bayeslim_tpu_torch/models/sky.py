"""
Sky models: point-source and pixelized skies with a frequency response,
several components, and the Stokes -> coherency conversion.

Counterpart of bayeslim_tpu/models/sky.py (DefaultResponse :33, SkyBase
:49 with freq_interp :92, PointSky :108, PointSkyResponse :115,
PixelSky :158, PixelSkyResponse :178, CompositeModel :275,
stokes2coherency :328, Stokes2Coherency :363, read_catalogue :375,
write_catalogue :434, Jy2K :485, SphHarmSky :499, InterpSky :523,
ang_index :541, pixelsky_Ylm_cut :559, eqarea_grid :586,
index_sky_pixels :598). Frequency minibatching: every response's
set_freq_index selects channels of its output (the identity's is a
no-op), and SkyBase.freq_interp moves channel-mode params onto new
channels.
Conventions kept: sky data (Nstokes, 1, Nfreqs, Npix) or a (2, 2,
Nfreqs, Npix) coherency; angs (2, Npix) equatorial [RA, Dec] in
degrees; PixelSky multiplies by the pixel solid angle so the output is
flux density. PixelSkyResponse carries the 'pixel', 'linear' and 'alm'
spatial modes and the 'channel', 'linear', 'powerlaw' and 'bessel'
frequency modes.

The 'bessel' mode computes what SFBModel computes (it holds one and
calls it): each (l, m) column of the t_lmn gets its own l's radial
matrix over that l's first Nk(l) rows. The JAX mode (sky.py:234-243)
picks one column an l by its rank among the unique l, so the m > 0
columns come out zero, and it raises when the Nk differ by l; neither
is copied (ROADMAP queue C item 5).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..data.containers import MapData
from ..utils.dtypes import _float, resolve_device, viewcomp
from ..utils.indexing import freq_interp as _interp_freqs
from ..utils.module import Module
from ..ops.sph_harm import SFBModel

__all__ = ["SkyBase", "DefaultResponse", "PointSky", "PointSkyResponse",
           "PixelSky", "PixelSkyResponse", "CompositeModel",
           "Stokes2Coherency", "CoherencySky", "stokes2coherency",
           "SphHarmSky", "pixelsky_Ylm_cut", "read_catalogue",
           "write_catalogue", "Jy2K", "InterpSky", "ang_index",
           "eqarea_grid", "index_sky_pixels"]


class DefaultResponse(Module):
    """Identity response."""

    def __init__(self, freqs=None):
        super().__init__()
        self.freqs = None if freqs is None else np.asarray(freqs)
        self.freq_mode = "channel"

    def set_freq_index(self, idx=None):
        """No-op for the identity response."""

    def forward(self, params):
        return params


def _select_freqs(resp, params):
    """The channels resp.set_freq_index chose, along axis -2 (all when
    none were chosen); the index goes to params' device once."""
    if resp._freq_idx is None:
        return params
    if resp._freq_idx_dev is None \
            or resp._freq_idx_dev.device != params.device:
        resp._freq_idx_dev = torch.as_tensor(resp._freq_idx,
                                             device=params.device)
    return params.index_select(params.ndim - 2, resp._freq_idx_dev)


class PointSkyResponse(Module):
    """Frequency response of a PointSky; params (Nstokes, 1, Ncoeff,
    Nsources).

    freq_mode 'channel': params pass through (Ncoeff = Nfreqs); 'linear':
    freq_LM(params), a LinearModel (or any callable on tensors) of the
    coefficients; 'powerlaw': params hold amplitude and spectral index,
    out = amp (f / f0) ** spix. log: the amplitude (powerlaw) or the
    output (channel, linear) is exp of the params. LM: an optional
    callable applied to the params first. set_freq_index selects
    channels of the output.
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
        self.set_freq_index(None)

    def set_freq_index(self, idx=None):
        """Select these channels of the output (None: all)."""
        self._freq_idx = None if idx is None else np.asarray(idx)
        self._freq_idx_dev = None

    def forward(self, params):
        if self.LM is not None:
            params = self.LM(params)
        if self.freq_mode == "linear":
            params = self.freq_LM(params)
        if self.freq_mode == "powerlaw":
            amp = params[..., 0:1, :]
            if self.log:
                amp = torch.exp(amp)
            params = amp * (self._freqs_arr[:, None] / self.f0) \
                ** params[..., 1:2, :]
        elif self.log:
            params = torch.exp(params)
        return _select_freqs(self, params)


class PixelSkyResponse(Module):
    """Spatial and frequency response of a PixelSky.

    spatial_mode 'pixel': params are per pixel; 'linear' or 'alm': spat_LM
    (a LinearModel or an AlmModel, or any callable) maps the last axis
    to pixels. freq_mode 'channel': params per channel pass through;
    'linear': freq_LM (a LinearModel) maps coefficients to channels;
    'powerlaw': params (..., 2, N) hold amplitude and spectral index,
    out = amp (f / f0) ** spix; 'bessel': params (..., Nn, Ncoeff) are
    spherical Fourier-Bessel t_lmn, mapped to (..., Nfreqs, Ncoeff) by
    an SFBModel (self.sfb) of the radial matrices gln {l: (Nfreqs, Nk)}
    and their kbins (gen_bessel2freq), over the l and m of spat_LM; it
    needs transform_order 1. cosmo: the Cosmology kept with it (default
    Cosmology()). transform_order 0: spatial then frequency; 1:
    frequency then spatial. comp_params: real-pair params (trailing axis
    2) are read as complex. Then: real_output keeps the real part of a
    complex result, log exponentiates, sky0 is added, abs_output takes
    the modulus, and set_freq_index selects channels. LM: an optional
    callable applied to the params first.
    """

    def __init__(self, freqs, comp_params=False, spatial_mode="pixel",
                 freq_mode="channel", transform_order=0, cosmo=None,
                 spat_LM=None, freq_LM=None, f0=None, gln=None, kbins=None,
                 log=False, real_output=True, abs_output=False, LM=None,
                 sky0=None, device=None, dtype=None):
        super().__init__()
        if spatial_mode not in ("pixel", "linear", "alm"):
            raise ValueError(f"unknown spatial_mode {spatial_mode}")
        if freq_mode not in ("channel", "linear", "powerlaw", "bessel"):
            raise ValueError(f"unknown freq_mode {freq_mode}")
        dev = resolve_device(device)
        dt = dtype or _float()
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.Nfreqs = len(self.freqs)
        self.comp_params = comp_params
        self.spatial_mode = spatial_mode
        self.freq_mode = freq_mode
        self.transform_order = transform_order
        self.log = log
        self.real_output = real_output
        self.abs_output = abs_output
        self.LM = LM
        self.spat_LM = spat_LM
        self.freq_LM = freq_LM
        self.f0 = f0
        self.gln = gln
        self.kbins = kbins
        self.sfb = None
        if freq_mode == "bessel":
            if cosmo is None:
                from .cosmology import Cosmology
                cosmo = Cosmology()
            self.cosmo = cosmo
            if getattr(spat_LM, "l", None) is None:
                raise ValueError(
                    "freq_mode 'bessel' needs the l and m of each column: "
                    "a spat_LM with l and m (an AlmModel)")
            self.sfb = SFBModel(spat_LM.l, spat_LM.m, gln, kbins or {},
                                device=dev, dtype=dt)
        self.register_buffer("_freqs_arr", torch.as_tensor(
            self.freqs, dtype=dt, device=dev))
        self.register_buffer("sky0", None if sky0 is None else _as_tensor(
            sky0, dt, dev))
        self.set_freq_index(None)

    def spatial_transform(self, params):
        if self.comp_params and not params.is_complex():
            params = viewcomp(params)
        if self.spatial_mode == "pixel":
            return params
        return self.spat_LM(params)

    def freq_transform(self, params):
        if self.comp_params and not params.is_complex():
            params = viewcomp(params)
        if self.freq_mode == "linear":
            return self.freq_LM(params)
        if self.freq_mode == "powerlaw":
            return params[..., 0:1, :] * \
                (self._freqs_arr[:, None] / self.f0) ** params[..., 1:2, :]
        if self.freq_mode == "bessel":
            assert self.transform_order == 1, \
                "bessel freq mode requires transform_order=1"
            return self.sfb(params)
        return params

    def forward(self, params):
        if self.LM is not None:
            params = self.LM(params)
        if self.transform_order == 0:
            params = self.freq_transform(self.spatial_transform(params))
        else:
            params = self.spatial_transform(self.freq_transform(params))
        if self.real_output and params.is_complex():
            params = params.real
        if self.log:
            params = torch.exp(params)
        if self.sky0 is not None:
            params = params + self.sky0
        if self.abs_output:
            params = torch.abs(params)
        return _select_freqs(self, params)

    def set_freq_index(self, idx=None):
        """Select these channels of the output (None: all)."""
        self._freq_idx = None if idx is None else np.asarray(idx)
        self._freq_idx_dev = None


def _as_tensor(x, dtype, device):
    """x as a tensor of the real dtype, or its complex counterpart if x
    is complex."""
    t = torch.as_tensor(x, device=device)
    if t.is_complex():
        return t.to(torch.complex64 if dtype == torch.float32
                    else torch.complex128)
    return t.to(dtype)


class SkyBase(Module):
    """Base sky block: output R(params + p0) with params trainable unless
    parameter=False, at angles angs (2, Nsources) [deg]."""

    def __init__(self, params, angs, R=None, name=None, parameter=True,
                 p0=None, device=None, dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        dt = dtype or _float()
        self.register_buffer("params", _as_tensor(params, dt, dev))
        self.p0 = None if p0 is None else _as_tensor(p0, dt, dev)
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

    def freq_interp(self, freqs, kind="linear"):
        """Move the sky onto the channels freqs [Hz]: for a 'channel'
        response the params are interpolated along their frequency axis
        (2) by scipy's interp1d of this kind, extrapolating, on the host
        in float64, and written back on their device in their dtype (a
        trainable one stays the same nn.Parameter); R.freqs becomes
        freqs. Nothing happens when freqs already match R.freqs to 1 Hz.
        Other responses keep their params and, as in the JAX package,
        evaluate at their own channels."""
        freqs = np.asarray(freqs, dtype=np.float64)
        cur = np.asarray(self.R.freqs)
        if len(freqs) == len(cur) and np.allclose(cur, freqs, atol=1.0):
            return
        if self.R.freq_mode == "channel":
            new = _interp_freqs(self.params, cur.astype(np.float64), freqs,
                              kind, 2)
            if isinstance(self.params, nn.Parameter):
                with torch.no_grad():
                    self.params.data = new
            else:
                self.params = new
        self.R.freqs = freqs


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


def read_catalogue(catfile, freqs=None, device=None, parameter=False,
                   freq_interp="linear", dtype=None):
    """Read a YAML point-source catalogue in the columnar schema
    (``sources`` holds parallel lists ``name``, ``ra``, ``dec``, plus
    ``amp`` / ``alpha`` for 'powerlaw' or ``freq{i}`` rows for 'channel',
    with ``mode_kwargs: {f0: ...}``), as the JAX package reads it.

    Returns (params, angs, meta): params a tensor on device, (1, 1, 2,
    Nsource) [amp, alpha] for a power law (for a PointSkyResponse of
    freq_mode 'powerlaw' and f0 meta['f0']) or (1, 1, Nfreqs, Nsource)
    for channel fluxes, interpolated onto freqs when given (scipy
    interp1d of kind freq_interp, extrapolating); angs (2, Nsource)
    [RA, Dec deg] as host float64 numpy (the port keeps angles on the
    host). yaml is imported here.
    """
    import yaml
    with open(catfile) as f:
        cat = yaml.safe_load(f)
    sources = cat["sources"]
    mode = cat.get("freq_mode", "powerlaw")
    mode_kwargs = dict(cat.get("mode_kwargs") or {})
    ra = np.asarray(sources["ra"], dtype=np.float64)
    dec = np.asarray(sources["dec"], dtype=np.float64)
    names = (list(sources["name"]) if "name" in sources
             else [f"src{i}" for i in range(len(ra))])
    angs = np.stack([ra, dec])
    if mode == "powerlaw":
        f0 = mode_kwargs.get("f0", cat.get("f0", 150e6))
        f0 = float(f0) if f0 is not None else None
        amp = np.asarray(sources["amp"], dtype=np.float64)
        alpha = np.asarray(sources.get("alpha", sources.get("spix", 0.0)),
                           dtype=np.float64)
        alpha = np.broadcast_to(np.atleast_1d(alpha), amp.shape)
        params = np.stack([amp, alpha])[None, None]
        meta = dict(f0=f0, freq_mode="powerlaw", names=names)
    elif mode == "channel":
        cat_freqs = np.asarray(cat["freqs"], dtype=np.float64)
        S = np.asarray([sources[f"freq{i}"] for i in range(len(cat_freqs))],
                       dtype=np.float64)
        if freqs is not None:
            from scipy import interpolate
            S = interpolate.interp1d(cat_freqs, S, kind=freq_interp, axis=0,
                                     fill_value="extrapolate")(
                np.asarray(freqs))
            out_freqs = np.asarray(freqs, dtype=np.float64)
        else:
            out_freqs = cat_freqs
        params = S[None, None]
        meta = dict(freq_mode="channel", names=names, freqs=out_freqs,
                    f0=None)
    else:
        raise NotImplementedError(f"freq_mode {mode}")
    return (torch.as_tensor(params, dtype=dtype or _float(),
                            device=resolve_device(device)), angs, meta)


def write_catalogue(catfile, params, angs=None, names=None,
                    freq_mode="powerlaw", f0=150e6, freqs=None,
                    overwrite=False, sky=None):
    """Write a YAML point-source catalogue in the columnar schema that
    read_catalogue (either package's) reads. A PointSky may be given
    as params (the form write_catalogue(catfile, sky, names)) or as
    sky=: its params, angles and response mode are written. yaml is
    imported here."""
    import os

    import yaml
    if sky is None and hasattr(params, "angs_np") and \
            hasattr(params, "params"):
        sky = params
    if sky is not None:
        if names is None and angs is not None and not hasattr(angs, "ndim"):
            names = angs
        params, angs = sky.params, sky.angs_np
        R = getattr(sky, "R", None)
        if R is not None:
            freq_mode = getattr(R, "freq_mode", freq_mode)
            f0 = getattr(R, "f0", f0)
        if freq_mode == "channel":
            freqs = getattr(sky, "freqs", freqs)
    if os.path.exists(catfile) and not overwrite:
        raise FileExistsError(catfile)
    params = params.detach().cpu().numpy() \
        if isinstance(params, torch.Tensor) else np.asarray(params)
    angs = angs.detach().cpu().numpy() \
        if isinstance(angs, torch.Tensor) else np.asarray(angs)
    n = angs.shape[1]
    names = names if names is not None else [f"src{i}" for i in range(n)]
    sources = dict(name=list(names), ra=angs[0].tolist(),
                   dec=angs[1].tolist())
    d = dict(freq_mode=freq_mode, sources=sources)
    if freq_mode == "powerlaw":
        if params.shape[0] != 1:
            raise ValueError(
                "the columnar catalogue schema holds Stokes-I only; got "
                f"Nstokes={params.shape[0]}")
        sources["amp"] = params[0, 0, 0].tolist()
        sources["alpha"] = params[0, 0, 1].tolist()
        d["mode_kwargs"] = dict(f0=float(f0))
    elif freq_mode == "channel":
        if freqs is None:
            raise ValueError("a channel catalogue needs freqs")
        freqs = np.asarray(freqs, dtype=np.float64)
        for i in range(len(freqs)):
            sources[f"freq{i}"] = params[0, 0, i].tolist()
        d["freqs"] = freqs.tolist()
        d["mode_kwargs"] = dict(f0=None)
    else:
        raise NotImplementedError(f"freq_mode {freq_mode}")
    with open(catfile, "w") as f:
        yaml.safe_dump(d, f)


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


class SphHarmSky(PixelSky):
    """A PixelSky whose params are a_lm: its response is a
    PixelSkyResponse in the 'alm' spatial mode through alm_model (an
    AlmModel) and freq_mode, with resp_kwargs passed on."""

    def __init__(self, params, angs, px_area, alm_model, freqs,
                 freq_mode="channel", name=None, parameter=True, p0=None,
                 device=None, dtype=None, **resp_kwargs):
        R = PixelSkyResponse(freqs, spatial_mode="alm", freq_mode=freq_mode,
                             spat_LM=alm_model, device=device, dtype=dtype,
                             **resp_kwargs)
        super().__init__(params, angs, px_area, R, name=name,
                         parameter=parameter, p0=p0, device=device,
                         dtype=dtype)


def pixelsky_Ylm_cut(obj, lmin=None, lmax=None, mmin=None, mmax=None,
                     other=None):
    """Cut the a_lm modes of a sky with an 'alm' response, in place: the
    AlmModel's modes (AlmModel.select), the 'bessel' mode's SFBModel
    columns, and the params and p0 along the mode axis (-2 for real
    pairs, comp_params, else -1). Returns the kept indices."""
    spat = obj.R.spat_LM
    s = spat.select(lmin=lmin, lmax=lmax, mmin=mmin, mmax=mmax, other=other)
    if getattr(obj.R, "sfb", None) is not None:
        obj.R.sfb.setup_gln(spat.l, gln=obj.R.sfb.gln, m=spat.m)
    idx = np.where(s)[0]
    pair = bool(getattr(obj.R, "comp_params", False))

    def _cut(p):
        if p is None:
            return None
        axis = p.ndim - 2 if pair and not p.is_complex() else p.ndim - 1
        return p.index_select(axis, torch.as_tensor(idx, device=p.device))
    obj.p0 = _cut(obj.p0)
    new = _cut(obj.params.detach())
    if "params" in obj._parameters:
        obj.params = nn.Parameter(new)
    else:
        obj.params = new
    return idx


def Jy2K(freqs, steradians=None, px_area=None):
    """Jy -> K conversion factor at each frequency [Hz] for a pixel of
    solid angle steradians (px_area its other name): 1e-26 c^2 / (2 kB
    nu^2 Omega), host float64."""
    px_area = steradians if steradians is not None else px_area
    kb = 1.380649e-23
    c = 2.99792458e8
    freqs = np.asarray(freqs, dtype=np.float64)
    return 1e-26 * c ** 2 / (2 * kb * freqs ** 2 * px_area)


class InterpSky(Module):
    """A sky model whose output map goes through freq_interp (a callable
    on MapData, e.g. onto new channels) at forward time; the result's
    freqs become new_freqs."""

    def __init__(self, sky, freq_interp=None, new_freqs=None, name=None):
        super().__init__(name=name)
        self.sky = sky
        self.freq_interp = freq_interp
        self.new_freqs = None if new_freqs is None else np.asarray(new_freqs)

    def forward(self, *args, prior_cache=None, **kwargs):
        skymap = self.sky(prior_cache=prior_cache)
        if self.freq_interp is not None:
            skymap = self.freq_interp(skymap)
            skymap.freqs = self.new_freqs
        return skymap


def ang_index(theta, phi, theta_min=None, theta_max=None, phi_min=None,
              phi_max=None):
    """Indices of the angles within the cuts (a cut of 0 or None is not
    applied), host numpy."""
    theta = np.asarray(theta)
    phi = np.asarray(phi)
    idx = np.ones(len(theta), dtype=bool)
    if phi_min:
        idx &= phi >= phi_min
    if phi_max:
        idx &= phi <= phi_max
    if theta_min:
        idx &= theta >= theta_min
    if theta_max:
        idx &= theta <= theta_max
    return np.where(idx)[0]


def eqarea_grid(resol):
    """Equal-area (theta, phi) grid [rad] with a cell side of resol
    degrees at the equator: theta from equal steps in cos theta."""
    n = int(2 * np.pi / (resol * np.pi / 180))
    phi, dphi = np.linspace(0, 2 * np.pi, n, endpoint=False, retstep=True)
    t = np.arange(0, 1, dphi)
    t = np.concatenate([t[::-1], -t[1:]])
    theta = np.arccos(t)
    return theta, phi


def index_sky_pixels(angs_large, angs_small):
    """For each angle of angs_small (2, N) [deg], the index of the
    nearest angle of angs_large (2, M), host numpy."""
    large = np.asarray(angs_large, dtype=np.float64).T
    idx = []
    for ph, th in zip(*np.asarray(angs_small)):
        target = np.asarray([ph % 360 % 360, th])
        idx.append(int(np.argmin(np.linalg.norm(large - target, axis=1))))
    return np.asarray(idx)
