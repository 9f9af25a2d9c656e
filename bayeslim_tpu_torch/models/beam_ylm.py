"""
Spherical-harmonic beam response (YlmResponse) and AlmBeam.

Counterpart of bayeslim_tpu/models/beam_ylm.py (YlmResponse :25, AlmBeam
:217). The response maps beam a_lm to a pixelized beam: the a_lm (after
beam0, the polynomial expansion over l and a frequency model) go through
AlmModel.forward_alm onto a fixed grid and are interpolated onto the
requested angles ('interpolate', what the RIME runs: its interpolation
ctx is precomputed on the host), or are evaluated at the requested
angles themselves from a Ylm of those angles ('generate': the ctx, or
the attached Ylm). In interpolate mode the grid's Ylm is built in the
constructor, on device (default CUDA) in dtype (default float32).
freq_mode 'linear' maps the a_lm's frequency coefficients to channels by
freq_LM (a LinearModel).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.sph_harm import AlmModel, gen_sph2pix
from ..utils.dtypes import D2R, resolve_device, viewcomp
from ..utils.interp import PixInterp
from ..utils.module import Module
from .beam import beam_edge_taper

__all__ = ["YlmResponse", "AlmBeam"]


class YlmResponse(Module):
    """a_lm -> beam response of a PixelBeam.

    params (Npol, Nvec, Nmodel, Nfreqs, Ncoeff), complex or real pairs
    (comp_params). mode 'interpolate': the beam is made on the native
    grid (pixtype 'healpix' at nside, or 'rect' on theta_grid / phi_grid
    [deg], separable by default) and interpolated onto the requested
    angles with interp_mode; the ctx (inds, wgts) is precomputed
    (precompute, which the RIME calls) or computed from the angles.
    mode 'generate': the beam is evaluated at the requested angles from
    the ctx (Ylm, alm_mult) or from the Ylm attached by setup_Ylm.
    Ylm_kwargs go to gen_sph2pix. powerbeam takes the modulus, realbeam
    the real part, log exponentiates; beam0 is added to the a_lm;
    norm_pix divides the grid beam by its value at that pixel;
    taper_kwargs multiply the output by beam_edge_taper.
    """

    def __init__(self, l, m, freqs, mode="interpolate", pixtype="healpix",
                 nside=None, theta_grid=None, phi_grid=None,
                 interp_mode="linear", freq_mode="channel", freq_LM=None,
                 comp_params=False, powerbeam=True, realbeam=True, log=False,
                 beam0=None, norm_pix=None, taper_kwargs=None, Ylm_kwargs=None,
                 name=None, device=None, dtype=None):
        super().__init__(name=name)
        self.alm = AlmModel(l, m, real_output=realbeam, device=device,
                            dtype=dtype)
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.mode = mode
        self.pixtype = pixtype
        self.freq_mode = freq_mode
        self.freq_LM = freq_LM
        self.comp_params = comp_params
        self.powerbeam = powerbeam
        self.realbeam = realbeam
        self.log = log
        self.beam0 = None if beam0 is None else torch.as_tensor(
            beam0, device=resolve_device(device))
        self.norm_pix = norm_pix
        self.taper_kwargs = taper_kwargs
        self._lm_poly = False
        Ylm_kwargs = dict(Ylm_kwargs or {})

        if mode == "interpolate":
            if pixtype == "healpix":
                from ..utils import healpix as hp
                assert nside is not None
                theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
                self.interp = PixInterp("healpix", nside=nside,
                                        interp_mode=interp_mode)
                self.alm.generate_Ylm(theta, phi, **Ylm_kwargs)
            else:
                assert theta_grid is not None and phi_grid is not None
                th = np.asarray(theta_grid) * D2R
                ph = np.asarray(phi_grid) * D2R
                self.interp = PixInterp("rect", interp_mode=interp_mode,
                                        theta_grid=theta_grid,
                                        phi_grid=phi_grid)
                if Ylm_kwargs.pop("separable", True):
                    self.alm.generate_Ylm(th, ph, separable=True,
                                          **Ylm_kwargs)
                else:
                    self.alm.generate_Ylm(*AlmModel.setup_angs(th, ph, True),
                                          **Ylm_kwargs)

    def setup_Ylm(self, Ylm, alm_mult=None):
        """Attach a precomputed Ylm (generate mode, or another grid)."""
        self.alm.setup_Ylm(Ylm, alm_mult=alm_mult)

    def precompute(self, zen, az):
        """Host interpolation ctx (inds, wgts) for angles [deg]
        (interpolate mode only)."""
        assert self.mode == "interpolate"
        return self.interp.precompute(np.asarray(zen), np.asarray(az))

    def _freq_transform(self, params):
        if self.comp_params and not params.is_complex():
            params = viewcomp(params)
        if self.beam0 is not None:
            b0 = self.beam0.to(params.device)
            cdt = torch.complex128 if params.real.dtype == torch.float64 \
                else torch.complex64
            params = params + b0.to(cdt if params.is_complex()
                                    or b0.is_complex() else params.dtype)
        if self.freq_mode == "linear":
            params = self.freq_LM(params)
        if self._lm_poly:
            params = self.lm_poly_forward(params)
        return params

    # --- the per-m polynomial compression over l ------------------------
    def lm_poly_setup(self, lm_poly_kwargs=None):
        """Compress the l axis per integer m with polynomial bases: the
        params' last axis then holds the weights of each m group in
        increasing m (gen_poly_A of the group's l with lm_poly_kwargs,
        or lm_poly_kwargs[m] where given; Ndeg None keeps the group's
        a_lm as they are), and lm_poly_forward expands them to Ncoeff."""
        from .linear_model import gen_poly_A
        self._lm_poly_kwargs = lm_poly_kwargs or {}
        self._lm_poly = bool(lm_poly_kwargs)
        if not self._lm_poly:
            return
        l, m = np.asarray(self.alm.l), np.asarray(self.alm.m)
        munique = np.unique(m)
        assert np.allclose(munique % 1, 0), "lm_poly needs integer m"
        self.lm_poly_A = {}
        i = 0
        for mm in munique:
            lm_inds = np.where(m == mm)[0]
            kw = dict(lm_poly_kwargs.get(mm, lm_poly_kwargs)
                      if mm in lm_poly_kwargs else lm_poly_kwargs)
            Ndeg = kw.pop("Ndeg")
            if Ndeg is None:
                Ndeg = len(lm_inds)
                A = None
            else:
                # float64, cast to the params' dtype where it is used
                A = gen_poly_A(l[lm_inds], Ndeg, device=self.alm.device,
                               dtype=torch.float64, **kw)
            p_inds = i + np.arange(Ndeg)
            i += Ndeg
            self.lm_poly_A[float(mm)] = (lm_inds, p_inds, A)
        self._lm_poly_ncoeff_in = i

    def lm_poly_fit(self, params, fit_kwargs=None):
        """Least-squares fit of the per-m polynomial weights to a full
        a_lm tensor (..., Ncoeff) -> (..., Nweights), the inverse of
        lm_poly_forward (ops/linalg.least_squares, fit_kwargs or
        fit_kwargs[m] passed on)."""
        from ..ops.linalg import least_squares as _lsq
        assert self._lm_poly
        fit_kwargs = fit_kwargs or {}
        out = []
        # the groups' weights are consecutive, in the groups' order
        for mm, (lm_inds, p_inds, A) in self.lm_poly_A.items():
            kw = fit_kwargs.get(mm, fit_kwargs) \
                if mm in fit_kwargs else fit_kwargs
            x = params[..., torch.as_tensor(lm_inds, device=params.device)]
            if A is not None:
                x, _ = _lsq(A.to(device=params.device, dtype=params.dtype),
                            x, dim=-1, **kw)
            out.append(x)
        return torch.cat(out, dim=-1)

    def lm_poly_forward(self, params):
        """Expand the per-m polynomial weights (..., Nweights) to the
        a_lm (..., Ncoeff)."""
        blocks, cols = [], []
        for mm, (lm_inds, p_inds, A) in self.lm_poly_A.items():
            block = params[..., torch.as_tensor(p_inds, device=params.device)]
            if A is not None:
                block = torch.einsum("lc,...c->...l", A.to(
                    device=params.device, dtype=params.dtype), block)
            blocks.append(block)
            cols.append(lm_inds)
        order = torch.as_tensor(np.argsort(np.concatenate(cols)),
                                device=params.device)
        return torch.cat(blocks, dim=-1).index_select(-1, order)

    def grid_beam(self, params):
        """params -> beam maps on the native grid (Npol, Nvec, Nmodel,
        Nfreqs, Npix)."""
        beam = self.alm.forward_alm(self._freq_transform(params))
        if self.log:
            beam = torch.exp(beam)
        if self.realbeam and beam.is_complex():
            beam = beam.real
        if self.norm_pix is not None:
            beam = beam / beam[..., self.norm_pix:self.norm_pix + 1]
        return beam

    def forward(self, params, zen, az, freqs, ctx=None, **kwargs):
        if self.mode == "interpolate":
            beam = self.grid_beam(params)
            if ctx is None:
                ctx = self.precompute(_host(zen), _host(az))
            out = self.interp.interp(beam, inds=ctx[0], wgts=ctx[1])
        else:
            p = self._freq_transform(params)
            if ctx is not None:
                Ylm, alm_mult = ctx
                out = self.alm.forward_alm(p, Ylm=Ylm, alm_mult=alm_mult)
            else:
                out = self.alm.forward_alm(p)
            if self.log:
                out = torch.exp(out)
            if self.realbeam and out.is_complex():
                out = out.real
        if self.powerbeam:
            out = torch.abs(out)
        if self.taper_kwargs is not None:
            zt = torch.as_tensor(zen, device=out.device,
                                 dtype=out.real.dtype)
            out = out * beam_edge_taper(zt, **self.taper_kwargs)
        return out

    def gen_grid_Ylm(self, zen, az, **kwargs):
        """(Ylm, alm_mult) at angles zen, az [deg] (gen_sph2pix with
        kwargs, on this response's device and dtype): a generate-mode
        ctx."""
        kwargs.setdefault("device", self.alm.device)
        kwargs.setdefault("dtype", self.alm.dtype)
        Y, _, am = gen_sph2pix(np.asarray(zen) * D2R, np.asarray(az) * D2R,
                               self.alm.l, self.alm.m, **kwargs)
        return Y, am


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class AlmBeam(Module):
    """A beam parameterised in the harmonic domain: a YlmResponse in
    generate mode (kwargs passed on). Without a ctx or an attached Ylm,
    forward generates the Ylm at the host angles zen, az [deg]
    (gen_grid_Ylm with Ylm_kwargs)."""

    def __init__(self, l, m, freqs, **kwargs):
        super().__init__()
        self.R = YlmResponse(l, m, freqs, mode="generate", **kwargs)

    def forward(self, params, zen, az, freqs, ctx=None, Ylm_kwargs=None,
                **kwargs):
        if ctx is None and self.R.alm.Ylm is None:
            ctx = self.R.gen_grid_Ylm(_host(zen), _host(az),
                                      **(Ylm_kwargs or {}))
        return self.R(params, zen, az, freqs, ctx=ctx, **kwargs)
