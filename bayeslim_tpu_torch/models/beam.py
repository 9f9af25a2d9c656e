"""
Primary-beam models evaluated on sky pixels.

Counterpart of bayeslim_tpu/models/beam.py (cut_sky_fov :43,
pointing_offset :53, beam_edge_taper :80, airy_disk :109, GaussResponse
:161, AiryResponse :187, UniformResponse :220, PixelResponse :237,
PixelBeam :306-496 with freq_interp :498, _expand_2pol :513, and the
host rotation helpers
R_eq_to_xyz, rotation, R_beta, R_XYZ_to_top and R_chi :525-583). Beam
tensors are (Npol, Nvec,
Nmodel, Nfreqs, Npix). Polarization modes:

- '1pol': a power beam (Npol = Nvec = 1) or a Jones beam (Npol = 1,
  Nvec = 2);
- '2pol': power beams (Npol = 2, Nvec = 1) on a Stokes-I sky;
- '4pol': a 2x2 Jones beam (Npol = Nvec = 2) on a 2x2 coherency sky.

The FOV cut is a host precompute: padded gather indices plus a mask
(``fov_cut``), applied on the device by ``cut_sky_fov``. A pixelized
response interpolates its grid at angles whose neighbours and weights
are precomputed on the host (``PixelResponse.precompute``, the ``ctx``
of ``gen_beam``). With several beam models (``ant2beam``) the beam is
applied per unique model pair (``modelpairs``), never per baseline.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.dtypes import D2R, C_MS, _float, resolve_device, viewcomp
from ..utils.indexing import freq_interp as _interp_freqs
from ..utils.interp import PixInterp
from ..utils.module import Module
from ..ops.special import j1_integral
from .bessel import j1

__all__ = ["PixelBeam", "GaussResponse", "AiryResponse", "UniformResponse",
           "PixelResponse", "airy_disk", "beam_edge_taper", "cut_sky_fov",
           "pointing_offset", "R_eq_to_xyz", "rotation", "R_beta",
           "R_XYZ_to_top", "R_chi"]


def cut_sky_fov(sky, cut):
    """Select sky pixels by a (padded) index tensor along the last axis."""
    if cut is None:
        return sky
    return sky.index_select(-1, cut)


def pointing_offset(zen, az, theta_x=0.0, theta_y=0.0):
    """Small-angle pointing offset: rotate the directions (zen, az)
    [rad] about x-hat by theta_x, then about y-hat by theta_y [rad], in
    the frame x = sin(zen) cos(az), y = sin(zen) sin(az), z = cos(zen).
    Any nonzero offset is applied. numpy in, numpy out; a tensor in, a
    tensor out. Returns (zen, az) [rad]."""
    xp = torch if isinstance(zen, torch.Tensor) else np
    sz, cz = xp.sin(zen), xp.cos(zen)
    sa, ca = xp.sin(az), xp.cos(az)
    x, y, z = sz * ca, sz * sa, cz
    y2 = y * np.cos(theta_x) - z * np.sin(theta_x)
    z2 = y * np.sin(theta_x) + z * np.cos(theta_x)
    x3 = x * np.cos(theta_y) + z2 * np.sin(theta_y)
    z3 = -x * np.sin(theta_y) + z2 * np.cos(theta_y)
    new_zen = xp.arccos(xp.clip(z3, -1, 1))
    new_az = xp.remainder(xp.arctan2(y2, x3), 2 * np.pi)
    return new_zen, new_az


def beam_edge_taper(zen, mode="gauss", fov=180.0, mu=85.0, sigma=2.5,
                    alpha=0.1, zen_start=None):
    """Taper toward the horizon at zen [deg] (a tensor). 'gauss': unity
    below mu, a Gaussian roll-off beyond (zen_start is an alias of mu);
    'tukey': a Tukey window over [-fov/2, fov/2] sampled at zen (5000
    points, linear interpolation, zero outside the fov)."""
    if zen_start is not None:
        mu = zen_start
    if mode == "gauss":
        return torch.where(zen >= mu,
                           torch.exp(-0.5 * ((zen - mu) / sigma) ** 2),
                           torch.ones_like(zen))
    if mode == "tukey":
        from scipy.signal import windows
        th = np.linspace(-fov / 2, fov / 2, 5000, endpoint=True)
        w = torch.as_tensor(windows.tukey(5000, alpha=alpha),
                            dtype=zen.dtype, device=zen.device)
        x = (zen - th[0]) / (th[1] - th[0])
        i = torch.clip(torch.floor(x).long(), 0, 4998)
        f = x - i
        t = w[i] * (1 - f) + w[i + 1] * f
        return torch.where((zen >= th[0]) & (zen <= th[-1]), t,
                           torch.zeros_like(t))
    raise ValueError(f"unknown taper mode {mode}")


def airy_disk(zen_rad, az_rad, Dew, freqs, Dns=None, freq_ratio=1.0,
              square=True, brute_force=False, Ntau=100):
    """Airy-disk beam b = [2 J1(x) / x]^2, x = 2 pi f (D/2) sin(zen) / c.

    zen_rad, az_rad : (Npix,) tensors [rad]; Dew (and optional Dns, for
    an elliptical aperture D(az) = Dns + sin^2(az) (Dew - Dns)) have the
    leading shape (Npol, Nvec, Nmodel); freqs : (Nfreqs,) tensor [Hz],
    scaled by freq_ratio. brute_force takes J1 from the trapezoid rule
    on its integral with Ntau points (ops/special.j1_integral) instead
    of the polynomial. Returns (Npol, Nvec, Nmodel, Nfreqs, Npix).
    """
    nb = zen_rad.ndim
    Dew = Dew.reshape(Dew.shape[:3] + (1,) * (nb + 1))
    if Dns is not None:
        Dns = Dns.reshape(Dns.shape[:3] + (1,) * (nb + 1))
        diameter = Dns + torch.sin(az_rad) ** 2 * (Dew - Dns)
    else:
        diameter = Dew
    # clip sin(zen) below the horizon so the beam doesn't wrap
    szen = torch.where(zen_rad > np.pi / 2, torch.ones_like(zen_rad),
                       torch.sin(zen_rad))
    fshape = (freqs * freq_ratio).reshape((-1,) + (1,) * nb)
    x = 2 * np.pi * fshape * (diameter / 2.0) / C_MS * szen
    small = x < 1e-8
    xs = torch.where(small, torch.ones_like(x), x)
    J1 = j1_integral(xs, Ntau=Ntau) if brute_force else j1(xs)
    b = torch.where(small, torch.ones_like(x), 2 * J1 / xs)
    return b ** 2 if square else torch.abs(b)


class GaussResponse(Module):
    """Gaussian beam in image-plane l, m. params (Npol, Nvec, Nmodel,
    Nfreqs, 2): sigma_EW, sigma_NS. The square root when not a power
    beam."""

    def __init__(self, powerbeam=True):
        super().__init__()
        self.freq_mode = "channel"
        self.powerbeam = powerbeam

    def forward(self, params, zen, az, freqs, ctx=None):
        zr, ar = zen * D2R, az * D2R
        srad = torch.where(zr > np.pi / 2, torch.ones_like(zr),
                           torch.sin(zr))
        l, m = srad * torch.sin(ar), srad * torch.cos(ar)
        beam = torch.exp(-0.5 * ((l / params[..., 0:1]) ** 2
                                 + (m / params[..., 1:2]) ** 2))
        return beam if self.powerbeam else torch.sqrt(beam)


class AiryResponse(Module):
    """Airy-disk beam response. params (Npol, Nvec, Nmodel, 1, 2): EW and
    NS aperture diameters [m] (or (..., 1, 1) for a circular one);
    freq_ratio scales the frequencies; brute_force and Ntau: J1 by the
    trapezoid rule (airy_disk); taper_kwargs: an optional
    beam_edge_taper."""

    def __init__(self, freq_ratio=1.0, powerbeam=True, taper_kwargs=None,
                 brute_force=False, Ntau=100):
        super().__init__()
        self.freq_ratio = freq_ratio
        self.freq_mode = "other"
        self.powerbeam = powerbeam
        self.taper_kwargs = taper_kwargs
        self.brute_force = brute_force
        self.Ntau = Ntau

    def forward(self, params, zen, az, freqs, ctx=None):
        Dew = params[..., 0, 0:1]
        Dns = params[..., 0, 1:2] if params.shape[-1] > 1 else None
        beam = airy_disk(zen * D2R, az * D2R, Dew, freqs, Dns,
                         freq_ratio=self.freq_ratio, square=self.powerbeam,
                         brute_force=self.brute_force, Ntau=self.Ntau)
        if self.taper_kwargs is not None:
            beam = beam * beam_edge_taper(zen, **self.taper_kwargs)
        return beam


class UniformResponse(Module):
    """Uniform (tophat) beam, with an optional beam_edge_taper."""

    def __init__(self, taper_kwargs=None):
        super().__init__()
        self.freq_mode = "other"
        self.taper_kwargs = taper_kwargs

    def forward(self, params, zen, az, freqs, ctx=None):
        shape = params.shape[:3] + (len(freqs),) + tuple(zen.shape)
        out = torch.ones(shape, dtype=zen.dtype, device=zen.device)
        if self.taper_kwargs is not None:
            out = out * beam_edge_taper(zen, **self.taper_kwargs)
        return out


class PixelResponse(Module):
    """Pixelized beam: params live on a fixed angular grid and are
    interpolated onto the requested angles.

    params (Npol, Nvec, Nmodel, Nfreqs, Npix_grid), real, complex, or
    real pairs (trailing dim 2) with comp_params. pixtype 'healpix'
    (nside) or 'rect' (theta_grid / phi_grid [deg]). The interpolation
    neighbours and weights come as ctx = (inds, wgts), precomputed on
    the host (``precompute``; RIME does it per time), or are computed
    here from the angles. freq_mode 'channel': params per channel;
    'linear': freq_LM (a LinearModel) maps the params' coefficients to
    channels after beam0.
    """

    def __init__(self, freqs, pixtype, nside=None, theta_grid=None,
                 phi_grid=None, interp_mode="linear", freq_mode="channel",
                 freq_LM=None, comp_params=False, log=False, powerbeam=True,
                 realbeam=True, beam0=None, norm_pix=None, taper_kwargs=None):
        super().__init__()
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.pixtype = pixtype
        self.interp = PixInterp(pixtype, nside=nside, interp_mode=interp_mode,
                                theta_grid=theta_grid, phi_grid=phi_grid)
        self.freq_mode = freq_mode
        self.freq_LM = freq_LM
        self.comp_params = comp_params
        self.log = log
        self.powerbeam = powerbeam
        self.realbeam = realbeam
        self.beam0 = None if beam0 is None else torch.as_tensor(beam0)
        self.norm_pix = norm_pix
        self.taper_kwargs = taper_kwargs

    def precompute(self, zen, az):
        """Host interpolation ctx (inds, wgts) for angles [deg]."""
        return self.interp.precompute(np.asarray(zen), np.asarray(az))

    def grid_beam(self, params):
        """params -> beam maps on the native grid."""
        if self.comp_params and not params.is_complex():
            params = viewcomp(params)
        if self.beam0 is not None:
            # in params' precision (a float64 offset must not promote a
            # float32 beam), complex if either is
            b0 = self.beam0.to(params.device)
            cdt = torch.complex128 if params.real.dtype == torch.float64 \
                else torch.complex64
            params = params + b0.to(cdt if params.is_complex()
                                    or b0.is_complex() else params.dtype)
        if self.freq_mode == "linear":
            params = self.freq_LM(params)
        if self.log:
            params = torch.exp(params)
        if self.realbeam and params.is_complex():
            params = params.real
        if self.norm_pix is not None:
            # normalise by the beam at a reference pixel (e.g. zenith)
            params = params / params[..., self.norm_pix:self.norm_pix + 1]
        return params

    def forward(self, params, zen, az, freqs, ctx=None):
        beam = self.grid_beam(params)
        if ctx is None:
            ctx = self.precompute(zen.detach().cpu().numpy(),
                                  az.detach().cpu().numpy())
        out = self.interp.interp(beam, inds=ctx[0], wgts=ctx[1])
        if self.powerbeam:
            out = torch.abs(out.real if out.is_complex() else out)
        if self.taper_kwargs is not None:
            out = out * beam_edge_taper(zen, **self.taper_kwargs)
        return out


class PixelBeam(Module):
    """Antenna primary beam block: R(params + p0) at given angles, and
    psky = A_p B A_q^H per baseline model pair.

    params (Npol, Nvec, Nmodel, ...), real or complex. ant2beam maps
    antenna number -> beam model index (None: every antenna uses model
    0). fov [deg] sets the host FOV cut.
    """

    def __init__(self, params, freqs, R=None, ant2beam=None, parameter=True,
                 pol=None, powerbeam=True, fov=180.0, name=None, p0=None,
                 device=None, dtype=None):
        super().__init__(name=name)
        dev = resolve_device(device)
        dt = dtype or _float()
        cplx = params.is_complex() if isinstance(params, torch.Tensor) \
            else np.iscomplexobj(params)
        pdt = (torch.complex128 if dt == torch.float64
               else torch.complex64) if cplx else dt
        self.register_buffer("params", torch.as_tensor(params, dtype=pdt,
                                                       device=dev))
        self.p0 = None if p0 is None else torch.as_tensor(p0, dtype=pdt,
                                                          device=dev)
        if parameter:
            self.set_param("params")
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.register_buffer("_freqs_t", torch.as_tensor(
            self.freqs, dtype=dt, device=dev))
        self.R = R if R is not None else UniformResponse()
        self.pol = pol
        self.powerbeam = powerbeam
        self.fov = fov
        self.Npol, self.Nvec, self.Nmodel = self.params.shape[:3]
        self.ant2beam = None if ant2beam is None else dict(ant2beam)
        if powerbeam and self.Nvec != 1:
            raise ValueError("powerbeam requires Nvec=1")
        self.theta_x = 0.0
        self.theta_y = 0.0

    def set_pointing_offset(self, theta_x=0.0, theta_y=0.0):
        """Small-angle pointing offset [rad] of the beam (not
        differentiable). RIME folds it into its host precompute (angles
        and interpolation ctx): set it before building the RIME, or
        re-run ``rime.precompute()`` after changing it."""
        self.theta_x = float(theta_x)
        self.theta_y = float(theta_y)

    def apply_pointing(self, zen, az):
        """zen / az [deg] offset by the stored pointing offset (numpy or
        tensors); the identity when no offset is set."""
        if self.theta_x == 0.0 and self.theta_y == 0.0:
            return zen, az
        zr, ar = pointing_offset(zen * D2R, az * D2R, self.theta_x,
                                 self.theta_y)
        return zr / D2R, ar / D2R

    def fov_cut(self, zen, pad_to=None):
        """Host FOV cut: indices of pixels with zen < fov/2, padded to a
        static size (default a multiple of 8), and the padding mask."""
        zen = np.asarray(zen)
        idx = np.where(zen < self.fov / 2)[0]
        n = len(idx)
        if pad_to is None:
            pad_to = max(8, int(np.ceil(n / 8) * 8))
        if pad_to < n:
            raise ValueError("pad_to smaller than FOV pixel count")
        pad_idx = np.zeros(pad_to, dtype=np.int64)
        pad_idx[:n] = idx
        mask = np.zeros(pad_to, dtype=bool)
        mask[:n] = True
        return pad_idx, mask

    def modelpair_index(self, bls):
        """Host map bls -> (m1, m2) indices into the Nmodel axis."""
        if self.ant2beam is None:
            z = np.zeros(len(bls), dtype=np.int64)
            return z, z
        m1 = np.asarray([self.ant2beam[bl[0]] for bl in bls], dtype=np.int64)
        m2 = np.asarray([self.ant2beam[bl[1]] for bl in bls], dtype=np.int64)
        return m1, m2

    def modelpairs(self, bls):
        """Unique model pairs and the baseline -> pair index (host):
        (mp1, mp2, mp_idx); mp_idx is None when there is one pair, and
        psky then stays shared across baselines."""
        m1, m2 = self.modelpair_index(bls)
        pairs = sorted(set(zip(m1.tolist(), m2.tolist())))
        mp1 = np.asarray([p[0] for p in pairs], dtype=np.int64)
        mp2 = np.asarray([p[1] for p in pairs], dtype=np.int64)
        if len(pairs) == 1:
            return mp1, mp2, None
        lut = {p: i for i, p in enumerate(pairs)}
        mp_idx = np.asarray([lut[(a, b)] for a, b in zip(m1, m2)],
                            dtype=np.int64)
        return mp1, mp2, mp_idx

    def gen_beam(self, zen, az, prior_cache=None, ctx=None, params=None,
                 angles_offset=False, freqs=None):
        """Beam response at zen / az [deg] tensors: (Npol, Nvec, Nmodel,
        Nfreqs, Npix). angles_offset: the caller already folded the
        pointing offset into zen / az (and ctx), as RIME does. freqs: the
        channels [Hz] as a tensor (default the beam's own, in its type).
        The beam's priors go into prior_cache."""
        p = self.params if params is None else params
        if self.p0 is not None:
            p = p + self.p0
        if not angles_offset:
            zen, az = self.apply_pointing(zen, az)
        beam = self.R(p, zen, az, self._freqs_t if freqs is None else freqs,
                      ctx=ctx)
        self.eval_prior(prior_cache, inp_params=self.params, out_params=None)
        return beam

    def apply_beam_mp(self, beam, mp1, mp2, sky):
        """psky in model-pair space (Npol, Npol, Nmp, Nfreqs, Npix):
        apply_beam indexed by the unique model pairs."""
        return self.apply_beam(beam, mp1, mp2, sky)

    def apply_beam(self, beam, m1, m2, sky):
        """psky = A_p B A_q^H.

        beam (Npol, Nvec, Nmodel, Nfreqs, Npix); m1, m2 index tensors
        into the Nmodel axis; sky (Nvec, Nvec, [Nbls,] Nfreqs, Npix), a
        coherency or (1, 1, ...) Stokes I. Returns (Npol, Npol, len(m1),
        Nfreqs, Npix).
        """
        beam1 = beam.index_select(2, m1)
        if sky.ndim == 4:
            sky = sky[:, :, None]
        if self.powerbeam:
            psky = beam1 * sky
            return psky if self.Npol == 1 else _expand_2pol(psky)
        beam2 = beam.index_select(2, m2)
        if self.Npol == 1 and self.Nvec == 1:
            return beam1 * beam2.conj() * sky
        cdt = torch.promote_types(beam.dtype, sky.dtype)
        return torch.einsum("ab...,bc...,dc...->ad...", beam1.to(cdt),
                            sky.to(cdt), beam2.to(cdt).conj())

    def forward(self, sky_comp, telescope, time, bls):
        """Standalone single-time forward: host eq2top, FOV cut and
        interpolation ctx, then the beam applied per baseline. Returns a
        dict of sky (psky), angs, zenaz, cut and mask."""
        ra, dec = np.asarray(sky_comp.angs)
        zen, az = telescope.eq2top(time, ra, dec)
        cut, mask = self.fov_cut(zen)
        zen_c, az_c = self.apply_pointing(zen[cut], az[cut])
        ctx = self.R.precompute(zen_c, az_c) \
            if hasattr(self.R, "precompute") else None
        rdt, dev = self._freqs_t.dtype, self._freqs_t.device
        zt = torch.as_tensor(zen_c, dtype=rdt, device=dev)
        at = torch.as_tensor(az_c, dtype=rdt, device=dev)
        beam = self.gen_beam(zt, at, ctx=ctx, angles_offset=True)
        beam = beam * torch.as_tensor(mask, dtype=rdt, device=dev)
        cut_t = torch.as_tensor(cut, device=dev)
        m1, m2 = (torch.as_tensor(m, device=dev)
                  for m in self.modelpair_index(bls))
        psky = self.apply_beam(beam, m1, m2, cut_sky_fov(sky_comp.data,
                                                         cut_t))
        return dict(sky=psky, angs=np.asarray(sky_comp.angs)[:, cut],
                    zenaz=torch.stack([zt, at]), cut=cut, mask=mask)

    def freq_interp(self, freqs, kind="linear"):
        """Move the beam onto the channels freqs [Hz]. A channel-mode
        beam whose params hold one entry a channel (axis 3) has them
        interpolated by scipy's interp1d of this kind, extrapolating, on
        the host in float64, written back on their device in their dtype
        (a trainable one stays the same nn.Parameter); any other beam
        (an Airy or Gaussian one) keeps its params. freqs, the channels
        gen_beam evaluates at, and R.freqs where R has them become
        freqs."""
        freqs = np.asarray(freqs, dtype=np.float64)
        if getattr(self.R, "freq_mode", "channel") == "channel" and \
                self.params.shape[3] == len(self.freqs):
            new = _interp_freqs(self.params, self.freqs, freqs, kind, 3)
            if isinstance(self.params, torch.nn.Parameter):
                with torch.no_grad():
                    self.params.data = new
            else:
                self.params = new
        self.freqs = freqs
        self._freqs_t = torch.as_tensor(freqs, dtype=self._freqs_t.dtype,
                                        device=self._freqs_t.device)
        if hasattr(self.R, "freqs"):
            self.R.freqs = freqs


def _expand_2pol(psky):
    """(2, 1, ...) per-pol power-beam psky -> (2, 2, ...) with zero
    cross terms."""
    z = torch.zeros_like(psky[:, 0:1])
    top = torch.cat([psky[0:1, 0:1], z[0:1]], dim=1)
    bot = torch.cat([z[1:2], psky[1:2, 0:1]], dim=1)
    return torch.cat([top, bot], dim=0)


# ---------------------------------------------------------------------------
# polarization / frame rotations (host numpy)
# ---------------------------------------------------------------------------

def R_eq_to_xyz(alpha, delta):
    """The equatorial unit vectors (e_alpha, e_delta) at (alpha, delta)
    [rad] in xyz: (3, 2, ...)."""
    alpha = np.asarray(alpha)
    delta = np.asarray(delta)
    return np.array([
        [-np.sin(alpha), np.cos(alpha) * np.sin(delta)],
        [np.cos(alpha), np.sin(alpha) * np.sin(delta)],
        [np.zeros_like(alpha), -np.cos(delta)],
    ])


def rotation(beta, axis):
    """3x3 rotation by beta [rad] about 'x' or 'y'."""
    c, s = np.cos(beta), np.sin(beta)
    if axis.lower() == "x":
        return np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    if axis.lower() == "y":
        return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])
    raise ValueError(f"unknown axis {axis}")


def R_beta(beta):
    """xyz -> XYZ: the rotation by beta about y."""
    return rotation(beta, "y")


def R_XYZ_to_top(phi, theta):
    """XYZ unit vectors projected onto the topocentric (e_phi, e_theta)
    at (phi, theta) [rad]: (2, 3, ...)."""
    phi = np.asarray(phi)
    theta = np.asarray(theta)
    return np.array([
        [-np.sin(phi), np.cos(phi), np.zeros_like(phi)],
        [np.cos(phi) * np.cos(theta), np.sin(phi) * np.cos(theta),
         -np.sin(theta)],
    ])


def R_chi(alpha, delta, beta):
    """Rotation from the equatorial basis (e_alpha, e_delta) to the
    spherical basis (e_phi, e_theta) of a polarized beam at (alpha,
    delta) [rad], the frame turned by beta [rad]: (2, 2, Nangles)."""
    alpha = np.atleast_1d(np.asarray(alpha, dtype=np.float64))
    delta = np.atleast_1d(np.asarray(delta, dtype=np.float64))
    Rb = R_beta(beta)
    xyz = np.einsum("ij,jk...->ik...", Rb, R_eq_to_xyz(alpha, delta))
    v = np.array([np.cos(delta) * np.cos(alpha),
                  np.cos(delta) * np.sin(alpha),
                  np.sin(delta)])
    V = Rb @ v
    theta = np.arccos(np.clip(V[2], -1, 1))
    phi = np.mod(np.arctan2(V[1], V[0]), 2 * np.pi)
    return np.einsum("ij...,jk...->ik...", R_XYZ_to_top(phi, theta), xyz)
