"""
Antenna/baseline bookkeeping and small host-side index utilities.

Counterpart of bayeslim_tpu/utils/indexing.py (AntposDict :36,
ants2blnum :115, blnum2ants :137, make_hex :158, split_into_groups
:192, flatten :208, white_noise :231, gauss_taper :248, tukey_taper
:253, SimpleIndex :259, Jy_to_KStr :270, tensor2numpy :278, conjbl
:301, colat2lat :312, inflate_bls :317, fit_zero / get_zeros :332,
:341, stripe_tukey_mask :360, half_gaussian_taper :376, voigt_beam
:384, freq_interp :394). Everything here is host numpy but
white_noise, gauss_taper, tukey_taper and half_gaussian_taper (tensors
on the device of their input, or on device= where they make one:
None means CUDA) and freq_interp of a tensor (interpolated on the host
in float64, returned on the tensor's device in its dtype).
"""
from __future__ import annotations

import numpy as np
import torch

from .dtypes import _float, resolve_device

__all__ = ["AntposDict", "blnum2ants", "ants2blnum", "make_hex",
           "split_into_groups", "flatten", "white_noise", "gauss_taper",
           "tukey_taper", "SimpleIndex", "Jy_to_KStr", "tensor2numpy",
           "conjbl", "colat2lat", "inflate_bls", "fit_zero", "get_zeros",
           "stripe_tukey_mask", "half_gaussian_taper", "voigt_beam",
           "freq_interp"]


class AntposDict:
    """Dict-like antenna-position store: ``ants`` is a list of ints,
    ``antvecs`` an (Nants, 3) array of ENU positions [m]: float64 numpy,
    or a tensor (trainable antenna positions), kept as given."""

    def __init__(self, ants, antvecs):
        self.ants = [int(a) for a in ants]
        self._ant_idx = {a: i for i, a in enumerate(self.ants)}
        if not isinstance(antvecs, torch.Tensor):
            antvecs = np.asarray(antvecs, dtype=np.float64)
        self.antvecs = antvecs

    def asnumpy(self):
        """Host float64 numpy copy of antvecs."""
        if isinstance(self.antvecs, torch.Tensor):
            return self.antvecs.detach().cpu().numpy().astype(np.float64)
        return self.antvecs

    def keys(self):
        return iter(self.ants)

    def values(self):
        return iter(self.antvecs)

    def items(self):
        return zip(self.ants, self.antvecs)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.antvecs[self._ant_idx[int(key)]]
        return self.antvecs[[self._ant_idx[int(k)] for k in key]]

    def __len__(self):
        return len(self.ants)

    def __contains__(self, key):
        return int(key) in self._ant_idx

    def __iter__(self):
        return self.keys()

    def __repr__(self):
        return f"Antpos{{{self.ants}}}"

    def index(self, ants):
        """Integer indices into antvecs for a list of antenna numbers."""
        return np.asarray([self._ant_idx[int(a)] for a in ants])

    def select(self, new_ants):
        """A new AntposDict of these antennas (in this order)."""
        return AntposDict(new_ants, self[new_ants])


def ants2blnum(antnums, separate=False):
    """Antenna-pair tuple(s) -> baseline integer(s): (1, 2) -> 101102."""
    if isinstance(antnums, tuple):
        a1, a2 = antnums[0] + 100, antnums[1] + 100
        return (a1, a2) if separate else int(a1 * 1000 + a2)
    if isinstance(antnums, list) and len(antnums) \
            and isinstance(antnums[0], tuple):
        bl = np.asarray(antnums) + 100
        if separate:
            return bl[:, 0] * 1000, bl[:, 1]
        return bl[:, 0] * 1000 + bl[:, 1]
    return np.asarray(antnums)  # already blnums


def blnum2ants(blnum, separate=False):
    """Baseline integer(s) -> antenna-pair tuple(s): 102103 -> (2, 3)."""
    if isinstance(blnum, tuple):
        return blnum
    if isinstance(blnum, list) and len(blnum) \
            and isinstance(blnum[0], tuple):
        return list(zip(*blnum)) if separate else blnum
    if isinstance(blnum, (int, np.integer)):
        a1 = int(blnum // 1000)
        a2 = int(blnum - a1 * 1000)
        return (a1 - 100, a2 - 100)
    arr = np.asarray(blnum)
    a1 = (arr // 1000).astype(np.int64) - 100
    a2 = (arr % 1000).astype(np.int64) - 100
    if separate:
        return a1.tolist(), a2.tolist()
    return list(zip(a1.tolist(), a2.tolist()))


def make_hex(N, D=15.0):
    """Hexagonal array with N antennas per side and spacing D [m].

    Returns ants (list of int) and antvecs (Nants, 3) numpy."""
    x, y, ants = [], [], []
    ant, k, start = 0, 0, 0.0
    for i in range(2 * N - 1):
        for j in range(N + k):
            x.append(j + start)
            y.append(i * np.sin(np.pi / 3))
            ants.append(ant)
            ant += 1
        if i < N - 1:
            k += 1
            start -= 0.5
        else:
            k -= 1
            start += 0.5
    x = np.asarray(x) - np.mean(x)
    y = np.asarray(y) - np.mean(y)
    antvecs = np.vstack([x, y, np.zeros_like(x)]).T * D
    return ants, antvecs


def split_into_groups(items, Nelem=None, Ngroup=None, interleave=False):
    """Split a list into contiguous groups of Nelem (or into Ngroup
    groups); interleave=True deals round-robin (items[i::Ngroup])."""
    items = list(items)
    if interleave:
        if Ngroup is None:
            if Nelem is None:
                raise ValueError("split_into_groups needs Nelem or Ngroup")
            Ngroup = int(np.ceil(len(items) / Nelem))
        return [items[i::Ngroup] for i in range(Ngroup)]
    if Nelem is None:
        if Ngroup is None:
            raise ValueError("split_into_groups needs Nelem or Ngroup")
        Nelem = int(np.ceil(len(items) / Ngroup))
    return [items[i:i + Nelem] for i in range(0, len(items), Nelem)]


def flatten(nested, Nelem=None):
    """Flatten a nested sequence one level; Nelem keeps the first Nelem
    elements of each sub-sequence. Non-sequence items pass through."""
    s = slice(None) if Nelem is None else slice(0, Nelem)
    out = []
    for x in nested:
        if isinstance(x, (list, tuple, np.ndarray)) or hasattr(x, "__next__"):
            out.extend(list(x)[s] if hasattr(x, "__next__") else x[s])
        else:
            out.append(x)
    return out


def white_noise(shape, key=None, dtype=None, complex=False, device=None):
    """Unit-variance white noise on device (None: CUDA) in the real
    dtype (default _float()); complex=True: complex noise whose real
    and imaginary parts each have variance 1/2. key is a
    torch.Generator on that device (None: one seeded from numpy's
    global generator, as the JAX package draws its key); it draws from
    another generator than JAX's, so only the moments match."""
    dev = key.device if key is not None else resolve_device(device)
    dt = dtype or _float()
    if key is None:
        key = torch.Generator(device=dev).manual_seed(
            int(np.random.randint(0, 2**31 - 1)))
    shape = tuple(np.atleast_1d(shape).tolist()) \
        if not isinstance(shape, tuple) else shape
    if complex:
        re = torch.randn(shape, generator=key, dtype=dt, device=dev)
        im = torch.randn(shape, generator=key, dtype=dt, device=dev)
        return torch.complex(re, im) / np.sqrt(2)
    return torch.randn(shape, generator=key, dtype=dt, device=dev)


def gauss_taper(x, scale):
    """Gaussian edge taper exp(-0.5 (x/scale)^2)."""
    return torch.exp(-0.5 * (torch.as_tensor(x) / scale) ** 2)


def tukey_taper(N, alpha=0.5, device=None, dtype=None):
    """Tukey (tapered cosine) window of length N (scipy's, made on the
    host in float64) as a tensor on device (None: CUDA) in dtype
    (default _float())."""
    from scipy.signal import windows
    return torch.as_tensor(windows.tukey(N, alpha), dtype=dtype or _float(),
                           device=resolve_device(device))


class SimpleIndex:
    """Returns the same value for any key: a trivial antenna -> beam
    model map."""

    def __init__(self, value=0):
        self.value = value

    def __getitem__(self, k):
        return self.value


def Jy_to_KStr(freqs):
    """Jy -> Kelvin-steradian conversion [K sr / Jy] at freqs [Hz]."""
    c = 2.99792458e8
    k_B = 1.380649e-23
    return 1e-26 * (c / np.asarray(freqs, dtype=np.float64)) ** 2 / (2 * k_B)


def tensor2numpy(x, clone=True):
    """A tensor (any device; detached) or array as numpy; clone forces
    an owning copy."""
    if isinstance(x, torch.Tensor):
        out = x.detach().cpu().numpy()
        return out.copy() if clone and x.device.type == "cpu" else out
    out = np.asarray(x)
    if clone and out is x:
        out = out.copy()
    return out


def conjbl(bl):
    """The conjugate baseline: a reversed antenna pair, a list of them,
    or blnum(s) with the antennas swapped."""
    if isinstance(bl, tuple):
        return bl[::-1]
    if isinstance(bl, list) and len(bl) and isinstance(bl[0], tuple):
        return [conjbl(b) for b in bl]
    bl = np.asarray(bl)
    out = 1000 * (bl % 1000) + bl // 1000
    return out if out.ndim else int(out)


def colat2lat(theta, deg=True):
    """Colatitude <-> latitude [deg, or rad with deg=False]."""
    return (90 - np.asarray(theta)) if deg \
        else (np.pi / 2 - np.asarray(theta))


def inflate_bls(red_bls, bl2red, all_bls=None):
    """The baselines of all_bls (default: every key of bl2red) whose
    redundant group holds one of red_bls, and each one's group index:
    (new_bls, red_inds)."""
    if all_bls is None:
        all_bls = list(bl2red.keys())
    red_indices = set(bl2red.get(bl, None) for bl in red_bls)
    new_bls, red_inds = [], []
    for bl in all_bls:
        ridx = bl2red.get(bl, -1)
        if ridx in red_indices:
            new_bls.append(bl)
            red_inds.append(ridx)
    return new_bls, red_inds


def fit_zero(x, y):
    """The root nearest x[0] of a quadratic fitted to (x, y)."""
    a, b, c = np.polyfit(np.asarray(x), np.asarray(y), 2)
    d = np.sqrt(b ** 2 - 4 * a * c)
    x1, x2 = (-b + d) / (2 * a), (-b - d) / (2 * a)
    return x1 if abs(x1 - x[0]) < abs(x2 - x[0]) else x2


def get_zeros(x, y):
    """Zero crossings of a sampled function, each from a quadratic fit
    to the three samples nearest zero around the sign change."""
    x, y = np.asarray(x), np.asarray(y)
    roots, prev = [], np.sign(y[0])
    for i in range(1, len(y)):
        curr = np.sign(y[i])
        if (curr != prev) and abs(y[i]) > 1e-40 and curr != 0.0 \
                and np.isfinite(prev):
            if prev == 0.0:
                prev = curr
                continue
            start = max(i - 3, 0)
            nn = np.argsort(np.abs(y)[start:i + 3])[:3] + start
            roots.append(fit_zero(x[nn], y[nn]))
            prev = curr
    return roots


def stripe_tukey_mask(theta, theta_min, theta_max, phi, phi_min, phi_max,
                      theta_alpha=0.5, phi_alpha=0.5):
    """Tukey apodization mask of a spherical stripe [rad]: the product
    of tukey windows in colatitude and azimuth (5000 samples each
    between the limits, zero outside), interpolated onto the points."""
    from scipy.signal import windows

    def axis_mask(vals, vmin, vmax, alpha):
        grid = np.linspace(vmin, vmax, 5000, endpoint=True)
        win = windows.tukey(5000, alpha=alpha)
        return np.interp(np.asarray(vals), grid, win, left=0.0, right=0.0)

    return (axis_mask(theta, theta_min, theta_max, theta_alpha)
            * axis_mask(phi, phi_min, phi_max, phi_alpha))


def half_gaussian_taper(x, xcenter, sigma, below=True, device=None):
    """One-sided Gaussian taper: exp(-0.5 (x - xcenter)^2 / sigma^2)
    below xcenter (above with below=False), one elsewhere. x a tensor
    (its device and dtype), or values put on device (None: CUDA)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=resolve_device(device))
    g = torch.exp(-0.5 * (x - xcenter) ** 2 / sigma ** 2)
    sel = (x < xcenter) if below else (x > xcenter)
    return torch.where(sel, g, torch.ones_like(g))


def voigt_beam(nside, sigma, gamma):
    """Voigt-profile power beam on a HEALPix grid, normalised to a peak
    of one, as host numpy: (beam, theta, phi) [rad]."""
    from scipy.special import voigt_profile
    from . import healpix as hp
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    beam = voigt_profile(theta, sigma, gamma)
    return beam / beam.max(), theta, phi


def freq_interp(params, param_freqs, freqs, kind, axis,
                fill_value="extrapolate"):
    """params sampled at param_freqs, interpolated along axis onto freqs
    by scipy's interp1d of this kind (extrapolating by default), on the
    host in float64. A tensor comes back on its device in its dtype,
    an array as numpy. (The JAX package's note: only the interp1d path
    exists, since the reference's matched-frequency fast path is broken
    by a typo.)"""
    from scipy.interpolate import interp1d
    is_t = isinstance(params, torch.Tensor)
    p = params.detach().cpu().numpy() if is_t else np.asarray(params)
    f = interp1d(np.asarray(param_freqs), p, kind=kind, axis=axis,
                 fill_value=fill_value, bounds_error=False)
    out = f(np.asarray(freqs))
    if is_t:
        return torch.as_tensor(out, dtype=params.dtype, device=params.device)
    return out
