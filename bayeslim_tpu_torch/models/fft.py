"""
FFT blocks: windows, the delay transform, and the peak-delay estimate.

Counterpart of bayeslim_tpu/models/fft.py (gen_window :25, FFT :71,
PeakDelay :135, vis_wedge :178). Windows are made by scipy.signal on
the host (imported when a window is made: importing it costs most of a
second) and kept on the model's device; the transform is torch.fft with
numpy's norm and fftshift conventions; PeakDelay's Quinn estimator runs
over every leading axis at once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.containers import TensorData
from ..utils.dtypes import _float, resolve_device
from ..utils.module import Module

__all__ = ["FFT", "PeakDelay", "vis_wedge", "gen_window"]

# general_cosine coefficients of the named many-term windows
_COSINE_TERMS = {
    "bh7": [0.27105140069342, 0.43329793923448, 0.21812299954311,
            0.06592544638803, 0.01081174209837, 0.00077658482522,
            0.00001388721735],
    "cs9": [2.384331152777942e-1, 4.00554534864382e-1,
            2.358242530472107e-1, 9.527918858383112e-2,
            2.537395516617152e-2, 4.152432907505835e-3,
            3.68560416329818e-4, 1.38435559391703e-5,
            1.161808358932861e-7],
    "cs11": [2.151527506679809e-1, 3.731348357785249e-1,
             2.424243358446660e-1, 1.166907592689211e-1,
             4.077422105878731e-2, 1.000904500852923e-2,
             1.639806917362033e-3, 1.651660820997142e-4,
             8.884663168541479e-6, 1.938617116029048e-7,
             8.482485599330470e-10],
}


def _window(window, N, alpha=None, edgecut=None, **kwargs):
    """The float64 numpy window of gen_window."""
    from scipy.signal import windows
    if edgecut is not None:
        N = N - sum(edgecut)
    if window in ("none", None, "None", "boxcar", "tophat"):
        w = windows.boxcar(N)
    elif window in ("blackmanharris", "blackman-harris", "bh", "bh4"):
        w = windows.blackmanharris(N)
    elif window in ("hanning", "hann"):
        w = windows.hann(N)
    elif window == "tukey":
        w = windows.tukey(N, alpha=alpha, **kwargs)
    elif window == "gaussian":
        w = windows.gaussian(N, std=alpha, **kwargs)
    elif window in ("blackmanharris-7term", "bh7"):
        w = windows.general_cosine(N, _COSINE_TERMS["bh7"], True)
    elif window in ("cosinesum-9term", "cs9"):
        w = windows.general_cosine(N, _COSINE_TERMS["cs9"], True)
    elif window in ("cosinesum-11term", "cs11"):
        w = windows.general_cosine(N, _COSINE_TERMS["cs11"], True)
    else:
        try:
            w = getattr(windows, window)(N, **kwargs)
        except AttributeError:
            raise ValueError(f"unrecognized window {window}") from None
    if edgecut is not None:
        w = np.concatenate([np.zeros(edgecut[0]), w, np.zeros(edgecut[1])])
    return np.asarray(w, dtype=np.float64)


def gen_window(window, N, alpha=None, edgecut=None, device=None, dtype=None,
               **kwargs):
    """Window of length N: boxcar ('none', 'tophat'), blackman-harris
    ('bh'), hann, tukey (alpha), gaussian (std alpha), the 7-term
    blackman-harris ('bh7'), the 9- and 11-term cosine sums ('cs9',
    'cs11') or any other scipy.signal.windows name (kwargs); edgecut
    (lo, hi) zeroes that many samples at each end. A tensor of dtype
    (default float32) on device (default CUDA)."""
    return torch.as_tensor(_window(window, N, alpha=alpha, edgecut=edgecut,
                                   **kwargs), dtype=dtype or _float(),
                           device=resolve_device(device))


class FFT(Module):
    """1D FFT over dim of a tensor or of a data container's data.

    N and dx (the sample spacing) give the transform's frequencies
    (self.freqs, numpy; fftshifted with fftshift), its first (start) and
    its spacing (df). window: a tensor, or a gen_window name (kwargs)
    made for N samples along dim of ndim-dimensional inputs, on device
    in dtype; edgecut (an int or (lo, hi)) zeroes its ends. forward
    multiplies by the window, then takes the FFT (or with ifft the
    inverse, ifftshifted first) with numpy's norm, fftshifted; then abs,
    peaknorm (divide by the peak modulus along dim) and square (|x|^2),
    each if asked.
    """

    def __init__(self, dim=0, abs=False, peaknorm=False, N=None, dx=None,
                 ndim=None, window=None, fftshift=True, ifft=False,
                 norm=None, edgecut=None, square=False, name=None,
                 device=None, dtype=None, **kwargs):
        super().__init__(name=name)
        self.dim = dim
        self.abs = abs
        self.peaknorm = peaknorm
        self.dx = dx if dx is not None else 1.0
        self.fftshift = fftshift
        self.ifft = ifft
        self.norm = norm
        self.square = square
        if N is not None:
            freqs = np.fft.fftfreq(N, d=self.dx)
            if fftshift:
                freqs = np.fft.fftshift(freqs)
            self.freqs = freqs
            self.start = float(freqs[0])
            self.df = float(freqs[1] - freqs[0])
        else:
            self.freqs, self.start, self.df = None, 0.0, None
        if isinstance(edgecut, (int, np.integer)):
            edgecut = (edgecut, edgecut)
        self.edgecut = edgecut if edgecut is not None else (0, 0)
        win = None
        if window is not None:
            if isinstance(window, (torch.Tensor, np.ndarray)):
                win = torch.as_tensor(window, device=resolve_device(device))
            else:
                if N is None or ndim is None:
                    raise ValueError("a named window needs N and ndim")
                shape = [1] * ndim
                shape[dim] = N
                win = gen_window(window, N, edgecut=self.edgecut,
                                 device=device, dtype=dtype,
                                 **kwargs).reshape(shape)
        self.register_buffer("win", win)

    def forward(self, inp, ifft=None, win=None, **kwargs):
        if isinstance(inp, TensorData):
            out = inp.copy()
            out.data = self.forward(inp.data, ifft=ifft, win=win, **kwargs)
            return out
        x = inp
        win = win if win is not None else self.win
        if win is not None:
            x = x * win
        do_ifft = ifft if ifft is not None else self.ifft
        if self.fftshift and do_ifft:
            x = torch.fft.ifftshift(x, dim=self.dim)
        x = torch.fft.ifft(x, norm=self.norm, dim=self.dim) if do_ifft \
            else torch.fft.fft(x, norm=self.norm, dim=self.dim)
        if self.fftshift and not do_ifft:
            x = torch.fft.fftshift(x, dim=self.dim)
        if self.abs:
            x = torch.abs(x)
        if self.peaknorm:
            x = x / torch.amax(torch.abs(x), dim=self.dim, keepdim=True)
        if self.square:
            x = torch.abs(x) ** 2
        return x


class PeakDelay(FFT):
    """The peak of the transform along dim, interpolated between bins by
    Quinn's second estimator, in the units of self.freqs: forward(x)
    transforms x as FFT does, then get_peak."""

    @staticmethod
    def _k(x):
        return 0.25 * torch.log(3 * x ** 2 + 6 * x + 1) \
            - np.sqrt(6) / 24 * torch.log((x + 1 - np.sqrt(2.0 / 3.0))
                                          / (x + 1 + np.sqrt(2.0 / 3.0)))

    def k(self, x):
        """Quinn's kappa term."""
        return self._k(x)

    def forward(self, inp, **kwargs):
        if isinstance(inp, TensorData):
            out = inp.copy()
            out.data = self.forward(inp.data)
            return out
        return self.get_peak(super().forward(inp))

    def get_peak(self, y):
        """Quinn-interpolated peak location of an already transformed
        spectrum y along self.dim."""
        y = torch.movedim(y, self.dim, -1)
        n = y.shape[-1]
        amax = torch.argmax(torch.abs(y), dim=-1)
        apos = torch.where(amax == n - 1, 0, amax + 1)
        aneg = torch.where(amax == 0, n - 1, amax - 1)
        y0 = torch.take_along_dim(y, amax[..., None], dim=-1)[..., 0]
        yp = torch.take_along_dim(y, apos[..., None], dim=-1)[..., 0]
        yn = torch.take_along_dim(y, aneg[..., None], dim=-1)[..., 0]
        rpos = (yp / y0).real
        rneg = (yn / y0).real
        dpos = -rpos / (1 - rpos)
        dneg = rneg / (1 - rneg)
        max_bin = amax + ((dneg + dpos) / 2 + self._k(dneg ** 2)
                          - self._k(dpos ** 2))
        return self.start + max_bin * self.df


def vis_wedge(vd, ravg_kwgs=None, **kwargs):
    """Redundantly average a VisData (VisData.bl_average with
    ravg_kwgs; the groups built from its antpos unless given) and
    delay-transform it along frequency. Returns (the wedge VisData, the
    FFT block); kwargs go to the FFT."""
    ravg_kwgs = dict(ravg_kwgs or {})
    vd = vd.bl_average(inplace=False, **ravg_kwgs)
    dfreq = vd.freqs[1] - vd.freqs[0]
    kwargs.setdefault("device", vd.data.device)
    kwargs.setdefault("dtype", vd.data.real.dtype)
    FT = FFT(dim=4, ndim=5, dx=dfreq, N=vd.Nfreqs, **kwargs)
    return FT(vd), FT
