"""
Pixel interpolation: host-precomputed (indices, weights), a gather and
a weighted sum on the device.

Counterpart of bayeslim_tpu/utils/interp.py (`_lagrange_weights` :29,
`bipoly_interp_weights` :47, `interp_gather` :97, PixInterp :110). The
interpolation metadata is computed once on the host with numpy
(``PixInterp.precompute``); the device op (``interp_gather``) is an
``index_select`` of the map's pixels followed by a weighted sum over the
neighbours, for real or complex maps.

- 'healpix': bilinear 4-neighbour interpolation (RING ordering)
- 'rect': bipolynomial interpolation on a rectangular (theta, phi)
  grid, degree 0..3 per axis (nearest / linear / quadratic / cubic),
  with phi wrap-around.
"""
from __future__ import annotations

import numpy as np
import torch

from . import healpix as hp
from .dtypes import D2R

__all__ = ["PixInterp", "interp_gather", "bipoly_interp_weights"]

_S2D = {"nearest": 0, "linear": 1, "quadratic": 2, "cubic": 3}


def _lagrange_weights(xrel, offsets):
    """Lagrange interpolation weights at fractional positions xrel (N,)
    for integer sample offsets (e.g. [0, 1] for linear), in grid-index
    units. Returns (N, len(offsets))."""
    offs = np.asarray(offsets, dtype=np.float64)
    k = len(offs)
    w = np.ones((len(xrel), k), dtype=np.float64)
    for j in range(k):
        for m in range(k):
            if m == j:
                continue
            w[:, j] *= (xrel - offs[m]) / (offs[j] - offs[m])
    return w


def bipoly_interp_weights(xgrid, ygrid, xnew, ynew, degx=1, degy=1,
                          wrapx=True):
    """Tensor-product polynomial interpolation on a rect grid, pixels
    ordered x-fastest (flat index = iy * len(xgrid) + ix).

    Returns inds (Nnew, (degx+1)*(degy+1)) int64 flat pixel indices and
    wgts of the same shape (float64).
    """
    xgrid = np.asarray(xgrid, dtype=np.float64)
    ygrid = np.asarray(ygrid, dtype=np.float64)
    xnew = np.atleast_1d(np.asarray(xnew, dtype=np.float64))
    ynew = np.atleast_1d(np.asarray(ynew, dtype=np.float64))
    nx, ny = len(xgrid), len(ygrid)
    dx = xgrid[1] - xgrid[0]
    dy = ygrid[1] - ygrid[0]
    kx, ky = degx + 1, degy + 1

    fx = (xnew - xgrid[0]) / dx
    fy = (ynew - ygrid[0]) / dy
    if wrapx:
        fx = np.mod(fx, nx)

    # left-most sample of each interpolation window
    x0 = np.floor(fx - (kx - 1) / 2.0 + 0.5).astype(np.int64) if degx > 0 \
        else np.round(fx).astype(np.int64)
    y0 = np.floor(fy - (ky - 1) / 2.0 + 0.5).astype(np.int64) if degy > 0 \
        else np.round(fy).astype(np.int64)
    if not wrapx:
        x0 = np.clip(x0, 0, nx - kx)
    y0 = np.clip(y0, 0, ny - ky)

    wx = _lagrange_weights(fx - x0, np.arange(kx))
    wy = _lagrange_weights(fy - y0, np.arange(ky))

    ix = x0[:, None] + np.arange(kx)[None, :]
    ix = np.mod(ix, nx) if wrapx else np.clip(ix, 0, nx - 1)
    iy = np.clip(y0[:, None] + np.arange(ky)[None, :], 0, ny - 1)

    inds = iy[:, :, None] * nx + ix[:, None, :]           # (N, ky, kx)
    wgts = wy[:, :, None] * wx[:, None, :]
    return inds.reshape(len(xnew), -1), wgts.reshape(len(xnew), -1)


def interp_gather(m, inds, wgts):
    """Interpolate m (..., Npix) at precomputed neighbours: inds, wgts
    (Nangles, Nnearest) (tensors or arrays) -> (..., Nangles). m may be
    real or complex; the weights take m's real dtype."""
    inds = torch.as_tensor(inds, device=m.device)
    wgts = torch.as_tensor(wgts, dtype=m.real.dtype, device=m.device)
    near = m.index_select(-1, inds.reshape(-1))
    near = near.reshape(m.shape[:-1] + tuple(inds.shape))
    return torch.sum(near * wgts, dim=-1)


class PixInterp:
    """Host precompute and device gather for pixel interpolation.

    pixtype 'healpix' (RING, nside) or 'rect' (theta_grid / phi_grid
    pixel centres [deg]); interp_mode 'nearest' / 'linear' / 'quadratic'
    / 'cubic' or an 'azmode,zenmode' pair (rect only; healpix is always
    bilinear).
    """

    def __init__(self, pixtype, nside=None, interp_mode="linear",
                 theta_grid=None, phi_grid=None):
        self.pixtype = pixtype
        self.nside = nside
        self.interp_mode = interp_mode
        self.theta_grid = None if theta_grid is None \
            else np.asarray(theta_grid)
        self.phi_grid = None if phi_grid is None else np.asarray(phi_grid)
        self.interp_cache = {}

    def get_interp(self, zen, az):
        """(inds, wgts) for target angles [deg], cached by a cheap key of
        zen (first value, last value, length): for pointings that recur
        across calls. precompute() is the uncached primitive."""
        z = np.atleast_1d(np.asarray(zen))
        key = (z.flat[0].item(), z.flat[-1].item(), z.shape[0])
        if key not in self.interp_cache:
            self.interp_cache[key] = self.precompute(zen, az)
        return self.interp_cache[key]

    def clear_cache(self):
        self.interp_cache = {}

    @property
    def nnearest(self):
        if self.pixtype == "healpix":
            return 4
        degx, degy = self._degrees()
        return (degx + 1) * (degy + 1)

    def _degrees(self):
        mode = self.interp_mode
        if "," in mode:
            az_mode, zen_mode = [s.strip() for s in mode.split(",")]
        else:
            az_mode = zen_mode = mode
        return _S2D[az_mode], _S2D[zen_mode]

    def precompute(self, zen, az):
        """(inds, wgts) for target angles [deg] on the host: int64
        indices (Nangles, Nnearest) and float64 weights."""
        zen = np.atleast_1d(np.asarray(zen, dtype=np.float64))
        az = np.atleast_1d(np.asarray(az, dtype=np.float64))
        if self.pixtype == "healpix":
            inds, wgts = hp.get_interp_weights(self.nside, zen * D2R,
                                               az * D2R)
            inds, wgts = inds.T, wgts.T
        elif self.pixtype == "rect":
            degx, degy = self._degrees()
            inds, wgts = bipoly_interp_weights(
                self.phi_grid, self.theta_grid, az, zen, degx, degy,
                wrapx=True)
        else:
            raise ValueError(f"unknown pixtype {self.pixtype}")
        return inds.astype(np.int64), wgts

    def interp(self, m, zen=None, az=None, inds=None, wgts=None):
        """Interpolate map(s) m (..., Npix) at target angles: from
        precomputed (inds, wgts), or from zen / az [deg] precomputed
        here on the host."""
        if inds is None:
            inds, wgts = self.precompute(zen, az)
        return interp_gather(m, inds, wgts)
