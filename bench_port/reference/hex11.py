"""
Plain reference of the hex11 configuration: a pixelised power-law sky
through a fixed Airy power beam, simulated on each redundant group's
representative baseline (trainable antenna positions), expanded to every
cross baseline, times per-antenna complex gains (the first antenna's
phase taken out), against a target under unit inverse covariance;
evaluated a block of channels at a time (physics.ChannelBlocks: each
channel's gains are its own).
"""
from __future__ import annotations

import numpy as np
import torch

from . import astro
from .physics import ChannelBlocks, airy_power, gains_complex, reduce_pixels


class Model(ChannelBlocks):
    """value_and_grad({'antvecs': (Na, 3), 'gains': (1, 1, Na, 1, F, 2)})
    and forward(leaves) -> (T, F, B) complex in ``bls`` order."""

    leaves = ("antvecs", "gains")

    def __init__(self, cfg, inputs, device, dtype=torch.float64, tf32=False,
                 elems=64_000_000):
        self.dev, self.dt, self.tf32 = device, dtype, tf32
        pos = astro.make_hex(cfg["hex"], cfg["spacing_m"])
        a1, a2, group, r1, r2 = astro.redundant_groups(pos)
        self.bls = list(zip(a1.tolist(), a2.tolist()))
        t = lambda x, d=dtype: torch.as_tensor(x, dtype=d, device=device)
        self.a1, self.a2 = t(a1, torch.long), t(a2, torch.long)
        self.r1, self.r2 = t(r1, torch.long), t(r2, torch.long)
        self.group = t(group, torch.long)
        self.icov = torch.ones(len(a1), dtype=dtype, device=device)
        self.freqs = t(np.linspace(cfg["fmin_hz"], cfg["fmax_hz"], cfg["nfreq"]))
        times = cfg["time0_jd"] + np.arange(cfg["ntime"]) * cfg["dtime_jd"]
        geo, _, _, _ = astro.sky_geometry(cfg["nside"], times)
        npix = 12 * cfg["nside"] ** 2
        amp = inputs["sky_amp"].to(device=device, dtype=dtype)
        self.pix = [(t(s), amp[t(idx, torch.long)] * (4 * np.pi / npix))
                    for idx, s in geo]
        self.index = cfg["sky_index"]
        self.diam = cfg["beam_diameter_m"]
        K = max(s.shape[1] for s, _ in self.pix)
        self.fb = max(1, elems // (len(r1) * K))
        self.data = None

    def _psky(self, s, sky, f):
        up = s[2]
        d = torch.full_like(up, self.diam)
        spec = (f / self.freqs[0])[:, None] ** self.index
        return airy_power(f, s, d, d) * sky[None, :] * spec

    def _block(self, leaves, f0, f1):
        """(T, F_b, B) complex: the chain's output on channels f0:f1."""
        f = self.freqs[f0:f1]
        av = leaves["antvecs"]
        blv = av[self.r2] - av[self.r1]
        vis = torch.stack([reduce_pixels(self._psky(s, sky, f), blv, s, f,
                                         self.tf32)
                           for s, sky in self.pix])      # (T, F_b, G)
        vis = vis[..., self.group]
        g = gains_complex(leaves["gains"][0, 0, :, 0, f0:f1], 0)   # (Na, F_b)
        G = (g[self.a1] * g[self.a2].conj()).t()                   # (F_b, B)
        return vis * G[None]
