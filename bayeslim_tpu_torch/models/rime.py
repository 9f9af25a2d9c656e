"""
RIME forward model: V_pq(t, f) = sum_pix A(pix) I(pix) exp(2 pi i f b_pq.s/c).

Counterpart of bayeslim_tpu/models/rime.py (precompute :203,
`_sim_component` :313, forward :369).

- ``precompute`` runs once on the host: eq2top per (time, sky pixel),
  the padded FOV cut (indices + mask) and unit pointing vectors s, all
  stored as device tensors.
- ``forward`` loops over times (the JAX package's lax.map): beam
  evaluation and beam-weighted sky in model-pair space (``make_psky``,
  checkpointed as the JAX one is, so the backward keeps only psky per
  time), and the pixel
  reduction ``rime_reduce`` with the delay factored as blvecs @ s/c,
  which on CUDA runs the fused kernel. The simulated baselines expand
  to the data baselines through a host index (sim -> data redundancy).

This slice carries one baseline group, one time group and a single sky
component (Nbatch == 1) and the shared-beam case (Nmp == 1).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.containers import VisData
from ..ops.rime_kernel import rime_reduce
from ..utils.dtypes import C_MS
from ..utils.indexing import ants2blnum
from ..utils.module import Module
from .beam import cut_sky_fov

__all__ = ["RIME"]


class RIME(Module):
    """The sky-integral RIME forward model.

    Tensors it precomputes take the device and dtype of the sky params.
    use_kernel is passed to rime_reduce ("auto": the fused kernel on
    CUDA for eligible problems).
    """

    def __init__(self, sky, telescope, beam, array, sim_bls, times, freqs,
                 data_bls=None, name=None, pix_chunk=1024, use_kernel="auto"):
        super().__init__(name=name)
        self.sky = sky
        self.telescope = telescope
        self.beam = beam
        self.array = array
        self.pix_chunk = pix_chunk
        self.use_kernel = use_kernel
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.Nfreqs = len(self.freqs)
        self.array.set_freqs(self.freqs)
        self.times = np.atleast_1d(np.asarray(times, dtype=np.float64))
        self.setup_sim_bls(sim_bls, data_bls)
        self.precompute()

    def setup_sim_bls(self, sim_bls, data_bls=None):
        """Simulated baselines, their antenna indices on the device, and
        the sim -> data expansion index for redundant data."""
        self.sim_bls = [tuple(b) for b in sim_bls]
        a1, a2 = self.array.bl_index(self.sim_bls)
        dev = self.array.antvecs.device
        self._a1 = torch.as_tensor(a1, device=dev)
        self._a2 = torch.as_tensor(a2, device=dev)
        self._sim2data = None
        self.data_bls = list(self.sim_bls)
        if data_bls is not None:
            data_bls = [tuple(b) for b in data_bls]
            bl2red = self.array.bl2red
            # group -> first simulated baseline of that group
            sim_of = {}
            for i, bl in enumerate(self.sim_bls):
                sim_of.setdefault(bl2red[bl], i)
            dbls = [bl for bl in data_bls if bl2red[bl] in sim_of]
            if set(sim_of) != {bl2red[bl] for bl in dbls}:
                raise ValueError(
                    "non-overlapping bl type(s) in data_bls and sim_bls")
            self.data_bls = dbls
            self._sim2data = torch.as_tensor(
                [sim_of[bl2red[bl]] for bl in dbls], device=dev)
        self._data_blnums = ants2blnum(self.data_bls)

    def precompute(self):
        """Per time: zen/az of the sky pixels, the padded FOV cut and
        the pointing vectors of the cut pixels (host), as tensors."""
        params = self.sky.params
        dev, rdt = params.device, params.dtype
        ra, dec = self.sky.angs_np[0], self.sky.angs_np[1]
        raw = [self.telescope.eq2top(t, ra, dec) for t in self.times]
        ncut = max(int((zen < self.beam.fov / 2).sum()) for zen, _ in raw)
        base = self.pix_chunk if ncut >= self.pix_chunk else 8
        pad = int(np.ceil(max(ncut, 1) / base) * base)
        self._pre = []
        for zen, az in raw:
            cut, mask = self.beam.fov_cut(zen, pad_to=pad)
            self._pre.append(dict(
                zen=torch.as_tensor(zen[cut], dtype=rdt, device=dev),
                az=torch.as_tensor(az[cut], dtype=rdt, device=dev),
                cut=torch.as_tensor(cut, device=dev),
                mask=torch.as_tensor(mask, dtype=rdt, device=dev),
                s_c=torch.as_tensor(
                    self.array.s_vector(zen[cut], az[cut]), dtype=rdt,
                    device=dev) / C_MS))
        self.Npix_cut = pad
        mp1, mp2, mp_idx = self.beam.modelpairs(self.sim_bls)
        self._mp = (torch.as_tensor(mp1, device=dev),
                    torch.as_tensor(mp2, device=dev), mp_idx)

    def forward(self, *args, **kwargs):
        """Forward model -> VisData (Npol, Npol, Ndata_bls, Ntimes, Nfreqs)."""
        sky = self.sky().data                       # (Nstokes, 1, Nf, Npix)
        blvecs = self.array.antvecs[self._a2] - self.array.antvecs[self._a1]
        mp1, mp2, mp_idx = self._mp

        def make_psky(sky, zen, az, cut, mask):
            csky = cut_sky_fov(sky, cut) * mask
            beam = self.beam.gen_beam(zen, az)
            return self.beam.apply_beam_mp(beam, mp1, mp2, csky)

        vis_t = []
        for pre in self._pre:
            args = (sky, pre["zen"], pre["az"], pre["cut"], pre["mask"])
            # psky's construction chains many (Nfreqs, Ncut) intermediates:
            # checkpoint it, so the backward keeps only psky per time and
            # recomputes the rest (the beam and sky hold no randomness)
            psky = checkpoint(make_psky, *args, use_reentrant=False,
                              preserve_rng_state=False) \
                if torch.is_grad_enabled() else make_psky(*args)
            vis_t.append(rime_reduce(psky, None, self.freqs, mp_idx=mp_idx,
                                     chunk=self.pix_chunk,
                                     use_kernel=self.use_kernel,
                                     blvecs=blvecs, s_c=pre["s_c"]))
        vis = torch.stack(vis_t, dim=3)             # (Np, Np, Nb, Nt, Nf)
        if self._sim2data is not None:
            vis = vis.index_select(2, self._sim2data)
        pol = None
        if self.beam.Npol == 1 and self.beam.pol is not None:
            pol = f"{self.beam.pol}{self.beam.pol}"
        vd = VisData()
        vd.setup_meta(self.telescope, self.array.to_antpos())
        vd.setup_data(self._data_blnums, self.times, self.freqs, pol=pol,
                      data=vis, history=f"RIME forward ({self.name})")
        return vd
