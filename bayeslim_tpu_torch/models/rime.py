"""
RIME forward model: V_pq(t, f) = sum_pix A_p(pix) B(pix) A_q^H(pix)
exp(2 pi i f b_pq.s/c).

Counterpart of bayeslim_tpu/models/rime.py (setup_freqs :74,
setup_sim_bls :86,
setup_sim_times :140, the batching API :161-210, precompute :203-260,
`_sim_component` :313, forward :369 with the beam's prior :394,
run_batches :405).

- Minibatches: baseline groups (a dict or a list of lists of sim_bls)
  times time groups, selected by ``batch_idx`` (Nbatch of them); each
  baseline group has its own sim -> data redundancy expansion.
- ``precompute`` runs once on the host, per (time group, sky
  component) and time: eq2top of the component's pixels, the padded FOV
  cut (indices + mask), the unit pointing vectors s (true angles), the
  beam's angles with its pointing offset folded in and, for a
  pixelized beam, its interpolation ctx; all stored as device tensors.
- ``forward`` loops over the active group's times (the JAX package's
  lax.map or vmap: here ``time_mode`` 'scan' and 'vmap' are the same
  eager loop) and sums the sky components: beam evaluation and the
  beam-weighted sky in model-pair space (``make_psky``: for a float32
  Airy power beam on CUDA the fused kernels of ``airy_psky``, otherwise
  eager and checkpointed as the JAX one is, so the backward keeps only
  psky per time), then the pixel reduction ``rime_reduce`` with the
  delay factored as blvecs @ s/c, which on CUDA runs the fused kernel
  (grouped by model pair when Nmp > 1). ``remat`` checkpoints each
  whole time step instead. The simulated baselines expand to the data
  baselines through a host index.
- Sharding (parallel/sharding.py, the JAX package's vis_sharding :46,
  :361-363 and ``_mp_idx_dev`` :379-383): ``shard_rime`` and
  ``shard_pixels`` give a rank's copy its local times, baselines or
  pixels and set the hooks ``forward`` reads: ``_sim_gather`` gathers
  the simulated cube across baseline shards before the expansion,
  ``_pix_comm`` sums the pixel shards' partial visibilities (and the
  gradients of the replicated inputs), ``_mp_idx_dev`` (a device
  baseline -> pair map by baseline group) takes the kernel dispatch's
  device branch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.containers import VisData, concat_VisData
from ..ops.linalg import dual_active
from ..ops.rime_kernel import rime_reduce
from ..utils.dtypes import C_MS
from ..utils.indexing import ants2blnum, flatten
from ..utils.logging import span
from ..utils.module import Module
from . import airy_psky
from .beam import cut_sky_fov
from .sky import CompositeModel

__all__ = ["RIME"]


def _grad_leaves(mod):
    """{dotted path: tensor} of a module tree's tensors that carry
    gradients: its Parameters, and the leaves a functional update
    (Module.updated) put in their place."""
    out = {}
    for prefix, m in mod.named_modules():
        items = list(m._parameters.items()) + [
            (k, v) for k, v in m.__dict__.items()
            if isinstance(v, torch.Tensor)]
        for k, v in items:
            if v is not None and v.requires_grad:
                out[f"{prefix}.{k}" if prefix else k] = v
    return out


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


class RIME(Module):
    """The sky-integral RIME forward model.

    Tensors it precomputes take the device and dtype of the array's
    antenna positions. use_kernel is passed to rime_reduce ("auto": the
    fused kernel on CUDA for eligible problems). remat: checkpoint each
    time step (psky and the reduction), trading the forward's reduction
    again in the backward for the step's saved tensors.

    vis_sharding: which axes of the visibilities (Npol, Npol, Nbls,
    Ntimes, Nfreqs) are partitioned over which mesh axes, a 5-tuple of
    axis names or None. ``parallel.shard_rime`` sets it on a rank's copy
    (times over the time axis, baselines over the baseline axis), and
    ``parallel.ShardedLogProb`` reads it to cut the targets the same
    way. None on an unsharded RIME.
    """

    def __init__(self, sky, telescope, beam, array, sim_bls, times, freqs,
                 data_bls=None, name=None, pix_chunk=1024, remat=False,
                 time_mode="scan", use_kernel="auto", vis_sharding=None):
        super().__init__(name=name)
        if time_mode not in ("scan", "vmap"):
            raise ValueError(f"unknown time_mode {time_mode!r}")
        self.sky = sky
        self.telescope = telescope
        self.beam = beam
        self.array = array
        self.pix_chunk = pix_chunk
        self.remat = remat
        self.time_mode = time_mode
        self.use_kernel = use_kernel
        self.vis_sharding = vis_sharding
        self.setup_freqs(freqs)
        self.setup_sim_bls(sim_bls, data_bls)
        self.setup_sim_times(times)
        self.precompute()

    # ------------------------------------------------------------ setup
    def setup_freqs(self, freqs):
        """The channels [Hz] to simulate (the array gets them too). The
        precompute does not depend on them, so a frequency minibatch is
        setup_freqs(f[idx]) with the sky's R.set_freq_index(idx) and the
        beam's freq_interp(f[idx]); a regular grid keeps the fused
        kernel."""
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.Nfreqs = len(self.freqs)
        self.array.set_freqs(self.freqs)

    def setup_sim_bls(self, sim_bls, data_bls=None):
        """Baseline groups (a dict, a list of lists, or one list of
        baselines), their antenna indices on the device, and per group
        the sim -> data expansion index for redundant data."""
        if isinstance(sim_bls, dict):
            groups = {k: [tuple(b) for b in v] for k, v in sim_bls.items()}
        elif isinstance(sim_bls[0], tuple):
            groups = {0: [tuple(b) for b in sim_bls]}
        else:
            groups = {i: [tuple(b) for b in g] for i, g in enumerate(sim_bls)}
        self.sim_bl_groups = groups
        self.all_sim_bls = flatten(groups.values())
        self.Nbl_groups = len(groups)
        self.bl_group_id = 0
        dev = self.array.antvecs.device
        self._blidx_groups = {
            k: tuple(torch.as_tensor(ix, device=dev)
                     for ix in self.array.bl_index(v))
            for k, v in groups.items()}
        self.data_bl_groups, self._sim2data = {}, {}
        bl2red = self.array.bl2red
        for k, blg in groups.items():
            if data_bls is None:
                self.data_bl_groups[k] = list(blg)
                self._sim2data[k] = None
                continue
            # group -> first simulated baseline of that group
            sim_of = {}
            for i, bl in enumerate(blg):
                sim_of.setdefault(bl2red[bl], i)
            dbls = [tuple(bl) for bl in data_bls
                    if bl2red[tuple(bl)] in sim_of]
            if set(sim_of) != {bl2red[bl] for bl in dbls}:
                raise ValueError(
                    "non-overlapping bl type(s) in data_bls and sim_bls")
            self.data_bl_groups[k] = dbls
            self._sim2data[k] = torch.as_tensor(
                [sim_of[bl2red[bl]] for bl in dbls], device=dev)
        self._data_blnums = {k: ants2blnum(v)
                             for k, v in self.data_bl_groups.items()}
        if hasattr(self, "_pre"):
            self.precompute()

    def setup_sim_times(self, times):
        """Time groups: a dict, a list of arrays, or one array (2D: one
        group a row)."""
        if isinstance(times, dict):
            groups = {k: np.asarray(v, dtype=np.float64)
                      for k, v in times.items()}
        elif isinstance(times, list) and np.ndim(times[0]) > 0:
            groups = {i: np.asarray(t, dtype=np.float64)
                      for i, t in enumerate(times)}
        else:
            t = np.atleast_1d(np.asarray(times, dtype=np.float64))
            groups = {0: t} if t.ndim == 1 else \
                {i: t[i] for i in range(t.shape[0])}
        self.sim_time_groups = groups
        self.all_sim_times = np.concatenate(list(groups.values()))
        self.Ntime_groups = len(groups)
        self.time_group_id = 0
        if hasattr(self, "_pre"):
            self.precompute()

    # ----------------------------------------------------- batching API
    @property
    def Ntimes_all(self):
        return len(self.all_sim_times)

    @property
    def Nbls_all(self):
        return len(self.all_sim_bls)

    @property
    def Nbatch(self):
        return self.Nbl_groups * self.Ntime_groups

    @property
    def batch_idx(self):
        return self.time_group_id * self.Nbl_groups + self.bl_group_id

    @batch_idx.setter
    def batch_idx(self, val):
        if not 0 <= val < self.Nbatch:
            raise ValueError(f"batch_idx {val} not in [0, {self.Nbatch})")
        self.time_group_id = int(val // self.Nbl_groups)
        self.bl_group_id = int(val % self.Nbl_groups)

    @property
    def sim_bls(self):
        return self.sim_bl_groups[self.bl_group_id]

    @property
    def data_bls(self):
        return self.data_bl_groups[self.bl_group_id]

    @property
    def sim_times(self):
        return self.sim_time_groups[self.time_group_id]

    @property
    def Npix_cut(self):
        """Padded FOV pixels of the active time group's first sky
        component."""
        return int(self._pre[(self.time_group_id, 0)][0]["cut"].shape[0])

    # ------------------------------------------------------- precompute
    def _sky_components(self):
        if isinstance(self.sky, CompositeModel):
            return list(self.sky.models.values())
        return [self.sky]

    def precompute(self):
        """Per (time group, sky component) and time: the beam's zen / az
        (pointing offset folded in), the padded FOV cut and mask, the
        pointing vectors / c of the cut pixels (true angles) and the beam
        response's interpolation ctx where it has one, as tensors; and
        per baseline group the model pairs."""
        dev, rdt = self.array.antvecs.device, self.array.antvecs.dtype

        def t(x, dtype=rdt):
            return torch.as_tensor(x, dtype=dtype, device=dev)
        self._pre = {}
        for tg, times in self.sim_time_groups.items():
            for ci, comp in enumerate(self._sky_components()):
                ra, dec = comp.angs_np[0], comp.angs_np[1]
                raw = [self.telescope.eq2top(tm, ra, dec) for tm in times]
                ncut = max(int((zen < self.beam.fov / 2).sum())
                           for zen, _ in raw)
                # pad to a multiple of the pixel chunk (or of 8)
                base = self.pix_chunk if ncut >= self.pix_chunk else 8
                pad = int(np.ceil(max(ncut, 1) / base) * base)
                pres = []
                for zen, az in raw:
                    cut, mask = self.beam.fov_cut(zen, pad_to=pad)
                    zen_c, az_c = zen[cut], az[cut]
                    # s in the working dtype, then / c there, as the
                    # JAX package does
                    s_c = t(self.array.s_vector(zen_c, az_c)) / C_MS
                    zen_b, az_b = self.beam.apply_pointing(zen_c, az_c)
                    pre = dict(zen=t(zen_b), az=t(az_b),
                               cut=t(cut, torch.int64), mask=t(mask),
                               s_c=s_c)
                    if hasattr(self.beam.R, "precompute"):
                        inds, wgts = self.beam.R.precompute(zen_b, az_b)
                        pre["ctx"] = (t(inds, torch.int64), t(wgts))
                    pres.append(pre)
                self._pre[(tg, ci)] = pres
        self._mp_groups = {}
        for k, bls in self.sim_bl_groups.items():
            mp1, mp2, mp_idx = self.beam.modelpairs(bls)
            self._mp_groups[k] = (t(mp1, torch.int64), t(mp2, torch.int64),
                                  mp_idx)

    # ---------------------------------------------------------- forward
    def _sim_component(self, sky, pres, blvecs, mp1, mp2, mp_idx, beam):
        """Simulate one sky component (Nvec, Nvec, Nfreqs, Npix) over the
        active time group: (Npol, Npol, Nsim_bls, Ntimes, Nfreqs)."""
        # the checkpoints hold memory down for a backward; forward-mode AD
        # (compute_hessian's rows) does without them: torch 2.11's
        # checkpoint has no jvp, and the pixel chunks of rime_reduce
        # still keep only their inputs
        grad = torch.is_grad_enabled() and not dual_active()
        fused = airy_psky.fused_eligible(beam, sky, pres[0]["zen"])

        def make_psky(sky, zen, az, cut, mask, *ctx):
            with span("bl.psky"):
                if fused:
                    return airy_psky.airy_psky(beam, sky, zen, az, cut,
                                               mask, mp1)
                csky = cut_sky_fov(sky, cut) * mask
                b = beam.gen_beam(zen, az, ctx=ctx or None,
                                  angles_offset=True)
                return beam.apply_beam_mp(b, mp1, mp2, csky)

        def one_time(sky, blvecs, pre, nested):
            args = (sky, pre["zen"], pre["az"], pre["cut"], pre["mask"]) \
                + pre.get("ctx", ())
            # psky's eager construction chains many (Nfreqs, Ncut)
            # intermediates: checkpoint it, so the backward keeps only
            # psky per time and recomputes the rest (the beam and sky
            # hold no randomness); the fused Function saves only its
            # inputs, so a checkpoint would only add a forward
            psky = _ckpt(make_psky, *args) if nested and not fused \
                else make_psky(*args)
            with span("bl.rime"):
                return rime_reduce(psky, None, self.freqs, mp_idx=mp_idx,
                                   chunk=self.pix_chunk,
                                   use_kernel=self.use_kernel,
                                   blvecs=blvecs, s_c=pre["s_c"])

        vis_t = []
        for pre in pres:
            if self.remat and grad:
                vis_t.append(_ckpt(lambda s, b, p=pre: one_time(s, b, p,
                                                                False),
                                   sky, blvecs))
            else:
                vis_t.append(one_time(sky, blvecs, pre, grad))
        return torch.stack(vis_t, dim=3)           # (Np, Np, Nb, Nt, Nf)

    def forward(self, *args, prior_cache=None, **kwargs):
        """Forward model -> VisData (Npol, Npol, Ndata_bls, Ntimes,
        Nfreqs) of the active batch; the sky's and the beam's priors go
        into prior_cache."""
        with span("bl.sky"):
            comps = self.sky(prior_cache=prior_cache)
        if not isinstance(comps, list):
            comps = [comps]
        bg = self.bl_group_id
        a1, a2 = self._blidx_groups[bg]
        blvecs = self.array.antvecs[a2] - self.array.antvecs[a1]
        mp1, mp2, mp_idx = self._mp_groups[bg]
        mpdev = getattr(self, "_mp_idx_dev", None)
        if mpdev is not None and bg in mpdev:
            mp_idx = mpdev[bg]
        # pixel shards: each rank reduces its own pixels of replicated
        # inputs; their gradients are summed over the pixel group
        pix = getattr(self, "_pix_comm", None)
        beam = self.beam
        if pix is not None:
            blvecs = pix.copy_in(blvecs)
            beam = beam.updated({k: pix.copy_in(v)
                                 for k, v in _grad_leaves(beam).items()})
        vis = None
        for ci, comp in enumerate(comps):
            sky = comp.data if pix is None else pix.copy_in(comp.data)
            v = self._sim_component(sky, self._pre[(self.time_group_id, ci)],
                                    blvecs, mp1, mp2, mp_idx, beam)
            vis = v if vis is None else vis + v
        if pix is not None:
            vis = pix.sum_in(vis)
        if self._sim2data[bg] is not None:
            with span("bl.expand"):
                gather = getattr(self, "_sim_gather", None)
                if gather is not None:
                    vis = gather(vis)
                vis = vis.index_select(2, self._sim2data[bg])
        self.beam.eval_prior(prior_cache, inp_params=self.beam.params)
        pol = None
        if self.beam.Npol == 1 and self.beam.pol is not None:
            pol = f"{self.beam.pol}{self.beam.pol}"
        vd = VisData()
        vd.setup_meta(self.telescope, self.array.to_antpos())
        vd.setup_data(self._data_blnums[bg], self.sim_times, self.freqs,
                      pol=pol, data=vis, history=f"RIME forward ({self.name})")
        return vd

    def run_batches(self, concat=True):
        """Forward every batch; concat=True joins them along baselines
        within a time group, then along time; else a list by batch."""
        vis_times, vis_bls = [], []
        for i in range(self.Nbatch):
            self.batch_idx = i
            vis_bls.append(self.forward())
            if self.bl_group_id == self.Nbl_groups - 1:
                if concat:
                    vis_times.append(concat_VisData(vis_bls, "bl"))
                else:
                    vis_times.extend(vis_bls)
                vis_bls = []
        self.batch_idx = 0
        return concat_VisData(vis_times, "time") if concat else vis_times
