"""
Sharding of the log-posterior over the ranks of torch.distributed.

Counterpart of bayeslim_tpu/parallel/sharding.py (make_mesh :74,
replicate :85, shard_rime :93, shard_visdata :166, ShardedLogProb :194
with its chain walk :251-296, smap_value_and_grad :298 and the shard_map
closure :430-735, shard_pixels :738, DistributedLogProb :784).

The JAX package shards one SPMD program under one controller
(NamedSharding on global arrays, shard_map with psum). Here every rank
is a process (parallel/multihost.py) that

- builds the same full posterior as every other rank (host metadata is
  deterministic: the JAX module's invariant);
- keeps its block of the times (the mesh's time axis, 'data') and / or
  of the baselines (the baseline axis, 'model'): the RIME's per-time
  precompute and time groups, its baseline groups, baseline indices
  and model-pair map, the targets (5-d data, flags, icov and cov; the
  6-d structured covariances by their cov_axis) and the chain blocks'
  pinned baseline indices (JonesModel, RedVisModel);
- evaluates its local chi^2 with the ordinary port, the fused kernels
  included, and its gradient by a local backward;
- sums the chi^2 (in float64) and the gradients over the group of the
  mesh axes that partition the data: a mesh axis that partitions
  nothing holds replicas, and a sum over it would multiply the
  likelihood by its size;
- adds the Gaussian normalisation of the global target once, and the
  prior, evaluated on replicated parameters (a sharded one gathered),
  once.

Under baseline sharding with redundant sim -> data expansion the
simulated cube (its Nsim rows: small) is gathered across the baseline
group in the middle of the forward, and each rank expands onto its own
data rows; the gather's backward sums the cotangent over the group.
Every sum adds in rank order on every rank (parallel/collectives.py),
so losses, gradients and hence an optimizer's or a sampler's decisions
are bit-identical across ranks. Parameters are replicated unless
param_shardings cuts them.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..inference.prob import _walk_priors
from ..utils.indexing import ants2blnum, flatten
from ..utils.module import _shallow
from ..utils.paramdict import ParamDict
from . import collectives as C
from .multihost import global_put, local_block, process_count, process_index

__all__ = ["make_mesh", "shard_rime", "shard_visdata", "shard_pixels",
           "ShardedLogProb", "DistributedLogProb", "replicate"]

# host baseline metadata of a chain block that exposes no set_bls: its
# indices cannot follow a rank's baseline shard
_HOST_BL_ATTRS = ("filt2bls", "bls", "bl2red")


class Mesh:
    """Named axes over the ranks, row-major (the JAX package's
    devices.reshape(shape)): axis_names, shape, this rank's coordinate
    on each axis, and a process group for each set of axes (group(axes):
    the ranks that differ from this one only along those axes; None for
    a group of one rank). Every rank must ask for the groups in the same
    order (torch.distributed.new_group's rule); the constructor makes
    one for each axis."""

    def __init__(self, axis_sizes, ranks):
        self.axis_names = tuple(axis_sizes)
        self.shape = tuple(int(v) for v in axis_sizes.values())
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(self.shape)
        if np.any(np.diff(self.ranks.ravel()) <= 0):
            raise ValueError("make_mesh: devices (ranks) must increase")
        where = np.argwhere(self.ranks == process_index())
        if len(where) != 1:
            raise ValueError(f"rank {process_index()} is not on the mesh")
        self.coords = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self._groups = {}
        for a in self.axis_names:
            self.group(a)

    @property
    def axis_sizes(self):
        return dict(zip(self.axis_names, self.shape))

    def _axes(self, axes):
        if axes is None or isinstance(axes, str):
            axes = (axes,)
        axes = {a for a in axes if a is not None}
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"no mesh axis {a!r} in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes):
        return int(np.prod([self.axis_sizes[a] for a in self._axes(axes)],
                           dtype=np.int64))

    def coord(self, axis):
        return self.coords[axis]

    def group(self, axes):
        axes = self._axes(axes)
        if axes not in self._groups:
            mine = None
            if self.size(axes) > 1:
                other = [i for i, a in enumerate(self.axis_names)
                         if a not in axes]
                for at in itertools.product(*(range(self.shape[i])
                                              for i in other)):
                    sel = [slice(None)] * len(self.shape)
                    for i, c in zip(other, at):
                        sel[i] = c
                    members = self.ranks[tuple(sel)].ravel().tolist()
                    g = dist.new_group(ranks=members)
                    if process_index() in members:
                        mine = g
            self._groups[axes] = mine
        return self._groups[axes]


def make_mesh(axis_sizes, devices=None):
    """Mesh of {'data': n_dp, 'model': n_tp, ...} over the ranks
    (devices: the ranks in increasing order, default all of them; every
    rank is on the mesh). Call it on every rank, after
    multihost.initialize when there is more than one."""
    ranks = list(range(process_count())) if devices is None \
        else list(devices)
    n = int(np.prod(list(axis_sizes.values()), dtype=np.int64))
    if n != len(ranks):
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n} ranks, have "
                         f"{len(ranks)}")
    return Mesh(axis_sizes, ranks)


def replicate(tree, mesh):
    """Every tensor or array of a dict / list / tuple tree on the rank's
    device (multihost.global_put's rule: a numpy array goes to the card
    unless the rank was initialized on another device), whole: a host
    copy that every rank builds is replicated as it stands."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return global_put(tree, (), mesh)
    if isinstance(tree, dict):
        return type(tree)({k: replicate(v, mesh) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def _axis(mesh, axis):
    """(size, this rank's coordinate) of a mesh axis; (1, 0) for None."""
    return (1, 0) if axis is None else (mesh.size(axis), mesh.coord(axis))


def _cut(x, dims):
    """A copy of x's block {dim: (lo, hi)} (a copy, so that the full
    tensor can be freed)."""
    for d, (lo, hi) in dims.items():
        x = x.narrow(d, lo, hi - lo)
    return x.clone()


def shard_rime(rime, mesh, time_axis="data", bl_axis=None, inplace=False):
    """This rank's block of a RIME: its times of every time group over
    time_axis, and its baselines of every baseline group over bl_axis.

    A shallow copy by default (inplace=False): the wrapped model stays
    valid for single-process use, and the copy shares its sky, beam and
    array (their parameters are replicated).
    - Times: the per-time precompute ``_pre[(time group, component)]``
      and the time groups keep this rank's contiguous block.
    - Baselines: the simulated baselines of each group, their antenna
      indices ``_blidx_groups`` and the host baseline -> model-pair map
      keep this rank's block. No device map (``_mp_idx_dev``) is pinned:
      unlike one traced JAX program, a rank regroups its own baselines by
      model pair on the host, one kernel launch a pair over that pair's
      baselines (1x the kernel's triples, where the device map's
      mask-select costs Nmp x; ops/rime_kernel._rime_fused_dispatch).
    - Redundant data (sim -> data expansion): Nsim and Ndata must divide
      by the baseline axis' size; the rank simulates its block of the
      Nsim groups, gathers the whole simulated cube over the baseline
      group (``_sim_gather``) and expands it onto its block of the data
      baselines.
    - vis_sharding becomes (None, None, bl_axis, time_axis, None) over
      (Npol, Npol, Nbls, Ntimes, Nfreqs).
    """
    if not inplace:
        rime = rime.copy()
    nt, it = _axis(mesh, time_axis)
    nb, ib = _axis(mesh, bl_axis)
    if nt > 1:
        groups, pre = {}, {}
        for tg, times in rime.sim_time_groups.items():
            lo, hi = local_block(len(times), nt, it)
            if hi == lo:
                raise ValueError(f"time group {tg} has {len(times)} times, "
                                 f"fewer than the '{time_axis}' axis' {nt}")
            groups[tg] = times[lo:hi]
            for (tg2, ci), pres in rime._pre.items():
                if tg2 == tg:
                    pre[(tg, ci)] = pres[lo:hi]
        rime.sim_time_groups = groups
        rime.all_sim_times = np.concatenate(list(groups.values()))
        rime._pre = pre
    if nb > 1:
        sims, blidx, mpg, data, s2d_loc = {}, {}, {}, {}, {}
        for k, bls in rime.sim_bl_groups.items():
            s2d = rime._sim2data[k]
            if s2d is not None and (len(bls) % nb or len(s2d) % nb):
                raise AssertionError(
                    f"bl_axis expansion needs Nsim ({len(bls)}) and Ndata "
                    f"({len(s2d)}) divisible by the '{bl_axis}' axis size "
                    f"{nb}")
            lo, hi = local_block(len(bls), nb, ib)
            if hi == lo:
                raise ValueError(f"baseline group {k} has {len(bls)} "
                                 f"baselines, fewer than {nb} shards")
            sims[k] = bls[lo:hi]
            a1, a2 = rime._blidx_groups[k]
            blidx[k] = (a1[lo:hi], a2[lo:hi])
            mp1, mp2, mp_idx = rime._mp_groups[k]
            mpg[k] = (mp1, mp2,
                      None if mp_idx is None else np.asarray(mp_idx)[lo:hi])
            if s2d is None:
                data[k], s2d_loc[k] = sims[k], None
            else:
                dlo, dhi = local_block(len(s2d), nb, ib)
                data[k] = rime.data_bl_groups[k][dlo:dhi]
                s2d_loc[k] = s2d[dlo:dhi]
        rime.sim_bl_groups, rime._blidx_groups, rime._mp_groups = \
            sims, blidx, mpg
        rime.all_sim_bls = flatten(sims.values())
        rime.data_bl_groups, rime._sim2data = data, s2d_loc
        rime._data_blnums = {k: ants2blnum(v) for k, v in data.items()}
        if any(v is not None for v in s2d_loc.values()):
            rime._sim_gather = functools.partial(
                C.gather, group=mesh.group(bl_axis), dim=2, mode="sum")
    rime.vis_sharding = (None, None, bl_axis, time_axis, None)
    return rime


def shard_visdata(vd, mesh, time_axis="data", bl_axis=None):
    """This rank's block of a VisData (in place; pass a copy): the
    (Npol, Npol, Nbls, Ntimes, Nfreqs) arrays over (bl_axis, time_axis),
    and a structured covariance by its cov_axis: 'bl' (P, P, T, F, B, B)
    over times only, 'freq' (P, P, B, T, F, F) over baselines and times,
    'time' (P, P, B, F, T, T) over baselines only (the JAX package's
    cov_specs). cov_ndim and cov_logdet stay the global target's."""
    nt, it = _axis(mesh, time_axis)
    nb, ib = _axis(mesh, bl_axis)
    b = local_block(vd.Nbls, nb, ib)
    t = local_block(vd.Ntimes, nt, it)
    cov_dims = {"bl": {2: t}, "freq": {2: b, 3: t}, "time": {2: b}}
    for f in ("data", "flags", "icov", "cov"):
        v = getattr(vd, f, None)
        if not isinstance(v, torch.Tensor):
            continue
        if v.ndim == 5:
            setattr(vd, f, _cut(v, {2: b, 3: t}))
        elif v.ndim == 6 and vd.cov_axis in cov_dims:
            setattr(vd, f, _cut(v, cov_dims[vd.cov_axis]))
    vd.blnums = vd.blnums[b[0]:b[1]]
    vd.times = vd.times[t[0]:t[1]]
    return vd


def _walk_chain_blocks(model):
    """(container, key, block) of every block of a (possibly nested)
    Sequential."""
    if not hasattr(model, "models"):
        return
    for k, m in list(model.models.items()):
        if hasattr(m, "models"):
            yield from _walk_chain_blocks(m)
        else:
            yield model.models, k, m


def _copy_chain(seq):
    """A Sequential whose models containers (nested ones too) are its
    own, so replacing a block leaves the caller's chain as it was."""
    seq = _shallow(seq)
    seq._modules["models"] = _shallow(seq.models)
    for k, m in list(seq.models.items()):
        if hasattr(m, "models"):
            seq.models._modules[k] = _copy_chain(m)
    return seq


def _bl_index_leaves(m):
    """A chain block's pinned baseline-index tensors (set_bls: JonesModel
    _g1_idx / _g2_idx, RedVisModel _red_idx)."""
    return [n for n in ("_g1_idx", "_g2_idx", "_red_idx")
            if getattr(m, n, None) is not None]


def _with_leaf(model, path, value):
    """A copy of the module tree (along path only) whose leaf at the
    dotted path is value (a Parameter if the leaf was one)."""
    parts = path.split(".")
    new = _shallow(model)
    obj = new
    for p in parts[:-1]:
        child = _shallow(obj._modules[p])
        obj._modules[p] = child
        obj = child
    last = parts[-1]
    if last in obj._parameters:
        obj._parameters[last] = nn.Parameter(
            value, requires_grad=obj._parameters[last].requires_grad)
    elif last in obj._buffers:
        obj._buffers[last] = value
    else:
        obj.__dict__[last] = value
    return new


class ShardedLogProb:
    """Data / model-parallel LogProb over the ranks of a mesh.

    The counterpart of the JAX package's ShardedLogProb (and of the
    reference's DistributedLogProb). Wraps a LogProb whose model is a
    RIME, or a Sequential holding one at its top level; every rank wraps
    the same LogProb and keeps its block of times (time_axis) and of
    baselines (bl_axis) (module docstring). The wrapped LogProb stays
    valid for single-process use; ``prob`` is this rank's local one.

    value_and_grad(pdict) returns, on every rank, the loss and the
    gradient of the whole posterior, bit-identical across ranks.
    Optimizers and samplers drive it unchanged (value_and_grad,
    collect_main_params, update, __call__).

    param_shardings: {pdict key: spec}, spec naming for each leading
    dimension of the parameter the mesh axis it is cut over (None:
    whole), e.g. per-time gains under time sharding: {'models.cal.params':
    (None, None, None, 'data', None)}. The rank's model then holds its
    slice, collect_main_params and the gradient are that slice, and a
    pdict value of the full shape is cut on the way in. Priors of such a
    key must come from LogProb's prior_dict (evaluated on the gathered
    global value); module-attached priors are refused, as in the JAX
    package. An optimizer that takes dot products over the parameters
    (L-BFGS) would see only the local slice: use elementwise ones there.

    Refused under bl_axis: chain blocks that keep baseline indices as
    host metadata and expose no set_bls (WedgeFilter's filt2bls,
    VisCoupling's bls, ...): their indices cannot follow a baseline shard
    (time sharding carries them). Blocks that expose set_bls are pinned
    to the target's baselines (if not already), checked against them,
    and cut to the rank's rows. Structured covariances: 'freq' under
    either axis, 'bl' only without bl_axis, 'time' only without
    time_axis.
    """

    def __init__(self, prob, mesh=None, time_axis="data", bl_axis=None,
                 param_shardings=None):
        if mesh is None:
            mesh = make_mesh({"data": process_count()})
        self.mesh = mesh
        self.time_axis = time_axis
        self.bl_axis = bl_axis
        for a in (time_axis, bl_axis):
            if a is not None:
                mesh._axes(a)
        self.data_axes = tuple(a for a in (time_axis, bl_axis)
                               if a is not None)
        self.group = mesh.group(self.data_axes)
        self.param_shardings = None if param_shardings is None else {
            k: tuple(v) for k, v in param_shardings.items()}
        targets = list(prob.target)
        # the global targets' normalisation (added once); the targets
        # themselves are not kept, only this rank's blocks of them
        self._norms = [(t.icov is not None and t.cov_logdet is not None,
                        t.cov_ndim, t.cov_logdet) for t in targets]
        for t in targets:
            ca = getattr(t, "cov_axis", None)
            if ca is None:
                continue
            allowed = ["freq"] + (["bl"] if bl_axis is None else []) \
                + (["time"] if time_axis is None else [])
            if ca not in allowed:
                raise AssertionError(
                    f"cov_axis '{ca}' couples an axis this sharding "
                    f"partitions (allowed here: {allowed})")

        prob = _shallow(prob)
        model = prob.model
        if hasattr(model, "_pre"):
            prob.model = rime = shard_rime(model, mesh, time_axis, bl_axis)
        else:
            if not hasattr(model, "models"):
                raise AssertionError("ShardedLogProb needs a RIME in the "
                                     "model")
            seq = _copy_chain(model)
            k = next((k for k, m in seq.models.items()
                      if hasattr(m, "_pre")), None)
            if k is None:
                raise AssertionError("ShardedLogProb needs a RIME in the "
                                     "model")
            seq.models[k] = rime = shard_rime(seq.models[k], mesh,
                                              time_axis, bl_axis)
            prob.model = seq
        # the targets are cut as the RIME's visibilities are
        _, _, vis_bl, vis_t, _ = rime.vis_sharding
        prob.target = [
            shard_visdata(t.copy(), mesh, vis_t, vis_bl)
            if hasattr(t, "blnums") else t for t in targets]
        if bl_axis is not None and hasattr(prob.model, "models"):
            self._pin_chain(prob.model, targets[0] if targets else None)
        if self.param_shardings:
            for k, spec in self.param_shardings.items():
                full = prob.model[k]
                for d, a in enumerate(spec):
                    if a is not None and full.shape[d] % mesh.size(a):
                        raise ValueError(
                            f"param_shardings: {k} dim {d} "
                            f"({full.shape[d]}) does not divide by the "
                            f"'{a}' axis size {mesh.size(a)}")
                prob.model = _with_leaf(prob.model, k, global_put(
                    full.detach(), spec, mesh, device=full.device))
        self.prob = prob

    def _pin_chain(self, model, tgt0):
        """The JAX chain walk (:251-296) under baseline sharding: pin
        set_bls blocks to the target's baselines, check pinned indices
        against them, cut them to this rank's rows; refuse blocks with
        host baseline metadata."""
        nb, ib = _axis(self.mesh, self.bl_axis)
        has_bls = tgt0 is not None and hasattr(tgt0, "blnums")
        for container, k2, m in _walk_chain_blocks(model):
            if hasattr(m, "_pre"):
                continue
            names = _bl_index_leaves(m)
            if not names and hasattr(m, "set_bls") and has_bls:
                m = m.copy()
                m.set_bls(np.asarray(tgt0.blnums))
                names = _bl_index_leaves(m)
            if not names:
                if hasattr(m, "set_bls") or any(hasattr(m, a)
                                                for a in _HOST_BL_ATTRS):
                    raise AssertionError(
                        f"bl_axis sharding: chain block '{k2}' "
                        f"({type(m).__name__}) indexes baselines via host "
                        f"metadata; its indices cannot follow a baseline "
                        f"shard (use time sharding)")
                continue
            if has_bls:
                if "_g1_idx" in names:
                    g1e, g2e = m.ant_index(tgt0.blnums)
                    ok = (np.array_equal(m._g1_idx.cpu().numpy(), g1e)
                          and np.array_equal(m._g2_idx.cpu().numpy(), g2e))
                else:
                    ok = np.array_equal(m._red_idx.cpu().numpy(),
                                        m.red_index(tgt0.blnums))
                assert ok, (f"chain block '{k2}': set_bls indices do not "
                            f"match the target's baselines/order - "
                            f"re-call set_bls with the target's bls")
            m = m.copy()
            for n in names:
                idx = getattr(m, n)
                lo, hi = local_block(len(idx), nb, ib)
                setattr(m, n, idx[lo:hi].clone())
            container[k2] = m

    # --- the wrapped prob's surface ---------------------------------------
    @property
    def model(self):
        return self.prob.model

    @property
    def Nbatch(self):
        return self.prob.Nbatch

    @property
    def grad_mods(self):
        return self.prob.grad_mods

    @property
    def main_params(self):
        return self.prob.main_params

    def collect_main_params(self):
        """The rank's main params: replicated ones whole, param_shardings
        keys as the rank's slice."""
        return self.prob.collect_main_params()

    def send_main_params(self, main_params=None, **kwargs):
        """Into the rank's model (every rank sends the same values)."""
        return self.prob.send_main_params(main_params=main_params, **kwargs)

    def set_main_params(self, *args, **kwargs):
        return self.prob.set_main_params(*args, **kwargs)

    def sort_main_params(self, *args, **kwargs):
        return self.prob.sort_main_params(*args, **kwargs)

    def update(self, pdict):
        self.prob.update(self._local_pdict(pdict))

    # --- evaluation -------------------------------------------------------
    def _local_pdict(self, pdict):
        """pdict with param_shardings keys of the full shape cut to this
        rank's slice."""
        if pdict is None or not self.param_shardings:
            return pdict
        out = dict(pdict.items())
        for k, spec in self.param_shardings.items():
            if k in out and tuple(out[k].shape) != tuple(
                    self.prob.model[k].shape):
                out[k] = global_put(out[k], spec, self.mesh,
                                    device=out[k].device)
        return ParamDict(out)

    def _norm(self, idx):
        has, ndim, logdet = self._norms[idx % len(self._norms)]
        if not has:
            return 0.0
        if self.prob.complex_circular:
            return ndim * np.log(np.pi) + logdet
        return 0.5 * (ndim * np.log(2 * np.pi) + logdet)

    def _log_prior(self, leaves, prior_cache):
        """The prior of the whole parameters: prior_dict on global values
        (a param_shardings key gathered over its axes), else the
        module-attached priors, refused with param_shardings."""
        prob = self.prob
        ps = self.param_shardings
        if not ps or prob.prior_dict is None:
            walked = {}
            if ps and not prior_cache:
                _walk_priors(prob._model_at(leaves), walked)
            if ps and (prior_cache or walked):
                raise AssertionError(
                    "param_shardings with module-attached priors would "
                    "count only one shard's prior; attach priors via "
                    "LogProb's prior_dict instead (evaluated on global "
                    "parameters)")
            return prob._log_prior(leaves, prior_cache)
        model = prob._model_at(leaves)
        logprior = 0.0
        for key, pr in prob.prior_dict.items():
            val = model[key]
            for d, a in enumerate(ps.get(key, ())):
                if a is not None:
                    val = C.gather(val, self.mesh.group(a), d, "slice")
            for p in pr if isinstance(pr, (list, tuple)) else [pr]:
                logprior = logprior + p(val)
        return logprior

    def _sum_grads(self, grads):
        """Gradients summed over the ranks that share each leaf: a
        replicated leaf over every data axis, a param_shardings leaf over
        the data axes it is not cut along; one all-gather a group."""
        ps = self.param_shardings or {}
        by_group = {}
        for k in grads:
            axes = tuple(a for a in self.data_axes if a not in ps.get(k, ()))
            by_group.setdefault(axes, []).append(k)
        out = dict(grads)
        for axes, keys in by_group.items():
            group = self.mesh.group(axes)
            if C.group_size(group) == 1:
                continue
            flat = [torch.view_as_real(grads[k]) if grads[k].is_complex()
                    else grads[k] for k in keys]
            dt = flat[0].dtype
            same = all(f.dtype == dt for f in flat)
            parts = [f.reshape(-1) if same else f.reshape(-1).double()
                     for f in flat]
            total = C.sum_over(torch.cat(parts), group)
            i = 0
            for k, f in zip(keys, flat):
                g = total[i:i + f.numel()].reshape(f.shape).to(f.dtype)
                i += f.numel()
                out[k] = torch.view_as_complex(g.contiguous()) \
                    if grads[k].is_complex() else g
        return out

    def _local_terms(self, leaves, idx):
        """(local chi^2, prior or None) of batch idx on this rank, with
        their graphs."""
        prob = self.prob
        chisq, _, pc = prob.forward_chisq(leaves, idx)
        prior = None
        if prob.compute == "post" and prob.batch_idx == 0:
            prior = self._log_prior(leaves, pc)
            if not isinstance(prior, torch.Tensor):
                prior = None        # no priors: 0.0
        return chisq, prior

    def _batch(self, leaves, idx, grad):
        """(loss, gradients or None) of batch idx, global on every rank."""
        prob = self.prob
        c = 1.0 if prob.complex_circular else 0.5
        sign = 1.0 if prob.negate else -1.0
        chisq, prior = self._local_terms(leaves, idx)
        idx = prob.batch_idx
        chisq_all = C.sum_over(chisq.detach(), self.group)
        loss = sign * (c * chisq_all + self._norm(idx))
        if prior is not None:
            loss = loss - sign * prior.detach()
        if not grad:
            return loss, None
        keys = list(leaves.keys())
        ts = [leaves[k] for k in keys]

        def grads_of(obj, retain):
            if not obj.requires_grad:
                return [None] * len(ts)
            return torch.autograd.grad(obj, ts, allow_unused=True,
                                       retain_graph=retain)
        gl = grads_of(sign * c * chisq, prior is not None)
        g = {k: torch.zeros_like(t) if x is None else x
             for k, t, x in zip(keys, ts, gl)}
        g = self._sum_grads(g)
        if prior is not None:
            for k, x in zip(keys, grads_of(-sign * prior, False)):
                if x is not None:
                    g[k] = g[k] + x
        return loss, ParamDict(g)

    def _leaves(self, pdict):
        if pdict is None:
            pdict = self.collect_main_params()
        pdict = self._local_pdict(pdict)
        return ParamDict({k: v.detach().requires_grad_(True)
                          for k, v in pdict.items()})

    def value_and_grad(self, pdict=None):
        """Loss and gradients of the whole posterior on every rank
        (class docstring), accumulated over the batches for
        grad_type='accumulate' (the prior once, with batch 0), after
        grad_modify. The JAX package's value_and_grad (GSPMD) and
        smap_value_and_grad (shard_map) are one path here: each rank
        runs the ordinary port, kernels included, on its local shard."""
        prob = self.prob
        prob.closure_eval += 1
        if prob.compute == "prior":
            return prob.value_and_grad(self._local_pdict(pdict))
        leaves = self._leaves(pdict)
        if prob.grad_type != "accumulate" or prob.Nbatch == 1:
            v, g = self._batch(leaves, None, True)
            return v, prob.grad_modify(g)
        loss = grads = None
        for i in range(prob.Nbatch):
            v, g = self._batch(leaves, i, True)
            loss = v if loss is None else loss + v
            grads = g if grads is None else grads + g
        prob.batch_idx = 0
        return loss / prob.Nbatch, prob.grad_modify(grads)

    smap_value_and_grad = value_and_grad

    def closure(self, pdict=None):
        return self.value_and_grad(pdict)

    def __call__(self, pdict=None, idx=None, **kwargs):
        """The loss of batch idx (default the active one) of the whole
        posterior, on every rank (LogProb.forward's)."""
        prob = self.prob
        if prob.compute == "prior":
            return prob(self._local_pdict(pdict), idx=idx)
        with torch.no_grad():
            leaves = self._local_pdict(pdict)
            return self._batch(leaves, idx, False)[0]

    def local_objective(self, pdict=None, idx=None):
        """This rank's differentiable share of the loss of batch idx:
        its likelihood term, and the prior on the first rank of the data
        group only. Summed over the data group (its value, gradient or
        Hessian) it is the whole posterior's, up to the constant
        normalisation (inference.hessian.compute_hessian)."""
        prob = self.prob
        c = 1.0 if prob.complex_circular else 0.5
        sign = 1.0 if prob.negate else -1.0
        chisq, prior = self._local_terms(self._local_pdict(pdict), idx)
        obj = sign * c * chisq
        if prior is not None and C.group_rank(self.group) == 0:
            obj = obj - sign * prior
        return obj


def shard_pixels(rime, mesh, pix_axis="model", inplace=False):
    """The sky-pixel long axis over the mesh (the JAX package's
    shard_pixels, the sequence-parallel analog).

    Each rank keeps its contiguous block of every time's padded FOV cut
    (the precompute's trailing pixel axis: indices, mask, beam angles,
    pointing vectors, interpolation ctx) and reduces only those pixels:
    the fused kernel runs on the local K (in the JAX package the Pallas
    custom call forced an all-gather, hence its use_pallas=False note).
    The partial visibilities are summed over the pixel group, whose
    backward is the identity (every rank then computes the same loss);
    the replicated inputs of the per-pixel work (the sky map, the beam's
    parameters, the baseline vectors) pass through copy_in, whose
    backward sums their gradients over the group. The sky's parameters
    stay whole on every rank (a rank reads only its cut pixels of the
    sky map), so LogProb(shard_pixels(rime, mesh), tgt).value_and_grad(
    pdict) gives every rank the single-process loss and whole gradient.
    """
    if not inplace:
        rime = rime.copy()
    n, i = _axis(mesh, pix_axis)
    group = mesh.group(pix_axis)
    pre = {}
    for key, pres in rime._pre.items():
        out = []
        for p in pres:
            lo, hi = local_block(p["cut"].shape[-1], n, i)
            q = {k: v[..., lo:hi] for k, v in p.items() if k != "ctx"}
            if "ctx" in p:
                # interpolation ctx: (Nangles, Nnearest)
                q["ctx"] = tuple(a[lo:hi] for a in p["ctx"])
            out.append(q)
        pre[key] = out
    rime._pre = pre
    rime._pix_comm = _PixComm(group)
    return rime


class _PixComm:
    """The pixel group's two collectives, as RIME.forward reads them."""

    def __init__(self, group):
        self.group = group

    def copy_in(self, x):
        return C.copy_in(x, self.group)

    def sum_in(self, x):
        return C.sum_in(x, self.group)


# the reference's name: its DistributedLogProb (optim.py:1391-1628) is the
# single-node data-parallel posterior; the port's is the one above
DistributedLogProb = ShardedLogProb
