"""
Multi-process execution over torch.distributed.

Counterpart of bayeslim_tpu/parallel/multihost.py (initialize :44,
is_initialized :65, process_count / process_index :69-74,
is_multiprocess :77, global_put :81). The JAX package runs one program
under one controller and stitches every process's devices into one
global array; here each rank is a process of its own, started by the
caller (torchrun, or multiprocessing's spawn), which builds the same
host metadata as every other rank (the invariant of the JAX module's
docstring: construction is deterministic, so every rank holds the same
full host copy of targets and precompute), cuts out its local block and
runs the ordinary port, kernels included, on it. Ranks exchange
scalars, gradients and the small simulated cube only
(parallel/sharding.py).

Launch, one process a rank:

    torchrun --nproc-per-node=4 train.py      # or spawn the ranks

    # in train.py, before any sharded work:
    from bayeslim_tpu_torch.parallel import multihost, make_mesh
    multihost.initialize(backend="nccl")      # torchrun's environment
    mesh = make_mesh({"data": multihost.process_count()})
    sprob = ShardedLogProb(prob, mesh)        # the same API

The backend is always the caller's choice: "nccl" for one rank a card,
"gloo" for ranks that share a card (NCCL refuses two ranks on one GPU)
or run on the CPU.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.dtypes import resolve_device

__all__ = ["initialize", "is_initialized", "is_multiprocess", "global_put",
           "process_count", "process_index", "rank_device"]

_STATE = {"initialized": False, "device": None}


def rank_device(device=None, local_rank=None):
    """The rank's device: device if given (the tests pass "cpu"), else
    cuda:{local_rank % device_count}, local_rank from LOCAL_RANK or the
    rank; raises without a GPU (utils.dtypes.resolve_device)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    if local_rank is None:
        local_rank = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout=600.0, device=None):
    """torch.distributed.init_process_group (idempotent).

    With no init_method, world_size or rank, torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT) is read: the
    counterpart of jax.distributed.initialize's detection. backend
    ("nccl" or "gloo") must be given; timeout [s] bounds every
    collective, so that a rank whose peer died fails instead of
    hanging. device: the rank's device (rank_device); None is the
    rank's card."""
    if backend is None:
        raise ValueError(
            "initialize: pass backend='nccl' (one rank a card) or 'gloo' "
            "(ranks sharing a card, or the CPU)")
    if not dist.is_initialized():
        env = os.environ
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=int(env["WORLD_SIZE"]) if world_size is None
            else world_size,
            rank=int(env["RANK"]) if rank is None else rank,
            timeout=datetime.timedelta(seconds=timeout))
    _STATE["device"] = rank_device(device)
    _STATE["initialized"] = True


def is_initialized():
    return _STATE["initialized"]


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess():
    return process_count() > 1


def local_block(n, parts, i):
    """(lo, hi) of block i of range(n) cut into `parts` contiguous
    blocks whose sizes differ by at most one (np.array_split's)."""
    base, extra = divmod(int(n), int(parts))
    lo = i * base + min(i, extra)
    return lo, lo + base + (1 if i < extra else 0)


def global_put(x, spec, mesh, device=None):
    """This rank's block of a full host copy x (identical on every
    rank): spec names, for each leading dimension of x, the mesh axis it
    is cut over (None: whole). The block goes to device; by default the
    initialized rank's device, else a tensor's own, else the rank's card
    (rank_device: raises without a GPU)."""
    if not isinstance(x, torch.Tensor):
        if device is None and _STATE["device"] is None:
            device = rank_device()
        x = torch.as_tensor(np.asarray(x))
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        lo, hi = local_block(x.shape[d], mesh.size(axis), mesh.coord(axis))
        x = x.narrow(d, lo, hi - lo)
    dev = device if device is not None else _STATE["device"]
    return x.contiguous() if dev is None else x.to(dev).contiguous()
