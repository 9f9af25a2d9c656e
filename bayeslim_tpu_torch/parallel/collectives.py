"""
The collectives of the sharded posterior, on torch.distributed.

No counterpart file in the JAX package: there XLA inserts the psums and
all-gathers of one SPMD program (parallel/sharding.py :562, :596-604).
Here every rank is a process, and these helpers are its collectives.

- Every reduction is an all-gather followed by a sum in rank order on
  each rank: every rank holds the same bits whatever the backend's
  algorithm (an L-BFGS line search or a Metropolis test then decides the
  same way on every rank), and a float64 sum stays float64.
- Ranks that share one card must use gloo (NCCL refuses two ranks on
  one GPU). Gloo runs all_gather, all_reduce, broadcast and
  reduce_scatter on CUDA tensors and not all_to_all
  (bayeslim_tpu_torch/scripts/gloo_cuda_probe.py on an H100, torch
  2.11); these helpers use all_gather alone, so no tensor is staged
  through host memory.
- A group of None is a group of one rank: every helper is then the
  identity.
- STATS accumulates the host wall time [ms], the calls and the bytes
  received of the helpers' collectives (the wait for the peers
  included), so a caller can report them.

The autograd Functions, each the adjoint of another (so a gradient
through them is differentiable again, and forward-mode AD carries
tangents through them, as compute_hessian's rows need):

- gather(x, group, dim, "sum"): every rank's block concatenated along
  dim; backward: the cotangent summed over the ranks, this rank's block
  cut out (each rank's loss reads the whole gathered tensor: the
  simulated cube gathered across baseline shards);
- gather(x, group, dim, "slice"): the same forward; backward: this
  rank's block of the cotangent, unsummed (every rank computes the same
  function of the gathered tensor: a prior on a sharded parameter);
- sum_in(x, group): the sum over the ranks; backward: the identity
  (every rank then computes the same loss: the pixel shards' partial
  visibilities);
- copy_in(x, group): the identity; backward: the sum over the ranks (a
  replicated input of per-rank partial work, whose gradient each rank
  holds in part).

Trap: torch.distributed.nn.functional.all_reduce all-reduces the
cotangent too, so a replicated loss built on it scales its gradients
by the number of ranks; sum_in's backward is the identity.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["STATS", "group_size", "group_rank", "all_gather", "sum_over",
           "gather", "sum_in", "copy_in", "reset_stats"]

STATS = {"ms": 0.0, "calls": 0, "bytes": 0}


def reset_stats():
    STATS.update(ms=0.0, calls=0, bytes=0)


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group):
    return 0 if group is None else dist.get_rank(group)


def all_gather(x, group):
    """Every rank's x (same shape and dtype everywhere), in group rank
    order; no autograd."""
    n = group_size(group)
    if n == 1:
        return [x]
    t0 = time.perf_counter()
    src = x.detach()
    if src.is_complex():
        src = torch.view_as_real(src)
    src = src.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    if x.is_complex():
        out = [torch.view_as_complex(o) for o in out]
    STATS["ms"] += 1e3 * (time.perf_counter() - t0)
    STATS["calls"] += 1
    STATS["bytes"] += src.numel() * src.element_size() * n
    return out


def sum_over(x, group):
    """Sum of x over the group, added in rank order on every rank (the
    same bits everywhere); no autograd."""
    parts = all_gather(x, group)
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def _block(x, group, dim):
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n).clone()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, mode):
        ctx.args = (group, dim, mode)
        return torch.cat(all_gather(x, group), dim)

    @staticmethod
    def jvp(ctx, t, *_):
        group, dim, _ = ctx.args
        return torch.cat(all_gather(t, group), dim)

    @staticmethod
    def backward(ctx, g):
        return (_Scatter.apply(g, *ctx.args), None, None, None)


class _Scatter(torch.autograd.Function):
    """The adjoint of _Gather: mode 'sum' sums over the ranks, then cuts
    out this rank's block; 'slice' only cuts."""

    @staticmethod
    def _fwd(g, group, dim, mode):
        return _block(sum_over(g, group) if mode == "sum" else g, group, dim)

    @staticmethod
    def forward(ctx, g, group, dim, mode):
        ctx.args = (group, dim, mode)
        return _Scatter._fwd(g, group, dim, mode)

    @staticmethod
    def jvp(ctx, t, *_):
        return _Scatter._fwd(t, *ctx.args)

    @staticmethod
    def backward(ctx, h):
        return (_Gather.apply(h, *ctx.args), None, None, None)


class _SumIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_over(x, group)

    @staticmethod
    def jvp(ctx, t, _):
        return sum_over(t, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return _CopyIn.apply(g, ctx.group), None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def jvp(ctx, t, _):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return _SumIn.apply(g, ctx.group), None


def gather(x, group, dim, mode="sum"):
    """Every rank's block of x concatenated along dim (module docstring:
    mode 'sum' or 'slice' sets the backward)."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim, mode)


def sum_in(x, group):
    """The sum of x over the group; the identity backward."""
    return x if group_size(group) == 1 else _SumIn.apply(x, group)


def copy_in(x, group):
    """x itself; the sum over the group backward."""
    return x if group_size(group) == 1 else _CopyIn.apply(x, group)
