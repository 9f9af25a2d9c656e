"""
Hessians of the posterior, their inverses, and the factored inverse
Hessian of a quasi-Newton history.

Counterpart of bayeslim_tpu/inference/hessian.py (main_params_index
:32, _hessian_one :77, compute_hessian :115, main_params_kron_inv_hess
:163, invert_hessian :193, mask_hessian / unmask_hessian :235-243,
compute_icov :257, implicit_to_dense :264, factor_pairs :284,
factored_hvp / factored_lvp :326-342, FactoredInvHessian :355 with
from_lbfgs :391).

compute_hessian takes rows by forward-over-reverse, as the JAX package
does (jax.jacfwd of jax.grad): the raveled parameters become a dual
tensor (torch.autograd.forward_ad) whose tangent is a unit vector e_i,
the loss's gradient is taken by torch.autograd.grad, and its tangent is
H e_i, row i of the symmetric H. One row a pass; the memory is that of
one gradient evaluation carrying tangents. With rows_chunk the rows go
rows_chunk at a time by reverse-over-reverse instead: one forward and
one gradient graph a chunk (create_graph), then a backward through that
graph a row, H e_i again. Fewer forward passes, but the first
backward's whole graph is held: for small problems. The rows run inside
``ops.rime_kernel.force_chunked``: the fused kernels' backward has no
derivative of its own, and the chunked RIME path (its pixel chunks and
the psky construction under torch.utils.checkpoint) is differentiable
at any order. The model's own parameters are frozen while it runs, so
that only the raveled variables carry gradients.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops.linalg import invert_matrix
from ..ops.rime_kernel import force_chunked
from ..utils.paramdict import ParamDict

__all__ = [
    "compute_hessian", "invert_hessian", "mask_hessian", "unmask_hessian",
    "main_params_index", "main_params_kron_inv_hess", "compute_icov",
    "implicit_to_dense", "FactoredInvHessian", "factor_pairs",
    "factored_hvp", "factored_lvp",
]


def main_params_index(pdict, param=None, sub_index=None, params=None):
    """Where each key lies in the raveled vector: {key: slice} for a
    ParamDict; for a LogProb with set_main_params active, {key: integer
    indices} into its master vector. With param, that key's indices
    (sub_index selects among the parameter's, or its selection's,
    entries); params restricts and orders the keys."""
    if hasattr(pdict, "collect_main_params"):
        prob = pdict
        mp = prob.main_params
        if mp is not None:
            keys = params if params is not None else mp.keys
            out, i = {}, 0
            for k in keys:
                out[k] = np.arange(i, i + mp.sizes[k])
                i += mp.sizes[k]
            if param is None:
                return out
            idx = out[param]
            if sub_index is not None:
                idx = idx.reshape(-1)[np.asarray(
                    np.arange(mp.sizes[param]).reshape(
                        mp.shapes[param] if mp.idx[param] is None
                        else (-1,))[sub_index]).ravel()]
            return idx
        pdict = prob.collect_main_params()
    out, i = {}, 0
    keys = params if params is not None else list(pdict.keys())
    for k in keys:
        n = int(np.prod(np.shape(pdict[k]))) or 1
        out[k] = slice(i, i + n)
        i += n
    if param is not None:
        s = out[param]
        idx = np.arange(s.start, s.stop)
        if sub_index is not None:
            idx = idx.reshape(np.shape(pdict[param]))[sub_index].ravel()
        return idx
    return out


@contextlib.contextmanager
def _frozen(model):
    """The model's parameters (a Module's; anything else has none)
    without gradients inside the block."""
    params = [p for p in getattr(model, "parameters", list)()
              if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _hessian_one(prob, batch_idx, pdict, keys, row0=0, nrows=None,
                 rows_chunk=None):
    """Rows row0 ... row0 + nrows (default all) of one batch's Hessian
    of one LogProb: forward-over-reverse, one row a pass, or with
    rows_chunk reverse-over-reverse, rows_chunk rows a gradient graph."""
    if pdict is None:
        pdict = prob.collect_main_params()
    if keys is not None:
        pdict = ParamDict({k: pdict[k] for k in keys})
    template = pdict.copy()
    x0 = pdict.ravel().detach()
    n = x0.numel()
    row1 = n if nrows is None else min(row0 + nrows, n)
    step = rows_chunk or 1

    def unit(i):
        e = torch.zeros_like(x0)
        e[i] = 1
        return e
    rows = []
    with force_chunked(), _frozen(prob):
        for i0 in range(row0, row1, step):
            block = range(i0, min(i0 + step, row1))
            if rows_chunk:
                x = x0.clone().requires_grad_(True)
                loss = prob.forward(template.unravel(x), idx=batch_idx)
                g, = torch.autograd.grad(loss, x, create_graph=True)
                rows += [torch.autograd.grad(g, x, unit(i),
                                             retain_graph=True)[0].detach()
                         for i in block]
            else:
                with fwAD.dual_level():
                    x = fwAD.make_dual(x0.clone().requires_grad_(True),
                                       unit(i0))
                    loss = prob.forward(template.unravel(x), idx=batch_idx)
                    g, = torch.autograd.grad(loss, x)
                    rows.append(fwAD.unpack_dual(g).tangent.detach())
    return torch.stack(rows), main_params_index(pdict)


def compute_hessian(prob, pdict=None, rows_chunk=None, keys=None,
                    batches="all", Nstart=None, Nrows=None,
                    rm_offdiag=False, out_ftype=None, grad_real=True):
    """Dense Hessian of the (negative log) posterior with respect to the
    raveled ParamDict (default the main params).

    prob: a LogProb or a list of them (their Hessians sum). With
    batches='all' each prob's batches are summed (the prior enters once,
    with batch 0). keys restricts the parameters (a block of H);
    Nstart / Nrows compute only that contiguous row block; rm_offdiag
    keeps the diagonal; out_ftype casts the result. rows_chunk None takes
    one row a pass by forward-over-reverse (the memory of one gradient
    evaluation); an integer takes rows_chunk rows a pass by
    reverse-over-reverse from one gradient graph, which it holds whole
    (module docstring). The JAX package's rows_chunk bounds memory the
    other way (None vectorizes every row) and its vectorize and
    cast2real change nothing; the port has neither. Complex leaves are
    real pairs, so grad_real=False raises. Returns (H (n, n) or (Nrows,
    n), {key: slice}).
    """
    if not grad_real:
        raise NotImplementedError(
            "complex trainables are real pairs (a trailing dim of 2): "
            "there is no imaginary-gradient plane of the Hessian")
    probs = list(prob) if isinstance(prob, (list, tuple)) else [prob]
    for p in probs:
        if type(p).__name__ == "ShardedLogProb" or not hasattr(p, "forward"):
            raise NotImplementedError(
                "compute_hessian of a sharded posterior waits for the "
                "multi-device port (ROADMAP queue A10); pass the LogProb")
    H = index = None
    for p in probs:
        nb = getattr(p, "Nbatch", 1) if batches == "all" else 1
        for i in range(nb):
            Hb, index = _hessian_one(p, i, pdict, keys, row0=Nstart or 0,
                                     nrows=Nrows, rows_chunk=rows_chunk)
            H = Hb if H is None else H + Hb
    if rm_offdiag and H.shape[0] == H.shape[1]:
        H = torch.diag(torch.diagonal(H))
    if out_ftype is not None:
        H = H.to(out_ftype)
    return H, index


def main_params_kron_inv_hess(hess, index, key, shape, method="chol",
                              **inv_kwargs):
    """Kronecker-factored inverse-Hessian preconditioner of one
    parameter: key's block of hess, its leading (N, N) block (N the
    product of the parameter's trailing axes) inverted and factored
    ('chol', or 'svd' of the block), the factor's columns averaged, and
    a Kronecker product over the leading axis. Returns (shape[0] N,
    shape[0])."""
    hidx = index[key]
    Hs = hess[hidx][:, hidx]
    N = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    if method == "chol":
        L = torch.linalg.cholesky(invert_matrix(Hs[:N, :N], **inv_kwargs))
    elif method == "svd":
        u, s, _ = torch.linalg.svd(Hs[:N, :N])
        L = u @ torch.diag(1.0 / torch.sqrt(s))
    else:
        raise ValueError(method)
    L = L.sum(dim=1) / L.shape[1] ** 0.5
    eye = torch.eye(shape[0], dtype=L.dtype, device=L.device)
    return torch.kron(eye, L[None, :]).T


def invert_hessian(H, inv="pinv", diag=False, idx=None, rm_thresh=None,
                   rm_fill=1e-15, rm_offdiag=False, rcond=1e-15, eps=None,
                   hermitian=True):
    """A Hessian inverted into a covariance. diag: H is a diagonal (any
    shape), inverted elementwise; idx inverts only those rows and
    columns; rm_thresh drops rows whose diagonal is not above it;
    unselected and dropped diagonals get rm_fill. A ParamDict is
    inverted key by key."""
    if isinstance(H, (dict, ParamDict)):
        return ParamDict({k: invert_hessian(
            H[k], inv=inv, diag=diag, idx=idx, rm_thresh=rm_thresh,
            rm_fill=rm_fill, rm_offdiag=rm_offdiag, rcond=rcond, eps=eps,
            hermitian=hermitian) for k in H})
    H = torch.as_tensor(H)
    if diag:
        thresh = rm_thresh if rm_thresh is not None else -np.inf
        s = H > thresh
        return torch.where(s, 1.0 / torch.where(s, H, torch.ones_like(H)),
                           torch.full_like(H, rm_fill))
    if rm_offdiag:
        H = torch.diag(torch.diagonal(H))
    n = H.shape[0]
    if idx is None:
        sel = np.arange(n)
    elif isinstance(idx, slice):
        sel = np.arange(n)[idx]
    else:
        sel = np.atleast_1d(np.asarray(idx)).astype(int)
    if rm_thresh is not None:
        good = set(np.where(torch.diagonal(H).detach().cpu().numpy()
                            > rm_thresh)[0].tolist())
        sel = np.asarray([i for i in sel if i in good], dtype=int)
    st = torch.as_tensor(sel, device=H.device)
    sub = H[st][:, st]
    if eps:
        sub = sub + torch.eye(sub.shape[0], dtype=sub.dtype,
                              device=sub.device) * eps
    C = invert_matrix(sub, method=inv, rcond=rcond, hermitian=hermitian)
    if len(sel) == n:
        return C
    out = torch.eye(n, dtype=H.dtype, device=H.device) * rm_fill
    return out.index_put((st[:, None], st[None, :]), C)


def mask_hessian(H, thresh=1e0):
    """Rows and columns whose diagonal is at least thresh: (masked H,
    boolean mask)."""
    mask = torch.diagonal(H).detach().cpu().numpy() >= thresh
    idx = torch.as_tensor(np.where(mask)[0], device=H.device)
    return H[idx][:, idx], mask


def unmask_hessian(Hsub, mask, val=1e0, maskleft=False):
    """A masked Hessian scattered back to full size, val on the masked
    diagonal; maskleft unmasks the rows only (val unused)."""
    mask = np.asarray(mask).ravel()
    n = mask.size
    idx = torch.as_tensor(np.where(mask)[0], device=Hsub.device)
    if maskleft:
        H = torch.zeros((n,) + tuple(Hsub.shape[1:]), dtype=Hsub.dtype,
                        device=Hsub.device)
        return H.index_put((idx,), Hsub)
    H = torch.eye(n, dtype=Hsub.dtype, device=Hsub.device) * val
    return H.index_put((idx[:, None], idx[None, :]), Hsub)


def compute_icov(cov, cov_axis=None, inv="pinv", **kwargs):
    """A data covariance inverted: elementwise for a diagonal one
    (cov_axis None), else by invert_matrix."""
    if cov_axis is None:
        return 1.0 / cov
    return invert_matrix(cov, method=inv, **kwargs)


def implicit_to_dense(matvec, n=None, dtype=torch.float64, s=None, y=None):
    """An implicit operator applied to the identity's columns; or, with
    s and y, dense BFGS inverse-Hessian updates over the whole (s, y)
    history from H0 = matvec (the reference's implicit_to_dense(H0, s,
    y))."""
    if s is not None:
        H = torch.as_tensor(matvec, dtype=dtype)
        eye = torch.eye(H.shape[0], dtype=dtype, device=H.device)
        for sk, yk in zip(s, y):
            sk = torch.as_tensor(sk, dtype=dtype, device=H.device).ravel()
            yk = torch.as_tensor(yk, dtype=dtype, device=H.device).ravel()
            rho = 1.0 / (yk @ sk)
            V = eye - rho * torch.outer(sk, yk)
            H = V @ H @ V.T + rho * torch.outer(sk, sk)
        return H
    eye = torch.eye(n, dtype=dtype)
    return torch.stack([matvec(eye[:, i]) for i in range(n)], dim=1)


def factor_pairs(s_k, y_k, g_k, alpha_k, Hy_k=None, pos=True, rank2=True):
    """One quasi-Newton pair (s, y) as the (u, v) of the factored update
    H_{k+1} = (I + u v^T) H_k (I + u v^T)^T (Brodlie et al. 1973):
    rank2 the BFGS update, else SR1 (which needs Hy_k = H_k y_k).
    Returns (u, v, spd)."""
    sy_k = float(s_k @ y_k)
    # s_k = -alpha_k H_k g_k, so H_k^{-1} s_k = -alpha_k g_k
    Hs_k = -alpha_k * g_k
    sHs_k = float(s_k @ Hs_k)
    yHy_k = float(y_k @ Hy_k) if Hy_k is not None else None
    sign = 1.0 if pos else -1.0
    if rank2:
        spd = sy_k > 0
        if yHy_k is not None:
            spd = spd and ((sy_k - yHy_k) <= sy_k)
        u_k = s_k / sy_k
        v_k = sign * np.sqrt(sy_k / sHs_k) * Hs_k - y_k
    else:
        if Hy_k is None:
            raise ValueError("the SR1 update needs Hy_k")
        spd = ((sHs_k - sy_k) / (sy_k - yHy_k)) >= 0
        numer = -1.0 + sign * np.sqrt((sHs_k - sy_k) / (sy_k - yHy_k))
        denom = sHs_k - 2 * sy_k + yHy_k
        u_k = numer / denom * (s_k - Hy_k)
        v_k = Hs_k - y_k
    return u_k, v_k, bool(spd)


def _apply_op(M, vec, is_vec):
    """M vec for M None (identity), a diagonal (1-D), a dense matrix or
    an operator (hmat or any callable)."""
    if M is None:
        return vec
    if callable(M) and not isinstance(M, torch.Tensor):
        return M(vec)
    M = torch.as_tensor(M, device=vec.device)
    if M.ndim < 2:
        return M * vec if is_vec else M[:, None] * vec
    return M @ vec


def factored_hvp(vec, H0, u, v):
    """H vec for H = [prod_k (I + u_k v_k^T)] H0 [prod_k (I + v_k
    u_k^T)], vec a vector or the columns of a matrix."""
    is_vec = vec.ndim == 1
    for u_k, v_k in zip(reversed(u), reversed(v)):
        vec = vec + (v_k * (u_k @ vec) if is_vec
                     else v_k[:, None] * (u_k @ vec))
    vec = _apply_op(H0, vec, is_vec)
    for u_k, v_k in zip(u, v):
        vec = vec + (u_k * (v_k @ vec) if is_vec
                     else u_k[:, None] * (v_k @ vec))
    return vec


def factored_lvp(vec, L0, u, v):
    """L vec for H = L L^T, L = [prod_k (I + u_k v_k^T)] L0, with no
    dense factor formed."""
    is_vec = vec.ndim == 1
    vec = _apply_op(L0, vec, is_vec)
    for u_k, v_k in zip(u, v):
        vec = vec + (u_k * (v_k @ vec) if is_vec
                     else u_k[:, None] * (v_k @ vec))
    return vec


class FactoredInvHessian:
    """The inverse Hessian of quasi-Newton pairs, factored by Brodlie et
    al. 1973: H = U H0 U^T, U = prod_k (I + u_k v_k^T). hvp (H v) and
    lvp (L v, H = L L^T, L = U L0) act without forming anything dense;
    calling it is lvp (the cov_L protocol of the samplers' momenta).
    alpha: each pair's line-search step; g_end: the last gradient, from
    which the pairs' gradients are rebuilt along the y chain."""

    def __init__(self, s, y, g_end, alpha, Hy=None, H0=None, L0=None,
                 rank2=True):
        if H0 is not None and L0 is None:
            raise ValueError("If H0 is fed, L0 should be too")
        if not len(s) == len(y) == len(alpha):
            raise ValueError("s, y and alpha must have one entry a pair")
        self.H0, self.L0, self.rank2 = H0, L0, rank2
        self.m = len(s)
        self.N = int(s[0].numel()) if self.m else int(g_end.numel())
        g = []
        for i in range(self.m):
            g.append(g_end - y[self.m - i - 1])
            g_end = g[-1]
        g = g[::-1]
        if Hy is None:
            Hy = [None] * self.m
        self.u, self.v = [], []
        for _s, _y, _g, _a, _Hy in zip(s, y, g, alpha, Hy):
            _u, _v, spd = factor_pairs(_s, _y, _g, _a, _Hy, pos=True,
                                       rank2=rank2)
            if spd:
                self.u.append(_u)
                self.v.append(_v)

    @classmethod
    def from_lbfgs(cls, lbfgs, H0=None, L0=None, rank2=True):
        """From an LBFGS optimizer: its retained (s, y) pairs, their
        line-search steps (t_hist) and its last gradient."""
        return cls(lbfgs.s_hist, lbfgs.y_hist, lbfgs._g, lbfgs.t_hist,
                   H0=H0, L0=L0, rank2=rank2)

    def hvp(self, vec):
        """H vec."""
        return factored_hvp(vec, self.H0, self.u, self.v)

    def lvp(self, vec):
        """L vec (H = L L^T)."""
        return factored_lvp(vec, self.L0, self.u, self.v)

    matvec = hvp
    mat_vec_mul = hvp

    def to_dense(self, hess=True):
        """Dense H (hess=True) or dense L (False); small problems."""
        ref = self.u[0] if self.u else None
        kw = {} if ref is None else dict(dtype=ref.dtype, device=ref.device)
        eye = torch.eye(self.N, **kw)
        op = self.H0 if hess else self.L0
        M = eye if op is None else _to_dense_op(op, self.N).to(eye)
        for u, v in zip(self.u, self.v):
            V = eye + torch.outer(u, v)
            M = V @ M @ V.T if hess else V @ M
        return M

    def __call__(self, vec):
        return self.lvp(vec)

    def chol(self):
        """Dense L with H = L L^T (the factored product, not a
        triangular factor; lvp acts without it)."""
        return self.to_dense(hess=False)


def _to_dense_op(M, n):
    if not isinstance(M, torch.Tensor) and hasattr(M, "to_dense"):
        return torch.as_tensor(M.to_dense())
    M = torch.as_tensor(M)
    return torch.diag(M) if M.ndim < 2 else M
