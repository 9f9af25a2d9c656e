"""
Priors and the (negative) log-posterior of a forward model against data.

Counterpart of bayeslim_tpu/inference/prob.py (MainParams :35,
_coerce_main :101, the priors :119-247, apply_icov :249, LogProb :293,
set_main_params ... sort_main_params :347-411, forward_chisq /
forward_like / forward_prior :418-496, value_and_grad :621, closure
:650, set_grad_mod / grad_modify :655-687, update :689, _walk_priors
:695). The JAX package jits ``value_and_grad`` of a pure function of a
ParamDict; here the same function runs eagerly and
``torch.autograd.grad`` differentiates it. The target is a list, one
entry per minibatch of the model (Nbatch, batch_idx), and
grad_type='accumulate' sums the gradients over every batch; the prior
is counted once, with batch 0. A float32 model's chi^2 is summed in
float64 (the JAX package sums in the working dtype), so its likelihood
is normalised in float64 and its loss is a float64 scalar.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.containers import TensorData
from ..data.dataset import Dataset
from ..ops.linalg import pinv
from ..utils.logging import span
from ..utils.module import Module, model2pdict
from ..utils.paramdict import ParamDict

__all__ = [
    "BaseLogPrior", "LogUniformPrior", "LogTaperedUniformPrior",
    "LogGaussPrior", "LogLaplacePrior", "apply_icov", "LogProb",
    "MainParams",
]


def _complex_of(dtype):
    return torch.complex128 if dtype in (torch.float64, torch.complex128) \
        else torch.complex64


def _tensor(x):
    """x as a tensor (numpy and Python numbers as float64 / complex128
    on the CPU); None stays None."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not (np.iscomplexobj(x) or np.issubdtype(x.dtype, np.floating)):
        x = x.astype(np.float64)
    return torch.as_tensor(x)


class MainParams:
    """Gather / scatter of sub-slices of model parameters into one flat
    master vector.

    spec maps dotted parameter paths to a selection: None (the whole
    parameter), integer indices into the raveled parameter, or a boolean
    mask of the parameter's shape. Unselected entries stay at the
    wrapped model's values. Keys are sorted, so the flat layout is
    deterministic; offsets, shapes and dtypes are host metadata, and the
    index tensors are kept on each device they are used on.
    """

    def __init__(self, model, spec):
        self.keys = sorted(spec)
        self.idx, self.shapes, self.dtypes, self.sizes = {}, {}, {}, {}
        self.offsets = {}
        self._idx_dev = {}
        off = 0
        for k in self.keys:
            base = model[k]
            self.shapes[k] = tuple(base.shape)
            self.dtypes[k] = base.dtype
            ix = spec[k]
            if ix is not None:
                ix = np.asarray(ix)
                if ix.dtype == bool:
                    if ix.shape != self.shapes[k]:
                        raise ValueError(f"mask of {k} has shape "
                                         f"{ix.shape}, not {self.shapes[k]}")
                    ix = np.where(ix.ravel())[0]
                ix = ix.astype(np.int64).ravel()
            self.idx[k] = ix
            n = int(np.prod(self.shapes[k])) if ix is None else len(ix)
            self.sizes[k] = n
            self.offsets[k] = off
            off += n
        self.size = off

    def _index(self, k, device):
        key = (k, str(device))
        if key not in self._idx_dev:
            self._idx_dev[key] = torch.as_tensor(self.idx[k], device=device)
        return self._idx_dev[key]

    def gather(self, model):
        """Flat (size,) master vector of the selected entries."""
        parts = []
        for k in self.keys:
            flat = model[k].reshape(-1)
            parts.append(flat if self.idx[k] is None
                         else flat.index_select(0, self._index(k,
                                                               flat.device)))
        dt = parts[0].dtype
        for p in parts[1:]:
            dt = torch.promote_types(dt, p.dtype)
        return torch.cat([p.to(dt) for p in parts])

    def scatter(self, vec, model, fill=None):
        """Copy of the model with the selected entries taken from vec;
        unselected entries keep the model's values, or ``fill``. Out of
        place, differentiable in vec."""
        updates = {}
        for k in self.keys:
            off, n = self.offsets[k], self.sizes[k]
            sub = vec[off:off + n]
            if not self.dtypes[k].is_complex and sub.is_complex():
                sub = sub.real
            sub = sub.to(self.dtypes[k])
            if self.idx[k] is None:
                new = sub
            else:
                base = model[k].detach().reshape(-1)
                if fill is not None:
                    base = torch.full_like(base, fill)
                new = base.index_copy(0, self._index(k, base.device), sub)
            updates[k] = new.reshape(self.shapes[k])
        return model.updated(ParamDict(updates))


def _coerce_main(pdict, main_params):
    """forward_* take ``main_params=`` (a flat master vector or a
    ParamDict) as another name for pdict; a bare tensor becomes the
    'main' entry."""
    if main_params is None:
        return pdict
    if pdict is not None:
        raise ValueError("pass either pdict or main_params, not both")
    if isinstance(main_params, (dict, ParamDict)):
        return ParamDict(dict(main_params.items()))
    return ParamDict({"main": torch.as_tensor(main_params)})


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------

class BaseLogPrior(Module):
    """Base prior: an optional index into the params and a transform
    func(params, **fkwargs) applied before the prior. Its constant
    tensors are moved to the params' device and precision on first use
    there and kept."""

    def __init__(self, index=None, func=None, fkwargs=None, name=None):
        super().__init__(name=name)
        self.index = index
        self.func = func
        self.fkwargs = fkwargs if fkwargs is not None else {}
        self._on = {}

    def _t(self, name, ref):
        """Attribute ``name`` on ref's device, in ref's precision."""
        val = getattr(self, name)
        if val is None:
            return None
        key = (name, str(ref.device), ref.dtype)
        if key not in self._on:
            rdt = ref.real.dtype if ref.is_floating_point() \
                or ref.is_complex() else torch.float64
            dt = _complex_of(rdt) if val.is_complex() else rdt
            self._on[key] = val.to(device=ref.device, dtype=dt)
        return self._on[key]

    def _index_func(self, params):
        if self.index is not None:
            params = params[self._device_index(params.device)]
        if self.func is not None:
            params = self.func(params, **self.fkwargs)
        return params

    def _device_index(self, device):
        """The index, its arrays as tensors on the device (kept)."""
        key = ("index", str(device))
        if key not in self._on:
            def conv(ix):
                if isinstance(ix, (np.ndarray, list)):
                    return torch.as_tensor(np.asarray(ix), device=device)
                return ix
            ix = self.index
            self._on[key] = tuple(conv(i) for i in ix) \
                if isinstance(ix, tuple) else conv(ix)
        return self._on[key]

    def forward(self, params, **kwargs):
        raise NotImplementedError


class LogUniformPrior(BaseLogPrior):
    """Uniform prior between hard bounds: log(1 / (ub - lb)) summed,
    -inf when any entry is outside (the gradient stays connected to the
    params, as zero)."""

    def __init__(self, lower_bound, upper_bound, index=None, func=None,
                 fkwargs=None):
        super().__init__(index, func, fkwargs)
        self.lower_bound = _tensor(lower_bound)
        self.upper_bound = _tensor(upper_bound)
        self.norm = torch.sum(torch.log(
            1.0 / (self.upper_bound - self.lower_bound)))

    def forward(self, params, **kwargs):
        params = self._index_func(params)
        lb, ub = self._t("lower_bound", params), self._t("upper_bound",
                                                         params)
        inb = torch.all((params >= lb) & (params <= ub))
        anchor = torch.sum(params) * 0.0
        norm = self._t("norm", params)
        return torch.where(inb, norm + anchor, -np.inf + anchor)


class LogTaperedUniformPrior(BaseLogPrior):
    """Uniform prior with sigmoid (or tanh) tapered edges of sharpness
    alpha / (ub - lb); either bound may be None."""

    def __init__(self, lower_bound=None, upper_bound=None, kind="sigmoid",
                 alpha=10000.0, index=None, func=None, fkwargs=None):
        super().__init__(index, func, fkwargs)
        if lower_bound is None and upper_bound is None:
            raise ValueError("need a lower or an upper bound")
        self.lower_bound = _tensor(lower_bound)
        self.upper_bound = _tensor(upper_bound)
        if lower_bound is not None and upper_bound is not None:
            dbound = self.upper_bound - self.lower_bound
        else:
            dbound = 1.0
        self.coeff = _tensor(alpha) / dbound
        self.kind = kind

    def forward(self, params, **kwargs):
        params = self._index_func(params)
        f = torch.sigmoid if self.kind == "sigmoid" else torch.tanh
        coeff = self._t("coeff", params)
        prob = 1.0
        if self.lower_bound is not None:
            prob = prob * f(coeff * (params - self._t("lower_bound",
                                                      params)))
        if self.upper_bound is not None:
            prob = prob * f(-coeff * (params - self._t("upper_bound",
                                                       params)))
        return torch.sum(torch.log(prob))


class LogGaussPrior(BaseLogPrior):
    """Gaussian prior with a diagonal (cov broadcast against the params)
    or a dense covariance (over the raveled params). side 'upper' /
    'lower' makes it a half-Gaussian; density adds the normalisation.
    As in the JAX package, the normalisation counts mean's size as the
    dimension of a diagonal prior and inverts a dense cov with the JAX
    default pinv cut-off."""

    def __init__(self, mean, cov, diag_cov=True, side="both", density=True,
                 index=None, func=None, fkwargs=None):
        super().__init__(index, func, fkwargs)
        self.mean = _tensor(mean)
        self.cov = _tensor(cov)
        self.diag_cov = diag_cov
        self.side = side
        self.density = density
        if diag_cov:
            self.icov = 1.0 / self.cov
            self.logdet = torch.sum(torch.log(self.cov))
            self.ndim = self.mean.numel()
        else:
            self.icov = pinv(self.cov)
            self.logdet = torch.linalg.slogdet(self.cov)[1]
            self.ndim = self.cov.shape[0]
        self.norm = 0.5 * (self.ndim * np.log(2 * np.pi) + self.logdet)

    def forward(self, params, **kwargs):
        params = self._index_func(params)
        res = params - self._t("mean", params)
        if self.side == "upper":
            res = torch.where(res < 0, torch.zeros_like(res), res)
        elif self.side == "lower":
            res = torch.where(res > 0, torch.zeros_like(res), res)
        icov = self._t("icov", params)
        if self.diag_cov:
            chisq = 0.5 * torch.sum(torch.abs(res) ** 2 * icov)
        else:
            r = res.reshape(-1)
            chisq = 0.5 * (r.conj() @ icov.to(r.dtype) @ r).real
        out = -chisq
        if self.density:
            out = out - self._t("norm", params)
        return out


class LogLaplacePrior(BaseLogPrior):
    """Laplace prior of the given mean and scale."""

    def __init__(self, mean, scale, density=True, index=None, func=None,
                 fkwargs=None):
        super().__init__(index, func, fkwargs)
        self.mean = _tensor(mean)
        self.scale = _tensor(scale)
        self.density = density
        self.norm = torch.sum(torch.log(2 * self.scale))

    def forward(self, params, **kwargs):
        params = self._index_func(params)
        out = -torch.sum(torch.abs(params - self._t("mean", params))
                         / self._t("scale", params))
        if self.density:
            out = out - self._t("norm", params)
        return out


# ---------------------------------------------------------------------------
# chi-square with structured covariances
# ---------------------------------------------------------------------------

def apply_icov(data, icov, cov_axis=None, mode="vis"):
    """data^H Sigma^-1 data for each covariance structure.

    cov_axis None: icov is diagonal in data's shape (None: identity);
    'full': icov (N, N) over data.ravel(); or one coupled axis:
      vis: 'bl' icov (Npol, Npol, Ntimes, Nfreqs, Nbl, Nbl),
           'time' (Npol, Npol, Nbls, Nfreqs, Ntimes, Ntimes),
           'freq' (Npol, Npol, Nbls, Ntimes, Nfreqs, Nfreqs);
      map: 'freq' (Npol, 1, Npix, Nfreqs, Nfreqs),
           'pix' (Npol, 1, Nfreqs, Npix, Npix).
    'time' follows the JAX package's documented layout (batch axes
    first, the coupled times last, one block per frequency).
    """
    d = data
    if cov_axis is None:
        out = d.conj() * d
        return out if icov is None else out * icov
    icov = icov.to(d.dtype) if d.is_complex() else icov
    if cov_axis == "full":
        r = d.reshape(-1)
        return r.conj() @ icov @ r
    if cov_axis == "bl":
        return torch.einsum("ijklm,ijlmkn,ijnlm->ijlm", d.conj(), icov, d)
    if cov_axis == "time":
        return torch.einsum("ijklm,ijkmln,ijknm->ijkm", d.conj(), icov, d)
    if cov_axis == "freq":
        if mode == "vis":
            return torch.einsum("ijklm,ijklmn,ijkln->ijkl", d.conj(), icov,
                                d)
        return torch.einsum("ijkl,ijlkn,ijnl->ijl", d.conj(), icov, d)
    if cov_axis == "pix":
        return torch.einsum("ijkl,ijkln,ijkn->ijk", d.conj(), icov, d)
    raise ValueError(f"unknown cov_axis {cov_axis}")


# elements of a float32 chi^2 cast to float64 at a time (128 MB)
_SUM_CHUNK = 1 << 24


class _Sum64(torch.autograd.Function):
    """Sum of a float32 array (or of a complex64 array's real part),
    accumulated in float64 a chunk at a time (a whole-array cast would
    hold a float64 copy of the ~0.9 GB cube). Its backward is a plain
    sum's: the upstream gradient expanded, never materialised at full
    size (differentiable again); its jvp sums the tangent the same
    way."""

    @staticmethod
    def _sum(x):
        xr = (x.real if x.is_complex() else x).reshape(-1)
        return torch.sum(torch.stack([
            torch.sum(xr[i:i + _SUM_CHUNK], dtype=torch.float64)
            for i in range(0, xr.numel(), _SUM_CHUNK)]))

    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return _Sum64._sum(x)

    @staticmethod
    @torch.no_grad()
    def jvp(ctx, t):
        return _Sum64._sum(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).expand(ctx.shape)


def _sum_chisq(chisq):
    """The sum of a chi^2 array. A float32 / complex64 array is summed
    (its real part: the caller takes the real part of the sum) in
    float64: a sum of ~1e8 float32 terms of order 1 rounds at its ulp,
    ~8, which would decide a sampler's dH (~0.1). Gradients are the
    float32 sum's."""
    if chisq.dtype not in (torch.float32, torch.complex64):
        return torch.sum(chisq)
    return _Sum64.apply(chisq)


# ---------------------------------------------------------------------------
# LogProb
# ---------------------------------------------------------------------------

class LogProb(Module):
    """(Negative) log-posterior of a forward model against target data.

    The likelihood is Gaussian: complex_circular=True (the default)
    gives -ln L = chi^2 + n ln(pi) + ln det C, False the real Gaussian
    -ln L = chi^2 / 2 + (n ln(2 pi) + ln det C) / 2. compute 'post'
    adds the log prior to the log likelihood, 'like' and 'prior' give
    one of them; negate returns minus the log posterior (the loss).

    Priors come from the modules' own (set_priors, memoised by module
    name during the forward) or, if given, from prior_dict {dotted
    parameter path: prior or list of priors}. LM(key, value), if given,
    maps each pdict entry before it reaches the model. set_main_params
    restricts the solved parameters to sub-slices (MainParams); the
    pdict then holds one flat 'main' vector.

    target: one TensorData, a list of them or a Dataset, batch i using
    entry i mod len(target). start_inp, if given, is indexed the same
    way, and its entry is the model's input (the first block's, in a
    Sequential). grad_type 'accumulate': value_and_grad returns
    the mean loss over the model's batches and the sum of their
    gradients, as the JAX package does; any other value: the active
    batch's alone. The prior enters with batch 0 only.
    """

    def __init__(self, model, target, start_inp=None, prior_dict=None,
                 compute="post", negate=True, grad_type="accumulate",
                 complex_circular=True, LM=None, name=None):
        super().__init__(name=name)
        self.model = model
        if isinstance(target, TensorData):
            target = [target]
        self.target = target if isinstance(target, Dataset) \
            else list(target)
        self.start_inp = start_inp
        self.prior_dict = prior_dict
        self.compute = compute
        self.negate = negate
        self.grad_type = grad_type
        self.complex_circular = complex_circular
        self.LM = LM
        self.main_params = None
        self.closure_eval = 0
        self.set_grad_mod()

    # --- batching ------------------------------------------------------
    @property
    def Nbatch(self):
        return getattr(self.model, "Nbatch", 1) or 1

    @property
    def batch_idx(self):
        return getattr(self.model, "batch_idx", 0) or 0

    @batch_idx.setter
    def batch_idx(self, val):
        if hasattr(self.model, "batch_idx"):
            self.model.batch_idx = val
        elif val > 0:
            raise ValueError("model is not batched")

    def get_batch_data(self, idx=None):
        """The target of batch idx (default: the active batch), which
        idx then makes active."""
        if idx is not None:
            self.batch_idx = idx
        return self.target[self.batch_idx % len(self.target)]

    def get_batch_inp(self):
        """The model input of the active batch (None without
        start_inp)."""
        if self.start_inp is None:
            return None
        return self.start_inp[self.batch_idx % len(self.start_inp)]

    # --- parameter plumbing ---------------------------------------------
    def set_main_params(self, spec=None):
        """Solve for sub-slices of the model's parameters: spec {dotted
        key: None | raveled integer indices | boolean mask}; unselected
        entries stay at the model's values. None reverts to whole
        parameters."""
        self.main_params = None if spec is None else \
            MainParams(self.model, spec)
        return self.main_params

    def collect_main_params(self):
        """ParamDict of the model's trainable leaves, keyed like the JAX
        package ('sky.params', 'models.cal.params', ...), or with
        set_main_params active one 'main' entry holding the flat master
        vector."""
        if self.main_params is not None:
            return ParamDict({"main": self.main_params.gather(
                self.model).detach()})
        return model2pdict(self.model)

    def send_main_params(self, main_params=None, inplace=True, fill=None,
                         main_p0=None):
        """Write main params into the model: a ParamDict of leaves, or
        with set_main_params active the flat master vector (or a
        ParamDict holding it under 'main'), plus main_p0 if given, with
        unselected entries set to fill if given. inplace copies the
        values into the model's own tensors; otherwise a functional copy
        of the model is returned."""
        pd = main_params if main_params is not None \
            else self.collect_main_params()
        if self.main_params is not None:
            vec = pd["main"] if isinstance(pd, (dict, ParamDict)) else pd
            vec = torch.as_tensor(vec)
            if main_p0 is not None:
                vec = vec + torch.as_tensor(main_p0, device=vec.device)
            model = self.main_params.scatter(vec, self.model, fill=fill)
            updates = {k: model[k] for k in self.main_params.keys}
        else:
            updates = dict(pd.items())
            model = self.model.updated(ParamDict(updates))
        if not inplace:
            return model
        with torch.no_grad():
            for k, v in updates.items():
                self.model[k].copy_(v)
        return self.model

    def sort_main_params(self, spec, incomplete=False):
        """Rebuild the main-params layout from a new spec; incomplete
        keeps the current selection of keys that spec leaves out."""
        if self.main_params is None:
            raise ValueError("set_main_params first")
        if incomplete:
            cur = {k: self.main_params.idx[k] for k in self.main_params.keys}
            cur.update(spec)
            spec = cur
        return self.set_main_params(spec)

    def _model_at(self, pdict):
        """The model with pdict's values (after LM) in place."""
        if pdict is None:
            return self.model
        if self.LM is not None:
            pdict = ParamDict({k: self.LM(k, v) for k, v in pdict.items()})
        if self.main_params is not None:
            return self.main_params.scatter(pdict["main"], self.model)
        return self.model.updated(pdict)

    # --- evaluation -------------------------------------------------------
    def forward_chisq(self, pdict=None, idx=None, sum_chisq=True,
                      main_params=None, **kwargs):
        """(chi^2, residual, prior_cache) of the model against batch
        idx; the forward fills prior_cache with the modules' priors."""
        pdict = _coerce_main(pdict, main_params)
        tgt = self.get_batch_data(idx)
        data, icov = tgt.get_data(), tgt.get_icov()
        prior_cache = {}
        inp = self.get_batch_inp()
        out = self._model_at(pdict)(*(() if inp is None else (inp,)),
                                    prior_cache=prior_cache)
        if isinstance(out, TensorData):
            out = out.data
        with span("bl.chisq"):
            res = out - data
            chisq = apply_icov(res, icov, tgt.cov_axis)
            if sum_chisq:
                chisq = _sum_chisq(chisq)
            if chisq.is_complex():
                chisq = chisq.real
        return chisq, res, prior_cache

    def forward_like(self, pdict=None, idx=None, main_params=None,
                     **kwargs):
        """(log likelihood of batch idx, prior_cache)."""
        pdict = _coerce_main(pdict, main_params)
        chisq, _, prior_cache = self.forward_chisq(pdict, idx)
        tgt = self.get_batch_data()
        norm = 0.0
        if tgt.icov is not None and tgt.cov_logdet is not None:
            if self.complex_circular:
                norm = tgt.cov_ndim * np.log(np.pi) + tgt.cov_logdet
            else:
                norm = 0.5 * (tgt.cov_ndim * np.log(2 * np.pi)
                              + tgt.cov_logdet)
        if self.complex_circular:
            return -chisq - norm, prior_cache
        return -0.5 * chisq - norm, prior_cache

    def forward_prior(self, pdict=None, prior_cache=None, idx=None,
                      main_params=None, **kwargs):
        """Log prior, counted once across batches: with an explicit idx
        other than 0 it is 0. From prior_dict if given, else from
        prior_cache, which is filled by walking the model when empty."""
        pdict = _coerce_main(pdict, main_params)
        if idx is not None:
            if idx != 0:
                return self._zero()
            self.batch_idx = idx
        logprior = self._log_prior(pdict, prior_cache)
        return logprior if isinstance(logprior, torch.Tensor) \
            else self._zero() + logprior

    def _log_prior(self, pdict, prior_cache):
        """The log prior as forward_prior sums it (0.0, a float, when
        the model carries none)."""
        logprior = 0.0
        if self.prior_dict is not None:
            model = self._model_at(pdict)
            for key, pr in self.prior_dict.items():
                prs = pr if isinstance(pr, (list, tuple)) else [pr]
                val = model[key]
                for p in prs:
                    logprior = logprior + p(val)
            return logprior
        if not prior_cache:
            prior_cache = {}
            _walk_priors(self._model_at(pdict), prior_cache)
        for v in prior_cache.values():
            logprior = logprior + v
        return logprior

    def _zero(self):
        data = self.target[0].data
        return torch.zeros((), dtype=data.real.dtype, device=data.device)

    def forward(self, pdict=None, idx=None, **kwargs):
        """(Negative) log posterior of batch idx (default: the active
        one) with the model's parameters, or with pdict's tensors in
        their place."""
        if self.compute not in ("post", "like", "prior"):
            raise ValueError(f"unknown compute {self.compute!r}")
        if idx is not None:
            self.batch_idx = idx
        prob = 0.0
        prior_cache = None
        if self.compute in ("post", "like"):
            loglike, prior_cache = self.forward_like(pdict)
            prob = prob + loglike
        if self.compute in ("post", "prior") and self.batch_idx == 0:
            prob = prob + self._log_prior(pdict, prior_cache)
        if not isinstance(prob, torch.Tensor):
            prob = self._zero() + prob
        return -prob if self.negate else prob

    def _value_and_grad(self, leaves, idx):
        loss = self(leaves, idx=idx)
        keys = leaves.keys()
        if loss.requires_grad:
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                        allow_unused=True)
        else:
            grads = [None] * len(keys)
        grads = [torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(keys, grads)]
        return loss.detach(), ParamDict(dict(zip(keys, grads)))

    @span("bl.eval")
    def value_and_grad(self, pdict=None):
        """Loss and the ParamDict of its gradients with respect to
        pdict (default: the main params), after grad_modify;
        accumulated over the batches for grad_type 'accumulate'."""
        self.closure_eval += 1
        if pdict is None:
            pdict = self.collect_main_params()
        leaves = ParamDict({k: v.detach().requires_grad_(True)
                            for k, v in pdict.items()})
        if self.grad_type != "accumulate" or self.Nbatch == 1:
            v, g = self._value_and_grad(leaves, None)
            return v, self.grad_modify(g)
        loss = grads = None
        for i in range(self.Nbatch):
            v, g = self._value_and_grad(leaves, i)
            loss = v if loss is None else loss + v
            grads = g if grads is None else grads + g
        self.batch_idx = 0
        return loss / self.Nbatch, self.grad_modify(grads)

    def closure(self, pdict=None):
        """(loss, grads), as value_and_grad."""
        return self.value_and_grad(pdict)

    # --- gradient modification -----------------------------------------
    def set_grad_mod(self, grad_mods=None, alpha=1.0):
        """Per-parameter gradient modifications after value_and_grad:
        grad_mods {key: (mode, value)}, mode 'clamp' (clip at +-value),
        'mult' (scale by value), 'replace' (overwrite with value),
        'isolate' (zero every other key) or 'clip' (clip the key's norm
        to value)."""
        self.grad_mods = grad_mods
        self.grad_alpha = alpha

    def grad_modify(self, grads):
        if not self.grad_mods:
            return grads
        out = dict(grads.items())
        isolate = [k for k, (m, _) in self.grad_mods.items()
                   if m == "isolate"]
        if isolate:
            for k in out:
                if k not in isolate:
                    out[k] = torch.zeros_like(out[k])
        for k, (mode, val) in self.grad_mods.items():
            if k not in out:
                continue
            if mode == "clamp":
                out[k] = torch.clamp(out[k], -val, val)
            elif mode == "mult":
                out[k] = out[k] * val
            elif mode == "replace":
                out[k] = torch.broadcast_to(torch.as_tensor(
                    val, dtype=out[k].dtype, device=out[k].device),
                    out[k].shape).clone()
            elif mode == "clip":
                nrm = torch.linalg.vector_norm(out[k])
                scale = torch.clamp(val / torch.clamp(nrm, min=1e-30),
                                    max=1.0)
                out[k] = out[k] * scale
        return ParamDict(out)

    def update(self, pdict):
        """Write a ParamDict's values (after LM) into the model's
        parameters, in place; a 'main' master vector is scattered."""
        if self.main_params is not None and "main" in pdict:
            vec = pdict["main"]
            if self.LM is not None:
                vec = self.LM("main", vec)
            self.send_main_params(ParamDict({"main": vec}))
            return
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for k, v in pdict.items():
                if self.LM is not None:
                    v = self.LM(k, v)
                params[k].copy_(v)


def _walk_priors(model, prior_cache):
    """Fill prior_cache from every module of the tree that carries
    priors, evaluated on its params (for models whose forward was not
    run with the cache)."""
    if isinstance(model, Module) and (model.priors_inp_params
                                      or model.priors_out_params):
        params = getattr(model, "params", None)
        if params is not None:
            model.eval_prior(prior_cache, inp_params=params)
    for child in model.children():
        _walk_priors(child, prior_cache)
