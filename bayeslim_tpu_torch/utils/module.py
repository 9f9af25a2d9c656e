"""
Module base class on torch.nn.Module.

Counterpart of bayeslim_tpu/utils/module.py (Module :136, the prior
hooks set_priors / eval_prior :246-279, update / unset_param / push /
copy / clone :205-301, model2pdict :354). The JAX
Module is a pytree whose trainable leaves are marked by name; here
trainable leaves are ``nn.Parameter``s, so
``model.named_parameters()`` gives the same dotted keys as the JAX
package's ``model2pdict`` ("sky.params", "beam.params", ...).

``Sequential`` chains models; it holds them in an ``nn.ModuleDict``
named ``models``, so its parameter keys read "models.rime.array.antvecs",
"models.cal.params", as the JAX package's do.

``updated(pdict)`` is the functional update of the JAX package: it
returns a copy of the module tree whose leaves at pdict's paths are the
given tensors (gradients then flow into those tensors), sharing every
other submodule and tensor with the original. ``model[path]`` reads the
leaf at a dotted path. ``update(pdict)`` is the in-place update: it
copies values into the leaves' own tensors, so a Parameter stays the
object an optimizer holds. ``copy()`` gives the copy its own top-level
tensors, so an update of the copy's top-level leaves leaves the
original as it was; submodules stay shared, as in the JAX package.

Priors: ``set_priors`` attaches log-prior callables evaluated on a
module's input params and / or its response output; ``eval_prior``
(called by each model's forward) memoises their sum in a prior_cache
dict under the module's name, so module names must be unique within a
model that carries priors (a second module of the same name would find
its slot taken and its prior dropped).
"""
from __future__ import annotations

import copy as _copy

import torch
from torch import nn

from .paramdict import ParamDict

__all__ = ["Module", "Sequential", "model2pdict"]


def _shallow(mod):
    """Copy one nn.Module node, with its own registries."""
    new = _copy.copy(mod)
    new._parameters = dict(mod._parameters)
    new._buffers = dict(mod._buffers)
    new._modules = dict(mod._modules)
    return new


class Module(nn.Module):
    """Base class of all model blocks."""

    def __init__(self, name=None):
        super().__init__()
        self.name = name if name is not None else self.__class__.__name__
        self.priors_inp_params = None
        self.priors_out_params = None

    def __getitem__(self, path):
        """The attribute at a dotted path ("models.cal.params")."""
        obj = self
        for p in path.split("."):
            obj = getattr(obj, p)
        return obj

    def set_param(self, name):
        """Make the tensor attribute ``name`` a trainable nn.Parameter."""
        t = getattr(self, name)
        if isinstance(t, nn.Parameter):
            return
        self._buffers.pop(name, None)
        self.__dict__.pop(name, None)
        self.register_parameter(name, nn.Parameter(t.detach()))

    def unset_param(self, name):
        """Make the trainable attribute(s) name plain (non-trainable)
        buffers holding the same values."""
        for n in [name] if isinstance(name, str) else list(name):
            t = self._parameters.pop(n, None)
            if t is not None:
                self.register_buffer(n, t.detach())

    def _resolve(self, path):
        """(the module owning the leaf at a dotted path, its name)."""
        parts = path.split(".")
        obj = self
        for p in parts[:-1]:
            obj = getattr(obj, p)
        return obj, parts[-1]

    def update(self, pdict, clobber_param=False):
        """Write pdict's values into the leaves at its dotted paths, in
        place: a tensor leaf of the same shape gets the values copied in
        (cast to its dtype and device), anything else is replaced.
        clobber_param makes each written leaf non-trainable."""
        items = pdict.items() if hasattr(pdict, "items") else pdict
        for path, v in items:
            obj, last = self._resolve(path)
            cur = getattr(obj, last, None)
            if isinstance(cur, torch.Tensor):
                t = torch.as_tensor(v, device=cur.device)
                if t.shape == cur.shape:
                    with torch.no_grad():
                        cur.copy_(t.to(cur.dtype))
                elif last in obj._parameters:
                    obj._parameters[last] = nn.Parameter(t.detach())
                elif last in obj._buffers:
                    obj._buffers[last] = t
                else:
                    setattr(obj, last, t)
            else:
                setattr(obj, last, v)
            if clobber_param and isinstance(obj, Module):
                obj.unset_param(last)

    def push(self, device):
        """Move every tensor of the tree to device, in place: parameters
        and buffers (Parameters stay the same objects), and tensors held
        in plain attributes, lists, tuples and dicts (precomputed
        indices and constants). Returns self."""
        dev = torch.device(device)
        self.to(dev)
        for mod in self.modules():
            for k, v in list(mod.__dict__.items()):
                if k in ("_parameters", "_buffers", "_modules"):
                    continue
                moved = _move(v, dev)
                if moved is not v:
                    mod.__dict__[k] = moved
        return self

    def copy(self):
        """Shallow copy: the same submodules, but its own registries and
        its own copies of its top-level tensors, so that update() on the
        copy leaves the original as it was (as a copy of a JAX Module
        gets its own leaves)."""
        new = _shallow(self)
        for k, v in new._parameters.items():
            if v is not None:
                new._parameters[k] = nn.Parameter(
                    v.detach().clone(), requires_grad=v.requires_grad)
        for k, v in new._buffers.items():
            if v is not None:
                new._buffers[k] = v.clone()
        for k, v in list(new.__dict__.items()):
            if isinstance(v, torch.Tensor):
                new.__dict__[k] = v.clone()
        return new

    def clone(self):
        """Deep copy: every tensor copied."""
        return _copy.deepcopy(self)

    def set_priors(self, priors_inp_params=None, priors_out_params=None):
        """Attach priors on the input params and / or the response
        output: each a callable p(x) -> scalar log prior (the priors of
        inference.prob) or a list of them."""
        def _aslist(p):
            if p is None:
                return None
            return list(p) if isinstance(p, (list, tuple)) else [p]
        self.priors_inp_params = _aslist(priors_inp_params)
        self.priors_out_params = _aslist(priors_out_params)

    def eval_prior(self, prior_cache, inp_params=None, out_params=None):
        """Evaluate the attached priors and memoise their sum in
        prior_cache under this module's name (nothing without a cache,
        or when the name is already there)."""
        if prior_cache is None or self.name in prior_cache:
            return
        total = None
        for priors, x in ((self.priors_inp_params, inp_params),
                          (self.priors_out_params, out_params)):
            if priors is None or x is None:
                continue
            for pr in priors:
                if pr is None:
                    continue
                val = pr(x)
                total = val if total is None else total + val
        if total is not None:
            prior_cache[self.name] = total

    def updated(self, pdict):
        """Copy of this module tree with the leaves at pdict's dotted
        paths replaced by pdict's tensors (functional update)."""
        new = _shallow(self)
        for path, value in pdict.items():
            parts = path.split(".")
            obj = new
            for p in parts[:-1]:
                child = _shallow(obj._modules[p])
                obj._modules[p] = child
                obj = child
            last = parts[-1]
            if last not in obj._parameters and last not in obj._buffers \
                    and last not in obj.__dict__:
                raise KeyError(f"updated: no leaf at {path}")
            obj._parameters.pop(last, None)
            obj._buffers.pop(last, None)
            obj.__dict__[last] = value
        return new


def _move(v, dev):
    """v with its tensors (inside lists, tuples and dicts too) on dev;
    v itself when nothing moved."""
    if isinstance(v, torch.Tensor):
        return v if v.device == dev else v.to(dev)
    if isinstance(v, (list, tuple)):
        out = [_move(x, dev) for x in v]
        if all(a is b for a, b in zip(out, v)):
            return v
        return type(v)(out) if isinstance(v, list) else tuple(out)
    if isinstance(v, dict):
        out = {k: _move(x, dev) for k, x in v.items()}
        if all(out[k] is v[k] for k in v):
            return v
        return out
    return v


class Sequential(Module):
    """Ordered chain of models threading one input through each
    (counterpart of bayeslim_tpu/utils/module.py:389). ``models`` maps
    name -> Module in call order; named sub-models are also attributes.
    The first model carries the minibatching (Nbatch / batch_idx)."""

    def __init__(self, models, name=None):
        super().__init__(name=name)
        self.models = nn.ModuleDict(models)

    def forward(self, inp=None, prior_cache=None, **kwargs):
        out = inp
        for model in self.models.values():
            out = model(out, prior_cache=prior_cache, **kwargs)
        return out

    def __getattr__(self, key):
        try:
            return super().__getattr__(key)
        except AttributeError:
            models = self._modules.get("models")
            if models is not None and key in models._modules:
                return models._modules[key]
            raise

    def _first(self):
        return next(iter(self.models.values()))

    @property
    def Nbatch(self):
        return getattr(self._first(), "Nbatch", 1)

    @property
    def batch_idx(self):
        return getattr(self._first(), "batch_idx", 0)

    @batch_idx.setter
    def batch_idx(self, val):
        first = self._first()
        if hasattr(first, "batch_idx"):
            first.batch_idx = val
        elif val > 0:
            raise ValueError("first model in the chain is not batched")


def model2pdict(model, clone=False):
    """ParamDict of the model's trainable parameters by dotted path."""
    d = dict(model.named_parameters())
    if clone:
        d = {k: v.detach().clone() for k, v in d.items()}
    return ParamDict(d)
