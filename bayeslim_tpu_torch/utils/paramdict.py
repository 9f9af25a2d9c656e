"""
ParamDict: a dict of named parameter tensors with elementwise algebra.

Counterpart of bayeslim_tpu/utils/paramdict.py (ParamDict :34, its
convenience surface :84-172, write_pdict / read_pdict :186-195). Keys
are the dotted parameter paths of a model ("sky.params", "beam.params",
...) and iterate in sorted order, as in the JAX package. A ParamDict's
pickle is the JAX package's: a plain dict of numpy arrays, so either
package reads the other's.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .dtypes import resolve_device

__all__ = ["ParamDict", "load_numpy_pdict", "write_pdict", "read_pdict"]


def _binary(op):
    def fn(self, other):
        if isinstance(other, ParamDict):
            return ParamDict({k: op(self[k], other[k]) for k in self})
        return ParamDict({k: op(self[k], other) for k in self})
    return fn


def _rbinary(op):
    def fn(self, other):
        return ParamDict({k: op(other, self[k]) for k in self})
    return fn


class ParamDict:
    """An ordered dict of named tensors with elementwise operators."""

    def __init__(self, params):
        self.params = dict(params)

    def __getitem__(self, key):
        return self.params[key]

    def __setitem__(self, key, val):
        self.params[key] = val

    def __delitem__(self, key):
        del self.params[key]

    def __contains__(self, key):
        return key in self.params

    def __iter__(self):
        return iter(sorted(self.params))

    def __len__(self):
        return len(self.params)

    def keys(self):
        return sorted(self.params)

    def values(self):
        return [self.params[k] for k in self.keys()]

    def items(self):
        return [(k, self.params[k]) for k in self.keys()]

    def update(self, other):
        """In-place update of entries from another dict or ParamDict."""
        for k in other:
            self.params[k] = other[k]

    __add__ = _binary(lambda a, b: a + b)
    __radd__ = _rbinary(lambda b, a: b + a)
    __sub__ = _binary(lambda a, b: a - b)
    __rsub__ = _rbinary(lambda b, a: b - a)
    __mul__ = _binary(lambda a, b: a * b)
    __rmul__ = _rbinary(lambda b, a: b * a)
    __truediv__ = _binary(lambda a, b: a / b)
    __rtruediv__ = _rbinary(lambda b, a: b / a)
    __pow__ = _binary(lambda a, b: a ** b)
    __matmul__ = _binary(lambda a, b: a @ b)

    def __neg__(self):
        return ParamDict({k: -v for k, v in self.items()})

    def operator(self, func, args=(), inplace=False):
        """Apply func to every value, returning a new ParamDict. Extra
        args are passed through; dict / ParamDict args are indexed by
        the same key. inplace assigns back into self and returns None."""
        def call(k):
            extra = (a[k] if isinstance(a, (dict, ParamDict)) else a
                     for a in args)
            return func(self[k], *extra)
        if inplace:
            for k in self.keys():
                self[k] = call(k)
            return None
        return ParamDict({k: call(k) for k in self.keys()})

    def copy(self):
        """New ParamDict holding the same tensors."""
        return ParamDict(self.params)

    def clone(self):
        """New ParamDict of copies of the tensors (autograd history
        kept, as torch.clone does)."""
        return self.operator(torch.clone)

    def detach(self):
        """The tensors detached from autograd."""
        return self.operator(torch.Tensor.detach)

    def ones(self):
        return self.operator(torch.ones_like)

    def zeros(self):
        return self.operator(torch.zeros_like)

    def push(self, device):
        """The tensors moved to a device."""
        return self.operator(lambda v: v.to(device))

    def ravel(self):
        """Concatenate all values, in key order, into one flat vector."""
        return torch.cat([v.reshape(-1) for v in self.values()])

    def unravel(self, flat):
        """Inverse of ravel given this ParamDict's shapes and dtypes."""
        out, i = {}, 0
        for k, v in self.items():
            n = v.numel()
            out[k] = flat[i:i + n].reshape(v.shape).to(v.dtype)
            i += n
        return ParamDict(out)

    def write_pkl(self, fname, overwrite=False):
        write_pdict(fname, self, overwrite=overwrite)

    @staticmethod
    def read_pkl(fname, device=None):
        """A ParamDict pickled by write_pkl (or by the JAX package), on
        device."""
        return read_pdict(fname, device=device)

    def __repr__(self):
        body = ", ".join(f"{k}: {tuple(v.shape)}" for k, v in self.items())
        return f"ParamDict({body})"


def write_pdict(fname, pdict, overwrite=False):
    """Pickle a ParamDict as a dict of numpy arrays."""
    if os.path.exists(fname) and not overwrite:
        raise FileExistsError(fname)
    with open(fname, "wb") as f:
        pickle.dump({k: v.detach().cpu().numpy()
                     if isinstance(v, torch.Tensor) else np.asarray(v)
                     for k, v in pdict.items()}, f)


def read_pdict(fname, device=None):
    """A ParamDict pickled by write_pdict, its tensors on device."""
    with open(fname, "rb") as f:
        d = pickle.load(f)
    dev = resolve_device(device)
    return ParamDict({k: torch.as_tensor(np.asarray(v), device=dev)
                      for k, v in d.items()})


def load_numpy_pdict(model, arrays):
    """Copy numpy arrays, keyed like ``model2pdict(model)``, into the
    model's parameters in place.

    Raises KeyError on a missing or an extra key and ValueError on a
    shape mismatch; nothing is written unless every key checks out.
    """
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"load_numpy_pdict: missing keys {missing}, "
                       f"extra keys {extra}")
    for k, v in arrays.items():
        if tuple(np.shape(v)) != tuple(params[k].shape):
            raise ValueError(f"load_numpy_pdict: {k} has shape "
                             f"{tuple(np.shape(v))}, model expects "
                             f"{tuple(params[k].shape)}")
    with torch.no_grad():
        for k, v in arrays.items():
            p = params[k]
            p.copy_(torch.as_tensor(np.asarray(v), dtype=p.dtype))
    return model
