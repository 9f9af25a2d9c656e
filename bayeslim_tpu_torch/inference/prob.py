"""
The (negative) Gaussian log-posterior of a forward model against data.

Counterpart of bayeslim_tpu/inference/prob.py (apply_icov :249, LogProb
:293, the batching API :322-345, `_batch_fn` :515, value_and_grad
:621). The JAX package jits ``value_and_grad`` of a pure function of a
ParamDict; here the same function runs eagerly and
``torch.autograd.grad`` differentiates it. The target is a list, one
entry per minibatch of the model (Nbatch, batch_idx), and
grad_type='accumulate' sums the gradients over every batch. Only
diagonal covariances and no priors (a flat prior) are carried in this
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.containers import TensorData
from ..utils.module import Module, model2pdict
from ..utils.paramdict import ParamDict

__all__ = ["apply_icov", "LogProb"]


def apply_icov(data, icov):
    """data^H Sigma^-1 data for a diagonal icov (None: identity)."""
    out = data.conj() * data
    return out if icov is None else out * icov


class LogProb(Module):
    """Negative log-posterior under a flat prior: the Gaussian chi^2 of
    model() against a target. complex_circular=True (the default) gives
    -ln L = chi^2 + n ln(pi) + ln det C; False gives the real Gaussian
    -ln L = chi^2 / 2 + (n ln(2 pi) + ln det C) / 2. The model may be a
    Sequential chain.

    target: one TensorData or a list of them, batch i using entry
    i mod len(target). grad_type 'accumulate': value_and_grad returns
    the mean loss over the model's batches and the sum of their
    gradients, as the JAX package does; any other value: the active
    batch's alone.
    """

    def __init__(self, model, target, grad_type="accumulate",
                 complex_circular=True, name=None):
        super().__init__(name=name)
        self.model = model
        self.target = [target] if isinstance(target, TensorData) \
            else list(target)
        self.grad_type = grad_type
        self.complex_circular = complex_circular

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

    def collect_main_params(self):
        """ParamDict of the model's trainable leaves, keyed like the JAX
        package ('sky.params', 'beam.params', ...)."""
        return model2pdict(self.model)

    def forward(self, pdict=None, idx=None):
        """Negative log posterior of batch idx (default: the active one)
        with the model's parameters, or with pdict's tensors in their
        place."""
        tgt = self.get_batch_data(idx)
        model = self.model if pdict is None else self.model.updated(pdict)
        data, icov = tgt.get_data(), tgt.get_icov()
        out = model()
        if isinstance(out, TensorData):
            out = out.data
        chisq = torch.sum(apply_icov(out - data, icov))
        if chisq.is_complex():
            chisq = chisq.real
        norm = 0.0
        if icov is not None and tgt.cov_logdet is not None:
            if self.complex_circular:
                norm = tgt.cov_ndim * np.log(np.pi) + tgt.cov_logdet
            else:
                norm = 0.5 * (tgt.cov_ndim * np.log(2 * np.pi)
                              + tgt.cov_logdet)
        return (chisq if self.complex_circular else 0.5 * chisq) + norm

    def _value_and_grad(self, leaves, idx):
        loss = self(leaves, idx=idx)
        grads = torch.autograd.grad(loss, leaves.values())
        return loss.detach(), ParamDict(dict(zip(leaves.keys(), grads)))

    def value_and_grad(self, pdict=None):
        """Loss and the ParamDict of its gradients with respect to
        pdict (default: the model's own parameters); accumulated over
        the batches for grad_type 'accumulate'."""
        if pdict is None:
            pdict = self.collect_main_params()
        leaves = ParamDict({k: v.detach().requires_grad_(True)
                            for k, v in pdict.items()})
        if self.grad_type != "accumulate" or self.Nbatch == 1:
            return self._value_and_grad(leaves, None)
        loss = grads = None
        for i in range(self.Nbatch):
            v, g = self._value_and_grad(leaves, i)
            loss = v if loss is None else loss + v
            grads = g if grads is None else grads + g
        self.batch_idx = 0
        return loss / self.Nbatch, grads

    def update(self, pdict):
        """Write a ParamDict's values into the model's parameters."""
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for k, v in pdict.items():
                params[k].copy_(v)
