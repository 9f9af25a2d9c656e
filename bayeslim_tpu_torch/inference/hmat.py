"""
Operators for the optimizers' inverse-Hessian estimates.

Counterpart of bayeslim_tpu/inference/hmat.py (DiagMat :184). This
slice carries DiagMat only, as the diagonal that LBFGS takes for H0 and
reports as its running starting inverse Hessian (LBFGS.H). Its products
and the other operators come with the samplers (ROADMAP queue A,
slice 3).
"""
from __future__ import annotations

import torch

__all__ = ["DiagMat"]


class DiagMat:
    """Diagonal (or scalar) operator stored as a vector; a scalar matrix
    is a length-1 diagonal with size."""

    def __init__(self, d, size=None):
        d = torch.atleast_1d(torch.as_tensor(d))
        if size is not None and d.numel() == 1:
            d = d.expand(int(size)).clone()
        self.d = d
        self.shape = (len(d), len(d))

    @property
    def diag(self):
        return self.d

    def diagonal(self):
        return self.d
