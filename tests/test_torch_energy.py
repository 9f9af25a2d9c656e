"""The energy repair of inference/prob.py: a float32 model's chi^2 is
summed, and its likelihood normalised, in float64, so that a sampler's
dH (needed to ~0.1) is not decided by the rounding of a ~1e8-term
float32 sum (whose ulp is ~8 at hera-cal's width). Gradients keep the
working dtype and their values."""
import numpy as np
import torch

import bayeslim_tpu_torch as bt
from bayeslim_tpu_torch.data.containers import TensorData
from bayeslim_tpu_torch.inference.prob import _sum_chisq


class Vis(bt.Module):
    """The model visibilities are its parameter (real pairs)."""

    def __init__(self, v):
        super().__init__(name="vis")
        self.register_buffer("params", torch.as_tensor(v))
        self.set_param("params")

    def forward(self, inp=None, prior_cache=None, **kwargs):
        return torch.view_as_complex(self.params)


def _prob(n, dtype, icov=True, seed=0):
    """A LogProb of n complex points of unit noise about the model."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 2)) * 3.0
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        / np.sqrt(2)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    data = torch.as_tensor(v[:, 0] + 1j * v[:, 1] + noise, dtype=cdt)
    tgt = TensorData()
    tgt.setup_data(data=data, icov=torch.ones(n, dtype=dtype) if icov
                   else None)
    return bt.LogProb(Vis(torch.as_tensor(v, dtype=dtype)), tgt)


def test_float32_chisq_of_1e7_points_within_1e3_of_float64():
    n = 10_000_000
    p32 = _prob(n, torch.float32)
    with torch.no_grad():
        chisq32, res, _ = p32.forward_chisq()
    assert chisq32.dtype == torch.float64
    r = res.to(torch.complex128)
    ref = float(torch.sum((r.conj() * r).real))
    assert abs(float(chisq32) - ref) <= 1e-3
    # a float32 sum of the same terms is off by far more: what the
    # repair removes
    terms = (res.conj() * res).real
    assert abs(float(torch.sum(terms)) - ref) > 1e-3
    assert abs(float(_sum_chisq(terms)) - ref) <= 1e-3


def test_float32_model_loss_is_float64_and_gradient_unchanged():
    n = 4096
    p32 = _prob(n, torch.float32)
    p64 = _prob(n, torch.float64)
    for compute in ("post", "like"):
        p32.compute = p64.compute = compute
        loss, grad = p32.value_and_grad()
        assert loss.dtype == torch.float64 and loss.ndim == 0
        g = grad["params"]
        assert g.dtype == torch.float32
        # d chi^2 / d v = 2 (v - d) in the working dtype
        res = torch.view_as_real(p32.model() - p32.target[0].data)
        assert torch.equal(g, 2 * res)
        loss64, grad64 = p64.value_and_grad()
        assert abs(float(loss) - float(loss64)) <= 1e-6 * abs(float(loss64))
    like, _ = p32.forward_like()
    assert like.dtype == torch.float64


def test_complex64_chisq_sum_and_float64_untouched():
    rng = np.random.default_rng(1)
    z = rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
    z32 = torch.as_tensor(z, dtype=torch.complex64)
    s = _sum_chisq(z32)
    assert s.dtype == torch.float64
    assert abs(float(s) - float(torch.sum(z32.real.double()))) <= 1e-9
    x = torch.as_tensor(rng.standard_normal(1000))
    assert torch.equal(_sum_chisq(x), torch.sum(x))
    # float64 losses are bit-for-bit the plain sum
    p64 = _prob(512, torch.float64)
    chisq, res, _ = p64.forward_chisq()
    assert torch.equal(chisq, torch.sum(res.conj() * res).real)


def test_chunked_float64_sum_and_its_gradient(monkeypatch):
    """Several chunks (a ragged last one): the value is the float64 sum,
    the gradient a float32 sum's (ones times the upstream gradient)."""
    from bayeslim_tpu_torch.inference import prob as tprob
    monkeypatch.setattr(tprob, "_SUM_CHUNK", 100)
    rng = np.random.default_rng(2)
    z = torch.as_tensor(rng.standard_normal(1037) * 1e3
                        + 1j * rng.standard_normal(1037),
                        dtype=torch.complex64).requires_grad_(True)
    s = _sum_chisq(z)
    assert s.dtype == torch.float64
    ref = float(torch.sum(z.detach().real.double()))
    assert abs(float(s.detach()) - ref) <= 1e-12 * abs(ref)
    (3.0 * s).backward()
    assert z.grad.dtype == torch.complex64
    assert torch.equal(z.grad, torch.full_like(z.grad, 3.0))
