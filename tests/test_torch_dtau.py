"""The port's delay cotangent (ops/rime_cuda.py::rime_dtau and the
RimeFusedBS backward) against autograd and the JAX package.

- the plain version vs autograd through rime_fwd_plain (float64): the
  contract dtauT = sum_r w_r Im(conj(g) ps E) in PyTorch's gradient
  convention;
- the plain version vs the Pallas kernel `_dtau_pallas` in interpret
  mode (float32), whose cotangent is JAX's ct itself;
- a float64 gradcheck of RimeFusedBS with respect to blvecs and s_c
  alone, and the rule that the backward runs each kernel only for a
  gradient that is asked for.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.ops import rime_pallas
from bayeslim_tpu_torch.ops import rime_cuda
from bayeslim_tpu_torch.utils.dtypes import C_MS

F0, DF = 100e6, 20e6 / 7


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _case(seed, nstack, nf, K, N, ps_real, tau_max=1e-7):
    rng = np.random.default_rng(seed)
    R = nstack * nf
    ps = rng.standard_normal((R, K))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal((R, K))
    ct = rng.standard_normal((R, N)) + 1j * rng.standard_normal((R, N))
    return ps, ct, rng.uniform(-tau_max, tau_max, (K, N))


@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("nstack,nf", [(1, 24), (3, 5)])
def test_dtau_plain_vs_autograd_f64(ps_real, conj, nstack, nf):
    ps, g, tauT = _case(0, nstack, nf, 70, 9, ps_real)
    tau = torch.as_tensor(tauT).requires_grad_(True)
    p, gt = torch.as_tensor(ps), torch.as_tensor(g)
    out = rime_cuda.rime_fwd_plain(p, tau, F0, DF, nf, conj=conj)
    (ref,) = torch.autograd.grad(out, tau, gt)
    got = rime_cuda.rime_dtau(gt.conj(), p, tau.detach(), F0, DF, nf,
                              conj=conj)
    assert got.dtype == torch.float64 and got.shape == tauT.shape
    assert _relerr(got.numpy(), ref.numpy()) <= 1e-9


@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_dtau_plain_vs_pallas_interpret(ps_real, conj):
    nstack, nf, K, N = 2, 8, 200, 24
    ps, ct, tauT = _case(1, nstack, nf, K, N, ps_real)
    ps = ps.astype(np.float32 if ps_real else np.complex64)
    ct = ct.astype(np.complex64)
    tauT = tauT.astype(np.float32)
    ref = rime_pallas._dtau_pallas(jnp.asarray(ct), jnp.asarray(ps),
                                   jnp.asarray(tauT), F0, DF, nf, conj=conj,
                                   interpret=True)
    got = rime_cuda.rime_dtau(torch.as_tensor(ct), torch.as_tensor(ps),
                              torch.as_tensor(tauT), F0, DF, nf, conj=conj)
    assert got.dtype == torch.float32
    # the JAX package's own bar for its kernel (tests/test_pallas.py)
    assert _relerr(got.numpy(), np.asarray(ref)) <= 2e-4


def _fused_inputs(ps_real, seed=4):
    rng = np.random.default_rng(seed)
    nf, nstack, npx, nb = 3, 2, 5, 4
    ps = rng.standard_normal((nf * nstack, npx))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal(ps.shape)
    blvecs = rng.uniform(-10, 10, (nb, 3))
    s = rng.standard_normal((3, npx))
    return nf, ps, blvecs, s / np.linalg.norm(s, axis=0)


@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_fused_function_gradcheck_delays_f64(ps_real, conj):
    nf, ps, blvecs, u = _fused_inputs(ps_real)
    p = torch.as_tensor(ps)
    inputs = [torch.as_tensor(x).requires_grad_(True) for x in (blvecs, u)]

    def fn(b, uu):
        return rime_cuda.rime_fused_bs(p, b, uu / C_MS, 100e6, 1e6, nf, conj)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("need", [(True, False, False), (False, True, False),
                                  (False, False, True), (True, True, True)])
def test_backward_runs_only_the_kernels_asked_for(monkeypatch, need):
    calls = {"fwd": 0, "dtau": 0}
    fwd, dtau = rime_cuda.rime_fwd, rime_cuda.rime_dtau

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(rime_cuda, "rime_fwd", spy("fwd", fwd))
    monkeypatch.setattr(rime_cuda, "rime_dtau", spy("dtau", dtau))
    nf, ps, blvecs, u = _fused_inputs(False)
    args = [torch.as_tensor(x).requires_grad_(n)
            for x, n in zip((ps, blvecs, u / C_MS), need)]
    out = rime_cuda.rime_fused_bs(*args, 100e6, 1e6, nf)
    assert calls == {"fwd": 1, "dtau": 0}
    out.abs().sum().backward()
    # one pixel chunk: the role-swapped forward for ps, one delay
    # cotangent shared by blvecs and s_c
    assert calls == {"fwd": 1 + need[0], "dtau": int(need[1] or need[2])}
    assert [a.grad is not None for a in args] == list(need)
