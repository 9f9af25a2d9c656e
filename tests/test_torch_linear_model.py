"""The port's linear models against the JAX package: the design matrices
of every mode, LinearModel's forward and gradient under each option,
least_squares, generate_A, MultiLM and DictLM (also as a LogProb's LM on
the small hera-cal chain), the promotion of real and complex operands,
and Bessel J0. Inputs come from numpy seeds; everything compares at
float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import bessel as jbessel
from bayeslim_tpu.models import linear_model as jlm
from bayeslim_tpu_torch.models import bessel as tbessel
from bayeslim_tpu_torch.models import linear_model as tlm
from bayeslim_tpu_torch.ops import linalg as tlinalg

from _torch_graft import build_cal_jax, build_cal_torch

CPU = dict(device="cpu")
X = np.linspace(100e6, 120e6, 12)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


POLY = [dict(basis=b, Ndeg=4) for b in ("direct", "legendre", "chebyshevt",
                                        "chebyshevu", "laguerre")] + [
    dict(basis="legendre", Ndeg=5, whiten=True, qr=True),
    dict(basis="direct", Ndeg=3, whiten=False, d0=1e8, logx=True),
    dict(basis="direct", Ndeg=3, whiten=True, x0=110e6, dx=2e7)]


@pytest.mark.parametrize("kw", POLY)
def test_gen_poly_A_vs_jax(kw):
    want = jlm.gen_linear_A("poly", x=X, **kw)
    got = tlm.gen_linear_A("poly", x=X, dtype=torch.float64, **CPU, **kw)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _relerr(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("Ndeg,norm", [(None, "ortho"), (5, "ortho"),
                                       (6, None), (7, "forward")])
def test_gen_fourier_A_vs_jax(Ndeg, norm):
    jA, jf = jlm.gen_fourier_A(X, Ndeg=Ndeg, fft_norm=norm)
    tA, tf = tlm.gen_fourier_A(X, Ndeg=Ndeg, fft_norm=norm,
                               dtype=torch.complex128, **CPU)
    assert _relerr(tA.numpy(), jA) <= 1e-12
    np.testing.assert_array_equal(tf, np.asarray(jf))
    # a complex matrix stays complex by default
    assert tlm.gen_linear_A("fourier", x=X, Ndeg=Ndeg, fft_norm=norm,
                            **CPU).is_complex()


# (mode, LinearModel kwargs, params shape, complex params, custom A)
CASES = [
    ("poly", dict(dim=1, x=X, Ndeg=4, basis="legendre", whiten=True),
     (2, 4, 3), False, None),
    ("poly", dict(dim=-1, x=X, Ndeg=4, basis="legendre", whiten=True),
     (1, 1, 3, 2, 4), True, None),
    ("poly", dict(dim=0, x=X, Ndeg=3, coeff=np.array([1.0, 0.5, 0.25])[
        :, None], out_real=True), (3, 5), True, None),
    ("poly", dict(dim=2, x=X, Ndeg=4, basis="chebyshevt",
                  idx=np.array([0, 2, 3, 1]), out_reshape=(2, -1)),
     (2, 1, 5), False, None),
    ("poly", dict(dim=1, x=X, Ndeg=3, dtype=torch.complex128),
     (2, 3, 2), False, None),
    ("fourier", dict(dim=1, x=X, Ndeg=6), (3, 6), False, None),
    ("fourier", dict(dim=0, x=X, Ndeg=6, out_real=True,
                     out_dtype=torch.complex128), (6, 2), True, None),
    ("custom", dict(dim=1), (2, 5, 3), True, "real"),
    ("custom", dict(dim=1), (2, 5, 3), False, "complex"),
    ("custom", dict(dim=2), (2, 3, 5, 4), False, "batched"),
    ("custom", dict(dim=1, diag=True), (2, 5, 3), True, "diag"),
]


def _custom_A(kind, rng):
    if kind == "real":
        return rng.standard_normal((7, 5))
    if kind == "complex":
        return rng.standard_normal((7, 5)) + 1j * rng.standard_normal((7, 5))
    if kind == "batched":
        return rng.standard_normal((3, 7, 5))
    return rng.standard_normal(5)


@pytest.mark.parametrize("mode,kw,shape,cplx,Akind", CASES)
def test_linear_model_forward_and_grad_vs_jax(mode, kw, shape, cplx, Akind):
    """Every option of the forward, and the gradient of a real loss of
    it (torch's is the conjugate of JAX's for a complex leaf)."""
    rng = np.random.default_rng(0)
    A = None if Akind is None else _custom_A(Akind, rng)
    jkw = {k: v for k, v in kw.items() if k != "dtype"}
    if "out_dtype" in jkw:
        jkw["out_dtype"] = jnp.complex128
    if kw.get("dtype") is torch.complex128:
        jkw["dtype"] = jnp.complex128
    extra = {} if A is None else dict(A=A)
    jm = jlm.LinearModel(mode, **jkw, **extra)
    tdt = kw.get("dtype", torch.complex128 if (mode == "fourier"
                                               or np.iscomplexobj(A))
                  else torch.float64)
    tm = tlm.LinearModel(mode, **dict(kw, dtype=tdt), **extra, **CPU)
    p = rng.standard_normal(shape)
    if cplx:
        p = p + 1j * rng.standard_normal(shape)
    w = rng.standard_normal(np.shape(jm(jnp.asarray(p))))

    def jloss(q):
        return jnp.sum(jnp.real(jm(q)) * w) + jnp.sum(jnp.imag(jm(q)) * w)
    want = jm(jnp.asarray(p))
    jg = jax.grad(jloss)(jnp.asarray(p))
    pt = torch.as_tensor(p).requires_grad_(True)
    got = tm(pt)
    assert tuple(got.shape) == want.shape
    assert got.is_complex() == np.iscomplexobj(want)
    assert _relerr(got.detach().numpy(), want) <= 1e-12
    wt = torch.as_tensor(w)
    loss = torch.sum(got.real * wt) + (torch.sum(got.imag * wt)
                                       if got.is_complex() else 0.0)
    (tg,) = torch.autograd.grad(loss, pt)
    assert _relerr(tg.numpy(), np.conj(np.asarray(jg))) <= 1e-12


@pytest.mark.parametrize("A_cplx,x_cplx", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_apply_along_promotes_both_ways(A_cplx, x_cplx):
    """A real A on complex params and a complex A on real params give
    jnp.einsum's promoted product, in the wider precision of the two."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((4, 3)) + (1j * rng.standard_normal((4, 3))
                                       if A_cplx else 0)
    x = rng.standard_normal((2, 3, 5)) + (1j * rng.standard_normal((2, 3, 5))
                                          if x_cplx else 0)
    want = jnp.einsum("ab,ibk->iak", jnp.asarray(A), jnp.asarray(x))
    got = tlinalg.apply_along(torch.as_tensor(A), torch.as_tensor(x), 1)
    assert got.dtype == (torch.complex128 if A_cplx or x_cplx
                         else torch.float64)
    assert _relerr(got.numpy(), want) <= 1e-13
    # float32 A on float64 params promotes to float64
    got = tlinalg.apply_along(torch.as_tensor(A).to(
        torch.complex64 if A_cplx else torch.float32), torch.as_tensor(x), 1)
    assert got.real.dtype == torch.float64


@pytest.mark.parametrize("kw", [dict(), dict(Ninv=np.linspace(1, 2, 12)),
                                dict(norm="pinv", mode="lstsq")])
@pytest.mark.parametrize("cplx", [False, True])
def test_least_squares_vs_jax(kw, cplx):
    rng = np.random.default_rng(2)
    jm = jlm.LinearModel("poly", dim=1, x=X, Ndeg=4, basis="legendre",
                         whiten=True)
    tm = tlm.LinearModel("poly", dim=1, x=X, Ndeg=4, basis="legendre",
                         whiten=True, dtype=torch.float64, **CPU)
    y = rng.standard_normal((3, 12)) + (1j * rng.standard_normal((3, 12))
                                        if cplx else 0)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jm.least_squares(jnp.asarray(y), **jkw)
    got = tm.least_squares(torch.as_tensor(y), cache_D=True, **tkw)
    assert _relerr(got.numpy(), want) <= 1e-9
    if kw.get("mode") != "lstsq":
        # the cached normalisation gives the same answer again
        assert tm._D is not None
        again = tm.least_squares(torch.as_tensor(y), **tkw)
        assert _relerr(again.numpy(), want) <= 1e-9
    # a poly fit inverts the forward of its own coefficients
    c = torch.as_tensor(rng.standard_normal((3, 4)))
    assert _relerr(tlm.LinearModel(
        "poly", dim=1, x=X, Ndeg=4, basis="legendre", whiten=True,
        dtype=torch.float64, **CPU).least_squares(tm(c)).numpy(),
        c.numpy()) <= 1e-9


def test_least_squares_diag_vs_jax():
    rng = np.random.default_rng(3)
    d = rng.uniform(1, 2, 6)
    jm = jlm.LinearModel("custom", A=d, dim=1, diag=True)
    tm = tlm.LinearModel("custom", A=d, dim=1, diag=True,
                         dtype=torch.float64, **CPU)
    y = rng.standard_normal((2, 6))
    want = jm.least_squares(jnp.asarray(y))
    got = tm.least_squares(torch.as_tensor(y))
    assert _relerr(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("mode", ["poly", "custom", "fourier"])
def test_generate_A_vs_jax(mode):
    rng = np.random.default_rng(4)
    if mode == "custom":
        kw = dict(A=rng.standard_normal((12, 3)), x=X)
    elif mode == "poly":
        kw = dict(x=X, Ndeg=4, basis="legendre", whiten=True)
    else:
        kw = dict(x=X, Ndeg=5)
    jm = jlm.LinearModel(mode, dim=0, **kw)
    tm = tlm.LinearModel(mode, dim=0, dtype=torch.complex128
                         if mode == "fourier" else torch.float64, **kw,
                         **CPU)
    x2 = np.linspace(101e6, 119e6, 9)
    ikw = dict(kind="cubic") if mode == "custom" else {}
    want = jm.generate_A(x2, **ikw)
    got = tm.generate_A(x2, **ikw)
    assert got.device == tm.A.device and got.shape == want.shape
    assert _relerr(got.numpy(), want) <= 1e-12


def test_multi_lm_vs_jax():
    """Two LinearModels on two dims: forward and least_squares (each
    model inverts in the chain's order, as the JAX MultiLM does)."""
    rng = np.random.default_rng(5)
    f2 = np.linspace(0, 1, 6)
    kws = [dict(dim=1, x=X, Ndeg=4, basis="legendre", whiten=True),
           dict(dim=2, x=f2, Ndeg=3, basis="direct", whiten=True)]
    jm = jlm.MultiLM([jlm.LinearModel("poly", **k) for k in kws])
    tm = tlm.MultiLM([tlm.LinearModel("poly", dtype=torch.float64, **k,
                                      **CPU) for k in kws])
    p = rng.standard_normal((2, 4, 3))
    want = jm(jnp.asarray(p))
    got = tm(torch.as_tensor(p))
    assert _relerr(got.numpy(), want) <= 1e-12
    y = rng.standard_normal((2, 12, 6))
    assert _relerr(tm.least_squares(torch.as_tensor(y)).numpy(),
                   jm.least_squares(jnp.asarray(y))) <= 1e-9


def test_dict_lm_vs_jax():
    rng = np.random.default_rng(6)
    kw = dict(dim=0, x=X, Ndeg=3, basis="legendre", whiten=True)
    jd = jlm.DictLM({"a": jlm.LinearModel("poly", **kw)})
    td = tlm.DictLM({"a": tlm.LinearModel("poly", dtype=torch.float64, **kw,
                                          **CPU)})
    p = rng.standard_normal((3, 2))
    assert _relerr(td("a", torch.as_tensor(p)).numpy(),
                   jd("a", jnp.asarray(p))) <= 1e-12
    # other names pass through
    assert torch.equal(td("b", torch.as_tensor(p)), torch.as_tensor(p))
    y = rng.standard_normal((12, 2))
    assert _relerr(td.least_squares("a", torch.as_tensor(y)).numpy(),
                   jd.least_squares("a", jnp.asarray(y))) <= 1e-9


def test_dict_lm_as_logprob_lm_vs_jax():
    """A DictLM as LogProb's LM on the small hera-cal chain: the gains'
    params are a per-channel scaling of the optimizer's (a diagonal
    custom LinearModel along the channel axis); loss and gradients."""
    rng = np.random.default_rng(7)
    tp = build_cal_torch()
    with torch.no_grad():
        target = tp.model().data.numpy()
    tp, jp = build_cal_torch(target=target), build_cal_jax(target)
    nf = tp.model.cal.params.shape[4]
    d = rng.uniform(0.5, 1.5, nf)[:, None]
    key = "models.cal.params"
    tp.LM = tlm.DictLM({key: tlm.LinearModel(
        "custom", A=d, dim=4, diag=True, dtype=torch.float64, **CPU)})
    jp.LM = jlm.DictLM({key: jlm.LinearModel("custom", A=d, dim=4,
                                             diag=True)})
    start = {key: tp.model.cal.params.detach().numpy()
             * (1 + 0.1 * rng.standard_normal(tp.model.cal.params.shape)),
             "models.rime.array.antvecs":
             tp.model.rime.array.antvecs.detach().numpy()}
    # update writes the values after LM into the model, in both
    tp.update(bt.ParamDict({k: torch.as_tensor(v) for k, v in start.items()}))
    jp.update(bl.ParamDict({k: jnp.asarray(v) for k, v in start.items()}))
    tv, tg = tp.value_and_grad()
    jv, jg = jp.value_and_grad()
    assert abs(tv.item() - float(jv)) <= 1e-9 * abs(float(jv))
    for k in tg.keys():
        assert _relerr(tg[k].numpy(), jg[k]) <= 1e-9, k


def test_linear_model_buffers_on_its_device():
    tm = tlm.LinearModel("poly", dim=0, x=X, Ndeg=3, coeff=np.ones(3),
                         idx=[0, 1, 2], **CPU)
    assert tm.A.dtype == torch.float32 and tm.coeff.dtype == torch.float32
    assert {n for n, _ in tm.named_buffers()} == {"A", "coeff", "_idx"}
    assert list(tm.parameters()) == []
    with pytest.raises(ValueError, match="needs A"):
        tlm.LinearModel("custom", **CPU)


def test_j0_vs_jax():
    x = np.concatenate([np.linspace(-20, 20, 401), [0.0, 8.0, -8.0, 1e-31]])
    want = jbessel.j0(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = tbessel.j0(xt)
    assert _relerr(got.detach().numpy(), want) <= 1e-12
    jg = jax.grad(lambda v: jnp.sum(jbessel.j0(v)))(jnp.asarray(x))
    (tg,) = torch.autograd.grad(got.sum(), xt)
    assert _relerr(tg.numpy(), jg) <= 1e-12
