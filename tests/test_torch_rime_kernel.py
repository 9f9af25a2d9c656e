"""The port's RIME reduction (ops/rime_kernel.py, ops/rime_cuda.py)
against the JAX package.

- the kernel's plain version vs the Pallas kernel `_fwd_pallas` in
  interpret mode (float32), every ps / conj / out_imag case;
- the chunked rime_reduce vs JAX rime_reduce: values and gradients with
  respect to psky, blvecs and s_c (float64);
- the fused autograd Function (use_kernel=True, plain version on the
  CPU) vs JAX rime_fused_bs through jax.vjp (float32), and a float64
  gradcheck: together they pin the sign convention of the backward;
- the kernel dispatch with Nmp > 1 model pairs (a host mp_idx: one
  fused call a pair) and with an unfactored delay matrix tau (the
  RimeFused Function): through use_kernel=True against JAX rime_reduce
  with the Pallas kernels in interpret mode (float32, values and
  jax.vjp gradients), and the dispatch itself at float64 against the
  JAX chunked path (1e-9); RimeFused's float64 gradcheck; and
  rime_pallas_reduce against its JAX counterpart.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.ops import rime_pallas
from bayeslim_tpu.ops import rime_kernel as jrk
from bayeslim_tpu_torch.ops import rime_cuda
from bayeslim_tpu_torch.ops import rime_kernel as trk
from bayeslim_tpu_torch.utils.dtypes import C_MS

F0, DF = 100e6, 20e6 / 7


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(rime_pallas, "INTERPRET", True)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _bf16(x):
    """Truncate float32 values to 8 mantissa bits. The Pallas kernel
    splits its contraction operands into bfloat16 hi + lo parts and
    drops the lo * lo term (~1.5e-5 relative); rows that are exactly
    bfloat16 keep that reference exact, so the comparison measures the
    port and not the split."""
    x = np.asarray(x, dtype=np.float32)
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _case(seed, R, K, N, ps_real, tau_max=1e-7):
    """ps (R, K) rows (bfloat16-valued) and tauT (K, N) delays."""
    rng = np.random.default_rng(seed)
    ps = _bf16(rng.standard_normal((R, K)))
    if not ps_real:
        ps = ps + 1j * _bf16(rng.standard_normal((R, K)))
    tauT = rng.uniform(-tau_max, tau_max, (K, N)).astype(np.float32)
    return ps, tauT


@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("out_imag", [True, False])
def test_plain_contract_vs_pallas_interpret(interpret_mode, ps_real, conj,
                                            out_imag):
    nf, R, K, N = 8, 16, 200, 24
    ps, tauT = _case(0, R, K, N, ps_real)
    jre, jim = rime_pallas._fwd_pallas(jnp.asarray(ps), jnp.asarray(tauT),
                                       F0, DF, nf, conj=conj,
                                       out_imag=out_imag)
    out = rime_cuda.rime_fwd(torch.as_tensor(ps), torch.as_tensor(tauT), F0,
                             DF, nf, conj=conj, out_imag=out_imag)
    if out_imag:
        assert out.dtype == torch.complex64
        ref = np.asarray(jre) + 1j * np.asarray(jim)
    else:
        assert out.dtype == torch.float32
        ref = np.asarray(jre)
    assert _relerr(out.numpy(), ref) <= 1e-5


def _reduce_inputs(seed, kind):
    rng = np.random.default_rng(seed)
    nb, nf, npx = 6, 5, 70
    nmp = 2 if kind == "mp" else 1
    psky = rng.standard_normal((1, 1, nmp, nf, npx))
    if kind == "complex":
        psky = psky + 1j * rng.standard_normal(psky.shape)
    blvecs = rng.uniform(-30, 30, (nb, 3))
    s = rng.standard_normal((3, npx))
    s_c = s / np.linalg.norm(s, axis=0) / C_MS
    freqs = np.linspace(100e6, 120e6, nf)
    mp_idx = rng.integers(0, 2, nb) if kind == "mp" else None
    d = rng.standard_normal((1, 1, nb, nf)) * 3
    return psky, blvecs, s_c, freqs, mp_idx, d


@pytest.mark.parametrize("kind", ["real", "complex", "mp"])
def test_rime_reduce_values_and_grads_f64(kind):
    psky, blvecs, s_c, freqs, mp_idx, d = _reduce_inputs(1, kind)
    conj = kind == "complex"

    def jloss(p, b, s):
        v = jrk.rime_reduce(p, None, freqs, mp_idx=mp_idx, conj=conj,
                            chunk=32, use_pallas=False, blvecs=b, s_c=s)
        return jnp.sum(jnp.abs(v - d) ** 2), v

    (jl, jv), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                              has_aux=True))(
        jnp.asarray(psky), jnp.asarray(blvecs), jnp.asarray(s_c))
    tin = [torch.as_tensor(x).requires_grad_(True)
           for x in (psky, blvecs, s_c)]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tv = trk.rime_reduce(tin[0], None, freqs, mp_idx=mp_idx, conj=conj,
                             chunk=32, blvecs=tin[1], s_c=tin[2])
    tl = torch.sum(torch.abs(tv - torch.as_tensor(d)) ** 2)
    # the chunks keep psky per model pair, never gathered onto the
    # baselines: nothing saved for the backward is (..., Nbls, F, C)
    nb, nf = d.shape[-2:]
    assert not [s for s in saved if len(s) >= 3 and s[-3:-1] == (nb, nf)]
    assert any(len(s) >= 3 and s[-3:-1] == psky.shape[-3:-1]
               for s in saved)
    tl.backward()
    assert _relerr(tv.detach().numpy(), jv) <= 1e-9
    assert abs(tl.item() - float(jl)) / abs(float(jl)) <= 1e-9
    for t, j in zip(tin, jg):
        # PyTorch's gradient of a real loss in a complex input is the
        # conjugate of JAX's
        assert _relerr(t.grad.numpy(), np.conj(np.asarray(j))) <= 1e-9
    ref = trk.rime_reduce_ref(tin[0].detach(), torch.as_tensor(blvecs @ s_c),
                              freqs, mp_idx=mp_idx, conj=conj)
    assert _relerr(ref.numpy(), jv) <= 1e-9


def test_kernel_eligibility():
    freqs = np.linspace(100e6, 120e6, 5)
    p32 = torch.zeros(1, 1, 5, 7)
    bv = torch.zeros(3, 3)
    tau = torch.zeros(3, 7)
    elig = trk._kernel_eligible
    assert elig(p32, None, freqs, True, bv)
    assert not elig(p32, None, freqs, "auto", bv)      # CPU tensor
    assert not elig(p32, None, freqs, False, bv)
    assert not elig(p32.double(), None, freqs, True, bv)
    assert not elig(p32, None, freqs, True, None)      # no delays at all
    assert elig(p32, None, freqs, True, None, tau)     # delays unfactored
    assert not elig(p32, None, freqs ** 1.01, True, bv)  # irregular grid
    # Nmp > 1 model pairs with a host baseline -> pair map
    assert elig(torch.zeros(1, 2, 5, 7), np.array([0, 1, 1]), freqs,
                True, bv)
    # a per-baseline psky without a map stays on the chunked path
    assert not elig(torch.zeros(1, 3, 5, 7), None, freqs, True, bv)


def test_device_mp_idx_waits_for_baseline_sharding():
    freqs = np.linspace(100e6, 120e6, 5)
    with pytest.raises(NotImplementedError, match="multi-device"):
        trk.rime_reduce(torch.zeros(1, 1, 2, 5, 7), None, freqs,
                        mp_idx=torch.tensor([0, 1, 1]), use_kernel=True,
                        blvecs=torch.zeros(3, 3), s_c=torch.zeros(3, 7))


def _dispatch_inputs(seed, kind, ps_real, f32=False):
    """psky (2, 2, Nmp, nf, npx) bf16-valued rows, blvecs, s_c, tau, a
    host mp_idx (kind 'mp': 3 of 4 pairs used, 3 baselines each, so the
    unused pair is skipped) and a cotangent."""
    rng = np.random.default_rng(seed)
    nb, nf, npx = 9, 8, 40
    nmp = 4 if kind == "mp" else 1
    psky = _bf16(rng.standard_normal((2, 2, nmp, nf, npx)))
    if not ps_real:
        psky = psky + 1j * _bf16(rng.standard_normal(psky.shape))
    blvecs = rng.uniform(-30, 30, (nb, 3))
    s = rng.standard_normal((3, npx))
    s_c = s / np.linalg.norm(s, axis=0) / C_MS
    mp_idx = np.array([2, 0, 0, 3, 2, 2, 0, 3, 3]) if kind == "mp" else None
    ct = (_bf16(rng.standard_normal((2, 2, nb, nf)))
          + 1j * _bf16(rng.standard_normal((2, 2, nb, nf))))
    if f32:
        blvecs, s_c = blvecs.astype(np.float32), s_c.astype(np.float32)
    else:
        psky = psky.astype(np.float64 if ps_real else np.complex128)
    tau = (blvecs.astype(np.float64) @ s_c.astype(np.float64)).astype(
        np.float32 if f32 else np.float64)
    return psky, blvecs, s_c, tau, mp_idx, ct


def _jax_reduce(psky, blvecs, s_c, tau, mp_idx, freqs, conj, factored,
                use_pallas):
    def f(p):
        if factored:
            return jrk.rime_reduce(p, None, freqs, mp_idx=mp_idx, conj=conj,
                                   chunk=32, use_pallas=use_pallas,
                                   blvecs=jnp.asarray(blvecs),
                                   s_c=jnp.asarray(s_c))
        return jrk.rime_reduce(p, jnp.asarray(tau), freqs, mp_idx=mp_idx,
                               conj=conj, chunk=32, use_pallas=use_pallas)
    return f


@pytest.mark.parametrize("kind,factored,ps_real,conj", [
    ("mp", True, True, False), ("mp", False, False, True),
    ("shared", False, True, False)])
def test_dispatch_vs_jax_pallas_interpret(interpret_mode, kind, factored,
                                          ps_real, conj):
    """rime_reduce(use_kernel=True) (on the CPU: the grouped dispatch on
    the kernels' plain versions) against JAX rime_reduce(use_pallas=True)
    with its Pallas kernels in interpret mode, float32: values and the
    psky cotangent (and the delay cotangent, unfactored). Every ps / conj
    case of the dispatch is held at float64 below; interpret mode costs
    ~15 s a case, so three cases here."""
    psky, blvecs, s_c, tau, mp_idx, ct = _dispatch_inputs(
        5, kind, ps_real, f32=True)
    psky = psky.astype(np.float32 if ps_real else np.complex64)
    freqs = F0 + np.arange(psky.shape[-2]) * DF
    jf = _jax_reduce(psky, blvecs, s_c, tau, mp_idx, freqs, conj, factored,
                     True)
    if factored:
        jv, vjp = jax.vjp(jf, jnp.asarray(psky))
        (jdp,) = vjp(jnp.asarray(ct.astype(np.complex64)))
    else:
        jv, vjp = jax.vjp(lambda p, t: jrk.rime_reduce(
            p, t, freqs, mp_idx=mp_idx, conj=conj, use_pallas=True),
            jnp.asarray(psky), jnp.asarray(tau))
        jdp, jdt = vjp(jnp.asarray(ct.astype(np.complex64)))
    p = torch.as_tensor(psky).requires_grad_(True)
    t = torch.as_tensor(tau).requires_grad_(True)
    kw = dict(blvecs=torch.as_tensor(blvecs), s_c=torch.as_tensor(s_c)) \
        if factored else {}
    n0 = rime_cuda.launches
    tv = trk.rime_reduce(p, None if factored else t, freqs, mp_idx=mp_idx,
                         conj=conj, use_kernel=True, **kw)
    assert rime_cuda.launches == n0      # CPU tensors run the plain version
    assert tv.shape == (2, 2, 9, 8)
    assert _relerr(tv.detach().numpy(), jv) <= 1e-5
    grads = torch.autograd.grad(tv, [p] if factored else [p, t],
                                torch.as_tensor(np.conj(ct)))
    assert _relerr(grads[0].numpy(), np.conj(np.asarray(jdp))) <= 1e-5
    if not factored:
        assert _relerr(grads[1].numpy(), jdt) <= 1e-4


@pytest.mark.parametrize("factored", [True, False])
@pytest.mark.parametrize("ps_real,conj", [(True, False), (False, True)])
def test_dispatch_f64_vs_jax_chunked(factored, ps_real, conj):
    """The grouped dispatch at float64 (the plain versions) against the
    JAX chunked path with the model pairs gathered per baseline: values
    and gradients in psky, blvecs and s_c (factored) or tau (1e-9)."""
    psky, blvecs, s_c, tau, mp_idx, ct = _dispatch_inputs(6, "mp", ps_real)
    freqs = F0 + np.arange(psky.shape[-2]) * DF
    d = np.real(ct) * 10

    def jloss(p, b, s, t):
        v = jrk.rime_reduce(p, None if factored else t, freqs,
                            mp_idx=mp_idx, conj=conj, chunk=32,
                            use_pallas=False,
                            blvecs=b if factored else None,
                            s_c=s if factored else None)
        return jnp.sum(jnp.abs(v - d) ** 2), v

    (jl, jv), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                      has_aux=True)(
        *(jnp.asarray(x) for x in (psky, blvecs, s_c, tau)))
    tin = [torch.as_tensor(x).requires_grad_(True)
           for x in (psky, blvecs, s_c, tau)]
    tv = trk._rime_fused_dispatch(
        tin[0], freqs, conj, mp_idx, tin[1] if factored else None, tin[2],
        None if factored else tin[3])
    tl = torch.sum(torch.abs(tv - torch.as_tensor(d)) ** 2)
    tl.backward()
    assert _relerr(tv.detach().numpy(), jv) <= 1e-9
    assert abs(tl.item() - float(jl)) / abs(float(jl)) <= 1e-9
    used = (0, 1, 2) if factored else (0, 3)
    for i in used:
        assert _relerr(tin[i].grad.numpy(), np.conj(np.asarray(jg[i]))) \
            <= 1e-9, i


@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_rime_fused_gradcheck_f64(ps_real, conj):
    rng = np.random.default_rng(8)
    nf, nstack, npx, nb = 3, 2, 5, 4
    ps = rng.standard_normal((nf * nstack, npx))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal(ps.shape)
    # delays in units of 10 ns: phases of a few radians
    tau = rng.uniform(-1, 1, (nb, npx))
    inputs = [torch.as_tensor(x).requires_grad_(True) for x in (ps, tau)]

    def fn(p, t):
        return rime_cuda.rime_fused(p, t * 1e-8, 100e6, 1e6, nf, conj)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("ps_real,conj", [(True, False), (False, True)])
def test_rime_pallas_reduce_vs_jax(interpret_mode, ps_real, conj):
    nf, npx, nb = 8, 128, 12
    ps, tauT = _case(9, nf, npx, nb, ps_real)
    freqs = F0 + np.arange(nf) * DF
    j = rime_pallas.rime_pallas_reduce(jnp.asarray(ps), jnp.asarray(tauT.T),
                                       freqs, conj=conj)
    t = rime_cuda.rime_pallas_reduce(torch.as_tensor(ps),
                                     torch.as_tensor(tauT.T), freqs,
                                     conj=conj)
    assert t.shape == (nb, nf)
    assert _relerr(t.numpy(), j) <= 1e-5
    with pytest.raises(ValueError, match="regular"):
        rime_cuda.rime_pallas_reduce(torch.as_tensor(ps),
                                     torch.as_tensor(tauT.T), freqs ** 1.01)


@pytest.mark.parametrize("ps_real,conj", [(True, False), (False, True)])
def test_fused_function_vs_jax_vjp(interpret_mode, ps_real, conj):
    nf, nstack, npx, nb = 8, 2, 128, 12
    ps, _ = _case(2, nf * nstack, npx, 1, ps_real)
    rng = np.random.default_rng(3)
    blvecs = rng.uniform(-30, 30, (nb, 3)).astype(np.float32)
    s = rng.standard_normal((3, npx))
    s_c = (s / np.linalg.norm(s, axis=0) / C_MS).astype(np.float32)
    ct = (_bf16(rng.standard_normal((nf * nstack, nb)))
          + 1j * _bf16(rng.standard_normal((nf * nstack, nb))))
    freqs = F0 + np.arange(nf) * DF
    jv, vjp = jax.vjp(
        lambda p: rime_pallas.rime_fused_bs(p, jnp.asarray(blvecs),
                                            jnp.asarray(s_c),
                                            tuple(freqs.tolist()), conj),
        jnp.asarray(ps))
    (jd,) = vjp(jnp.asarray(ct))
    # the same path rime_reduce dispatches to with use_kernel=True
    p = torch.as_tensor(ps).requires_grad_(True)
    psky = p.reshape(nstack, 1, 1, nf, npx)
    tv = trk.rime_reduce(psky, None, freqs, conj=conj, use_kernel=True,
                         blvecs=torch.as_tensor(blvecs),
                         s_c=torch.as_tensor(s_c))      # (nstack,1,nb,nf)
    tv = tv.reshape(nstack, nb, nf).transpose(1, 2).reshape(nstack * nf, nb)
    assert _relerr(tv.detach().numpy(), jv) <= 1e-5
    # JAX's vjp with cotangent ct equals PyTorch's backward with grad
    # conj(ct), conjugated for a complex input
    (td,) = torch.autograd.grad(tv, p, torch.as_tensor(np.conj(ct)))
    assert _relerr(td.numpy(), np.conj(np.asarray(jd))) <= 1e-5


@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_fused_function_gradcheck_f64(ps_real, conj):
    rng = np.random.default_rng(4)
    nf, nstack, npx, nb = 3, 2, 5, 4
    ps = rng.standard_normal((nf * nstack, npx))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal(ps.shape)
    blvecs = rng.uniform(-10, 10, (nb, 3))
    s = rng.standard_normal((3, npx))
    inputs = [torch.as_tensor(x).requires_grad_(True)
              for x in (ps, blvecs, s / np.linalg.norm(s, axis=0))]

    def fn(p, b, u):
        return rime_cuda.rime_fused_bs(p, b, u / C_MS, 100e6, 1e6, nf, conj)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)
