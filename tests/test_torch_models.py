"""The port's models against the JAX package at float64: eq2top
angles, redundant groups, the Airy beam with the polynomial J1, and the
RIME forward on __graft_entry__._build()'s shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import bayeslim_tpu as bl
from bayeslim_tpu.models import bessel as jbessel
from bayeslim_tpu.models import telescope as jtel
from bayeslim_tpu.utils import make_hex as jmake_hex, AntposDict as JAntpos
from bayeslim_tpu_torch.models import bessel as tbessel
from bayeslim_tpu_torch.models import telescope as ttel
from bayeslim_tpu_torch.models.beam import AiryResponse
from bayeslim_tpu_torch.utils import AntposDict as TAntpos

from _torch_graft import build_torch

LOC = (21.428305555, -30.72152777, 1073.0)


@pytest.mark.parametrize("apparent", [True, False])
def test_eq2top_angles_equal(apparent):
    rng = np.random.default_rng(0)
    ra, dec = rng.uniform(0, 360, 300), rng.uniform(-90, 90, 300)
    for t in (2458168.3, 2459000.75):
        jz, ja = jtel.eq2top(LOC, t, ra, dec, apparent=apparent)
        tz, ta = ttel.eq2top(LOC, t, ra, dec, apparent=apparent)
        np.testing.assert_array_equal(tz, jz)
        np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ttel.gmst_rad(2458168.3),
                                  jtel.gmst_rad(2458168.3))


@pytest.mark.parametrize("hexN,redtol", [(3, 1.0), (5, 0.5)])
def test_build_reds_groups_equal(hexN, redtol):
    ants, antvecs = jmake_hex(hexN, D=15.0)
    j = jtel.build_reds(JAntpos(ants, antvecs), redtol=redtol)
    t = ttel.build_reds(TAntpos(ants, antvecs), redtol=redtol)
    assert t[0] == j[0]                          # reds
    assert t[2] == j[2]                          # bl2red
    assert t[3] == j[3]                          # bls
    assert t[4] == j[4] and t[5] == j[5] and t[6] == j[6]
    np.testing.assert_array_equal(np.asarray(t[1]), np.asarray(j[1]))
    jarr = bl.ArrayModel(JAntpos(ants, antvecs), redtol=redtol)
    tarr = ttel.ArrayModel(TAntpos(ants, antvecs), redtol=redtol,
                           device="cpu", dtype=torch.float64)
    assert tarr.get_bls(keep_autos=False) == jarr.get_bls(keep_autos=False)
    assert tarr.get_bls(uniq_bls=True) == jarr.get_bls(uniq_bls=True)


def test_airy_beam_and_j1():
    x = np.concatenate([np.linspace(-30, 30, 401), [1e-9, 7.999, 8.0]])
    tj1 = tbessel.j1(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(tj1, np.asarray(jbessel.j1(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-15)
    assert np.abs(tj1 - scipy.special.j1(x)).max() < 1e-7
    # elliptical Airy power beam and its gradient in the diameters
    rng = np.random.default_rng(1)
    zen, az = rng.uniform(0, 95, 200), rng.uniform(0, 360, 200)
    freqs = np.linspace(100e6, 200e6, 6)
    params = np.array([13.5, 14.7]).reshape(1, 1, 1, 1, 2)
    jb = bl.beam_model.AiryResponse()(jnp.asarray(params), jnp.asarray(zen),
                                      jnp.asarray(az), freqs)
    p = torch.as_tensor(params).requires_grad_(True)
    tb = AiryResponse()(p, torch.as_tensor(zen), torch.as_tensor(az),
                        torch.as_tensor(freqs))
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb),
                               rtol=1e-9, atol=1e-14)
    jg = jax.jit(jax.grad(lambda q: jnp.sum(bl.beam_model.AiryResponse()(
        q, jnp.asarray(zen), jnp.asarray(az), freqs) ** 2)))(
        jnp.asarray(params))
    (tg,) = torch.autograd.grad(torch.sum(tb ** 2), p)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9)


def test_rime_forward_graft_shapes():
    import __graft_entry__ as ge
    jprob = ge._build()
    jvis = np.asarray(jprob.model.forward().data)
    tprob = build_torch()
    with torch.no_grad():
        vd = tprob.model()
    assert vd.data.shape == jvis.shape == (1, 1, 21, 2, 8)
    err = np.abs(vd.data.numpy() - jvis).max() / np.abs(jvis).max()
    assert err <= 1e-9
    assert list(vd.blnums) == list(jprob.target[0].blnums)
    assert tprob.model.Npix_cut == int(jprob.model._pre[(0, 0)]["mask"]
                                       .shape[-1])


def _saved_bytes(prob):
    """Bytes of the distinct tensors that autograd saves for backward
    during one value_and_grad (the forward's residuals)."""
    seen = {}

    def pack(t):
        seen[t.data_ptr(), t.dtype, tuple(t.shape)] = \
            t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        prob.value_and_grad()
    return sum(seen.values())


@pytest.mark.parametrize("dtype,use_kernel", [
    (torch.float64, "auto"),        # the chunked reduction (CPU)
    (torch.float32, True),          # the fused Function, as on the card
])
def test_rime_backward_keeps_only_psky_per_time(dtype, use_kernel):
    """psky's construction is checkpointed per time (the JAX package's
    make_psky): each extra time step saves psky, the reduction's own
    inputs (tau for the chunked path, s_c for the fused one), the
    time's precomputed zen / az / cut / mask (already resident; the
    checkpoint saves them as its inputs) and its share of the output,
    and no beam or sky intermediate. Margin: a quarter of psky. Without
    the checkpoint each time saved ~40 psky-sized tensors."""
    small, big = (build_torch(Ntimes=n, dtype=dtype, use_kernel=use_kernel)
                  for n in (1, 4))
    per_time = (_saved_bytes(big) - _saved_bytes(small)) / 3
    rime = big.model
    item = torch.tensor([], dtype=dtype).element_size()
    nf, ncut, nbls = rime.Nfreqs, rime.Npix_cut, len(rime.sim_bls)
    psky = nf * ncut * item
    reduction = (3 if use_kernel is True else nbls) * ncut * item
    pre = 3 * ncut * item + ncut * 8            # zen, az, mask; cut (int64)
    vis = nbls * nf * 2 * item
    assert per_time <= psky + reduction + pre + vis + psky / 4
    # the checkpoint does keep psky itself (it is the reduction's input)
    assert per_time >= psky
