"""The sharded posterior of the port (bayeslim_tpu_torch/parallel/) on
four gloo ranks on the CPU, in float64, against the JAX package's
ShardedLogProb on the 8-device CPU mesh and against the single-process
port, case by case as tests/test_parallel.py (tests/_torch_dist.py
builds both sides from the same numpy inputs). The bars are the JAX
dry run's (__graft_entry__.py:316-321): the loss to 1e-9 relative,
each gradient leaf to 1e-8 of its max |g|; every rank returns the same
bits. The ranks run every case in one spawn, while this process
evaluates the references. Also the kernel dispatch's device mp_idx
branch against the JAX package's and against the host grouping.
"""
import numpy as np
import pytest
import torch

import _torch_dist as D

WORLD = 4
NAMES = ["time4", "mesh2d", "unused", "red_time", "red_bl", "jones_time",
         "jones_pin", "jones_auto", "rv_pin", "rv_nested", "red_jones_bl",
         "nmp_bl", "multipol", "sufficient_stats"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, and each case's references (computed here
    while the ranks run)."""
    run = D.start_ranks(WORLD, NAMES, tmp_path_factory.mktemp("ranks"))
    refs = {n: (D.jax_sharded(n), D.torch_single(n)) for n in NAMES
            if n in D.SPECS}
    refs["sufficient_stats"] = D.stats_refs()
    return D.join_ranks(run), refs


@pytest.mark.parametrize("name", NAMES[:-1])
def test_sharded_matches_jax_and_single_process(ranks, name):
    results, refs = ranks
    D.assert_same_bits(results, name)
    jax_ref, single = refs[name]
    D.assert_close(results[0][name], single)
    D.assert_close(results[0][name], jax_ref, conj=True)


def test_sufficient_statistics_path(ranks):
    """Redundant-group sufficient statistics (sim baselines only, icov
    the group weights) on the 2-D mesh: against the JAX stat solve
    sharded, the port's stat solve single-process, and the full
    per-baseline expansion solve (1e-6, as the JAX test)."""
    results, refs = ranks
    D.assert_same_bits(results, "sufficient_stats")
    jax_ref, single, full = refs["sufficient_stats"]
    port = results[0]["sufficient_stats"]
    D.assert_close(port, single)
    D.assert_close(port, jax_ref, conj=True)
    D.assert_grads_close(port[1], full[1], gtol=1e-6)


# ---------------------------------------------------------------------------
# the kernel dispatch's device mp_idx branch (no ranks)
# ---------------------------------------------------------------------------

def _nmp_case(seed=3, nb=9, nmp=3, nf=6, npx=40, lead=(2,)):
    rng = np.random.default_rng(seed)
    psky = rng.standard_normal(lead + (nmp, nf, npx))
    blvecs = rng.uniform(-30, 30, (nb, 3))
    s = rng.standard_normal((3, npx))
    s_c = s / np.linalg.norm(s, axis=0) / 2.99792458e8
    mp_idx = rng.integers(0, nmp, nb)
    freqs = np.linspace(100e6, 120e6, nf)
    return psky, blvecs, s_c, mp_idx, freqs


@pytest.mark.parametrize("conj", [False, True])
def test_device_mp_idx_matches_jax_and_host_grouping(conj):
    """_rime_fused_dispatch with a tensor mp_idx (every pair over all
    baselines, mask-selected) against the JAX package's with a jax.Array
    mp_idx (its Pallas kernels in interpret mode), and against the host
    grouping, value and gradients (the fused Functions' plain versions on
    the CPU, in float64)."""
    import jax.numpy as jnp
    from bayeslim_tpu.ops import rime_kernel as jrk
    from bayeslim_tpu.ops import rime_pallas
    from bayeslim_tpu_torch.ops import rime_kernel as trk
    psky, blvecs, s_c, mp_idx, freqs = _nmp_case()
    f32 = [jnp.asarray(x, jnp.float32) for x in (psky, blvecs, s_c)]
    rime_pallas.INTERPRET, old = True, rime_pallas.INTERPRET
    try:
        jout = np.asarray(jrk._rime_fused_dispatch(
            f32[0], None, freqs, jnp.asarray(mp_idx, jnp.int32), conj,
            blvecs=f32[1], s_c=f32[2]))
    finally:
        rime_pallas.INTERPRET = old

    def port(mp):
        ps = torch.tensor(psky, requires_grad=True)
        bv = torch.tensor(blvecs, requires_grad=True)
        out = trk._rime_fused_dispatch(ps, freqs, conj, mp, bv,
                                       torch.tensor(s_c), None)
        loss = torch.sum(torch.abs(out) ** 2)
        return out.detach().numpy(), torch.autograd.grad(loss, (ps, bv))

    dev, gdev = port(torch.as_tensor(mp_idx))
    host, ghost = port(mp_idx)
    scale = np.abs(jout).max()
    # the JAX Pallas kernel is float32: its bar against float64
    assert np.abs(dev - jout).max() <= 1e-4 * scale
    assert np.abs(dev - host).max() <= 1e-12 * scale
    for a, b in zip(gdev, ghost):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12 * b.abs().max())


def test_rime_takes_device_mp_idx():
    """RIME.forward reads _mp_idx_dev (the JAX rime.py:379-383): with
    the device map pinned, the Nmp > 1 model's visibilities and
    gradients equal the host grouping's."""
    prob, _ = D.build(D.TorchPkg(), "nmp_bl")
    rime = prob.model
    rime.use_kernel = True      # the fused Functions' plain versions
    assert rime._mp_groups[0][2] is not None
    with torch.no_grad():
        host = rime().data
    rime._mp_idx_dev = {0: torch.as_tensor(rime._mp_groups[0][2])}
    with torch.no_grad():
        dev = rime().data
    assert torch.allclose(dev, host, rtol=0, atol=1e-12 * host.abs().max())
