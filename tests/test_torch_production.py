"""The production chain (__graft_entry__._build_production: a 4-pol
coherency sky under a 2x2 Jones PixelResponse beam, redundant sim ->
data expansion, Sequential(RIME -> 4-pol JonesModel with complex
leaves), Nbatch time minibatches whose gradients accumulate) through
the port (tests/_torch_graft.build_production_torch) against the JAX
package at float64 (1e-9 relative): each batch's loss, the accumulated
loss, every gradient (the conjugate of JAX's for complex leaves),
RIME.run_batches and concat_VisData. Also: the per-antenna-beam
(Nmp > 1) RIME against JAX, and the kernel path (use_kernel=True, on
the CPU the grouped dispatch on the kernels' plain versions) at float32
against float64; remat and time_mode; Adam over the accumulated
batches with complex leaves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.data.containers import concat_VisData as jconcat
from bayeslim_tpu_torch.data.containers import concat_VisData as tconcat
from _torch_graft import LOC, build_production_torch

NT, NB = 2, 2            # times a batch, batches


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.fixture(scope="module")
def pair():
    """(JAX LogProb, port LogProb) on the same targets."""
    jp = ge._build_production(Ntimes_per_batch=NT, Nbatch=NB)
    tgts = [np.array(t.data) for t in jp.target]
    return jp, build_production_torch(Ntimes_per_batch=NT, Nbatch=NB,
                                      targets=tgts)


def _grad_close(tg, jg, tol=1e-9):
    assert sorted(tg.keys()) == sorted(jg.keys())
    for k in tg.keys():
        j = np.asarray(jg[k])
        # a real loss' gradient in a complex leaf: torch's is the
        # conjugate of JAX's (ROADMAP queue C item 1)
        assert _relerr(tg[k].numpy(), np.conj(j)) <= tol, k


def test_production_loss_and_grads_match_jax(pair):
    jp, tp = pair
    pd = jp.collect_main_params()
    assert tp.Nbatch == jp.Nbatch == NB and len(tp.target) == NB
    assert sorted(tp.collect_main_params().keys()) == sorted(pd.keys())
    assert tp.model.models.cal.params.is_complex()
    # each batch's loss
    for i in range(NB):
        jl = float(jp(pd, idx=i))
        with torch.no_grad():
            tl = float(tp(idx=i))
        assert abs(tl - jl) / abs(jl) <= 1e-9
    # the accumulated loss (mean) and gradients (sum)
    jv, jg = jp.value_and_grad(pd)
    tv, tg = tp.value_and_grad()
    assert abs(float(tv) - float(jv)) / abs(float(jv)) <= 1e-9
    _grad_close(tg, jg)
    assert tp.batch_idx == 0


def test_accumulate_is_the_sum_of_batch_gradients(pair):
    _, tp = pair
    vg = tp.value_and_grad()
    tp.grad_type = "batch"
    try:
        per = []
        for i in range(NB):
            tp.batch_idx = i
            per.append(tp.value_and_grad())
    finally:
        tp.grad_type = "accumulate"
        tp.batch_idx = 0
    assert abs(float(vg[0]) - np.mean([float(v) for v, _ in per])) \
        <= 1e-12 * abs(float(vg[0]))
    for k in vg[1].keys():
        assert _relerr(vg[1][k].numpy(),
                       sum(g[k] for _, g in per).numpy()) <= 1e-12


def test_run_batches_and_concat_match_jax(pair):
    jp, tp = pair
    jr, tr = jp.model.models["rime"], tp.model.models.rime
    with torch.no_grad():
        tvd = tr.run_batches(concat=True)
        parts = tr.run_batches(concat=False)
    jvd = jr.run_batches(concat=True)
    assert tvd.data.shape == (2, 2, len(tr.data_bls), NT * NB, 4)
    assert _relerr(tvd.data.numpy(), jvd.data) <= 1e-9
    np.testing.assert_array_equal(tvd.times, jvd.times)
    np.testing.assert_array_equal(tvd.blnums, jvd.blnums)
    assert len(parts) == NB
    # concat_VisData along every axis, plain and interleaved
    jparts = []
    for i in range(NB):
        jr.batch_idx = i
        jparts.append(jr.forward())
    jr.batch_idx = 0
    for axis in ("bl", "time", "freq"):
        for interleave in (False, True):
            t = tconcat(parts, axis, interleave=interleave)
            j = jconcat(jparts, axis, interleave=interleave)
            assert _relerr(t.data.numpy(), j.data) <= 1e-9
            for meta in ("blnums", "times", "freqs"):
                np.testing.assert_array_equal(getattr(t, meta),
                                              getattr(j, meta))
    assert tconcat(parts[:1], "time") is parts[0]
    # lazily: a CatTensor that concatenates on access
    t = tconcat(parts, "time", lazy=True)
    j = jconcat(jparts, "time", lazy=True)
    assert t.data.shape == j.data.shape
    assert _relerr(t.data.load().numpy(), j.data.load()) <= 1e-9
    np.testing.assert_array_equal(t.times, j.times)


def test_concat_carries_icov_and_flags():
    def vd(t0, seed):
        rng = np.random.default_rng(seed)
        out = bt.VisData()
        shape = (1, 1, 3, 2, 4)
        out.setup_data([(0, 1), (0, 2), (1, 2)], t0 + np.arange(2) * 0.1,
                       np.arange(4.0), pol="ee",
                       data=torch.as_tensor(rng.standard_normal(shape)),
                       icov=torch.as_tensor(rng.uniform(1, 2, shape)),
                       flags=torch.zeros(shape, dtype=torch.bool))
        return out
    a, b = vd(0.0, 1), vd(1.0, 2)
    c = tconcat([a, b], "time", interleave=True)
    np.testing.assert_array_equal(c.times, [0.0, 1.0, 0.1, 1.1])
    assert torch.equal(c.icov[:, :, :, 1::2], b.icov)
    assert c.flags.shape == (1, 1, 3, 4, 4)


@pytest.mark.parametrize("kw", [dict(remat=True), dict(time_mode="scan")])
def test_remat_and_time_mode_change_nothing(pair, kw):
    """remat checkpoints whole time steps; 'scan' and 'vmap' are the
    same eager loop: values and gradients unchanged."""
    _, tp = pair
    rime = tp.model.models.rime
    v0, g0 = tp.value_and_grad()
    old = {k: getattr(rime, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(rime, k, v)
        v1, g1 = tp.value_and_grad()
    finally:
        for k, v in old.items():
            setattr(rime, k, v)
    assert abs(float(v1) - float(v0)) <= 1e-12 * abs(float(v0))
    for k in g0.keys():
        assert _relerr(g1[k].numpy(), g0[k].numpy()) <= 1e-12
    with pytest.raises(ValueError, match="time_mode"):
        bt.RIME(rime.sky, rime.telescope, rime.beam, rime.array,
                rime.sim_bls, rime.sim_times, rime.freqs, time_mode="x")


def test_adam_over_accumulated_batches_descends():
    """torch.optim.Adam steps the complex gain leaves as real pairs:
    the accumulated loss falls (no JAX trajectory is pinned: optax steps
    complex leaves uphill, ROADMAP queue C item 1)."""
    tp = build_production_torch(Ntimes_per_batch=1, Nbatch=NB)
    # a target the starting point misses by more than the entry's 0.01
    for t in tp.target:
        t.data = t.data * 1.05
    trainer = bt.Trainer(tp, lr=1e-3)
    hist = trainer.train(Nepochs=4)
    assert all(np.isfinite(hist)) and hist[-1] < hist[0]
    assert tp.model.models.cal.params.is_complex()


def _nmp_pair(dtype, use_kernel, seed=0):
    """A small per-antenna-beam RIME, as in
    __graft_entry__.dryrun_multichip's Nmp > 1 stage: 2 Gaussian power
    beam models split over the antennas (3 model pairs on these
    baselines), point sources, 4 times, trainable sky, beam and antenna
    positions; through both packages."""
    from bayeslim_tpu.models.beam import GaussResponse as JGauss
    from bayeslim_tpu.models.sky import PointSky as JPointSky
    from bayeslim_tpu.models.sky import PointSkyResponse as JPSR
    from bayeslim_tpu.utils import AntposDict as JAntposDict
    from bayeslim_tpu.utils import make_hex as jmake_hex
    from bayeslim_tpu_torch.utils import AntposDict, make_hex
    rng = np.random.default_rng(seed)
    freqs = np.linspace(1e8, 1.1e8, 8)
    T = bl.TelescopeModel(LOC)
    ra0 = bt.TelescopeModel(LOC).JD2RA(2458168.3)
    angs = np.stack([ra0 + rng.uniform(-20, 20, 3),
                     LOC[1] + rng.uniform(-20, 20, 3)])
    sp = np.zeros((1, 1, 2, 3))
    sp[0, 0, 0] = rng.uniform(1, 10, 3)
    sp[0, 0, 1] = -2.2
    times = 2458168.3 + np.arange(4) * 5e-4
    ants, av = make_hex(2, D=15.0)
    bp = np.stack([np.ones((1, 1, len(freqs), 2)) * 0.5,
                   np.ones((1, 1, len(freqs), 2)) * 0.8], axis=2)
    bls = [(a, b) for a in ants for b in ants if a < b]
    ant2beam = {a: (0 if i < len(ants) // 2 else 1)
                for i, a in enumerate(ants)}
    kw = dict(device="cpu", dtype=dtype)
    tsky = bt.PointSky(sp, angs, R=bt.PointSkyResponse(
        freqs, freq_mode="powerlaw", f0=freqs[0], **kw), **kw)
    tbeam = bt.PixelBeam(bp, freqs, R=bt.GaussResponse(), pol="e",
                         ant2beam=ant2beam, fov=180.0, **kw)
    tarr = bt.ArrayModel(AntposDict(ants, av), freqs=freqs, parameter=True,
                         **kw)
    trime = bt.RIME(tsky, bt.TelescopeModel(LOC), tbeam, tarr, bls, times,
                    freqs, time_mode="vmap", use_kernel=use_kernel)
    jants, jav = jmake_hex(2, D=15.0)
    jrime = bl.RIME(
        JPointSky(jnp.asarray(sp), angs, R=JPSR(freqs, freq_mode="powerlaw",
                                                f0=freqs[0])),
        T, bl.PixelBeam(jnp.asarray(bp), freqs, R=JGauss(), pol="e",
                        ant2beam=ant2beam, fov=180.0),
        bl.ArrayModel(JAntposDict(jants, jav), freqs=freqs, parameter=True),
        bls, times, freqs, time_mode="vmap")
    return jrime, trime


def test_nmp_rime_matches_jax_and_kernel_path():
    jr, tr = _nmp_pair(torch.float64, "auto")
    assert len(np.unique(tr.beam.modelpairs(tr.sim_bls)[2])) == 3
    d = np.asarray(jr.forward().data) * 1.1

    def jloss(p):
        return jnp.sum(jnp.abs(jr.updated(p).forward().data - d) ** 2)
    pd = bl.utils.model2pdict(jr)
    jl, jg = jax.value_and_grad(jloss)(pd)
    params = dict(tr.named_parameters())
    tl = torch.sum(torch.abs(tr().data - torch.as_tensor(d)) ** 2)
    tg = torch.autograd.grad(tl, list(params.values()))
    assert abs(tl.item() - float(jl)) / float(jl) <= 1e-9
    for k, g in zip(params, tg):
        assert _relerr(g.numpy(), jg[k]) <= 1e-9, k
    # the kernel path in float32 (one fused call a model pair, plain
    # versions on the CPU) against float64
    _, tk = _nmp_pair(torch.float32, True)
    kl = torch.sum(torch.abs(tk().data - torch.as_tensor(
        d, dtype=torch.complex64)) ** 2)
    kparams = dict(tk.named_parameters())
    kg = torch.autograd.grad(kl, list(kparams.values()))
    assert abs(kl.item() - tl.item()) / tl.item() <= 1e-4
    for k, g, g64 in zip(kparams, kg, tg):
        assert _relerr(g.numpy(), g64.numpy()) <= 1e-4, k


def test_hera_prod_builder_small():
    """bayeslim_tpu_torch/scripts/hera_prod.py's build at hex-2 on the
    CPU: the gains start at the identity, the target is the chain at the
    entry's gains plus unit complex noise, and Adam over both batches
    lowers the loss."""
    from bayeslim_tpu_torch.scripts import hera_prod
    prob, truth = hera_prod.build(bt, hexN=2, nside=8, nfreq=8, fmax=120e6,
                                  ntime=2, nbatch=2, pix_chunk=512,
                                  device="cpu", dtype=torch.float64)
    seq = prob.model
    g = seq.models.cal.params.detach().numpy()
    np.testing.assert_array_equal(g, np.broadcast_to(
        np.eye(2)[:, :, None, None, None], g.shape))
    assert prob.Nbatch == 2 and len(prob.target) == 2
    with torch.no_grad():
        for i in range(2):
            seq.batch_idx = i
            at = seq.updated(bt.ParamDict({"models.cal.params":
                                           torch.as_tensor(truth)}))()
            noise = prob.target[i].data - at.data
            # unit complex noise: E|n|^2 = 1
            assert abs(float(torch.mean(torch.abs(noise) ** 2)) - 1) < 0.1
        seq.batch_idx = 0
    hist = bt.Trainer(prob, lr=1e-3).train(Nepochs=3)
    assert hist[-1] < hist[0]
