"""The per-time sky and Airy power beam (models/airy_psky.py) on the CPU:
the backward's plain twin against autograd through the eager make_psky
at float64, the AiryPsky Function's plain route, the dispatch predicate
that puts a RIME on it, and the coefficients the CUDA source carries.
The kernels themselves run on the card (tests/test_torch_cuda.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import bayeslim_tpu_torch as bt
from bayeslim_tpu_torch.models import airy_psky as ap
from bayeslim_tpu_torch.models import bessel
from bayeslim_tpu_torch.ops.rime_kernel import force_chunked
from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex

from _torch_graft import build_torch

F64 = torch.float64
LOC = (21.428305555, -30.72152777, 1073.0)


def _relerr(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def _case(ncomp, nmodel, mp1, nf=12, npix=300, nvalid=90, ncut=104,
          seed=0):
    """AiryPsky's inputs at float64 (the order AiryPsky.apply takes) and
    psky's gradient g: nvalid FOV pixels padded to ncut with mask 0, the
    first at the zenith (x = 0) and the second 1e-9 deg from it (0 < x <
    1e-8), some below the horizon; 100-200 MHz and 9-17 m apertures, so
    that x crosses 8."""
    rng = np.random.default_rng(seed)
    cut = np.zeros(ncut, np.int64)
    cut[:nvalid] = np.sort(rng.choice(npix, nvalid, replace=False))
    mask = (np.arange(ncut) < nvalid).astype(np.float64)
    zen = rng.uniform(0, 100, ncut)
    zen[:2] = 0.0, 1e-9
    az = rng.uniform(0, 360, ncut)
    D = rng.uniform(9, 17, (nmodel, ncomp))
    sky = rng.uniform(1, 10, (1, 1, nf, npix))
    g = rng.standard_normal((1, 1, len(mp1), nf, ncut))
    t = lambda x, dt=F64: torch.as_tensor(x, dtype=dt)  # noqa: E731
    return [t(sky), t(zen), t(az), t(cut, torch.int64), t(mask), t(D),
            t(mp1, torch.int64), t(np.linspace(100e6, 200e6, nf)), 1.0], t(g)


def _x(args):
    """The Airy argument x (Nmp, Nf, Ncut) of a case, as the contract
    writes it."""
    sky, zen, az, cut, mask, D, mp1, freqs, ratio = args
    zr = np.radians(zen.numpy())
    s = np.where(zr > np.pi / 2, 1.0, np.sin(zr))
    sa2 = np.sin(np.radians(az.numpy())) ** 2
    Dm = D.numpy()[mp1.numpy()]
    Dp = Dm[:, :1] if Dm.shape[1] == 1 else \
        Dm[:, 1:2] + sa2 * (Dm[:, :1] - Dm[:, 1:2])
    f = freqs.numpy() * ratio
    return 2 * np.pi * f[None, :, None] * Dp[:, None] / 2 / 2.99792458e8 \
        * s[None, None]


CASES = {
    "circular": (1, 1, [0]),
    "elliptical": (2, 1, [0]),
    "circular-3pairs": (1, 2, [1, 0, 1]),
    "elliptical-4pairs": (2, 3, [0, 2, 2, 1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_autograd_through_eager_path(case):
    """airy_psky_bwd_ref (the kernel's formulas) against autograd through
    the eager make_psky (airy_disk, the FOV cut and apply_beam_mp) at
    float64, 1e-9 relative: the sky gradient and dD, with x below 1e-8,
    on both J1 branches, below the horizon, on padded pixels and over
    several model pairs."""
    args, g = _case(*CASES[case])
    x = _x(args)
    assert (x < 1e-8).any() and ((x >= 1e-8) & (x < 8)).any() \
        and (x >= 8).any()
    sky = args[0].clone().requires_grad_(True)
    D = args[5].clone().requires_grad_(True)
    psky = ap.airy_psky_plain(sky, *args[1:5], D, *args[6:])
    dsky, dD = torch.autograd.grad(psky, (sky, D), g)
    rsky, rD = ap.airy_psky_bwd_ref(g, *args)
    assert _relerr(rsky, dsky) <= 1e-9
    assert _relerr(rD, dD) <= 1e-9
    # padded pixels carry no gradient, and pixels outside the cut none
    outside = np.setdiff1d(np.arange(sky.shape[-1]),
                           args[3][args[4] > 0].numpy())
    assert float(rsky[..., outside].abs().max()) == 0.0


def test_airy_b_is_the_approximants_derivative():
    """airy_b's b is 2 j1(x) / x of bessel.j1 (1 below 1e-8) and its db
    autograd's derivative of that, across both branches and their
    edges (float64). db is compared where autograd's own form, 2 J1' / x
    - 2 J1 / x^2, keeps its digits: x = 0 and x >= 1e-3 (at 2e-8 its two
    terms of ~1e8 cancel to ~1e-8)."""
    x = torch.cat([torch.linspace(0, 40, 4001, dtype=F64),
                   torch.tensor([1e-9, 2e-8, 7.999999, 8.0, 8.000001],
                                dtype=F64)]).requires_grad_(True)
    small = x < 1e-8
    xs = torch.where(small, torch.ones_like(x), x)
    ref = torch.where(small, torch.ones_like(x), 2 * bessel.j1(xs) / xs)
    dref, = torch.autograd.grad(ref.sum(), x)
    b, db = ap.airy_b(x.detach())
    assert _relerr(b, ref) <= 1e-12
    keep = (x == 0) | (x >= 1e-3)
    assert _relerr(db[keep], dref[keep]) <= 1e-9
    assert float(db[small].abs().max()) == 0.0


@pytest.mark.parametrize("need", ["sky", "D", "both"])
@pytest.mark.parametrize("case", ["circular", "elliptical-4pairs"])
def test_function_plain_route_matches_eager(case, need):
    """AiryPsky on CPU tensors: its forward is the eager path bit for bit,
    its backward gives only the gradients asked for, equal to autograd's
    (1e-9); no kernel launch is counted."""
    args, g = _case(*CASES[case])
    n0 = (ap.launches, ap.bwd_launches)
    sky = args[0].clone().requires_grad_(need in ("sky", "both"))
    D = args[5].clone().requires_grad_(need in ("D", "both"))
    leaves = [t for t in (sky, D) if t.requires_grad]
    out = ap.AiryPsky.apply(sky, *args[1:5], D, *args[6:])
    ref = ap.airy_psky_plain(sky, *args[1:5], D, *args[6:])
    assert torch.equal(out, ref)
    for a, b in zip(torch.autograd.grad(out, leaves, g),
                    torch.autograd.grad(ref, leaves, g)):
        assert _relerr(a, b) <= 1e-9
    assert (ap.launches, ap.bwd_launches) == n0


def _variant(name):
    """(beam, sky, zen) with one condition of the predicate broken (None:
    none)."""
    kw, sky_shape, dtype, npol = {}, (1, 1, 4, 48), torch.float32, 1
    if name == "gauss response":
        kw = dict(R=bt.GaussResponse())
    elif name == "not a power beam":
        kw = dict(R=bt.AiryResponse(powerbeam=False))
    elif name == "brute force":
        kw = dict(R=bt.AiryResponse(brute_force=True))
    elif name == "taper":
        kw = dict(R=bt.AiryResponse(taper_kwargs=dict(mode="gauss")))
    elif name == "per-baseline sky":
        sky_shape = (1, 1, 3, 4, 48)
    elif name == "coherency sky":
        sky_shape = (2, 2, 4, 48)
    elif name == "float64":
        dtype = F64
    elif name == "Npol 2":
        npol = 2
    beam = bt.PixelBeam(np.ones((npol, 1, 1, 1, 2)) * 14.0,
                        np.linspace(100e6, 120e6, 4),
                        **{"R": bt.AiryResponse(), **kw}, device="cpu",
                        dtype=dtype)
    return beam, torch.ones(sky_shape, dtype=dtype), \
        torch.zeros(40, dtype=dtype)


BROKEN = ["gauss response", "not a power beam", "brute force", "taper",
          "Npol 2", "per-baseline sky", "coherency sky", "float64",
          "forward-mode AD", "force_chunked", "on the CPU"]


@pytest.mark.parametrize("broken", [None] + BROKEN)
def test_dispatch_predicate(monkeypatch, broken):
    """fused_eligible with the card check standing in for float32 (so
    the CPU can take the base case): a float32 Airy power beam on a
    (1, 1, Nf, Npix) sky is eligible; each condition of the predicate
    that fails makes it ineligible, and so do forward-mode AD,
    force_chunked and, with the real check, CPU tensors."""
    if broken != "on the CPU":
        monkeypatch.setattr(ap, "_on_card",
                            lambda t: t.dtype == torch.float32)
    beam, sky, zen = _variant(broken)
    if broken == "forward-mode AD":
        with fwAD.dual_level():
            assert not ap.fused_eligible(beam, sky, zen)
        return
    if broken == "force_chunked":
        with force_chunked():
            assert not ap.fused_eligible(beam, sky, zen)
        return
    assert ap.fused_eligible(beam, sky, zen) == (broken is None)


def _rime(nmodel, dtype):
    """A hex-2 RIME on the CPU whose sky and elliptical Airy beam (nmodel
    models, so that several model pairs appear) are trained."""
    kw = dict(device="cpu", dtype=dtype)
    ants, antvecs = make_hex(2, D=15.0)
    freqs = np.linspace(100e6, 200e6, 8)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs,
                        parameter=False, **kw)
    nside = 8
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    params = np.zeros((1, 1, 2, len(theta)))
    params[0, 0, 0] = np.random.default_rng(0).uniform(1, 10, len(theta))
    params[0, 0, 1] = -2.5
    sky = bt.PixelSky(params, np.stack([np.degrees(phi),
                                        90 - np.degrees(theta)]),
                      hp.nside2pixarea(nside), R=bt.PixelSkyResponse(
                          freqs, freq_mode="powerlaw", f0=100e6, **kw), **kw)
    bp = np.ones((1, 1, nmodel, 1, 2)) * [13.0, 15.0]
    ant2beam = {a: i % nmodel for i, a in enumerate(ants)}
    beam = bt.PixelBeam(bp, freqs, R=bt.AiryResponse(), pol="e",
                        ant2beam=ant2beam, **kw)
    times = 2458168.3 + np.arange(3) * 5e-4
    return bt.RIME(sky, bt.TelescopeModel(LOC), beam, arr,
                   arr.get_bls(keep_autos=False), times, freqs,
                   pix_chunk=256)


def _loss_and_grads(rime):
    vis = rime().data
    loss = (vis.real ** 2 + vis.imag ** 2).sum()
    leaves = [rime.sky.params, rime.beam.params]
    return (loss,) + torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("nmodel", [1, 2])
def test_rime_takes_the_fused_function_where_eligible(monkeypatch, nmodel):
    """A whole RIME forward and backward through AiryPsky (its plain route:
    the card check made to accept float64 CPU tensors) against the eager,
    checkpointed make_psky, at float64 (1e-9): one call a time, with
    several model pairs too; inside force_chunked the eager path again;
    no kernel launch counted on the CPU."""
    ref = _loss_and_grads(_rime(nmodel, F64))
    calls = []
    apply = ap.AiryPsky.apply
    monkeypatch.setattr(ap, "_on_card", lambda t: True)
    monkeypatch.setattr(ap.AiryPsky, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    n0 = (ap.launches, ap.bwd_launches)
    rime = _rime(nmodel, F64)
    out = _loss_and_grads(rime)
    assert len(calls) == 3
    assert len(rime.beam.modelpairs(rime.sim_bls)[0]) == nmodel ** 2
    for a, b in zip(out, ref):
        assert _relerr(a, b) <= 1e-9
    with force_chunked():
        _loss_and_grads(rime)
    assert len(calls) == 3
    assert (ap.launches, ap.bwd_launches) == n0


def _saved_bytes(prob):
    """Bytes of the distinct tensors autograd saves for the backward
    during one value_and_grad."""
    seen = {}

    def pack(t):
        seen[t.data_ptr(), t.dtype, tuple(t.shape)] = \
            t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        prob.value_and_grad()
    return sum(seen.values())


def test_fused_path_saves_only_its_inputs(monkeypatch):
    """On the fused path (its plain route, the card check made to accept
    float64 CPU tensors) no checkpoint is needed: each extra time step
    saves what the checkpointed eager path saves (psky as the
    reduction's input, the reduction's own inputs, the time's zen / az /
    cut / mask and its share of the output) and no beam or sky
    intermediate; the sky, the diameters and the channels AiryPsky also
    saves are shared by every time."""
    monkeypatch.setattr(ap, "_on_card", lambda t: True)
    calls = []
    apply = ap.AiryPsky.apply
    monkeypatch.setattr(ap.AiryPsky, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    small, big = (build_torch(Ntimes=n) for n in (1, 4))
    per_time = (_saved_bytes(big) - _saved_bytes(small)) / 3
    assert len(calls) == 1 + 4 + 1 + 4     # the targets' forwards, then ours
    rime = big.model
    nf, ncut, nbls = rime.Nfreqs, rime.Npix_cut, len(rime.sim_bls)
    psky = nf * ncut * 8
    pre = 3 * ncut * 8 + ncut * 8            # zen, az, mask; cut (int64)
    assert psky <= per_time <= psky + nbls * ncut * 8 + pre \
        + nbls * nf * 16 + psky / 4


def test_cuda_source_carries_bessel_coefficients():
    """csrc/airy_psky.cu's J1 tables and constants are bessel.py's
    numbers (the float tables their float32 rounding, as a float32 run
    of the eager path takes them)."""
    src = (Path(ap.__file__).resolve().parent.parent / "csrc"
           / "airy_psky.cu").read_text().replace("\\\n", " ")
    for name in ("J1_P", "J1_Q", "J1_P2", "J1_Q2"):
        body = re.search(rf"#define {name} \{{([^}}]*)\}}", src).group(1)
        vals = [float(v) for v in body.split(",")]
        assert vals == list(getattr(bessel, name)), name
    consts = dict(J1_K=bessel.J1_K, J1_PHASE=bessel.J1_PHASE,
                  J1_SQRT_K=np.sqrt(bessel.J1_K))
    for name, ref in consts.items():
        val = float(re.search(rf"double {name} = ([0-9.e+-]+);",
                              src).group(1))
        assert np.float32(val) == np.float32(ref), name
        if name != "J1_SQRT_K":
            assert val == ref, name
