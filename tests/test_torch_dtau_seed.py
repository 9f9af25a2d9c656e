"""The arithmetic and the pass plan of the rime_dtau CUDA kernel
(bayeslim_tpu_torch/csrc/rime_dtau.cu, with its phase helpers in
csrc/phasor.cuh), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py). Here:

- a numpy float32 model of its phasors (seeds once per pass, anchors
  advanced by D^8, two-term blocks of 8 rows) against float64 phases
  over the 100-200 MHz grid at nf = 1024, for delays from 0 to 3e-6 s;
- the passes of ops/rime_cuda.py::dtau_plan: every row once, none
  crossing a stacked block;
- the model's whole delay cotangent (w_r in float, the sum in the
  kernel's order) against rime_dtau_plain in float64.
"""
import numpy as np
import pytest
import torch

from bayeslim_tpu_torch.ops import phase, rime_cuda
from tests.test_torch_rime_seed import (SFU_ERR, _cfrac, _cmul, _cycles,
                                        _fma, _run_seed, _sincospi)

f32 = np.float32
F0, NF = 100e6, 1024
DF = 100e6 / (NF - 1)
RUN, LB = rime_cuda.DTAU_RUN, rime_cuda.DTAU_LB


def pass_rows(p, rps, nf):
    """The rows of pass p, (row0, k0, len), as rime_dtau.cu's `Pass`
    (:108-124) steps through them from pass 0."""
    s = p // rps
    k0 = (p - s * rps) * RUN
    return s * nf + k0, k0, min(RUN, nf - k0)


def model_phasors(tau, f0, df, nf, sgn=1.0):
    """The kernel's phasors exp(i sgn 2 pi (f0 + k df) tau) for the nf
    channels of one stacked block, (nf,) + tau's shape, computed as
    rime_dtau.cu does, in float32 (complex128 holding float32 parts)."""
    t = f32(tau)
    sg_ = f32(sgn)
    # once per output (rime_dtau.cu :201-222): c0, the c1 pair, D and D^8
    c0h, c0l = _cycles(phase._split_f32(f0), t)
    c1h, c1l = _cycles(phase._split_f32(df), t)
    c0 = f32(c0h + c0l)
    sd, cd = _sincospi(f32(2) * f32(c1h + c1l))
    sd = sg_ * sd
    s8, c8 = _sincospi(f32(2) * f32(_cfrac(f32(LB) * c1h) + f32(LB) * c1l))
    s8 = sg_ * s8
    k2 = f32(2) * cd
    out = np.zeros((nf,) + t.shape, dtype=np.complex128)
    rps = -(-nf // RUN)
    for p in range(rps):
        _, k0, n = pass_rows(p, rps, nf)
        # one seed a pass (:243-247)
        a = _run_seed(c0, c1h, c1l, k0, sgn)
        e = []
        for lb in range(RUN // LB):
            # a block of LB rows: e_0 = A, e_1 = A D, then the two-term
            # recurrence (:258-278); the next anchor A D^8 (:309-319)
            blk = [a, _cmul(*a, cd, sd)]
            while len(blk) < LB:
                blk.append((_fma(k2, blk[-1][0], -blk[-2][0]),
                            _fma(k2, blk[-1][1], -blk[-2][1])))
            e += blk
            if lb + 1 < RUN // LB:
                a = _cmul(*a, c8, s8)
        for i, (c, s) in enumerate(e[:n]):
            out[k0 + i] = np.float64(c) + 1j * np.float64(s)
    return out


@pytest.mark.parametrize("tau_max", [0.0, 1e-10, 1e-8, 1e-6, 3e-6])
def test_model_phasors_vs_float64(tau_max):
    rng = np.random.default_rng(7)
    tau = f32(np.concatenate([[tau_max, -tau_max],
                              tau_max * rng.uniform(-1, 1, 200)]))
    freqs = F0 + np.arange(NF) * DF
    for sgn in (1.0, -1.0):
        got = model_phasors(tau, F0, DF, NF, sgn)
        ref = np.exp(1j * sgn * 2 * np.pi
                     * np.mod(freqs[:, None] * np.float64(tau)[None], 1.0))
        assert np.abs(got - ref).max() <= 1e-5
    if tau_max == 0.0:
        # D = D^8 = 1 exactly and 2 Re D = 2: only the seed's SFU error
        assert np.abs(got - 1.0).max() <= 2 * SFU_ERR


@pytest.mark.parametrize("nf", [5, 24, 1000, 1024])
@pytest.mark.parametrize("nstack", [1, 2, 3, 4])
def test_plan_passes_cover_rows_inside_their_block(nf, nstack):
    R = nstack * nf
    rps, npass = rime_cuda.dtau_plan(R, nf)
    assert rps == -(-nf // RUN) and npass == nstack * rps
    rows = []
    for p in range(npass):
        row0, k0, n = pass_rows(p, rps, nf)
        run = list(range(row0, row0 + n))
        assert 1 <= n <= RUN and row0 - k0 == (p // rps) * nf
        assert len({r // nf for r in run}) == 1      # one stacked block
        rows += run
    assert rows == list(range(R))                    # each row once, in order


def test_plan_raises_on_rows_and_past_the_nf_limit():
    with pytest.raises(ValueError, match="multiple"):
        rime_cuda.dtau_plan(10, 3)
    nf = rime_cuda.FWD_MAX_NF
    assert rime_cuda.dtau_plan(nf, nf) == (nf // RUN, nf // RUN)
    with pytest.raises(ValueError, match="2\\^24"):
        rime_cuda.dtau_plan(nf + 1, nf + 1)


def model_dtau(ct, ps, tauT, f0, df, nf, conj):
    """dtauT (K, N) as rime_dtau.cu sums it, in float32: u = ct w_r with
    w_r = fmaf(k, w1, w0) (rime_dtau_weight, :168), then per row and
    output Im(u p E) (:294-306), rows in pass order."""
    sgn = -1.0 if conj else 1.0
    R, K = ps.shape
    N = tauT.shape[1]
    w0, w1 = f32(-sgn * 2 * np.pi * f0), f32(-sgn * 2 * np.pi * df)
    E = model_phasors(tauT, f0, df, nf, sgn)            # (nf, K, N)
    ec, es = f32(E.real), f32(E.imag)
    acc = np.zeros((K, N), dtype=f32)
    rps, npass = rime_cuda.dtau_plan(R, nf)
    for p in range(npass):
        row0, k0, n = pass_rows(p, rps, nf)
        for i in range(n):
            r, k = row0 + i, k0 + i
            w = _fma(f32(k), w1, w0)
            ux = f32(f32(ct[r].real) * w)[None, :]
            uy = f32(f32(ct[r].imag) * w)[None, :]
            im = _fma(ux, es[k], f32(uy * ec[k]))
            if np.isrealobj(ps):
                acc = _fma(f32(ps[r])[:, None], im, acc)
            else:
                re = _fma(ux, ec[k], -f32(uy * es[k]))
                acc = _fma(f32(ps[r].real)[:, None], im,
                           _fma(f32(ps[r].imag)[:, None], re, acc))
    return acc


@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_model_dtau_vs_plain_f64(ps_real, conj):
    rng = np.random.default_rng(3)
    nstack, nf, K, N = 2, 40, 33, 17                     # a ragged last pass
    R = nstack * nf
    ps = rng.standard_normal((R, K))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal((R, K))
    ps = ps.astype(np.float32 if ps_real else np.complex64)
    ct = (rng.standard_normal((R, N))
          + 1j * rng.standard_normal((R, N))).astype(np.complex64)
    tauT = rng.uniform(-1e-6, 1e-6, (K, N)).astype(np.float32)
    got = model_dtau(ct, ps, tauT, F0, DF, nf, conj)
    ref = rime_cuda.rime_dtau_plain(
        torch.as_tensor(ct).to(torch.complex128),
        torch.as_tensor(ps).to(torch.float64 if ps_real
                               else torch.complex128),
        torch.as_tensor(tauT).double(), F0, DF, nf, conj=conj).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-5
