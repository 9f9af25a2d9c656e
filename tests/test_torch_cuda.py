"""The port's CUDA kernels on the card. Every test skips without an
NVIDIA GPU (the kernels have no CPU mode). This file imports neither JAX
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from bayeslim_tpu_torch.ops import rime_cuda
from bayeslim_tpu_torch.scripts import mosaic_spike as spike
from bayeslim_tpu_torch.utils.dtypes import C_MS

F0, DF = 100e6, 20e6 / 7


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    return torch.device("cuda")


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _case(seed, R, K, N, ps_real):
    rng = np.random.default_rng(seed)
    ps = rng.standard_normal((R, K))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal((R, K))
    return ps, rng.uniform(-1e-6, 1e-6, (K, N))


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("nf,R,K,N", [(5, 10, 300, 70), (24, 72, 100, 45)])
def test_kernel_vs_plain(cuda, ps_real, nf, R, K, N):
    ps, tauT = _case(0, R, K, N, ps_real)
    cps = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                          else torch.complex64, device=cuda)
    ctau = torch.as_tensor(tauT, dtype=torch.float32, device=cuda)
    for conj in (False, True):
        for out_imag in (True, False):
            n0 = rime_cuda.launches
            a = rime_cuda.rime_fwd(cps, ctau, F0, DF, nf, conj, out_imag)
            assert rime_cuda.launches == n0 + 1
            assert a.dtype == (torch.complex64 if out_imag else torch.float32)
            b = rime_cuda.rime_fwd_plain(
                cps.cpu().to(torch.float64 if ps_real else torch.complex128),
                ctau.cpu().double(), F0, DF, nf, conj, out_imag)
            assert _relerr(a.cpu().numpy(), b.numpy()) <= 1e-4


def _longest_delay():
    """hera-stat's longest delay [s]: its longest baseline (hex-11, 15 m
    spacing) over c."""
    from bayeslim_tpu_torch.utils import make_hex
    _, av = make_hex(11, D=15.0)
    av = np.asarray(av)
    return float(np.linalg.norm(av[:, None] - av[None], axis=-1).max()
                 / C_MS)


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("nf,R,K,N,tau_max", [
    (5, 15, 300, 70, 1e-6),            # 3 stacked blocks, runs of 5 rows
    (1000, 3000, 100, 45, 1e-6),       # a ragged last run of 8 rows
    (24, 72, 1, 45, 1e-6),             # K = 1
    (24, 72, 100, 1, 1e-6),            # N = 1
    (1024, 1024, 100, 630, 1e-6),      # K split, K below one slice
    (24, 72, 300, 45, 1e-9),           # |tau| <= 1e-9 s
    (24, 72, 300, 45, 0.0),            # tau = 0
    (1024, 1024, 256, 64, None)])      # hera-stat's longest delays
def test_kernel_design_cases(cuda, ps_real, nf, R, K, N, tau_max):
    """The cases the kernel's run layout, K split and seeds could get
    wrong, each ps / conj / out_imag case within 1e-4 of float64; with
    tau = 0 the output is the sum over c."""
    ps, tauT = _case(8, R, K, N, ps_real)
    if tau_max is None:
        tmax = _longest_delay()
        tauT = np.sign(tauT) * tmax * np.random.default_rng(9).uniform(
            0.99, 1, tauT.shape)
    else:
        tauT = tauT * (tau_max / 1e-6)
    cps = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                          else torch.complex64, device=cuda)
    ctau = torch.as_tensor(tauT, dtype=torch.float32, device=cuda)
    p64 = cps.cpu().to(torch.float64 if ps_real else torch.complex128)
    for conj in (False, True):
        for out_imag in (True, False):
            a = rime_cuda.rime_fwd(cps, ctau, F0, DF, nf, conj, out_imag)
            assert a.shape == (R, N)
            b = rime_cuda.rime_fwd_plain(p64, ctau.cpu().double(), F0, DF,
                                         nf, conj, out_imag)
            assert _relerr(a.cpu().numpy(), b.numpy()) <= 1e-4
            if tau_max == 0.0:
                s = p64.sum(1, keepdim=True).expand(R, N)
                s = s.real if s.is_complex() and not out_imag else s
                assert _relerr(a.cpu().numpy(), s.numpy()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real,out_imag,R,K,N", [
    (True, True, 1024, 6144, 630),     # hera-stat forward: K split
    (False, False, 1024, 630, 6144)])  # role-swapped backward: one slice
def test_kernel_launches_are_bit_equal(cuda, ps_real, out_imag, R, K, N):
    """No atomics: the K slices are added in a fixed order, so two
    launches on the same inputs agree bit for bit."""
    ps, tauT = _case(10, R, K, N, ps_real)
    cps = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                          else torch.complex64, device=cuda)
    ctau = torch.as_tensor(tauT, dtype=torch.float32, device=cuda)
    a = rime_cuda.rime_fwd(cps, ctau, F0, DF, R, False, out_imag)
    b = rime_cuda.rime_fwd(cps, ctau, F0, DF, R, False, out_imag)
    assert torch.equal(a, b)
    _, _, per_sm, sms = rime_cuda.fwd_info(cuda, ps_real, out_imag)
    S = rime_cuda.fwd_plan(R, K, N, R, sms, per_sm)[0]
    assert (S > 1) == (K > N)


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real", [True, False])
def test_fused_function_backward_on_card(cuda, ps_real):
    """Values and the psky gradient of RimeFusedBS through the kernel
    (float32) against the CPU plain path (float64)."""
    nf, npx, nb = 16, 300, 20
    ps, _ = _case(1, 2 * nf, npx, 1, ps_real)
    rng = np.random.default_rng(2)
    blvecs = rng.uniform(-30, 30, (nb, 3))
    s = rng.standard_normal((3, npx))
    s_c = s / np.linalg.norm(s, axis=0) / C_MS
    d = rng.standard_normal((2 * nf, nb)) * 5
    res = []
    for dev, rdt, cdt in ((cuda, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        p = torch.as_tensor(ps, dtype=rdt if ps_real else cdt,
                            device=dev).requires_grad_(True)
        out = rime_cuda.rime_fused_bs(
            p, torch.as_tensor(blvecs, dtype=rdt, device=dev),
            torch.as_tensor(s_c, dtype=rdt, device=dev), F0, DF, nf)
        loss = torch.sum(torch.abs(out - torch.as_tensor(
            d, dtype=rdt, device=dev)) ** 2)
        (g,) = torch.autograd.grad(loss, p)
        res.append((out.detach().cpu().numpy(), g.cpu().numpy()))
    assert _relerr(res[0][0], res[1][0]) <= 1e-4
    assert _relerr(res[0][1], res[1][1]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("nf,R,K,N", [(5, 10, 300, 70), (24, 72, 100, 45)])
def test_dtau_kernel_vs_plain(cuda, ps_real, nf, R, K, N):
    ps, tauT = _case(3, R, K, N, ps_real)
    rng = np.random.default_rng(4)
    ct = rng.standard_normal((R, N)) + 1j * rng.standard_normal((R, N))
    cps = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                          else torch.complex64, device=cuda)
    ctau = torch.as_tensor(tauT, dtype=torch.float32, device=cuda)
    cct = torch.as_tensor(ct, dtype=torch.complex64, device=cuda)
    for conj in (False, True):
        n0 = rime_cuda.dtau_launches
        a = rime_cuda.rime_dtau(cct, cps, ctau, F0, DF, nf, conj)
        assert rime_cuda.dtau_launches == n0 + 1
        assert a.dtype == torch.float32 and a.shape == (K, N)
        b = rime_cuda.rime_dtau_plain(
            cct.cpu().to(torch.complex128),
            cps.cpu().to(torch.float64 if ps_real else torch.complex128),
            ctau.cpu().double(), F0, DF, nf, conj)
        assert _relerr(a.cpu().numpy(), b.numpy()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("nf,R,K,N,tau_max", [
    (5, 15, 300, 70, 1e-6),            # 3 stacked blocks, passes of 5 rows
    (1000, 3000, 100, 45, 1e-6),       # a ragged last pass of 8 rows
    (24, 72, 1, 45, 1e-6),             # K = 1
    (24, 72, 100, 1, 1e-6),            # N = 1
    (24, 48, 100, 30, 1e-6),           # N below one block of baselines
    (24, 72, 300, 45, 1e-9),           # |tau| <= 1e-9 s
    (24, 72, 300, 45, 0.0),            # tau = 0
    (1024, 1024, 256, 64, None),       # hera-cal's longest delays
    (1024, 1024, 6144, 630, 1e-6)])    # the hera-cal shape
def test_dtau_kernel_design_cases(cuda, ps_real, nf, R, K, N, tau_max):
    """The cases rime_dtau's passes, tiles and seeds could get wrong,
    each conj within 1e-4 of float64 (the plain version on the card) and
    bit-equal over two launches."""
    ps, tauT = _case(11, R, K, N, ps_real)
    if tau_max is None:
        tauT = np.sign(tauT) * _longest_delay() * np.random.default_rng(
            12).uniform(0.99, 1, tauT.shape)
    else:
        tauT = tauT * (tau_max / 1e-6)
    rng = np.random.default_rng(13)
    ct = rng.standard_normal((R, N)) + 1j * rng.standard_normal((R, N))
    cps = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                          else torch.complex64, device=cuda)
    ctau = torch.as_tensor(tauT, dtype=torch.float32, device=cuda)
    cct = torch.as_tensor(ct, dtype=torch.complex64, device=cuda)
    for conj in (False, True):
        a = rime_cuda.rime_dtau(cct, cps, ctau, F0, DF, nf, conj)
        assert torch.equal(a, rime_cuda.rime_dtau(cct, cps, ctau, F0, DF,
                                                  nf, conj))
        b = rime_cuda.rime_dtau_plain(
            cct.to(torch.complex128),
            cps.to(torch.float64 if ps_real else torch.complex128),
            ctau.double(), F0, DF, nf, conj)
        assert a.shape == (K, N)
        assert _relerr(a.cpu().numpy(), b.cpu().numpy()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_fused_function_delay_grads_on_card(cuda, ps_real, conj):
    """The blvecs and s_c gradients of RimeFusedBS through rime_dtau
    (float32) against the CPU plain path (float64)."""
    nf, npx, nb = 16, 300, 20
    ps, _ = _case(5, 2 * nf, npx, 1, ps_real)
    rng = np.random.default_rng(6)
    blvecs = rng.uniform(-30, 30, (nb, 3))
    s = rng.standard_normal((3, npx))
    s_c = s / np.linalg.norm(s, axis=0) / C_MS
    d = rng.standard_normal((2 * nf, nb)) * 5
    res = []
    for dev, rdt, cdt in ((cuda, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        p = torch.as_tensor(ps, dtype=rdt if ps_real else cdt, device=dev)
        bv, sc = (torch.as_tensor(x, dtype=rdt, device=dev)
                  .requires_grad_(True) for x in (blvecs, s_c))
        n0 = rime_cuda.dtau_launches
        out = rime_cuda.rime_fused_bs(p, bv, sc, F0, DF, nf, conj)
        loss = torch.sum(torch.abs(out - torch.as_tensor(
            d, dtype=rdt, device=dev)) ** 2)
        res.append([g.cpu().numpy() for g in torch.autograd.grad(
            loss, (bv, sc))])
        if dev == cuda:
            assert rime_cuda.dtau_launches == n0 + 1
    assert _relerr(res[0][0], res[1][0]) <= 1e-4
    assert _relerr(res[0][1], res[1][1]) <= 1e-4


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    ps = torch.zeros(8, 4, device=cuda)
    tau = torch.zeros(4, 3, device=cuda)
    with pytest.raises(TypeError):
        rime_cuda.rime_fwd(ps.double(), tau.double(), F0, DF, 8)
    with pytest.raises(ValueError):
        rime_cuda.rime_fwd(ps, tau, F0, DF, 3)          # 8 rows, nf=3
    with pytest.raises(ValueError):
        rime_cuda.rime_fwd(ps, tau.cpu(), F0, DF, 8)
    big = rime_cuda.FWD_MAX_NF + 1                      # past the seed's limit
    with pytest.raises(ValueError, match="2\\^24"):
        rime_cuda.rime_fwd(torch.zeros(big, 1, device=cuda),
                           torch.zeros(1, 1, device=cuda), F0, DF, big)
    ct = torch.zeros(8, 3, dtype=torch.complex64, device=cuda)
    with pytest.raises(TypeError):
        rime_cuda.rime_dtau(ct.to(torch.complex128), ps, tau, F0, DF, 8)
    with pytest.raises(ValueError):
        rime_cuda.rime_dtau(ct, ps, tau, F0, DF, 3)     # 8 rows, nf=3
    with pytest.raises(ValueError):
        rime_cuda.rime_dtau(ct[:, :2], ps, tau, F0, DF, 8)
    with pytest.raises(ValueError):
        rime_cuda.rime_dtau(ct.cpu(), ps, tau, F0, DF, 8)
    with pytest.raises(ValueError, match="2\\^24"):
        rime_cuda.rime_dtau(torch.zeros(big, 1, dtype=torch.complex64,
                                        device=cuda),
                            torch.zeros(big, 1, device=cuda),
                            torch.zeros(1, 1, device=cuda), F0, DF, big)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [name for name, _ in spike.SPIKES])
@pytest.mark.parametrize("NF,TC,TB,G", [(1024, 256, 256, 8),   # the script's
                                        (96, 200, 100, 8)])    # fills no tile
def test_spike_kernel_vs_plain(cuda, name, NF, TC, TB, G):
    """Each mosaic_spike kernel (float32) against its plain version in
    float64 on the same inputs; k_rot on unit_m's inputs, whose chains
    stay near unit modulus."""
    rel, _, n = spike.compare(name, NF, TC, TB, G, device=cuda)
    assert n == 1
    assert rel <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("G", spike.FWD_G)
def test_spike_fwd_every_chain_count(cuda, G):
    """k_fwd against the plain version at each chain count G in FWD_G
    (the kernel runs its own chains), in float64."""
    rel, _, n = spike.compare("k_fwd", 96, 200, 100, G, device=cuda)
    assert n == 1
    assert rel <= 1e-4


@pytest.mark.cuda
def test_spike_kernels_reject_what_they_do_not_take(cuda):
    ps = spike.mk((96, 200), 0, device=cuda)
    m = spike.mk((200, 100), 1, device=cuda)
    with pytest.raises(TypeError):
        spike.run_nn(ps.double(), m.double())
    with pytest.raises(ValueError):
        spike.run_nn(ps, m.cpu())
    with pytest.raises(ValueError):
        spike.run_fwd(m, ps, 3)                         # G not a power of 2
    with pytest.raises(ValueError):
        spike.run_bd(ps, m, 7)                          # 96 rows, G=7


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k_nn", "k_nt"])
@pytest.mark.parametrize("NF,TC,TB", [(1024, 256, 256), (96, 200, 100),
                                      (97, 203, 101)])    # K % 4 != 0
def test_spike_sgemm_vs_plain_and_bit_equal(cuda, name, NF, TC, TB):
    """The ring-buffered SGEMM against float64 on each chunk width and
    off the tile; two launches bit-equal (a fixed k order per output)."""
    rel, _, n = spike.compare(name, NF, TC, TB, 8, device=cuda)
    assert n == 1 and rel <= 1e-4
    args = spike.make_args(name, NF, TC, TB, device=cuda, distinct=True)
    assert torch.equal(spike.RUN[name](*args), spike.RUN[name](*args))


@pytest.mark.cuda
@pytest.mark.parametrize("nt", [False, True])
def test_spike_sgemm_unaligned_operands(cuda, nt):
    """Operands that start 4 bytes past a 16-byte boundary take the
    4-byte chunks, and agree with float64."""
    M, K, N = 97, 200, 100
    buf = spike.mk((M * K + N * K + 2,), 3, device=cuda)
    a = buf[1:1 + M * K].view(M, K)
    b = buf[2 + M * K:2 + M * K + N * K].view((N, K) if nt else (K, N))
    ptrs = (a.data_ptr(), b.data_ptr())
    assert spike.sgemm_plan(nt, M, N, K, ptrs)["chunk"] == 4
    run = spike.run_nt if nt else spike.run_nn
    ref = (a.double() @ (b.double().T if nt else b.double()))
    assert _relerr(run(a, b).cpu(), ref.cpu()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("nt", [False, True])
@pytest.mark.parametrize("M,N,K,offsets", [
    (1024, 256, 256, (0, 0)), (97, 101, 203, (0, 0)), (96, 100, 200, (0, 0)),
    (96, 100, 200, (4, 0)), (96, 100, 200, (0, 8)), (5, 3, 1, (0, 0))])
def test_spike_sgemm_plan_is_the_launchers(cuda, nt, M, N, K, offsets):
    base = torch.empty(64, device=cuda).data_ptr()
    ptrs = tuple(base + o for o in offsets)
    want = spike.sgemm_plan(nt, M, N, K, ptrs)
    got = spike.card_sgemm_plan(nt, M, N, K, ptrs)
    assert got == {k: want[k] for k in ("grid", "chunk", "smem")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k_vt", "k_lr"])
@pytest.mark.parametrize("NF,TC,TB", [(1024, 256, 256), (96, 200, 100),
                                      (97, 203, 101), (5, 3, 1)])
def test_spike_vt_lr_vs_plain_and_bit_equal(cuda, name, NF, TC, TB):
    """k_vt's cluster column sum and k_lr's lane-split product against
    float64, on each chunk width and off the tile; two launches
    bit-equal (one fixed order per output)."""
    rel, _, n = spike.compare(name, NF, TC, TB, 8, device=cuda)
    assert n == 1 and rel <= 1e-4
    args = spike.make_args(name, NF, TC, TB, device=cuda, distinct=True)
    assert torch.equal(spike.RUN[name](*args), spike.RUN[name](*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k_vt", "k_lr"])
def test_spike_vt_lr_unaligned_operands(cuda, name):
    """Operands that start 4 bytes past a 16-byte boundary take the
    4-byte loads, and agree with float64."""
    NF, TC, TB = 97, 200, 100
    rows = TC if name == "k_vt" else TB
    buf = spike.mk((NF * rows + TC * TB + 2,), 3, device=cuda)
    a = buf[1:1 + NF * rows].view(NF, rows)
    m = buf[2 + NF * rows:2 + NF * rows + TC * TB].view(TC, TB)
    ptrs = (a.data_ptr(), m.data_ptr())
    if name == "k_vt":
        assert spike.vt_plan(NF, TC, TB, ptrs + (0,))["chunk"] == 4
    else:
        assert spike.lr_plan(NF, TC, TB, ptrs)["chunk"] == 4
    got = spike.RUN[name](a, m)
    ref = spike.PLAIN[name](a.double(), m.double())
    assert _relerr(got.cpu(), ref.cpu()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("NF,TC,TB,offsets", [
    (1024, 256, 256, (0, 0, 0)), (97, 203, 101, (0, 0, 0)),
    (96, 200, 100, (0, 0, 0)), (96, 200, 100, (4, 0, 0)),
    (96, 200, 100, (0, 8, 0)), (96, 200, 100, (0, 0, 12)),
    (5, 3, 1, (0, 0, 0))])
def test_spike_vt_lr_plans_are_the_launchers(cuda, NF, TC, TB, offsets):
    base = torch.empty(64, device=cuda).data_ptr()
    ptrs = tuple(base + o for o in offsets)
    want = spike.vt_plan(NF, TC, TB, ptrs)
    assert spike.card_vt_plan(NF, TC, TB, ptrs) == {
        k: want[k] for k in ("grid", "cluster", "chunk", "smem")}
    want = spike.lr_plan(NF, TC, TB, ptrs[:2])
    assert spike.card_lr_plan(NF, TC, TB, ptrs[:2]) == {
        k: want[k] for k in ("grid", "chunk", "smem")}


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k_bd", "k_fwd"])
@pytest.mark.parametrize("NF,TC,TB,G", [
    (1024, 256, 256, 8), (96, 200, 100, 8),
    (104, 203, 101, 8),                     # off every tile, NF % G == 0
    (97, 203, 101, 1)])                     # NF odd: G = 1
def test_spike_bd_fwd_vs_plain_and_bit_equal(cuda, name, NF, TC, TB, G):
    """k_bd's scaled SGEMM and k_fwd's runs, chains and cluster sum
    against float64, on and off the tiles; two launches bit-equal (one
    fixed order an output, no atomics)."""
    rel, _, n = spike.compare(name, NF, TC, TB, G, device=cuda)
    assert n == 1 and rel <= 1e-4
    args = spike.make_args(name, NF, TC, TB, G, device=cuda, distinct=True)
    one, two = spike.RUN[name](*args), spike.RUN[name](*args)
    assert all(torch.equal(a, b) for a, b in zip(_outs(one), _outs(two)))


@pytest.mark.cuda
def test_spike_bd_unaligned_operands(cuda):
    """k_bd's operands 4 bytes past a 16-byte boundary take 4-byte
    chunks, and agree with float64."""
    NF, TC, TB, G = 104, 200, 100, 8
    buf = spike.mk((NF * TC + TC * TB + 2,), 3, device=cuda)
    ps = buf[1:1 + NF * TC].view(NF, TC)
    m = buf[2 + NF * TC:2 + NF * TC + TC * TB].view(TC, TB)
    assert spike.bd_plan(NF, TC, TB, (ps.data_ptr(), m.data_ptr()))[
        "chunk"] == 4
    ref = spike.run_bd_plain(ps.double(), m.double(), G)
    assert _relerr(spike.run_bd(ps, m, G).cpu(), ref.cpu()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("NF,TC,TB,offsets", [
    (1024, 256, 256, (0, 0)), (104, 203, 101, (0, 0)), (96, 200, 100, (4, 0)),
    (96, 200, 100, (0, 8)), (1024, 6144, 630, (0, 0)), (5, 3, 1, (0, 0))])
def test_spike_bd_fwd_plans_are_the_launchers(cuda, NF, TC, TB, offsets):
    base = torch.empty(64, device=cuda).data_ptr()
    ptrs = tuple(base + o for o in offsets)
    want = spike.bd_plan(NF, TC, TB, ptrs)
    assert spike.card_bd_plan(NF, TC, TB, ptrs) == {
        k: want[k] for k in ("grid", "chunk", "smem")}
    want = spike.fwd_plan(NF, TC, TB)
    assert spike.card_fwd_plan(NF, TC, TB) == {
        k: want[k] for k in ("grid", "cslice", "smem")}


# the NF at which k_rot's float-float power is held to 1e-6 of float64
ROT_NF = (0, 1, 2, 3, 7, 1023, 1024, 4096, 16384)


@pytest.mark.cuda
@pytest.mark.parametrize("NF", ROT_NF)
def test_spike_rot_power_within_float64(cuda, NF):
    """k_rot's float-float power against the float64 loop on unit_m's
    inputs at a ragged size (n % 4 = 3: the scalar tail), within 1e-6
    at every NF (the first design's float32 loop: 4.8e-5 at 1024)."""
    rel, _, n = spike.compare("k_rot", NF, 203, 101, 1, device=cuda)
    assert n == 1 and rel <= 1e-6


@pytest.mark.cuda
def test_spike_rot_unaligned_operand(cuda):
    """m 4 bytes past a 16-byte boundary takes one element a thread: the
    same bits as the aligned float4 path, within 1e-6 of float64."""
    NF, TC, TB = 1024, 97, 101
    buf = spike.unit_m((1, TC * TB + 1), 5, device=cuda)
    m = buf[0, 1:].view(TC, TB)
    assert m.data_ptr() % 16 == 4
    got = spike.run_rot(m, NF)
    assert torch.equal(got, spike.run_rot(m.clone(), NF))
    ref = spike.run_rot_plain(m.double(), NF)
    assert _relerr(got.cpu(), ref.cpu()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("TC,TB", [(256, 256), (203, 101), (1, 3)])
def test_spike_rot_launches_are_bit_equal(cuda, TC, TB):
    """Two launches of k_rot agree bit for bit (a fixed order an
    element), also where n < 4 leaves only the tail."""
    m = spike.unit_m((TC, TB), 4, device=cuda)
    one, two = spike.run_rot(m, 1024), spike.run_rot(m, 1024)
    assert torch.equal(one, two)
    ref = spike.run_rot_plain(m.double(), 1024)
    assert _relerr(one.cpu(), ref.cpu()) <= 1e-6


# ---------------------------------------------------------------------------
# the kernel entry points of the production chain: stacked complex rows,
# the Nmp > 1 grouped dispatch, RimeFused, rime_pallas_reduce, hera-prod
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("K,N", [(300, 70), (70, 300)])
def test_kernel_four_stacked_complex_rows(cuda, conj, K, N):
    """rime_fwd as the 4-pol chain launches it (4 stacked blocks of nf
    rows, complex ps, complex out; forward and role-swapped shapes)
    against the plain version in float64; two launches bit-equal."""
    nf = 64
    ps, tauT = _case(11, 4 * nf, K, N, False)
    cps = torch.as_tensor(ps, dtype=torch.complex64, device=cuda)
    ctau = torch.as_tensor(tauT, dtype=torch.float32, device=cuda)
    a = rime_cuda.rime_fwd(cps, ctau, F0, DF, nf, conj, True)
    b = rime_cuda.rime_fwd(cps, ctau, F0, DF, nf, conj, True)
    ref = rime_cuda.rime_fwd_plain(cps.cpu().to(torch.complex128),
                                   ctau.cpu().double(), F0, DF, nf, conj,
                                   True)
    assert torch.equal(a, b)
    assert _relerr(a.cpu().numpy(), ref.numpy()) <= 1e-4


def _dispatch_case(seed, nmp=3):
    rng = np.random.default_rng(seed)
    nb, nf, npx = 12, 16, 200
    psky = rng.standard_normal((2, 2, nmp, nf, npx)) \
        + 1j * rng.standard_normal((2, 2, nmp, nf, npx))
    blvecs = rng.uniform(-30, 30, (nb, 3))
    s = rng.standard_normal((3, npx))
    s_c = s / np.linalg.norm(s, axis=0) / C_MS
    mp_idx = rng.integers(0, nmp, nb)
    d = 5 * (rng.standard_normal((2, 2, nb, nf))
             + 1j * rng.standard_normal((2, 2, nb, nf)))
    return psky, blvecs, s_c, mp_idx, d, F0 + np.arange(nf) * DF


@pytest.mark.cuda
def test_grouped_dispatch_on_card(cuda):
    """rime_reduce with a host mp_idx on CUDA takes the grouped kernel
    dispatch (one rime_fwd a used model pair forward and one backward,
    one rime_dtau a pair) and matches the CPU float64 chunked path:
    values and gradients in psky, blvecs and s_c."""
    from bayeslim_tpu_torch.ops import rime_kernel
    psky, blvecs, s_c, mp_idx, d, freqs = _dispatch_case(12)
    npair = len(np.unique(mp_idx))
    res, counts = [], []
    for dev, rdt, cdt in ((cuda, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        args = [torch.as_tensor(x, dtype=dt, device=dev).requires_grad_(True)
                for x, dt in ((psky, cdt), (blvecs, rdt), (s_c, rdt))]
        n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
        out = rime_kernel.rime_reduce(args[0], None, freqs, mp_idx=mp_idx,
                                      chunk=64, blvecs=args[1], s_c=args[2])
        loss = torch.sum(torch.abs(out - torch.as_tensor(
            d, dtype=cdt, device=dev)) ** 2)
        grads = torch.autograd.grad(loss, args)
        counts.append((rime_cuda.launches - n0[0],
                       rime_cuda.dtau_launches - n0[1]))
        res.append([out.detach().cpu().numpy()]
                   + [g.cpu().numpy() for g in grads])
    assert counts[0] == (2 * npair, npair) and counts[1] == (0, 0)
    for a, b in zip(*res):
        assert _relerr(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real", [True, False])
@pytest.mark.parametrize("conj", [False, True])
def test_rime_fused_on_card(cuda, ps_real, conj):
    """RimeFused (a delay matrix given) through the kernels against the
    CPU float64 plain path: value, psky and tau gradients; launches."""
    nf, npx, nb = 16, 300, 20
    ps, tauT = _case(13, 2 * nf, npx, nb, ps_real)
    d = np.random.default_rng(14).standard_normal((2 * nf, nb)) * 5
    res = []
    for dev, rdt, cdt in ((cuda, torch.float32, torch.complex64),
                          ("cpu", torch.float64, torch.complex128)):
        args = [torch.as_tensor(x, dtype=dt, device=dev).requires_grad_(True)
                for x, dt in ((ps, rdt if ps_real else cdt), (tauT.T, rdt))]
        n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
        out = rime_cuda.rime_fused(*args, F0, DF, nf, conj)
        loss = torch.sum(torch.abs(out - torch.as_tensor(
            d, dtype=rdt, device=dev)) ** 2)
        grads = torch.autograd.grad(loss, args)
        if dev == cuda:
            assert (rime_cuda.launches - n0[0],
                    rime_cuda.dtau_launches - n0[1]) == (2, 1)
        res.append([out.detach().cpu().numpy()]
                   + [g.cpu().numpy() for g in grads])
    for a, b in zip(*res):
        assert _relerr(a, b) <= 1e-4


@pytest.mark.cuda
def test_rime_pallas_reduce_on_card(cuda):
    nf, npx, nb = 16, 300, 20
    ps, tauT = _case(15, nf, npx, nb, False)
    freqs = F0 + np.arange(nf) * DF
    n0 = rime_cuda.launches
    a = rime_cuda.rime_pallas_reduce(
        torch.as_tensor(ps, dtype=torch.complex64, device=cuda),
        torch.as_tensor(tauT.T, dtype=torch.float32, device=cuda), freqs)
    assert rime_cuda.launches == n0 + 1
    b = rime_cuda.rime_pallas_reduce(torch.as_tensor(ps),
                                     torch.as_tensor(tauT.T), freqs)
    assert _relerr(a.cpu().numpy(), b.numpy()) <= 1e-4


@pytest.mark.cuda
def test_device_mp_idx_raises_on_card(cuda):
    """A device mp_idx on the card: one rime_fwd launch a model pair over
    all the baselines, mask-selected, equal to the host grouping's (the
    kernel's K split depends on the baseline count, so to float32's
    bar)."""
    from bayeslim_tpu_torch.ops import rime_cuda, rime_kernel
    psky, blvecs, s_c, mp_idx, _, freqs = _dispatch_case(16)
    args = (torch.as_tensor(psky, dtype=torch.complex64, device=cuda), None,
            freqs)
    kw = dict(blvecs=torch.as_tensor(blvecs, dtype=torch.float32,
                                     device=cuda),
              s_c=torch.as_tensor(s_c, dtype=torch.float32, device=cuda))
    n0 = rime_cuda.launches
    dev = rime_kernel.rime_reduce(
        *args, mp_idx=torch.as_tensor(mp_idx, device=cuda), **kw)
    assert rime_cuda.launches == n0 + psky.shape[-3]
    host = rime_kernel.rime_reduce(*args, mp_idx=mp_idx, **kw)
    assert _relerr(dev.cpu().numpy(), host.cpu().numpy()) <= 1e-4


@pytest.mark.cuda
def test_hera_prod_small_on_card(cuda):
    """The hera-prod chain at hex-2 (2 batches of 2 times, 4-pol, complex
    gains): card float32 against CPU float64, the loss and gradients
    accumulated over the batches; one rime_fwd a time and pass."""
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.scripts import hera_prod
    kw = dict(hexN=2, nside=8, nfreq=16, fmax=120e6, ntime=2, nbatch=2,
              pix_chunk=512)
    cpu, _ = hera_prod.build(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _ = hera_prod.build(bt, device=cuda, dtype=torch.float32, **kw)
    for g, c in zip(gpu.target, cpu.target):
        g.data = c.data.to(torch.complex64).to(cuda)
    bt.load_numpy_pdict(gpu.model, {
        k: v.detach().numpy() for k, v in cpu.collect_main_params().items()})
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    vg, gg = gpu.value_and_grad()
    assert (rime_cuda.launches - n0[0],
            rime_cuda.dtau_launches - n0[1]) == (2 * 2 * 2, 0)
    vc, gc = cpu.value_and_grad()
    assert abs(float(vg) - float(vc)) / abs(float(vc)) <= 1e-4
    for k in gc.keys():
        assert _relerr(gg[k].cpu().numpy(), gc[k].numpy()) <= 1e-4, k


@pytest.mark.cuda
def test_hera_redcal_small_on_card(cuda):
    """The hera-redcal chain at hex-2 (chip_smoke.build_redcal: RIME ->
    RedVisModel -> JonesModel with the degeneracy projection and both
    priors) at its start: card float32 against CPU float64, the loss
    (priors included) and both gradients; one rime_fwd a time, no
    rime_dtau; the degeneracy projection's constants stay on the card."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bayeslim_tpu_torch as bt
    from chip_smoke import build_redcal
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512)
    cpu, _, _ = build_redcal(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _, _ = build_redcal(bt, device=cuda, dtype=torch.float32, **kw)
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(cuda)
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    vg, gg = gpu.value_and_grad()
    assert (rime_cuda.launches - n0[0],
            rime_cuda.dtau_launches - n0[1]) == (2, 0)
    vc, gc = cpu.value_and_grad()
    assert abs(float(vg) - float(vc)) / abs(float(vc)) <= 1e-4
    for k in gc.keys():
        assert _relerr(gg[k].cpu().numpy(), gc[k].numpy()) <= 1e-4, k
    consts = gpu.model.cal.R._proj_consts
    assert consts and all(c[2].is_cuda and c[3].is_cuda
                          for c in consts.values())


@pytest.mark.cuda
def test_hera_hmc_small_trajectory_on_card(cuda):
    """One HMC trajectory of the hera-hmc chain at hex-2
    (chip_smoke.build_hmc: RIME -> JonesModel with sky, beam and gains
    trainable) from the same start and momenta: card float32 against CPU
    float64, the end position and momentum of every leaf and dU; two
    rime_fwd launches a time and evaluation, no rime_dtau."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bayeslim_tpu_torch as bt
    from chip_smoke import (GAINS, HMC_EPS, HMC_STEPS, SKY, build_hmc,
                            hmc_trajectory)
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512)
    cpu, _ = build_hmc(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _ = build_hmc(bt, device=cuda, dtype=torch.float32, **kw)
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(cuda)
    start = {k: v.detach().numpy().copy() for k, v in
             cpu.collect_main_params().items()}
    start[SKY][..., 0, :] *= 1.05
    start[GAINS][..., 0], start[GAINS][..., 1] = 1.0, 0.0
    rng = np.random.default_rng(4)
    momenta = {k: rng.standard_normal(v.shape) for k, v in start.items()}
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    card = hmc_trajectory(bt, torch, gpu, start, momenta, HMC_EPS, HMC_STEPS)
    assert (rime_cuda.launches - n0[0], rime_cuda.dtau_launches - n0[1]) \
        == (2 * 2 * (HMC_STEPS + 2), 0)
    ref = hmc_trajectory(bt, torch, cpu, start, momenta, HMC_EPS, HMC_STEPS)
    for k in ref[0]:
        assert _relerr(card[0][k], ref[0][k]) <= 1e-4, k
        assert _relerr(card[1][k], ref[1][k]) <= 1e-4, k
    assert abs(card[2] - ref[2]) <= 1e-4 * abs(ref[2])


@pytest.mark.cuda
def test_hera_alm_small_on_card(cuda):
    """The hera-alm chain at hex-2 (chip_smoke.build_alm: nside 8, lmax
    23, the Ylm built on the card) at its start: card float32 against CPU
    float64, the loss and the a_lm and beam gradients; two rime_fwd
    launches a time (forward and role-swapped), no rime_dtau."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bayeslim_tpu_torch as bt
    from chip_smoke import build_alm
    kw = dict(hexN=2, nside=8, lmax=23, nfreq=8, fmax=120e6, ntime=2,
              pix_chunk=512)
    cpu, _, _ = build_alm(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _, info = build_alm(bt, device=cuda, dtype=torch.float32, **kw)
    assert info["alm"].Ylm.is_cuda and info["alm"].Ylm.dtype == torch.complex64
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(cuda)
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    vg, gg = gpu.value_and_grad()
    assert (rime_cuda.launches - n0[0],
            rime_cuda.dtau_launches - n0[1]) == (2 * 2, 0)
    vc, gc = cpu.value_and_grad()
    assert abs(float(vg) - float(vc)) / abs(float(vc)) <= 1e-4
    for k in gc.keys():
        assert _relerr(gg[k].cpu().numpy(), gc[k].numpy()) <= 1e-4, k


@pytest.mark.cuda
def test_hera_sfb_small_on_card(cuda):
    """The hera-sfb chain at hex-2 (chip_smoke.build_sfb: nside 8, lmax
    23, 8 k modes, a Ylm beam of lmax 8; the sky's and the beam's Ylm and
    the stacked g_ln on the card) at its start: card float32 against CPU
    float64, the loss and the t_lmn and beam gradients; two rime_fwd
    launches a time (forward and role-swapped), no rime_dtau; and the
    batched SFB product against its per-l loop on the card."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bayeslim_tpu_torch as bt
    from chip_smoke import build_sfb
    kw = dict(hexN=2, nside=8, lmax=23, nfreq=8, fmax=120e6, ntime=2,
              pix_chunk=512, beam_lmax=8, beam_nside=8, nn=8)
    cpu, _, _ = build_sfb(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _, info = build_sfb(bt, device=cuda, dtype=torch.float32, **kw)
    sfb = gpu.model.sky.R.sfb
    assert sfb._G.is_cuda and sfb._G.dtype == torch.float32
    assert gpu.model.beam.R.alm.Ylm.is_cuda
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(cuda)
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    vg, gg = gpu.value_and_grad()
    assert (rime_cuda.launches - n0[0],
            rime_cuda.dtau_launches - n0[1]) == (2 * 2, 0)
    vc, gc = cpu.value_and_grad()
    assert abs(float(vg) - float(vc)) / abs(float(vc)) <= 1e-4
    for k in gc.keys():
        assert _relerr(gg[k].cpu().numpy(), gc[k].numpy()) <= 1e-4, k
    p = torch.randn((2, 8, info["alm"].Ncoeff), dtype=torch.complex64,
                    device=cuda)
    assert _relerr(sfb(p).cpu().numpy(),
                   sfb.forward_plain(p).cpu().numpy()) <= 1e-6


@pytest.mark.cuda
def test_hera_hmc_alm_small_trajectory_on_card(cuda):
    """One HMC trajectory of the hera-hmc-alm chain at hex-2
    (chip_smoke.build_hmc_alm: the a_lm sky, the Ylm beam and the gains)
    card float32 against CPU float64, as phase 7 runs it."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bayeslim_tpu_torch as bt
    from chip_smoke import phase_small_hmc
    phase_small_hmc(bt, torch, rime_cuda, cuda, alm=True)


@pytest.mark.cuda
def test_ylm_on_card_and_its_product_in_true_fp32(cuda):
    """A Ylm built on the card (nside 16, lmax 47) against the CPU
    float64 one, and the a_lm product and its gradient against float64
    with TF32 allowed globally: forward_alm turns it off (under TF32 the
    product would be off by ~5e-4)."""
    from bayeslim_tpu_torch.ops import sph_harm as tsh
    from bayeslim_tpu_torch.utils import healpix as hp
    theta, phi = hp.pix2ang(16, np.arange(hp.nside2npix(16)))
    l, m = tsh.gen_lm(47)
    card = tsh.AlmModel(l, m, real_output=True, device=cuda,
                        dtype=torch.float32)
    card.generate_Ylm(theta, phi, high_prec=False)
    ref = tsh.AlmModel(l, m, real_output=True, device="cpu",
                       dtype=torch.float64)
    ref.generate_Ylm(theta, phi, high_prec=False)
    assert _relerr(card.Ylm.cpu().numpy(), ref.Ylm.numpy()) <= 1e-6
    rng = np.random.default_rng(0)
    p = rng.standard_normal((16, len(l), 2)) / (l[:, None] + 1.0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pc = torch.as_tensor(p, dtype=torch.float32, device=cuda) \
            .requires_grad_(True)
        out = card.forward_alm(pc)
        (out ** 2).sum().backward()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    pr = torch.as_tensor(p).requires_grad_(True)
    want = ref.forward_alm(pr)
    (want ** 2).sum().backward()
    assert _relerr(out.detach().cpu().numpy(), want.detach().numpy()) <= 1e-5
    assert _relerr(pc.grad.cpu().numpy(), pr.grad.numpy()) <= 1e-5


def _filt_case(nf=1024, nspec=64, seed=0):
    """Smooth spectra over 100-200 MHz (in the band of a 300 ns delay
    filter) plus unit noise, and that filter (Cn = 1e-9 I)."""
    from bayeslim_tpu_torch.models import filt as tfilt
    freqs = np.linspace(100e6, 200e6, nf)
    Cs = tfilt.sinc_cov(freqs, ls=1 / (2 * 3e-7), device="cpu")
    rng = np.random.default_rng(seed)
    L = np.linalg.cholesky(Cs.numpy() + 1e-6 * np.eye(nf))
    y = (L @ (rng.standard_normal((nf, nspec))
              + 1j * rng.standard_normal((nf, nspec)))).T * 100
    y = y + rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape)
    return freqs, Cs, np.eye(nf) * 1e-9, y.reshape(1, 1, nspec // 2, 2, nf)


@pytest.mark.cuda
def test_linear_model_fft_and_filters_on_card_against_float64(cuda):
    """LinearModel, FFT and WedgeFilter on the card: float32 data
    against the same modules on float64 data. The filters take their
    products in float64, so float32 data lose only the output's
    rounding."""
    import bayeslim_tpu_torch as bt
    freqs, Cs, Cn, y = _filt_case()
    kw = dict(dim=4, x=freqs, Ndeg=16, basis="legendre", whiten=True,
              device=cuda)
    lm32 = bt.LinearModel("poly", dtype=torch.float32, **kw)
    lm64 = bt.LinearModel("poly", dtype=torch.float64, **kw)
    rng = np.random.default_rng(1)
    c = rng.standard_normal((1, 1, 7, 1, 16)) \
        + 1j * rng.standard_normal((1, 1, 7, 1, 16))
    got = lm32(torch.as_tensor(c, dtype=torch.complex64, device=cuda))
    want = lm64(torch.as_tensor(c, device=cuda))
    assert got.dtype == torch.complex64
    assert _relerr(got.cpu().numpy(), want.cpu().numpy()) <= 1e-6
    spectra = [bt.FFT(dim=4, N=len(freqs), dx=freqs[1] - freqs[0], ndim=5,
                      window="bh", device=cuda, dtype=dt)(
        torch.as_tensor(y, dtype=cdt, device=cuda)).cpu().numpy()
        for dt, cdt in ((torch.float32, torch.complex64),
                        (torch.float64, torch.complex128))]
    assert _relerr(*spectra) <= 1e-6
    bls = [(0, i) for i in range(1, y.shape[2] + 1)]
    f = bt.GPFilter(Cs, Cn, residual=True, device=cuda)
    w = bt.WedgeFilter([f], {0: bls[::2]}, bls=bls)
    y64 = torch.as_tensor(y, device=cuda)
    out32 = w(y64.to(torch.complex64))
    out64 = w(y64)
    assert out32.dtype == torch.complex64
    err = float(torch.max(torch.abs(out32.to(torch.complex128) - out64)))
    assert err <= 1e-7 * float(torch.max(torch.abs(y64)))
    # the baselines in no group pass through
    assert torch.equal(out64[:, :, 1::2], y64[:, :, 1::2])


@pytest.mark.cuda
def test_linear_model_and_filter_products_in_true_fp32(cuda):
    """With TF32 allowed globally, a float32 LinearModel and a filter
    with G in float32 (forward and gradient) stay within float32's
    rounding of float64 (TF32 keeps ~3 digits: ~1e-3)."""
    import bayeslim_tpu_torch as bt
    freqs, Cs, Cn, y = _filt_case(nspec=32)
    rng = np.random.default_rng(2)
    A = rng.standard_normal((512, 512))
    x = rng.standard_normal((8, 512)) + 1j * rng.standard_normal((8, 512))
    f64 = bt.GPFilter(Cs, Cn, residual=True, device=cuda)
    f32 = bt.MatFilter(G=f64.G, residual=True, device=cuda,
                       dtype=torch.float32)
    lm32 = bt.LinearModel("custom", A=A, dim=1, device=cuda,
                          dtype=torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x32 = torch.as_tensor(x, dtype=torch.complex64,
                              device=cuda).requires_grad_(True)
        lout = lm32(x32)
        torch.abs(lout).pow(2).sum().backward()
        y32 = torch.as_tensor(y, dtype=torch.complex64,
                              device=cuda).requires_grad_(True)
        fout = f32(y32)
        torch.abs(fout).pow(2).sum().backward()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    x64 = torch.as_tensor(x, device=cuda).requires_grad_(True)
    lwant = torch.as_tensor(A, device=cuda).to(torch.complex128) @ x64.T
    torch.abs(lwant).pow(2).sum().backward()
    assert _relerr(lout.detach().cpu().numpy(),
                   lwant.T.detach().cpu().numpy()) <= 1e-5
    assert _relerr(x32.grad.cpu().numpy(), x64.grad.cpu().numpy()) <= 1e-5
    y64 = torch.as_tensor(y, device=cuda).requires_grad_(True)
    fwant = f64(y64)
    torch.abs(fwant).pow(2).sum().backward()
    # the residual is ~1e-4 of the data: its errors, and its gradient's,
    # are held to the data's peak
    peak = float(torch.max(torch.abs(y64.detach())))
    assert float(torch.max(torch.abs(fout.detach().to(torch.complex128)
                                     - fwant))) <= 1e-5 * peak
    assert float(torch.max(torch.abs(y32.grad.to(torch.complex128)
                                     - y64.grad))) <= 1e-5 * peak


@pytest.mark.cuda
def test_hera_filt_small_on_card(cuda):
    """The hera-filt chain at hex-2 (chip_smoke.build_filt: 64 channels,
    16 Legendre coefficients a gain, the delay filter at a suppression
    of 100) at its start: card float32 against CPU float64, the loss and
    the antenna and gain gradients; one rime_fwd and one rime_dtau a
    time."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bayeslim_tpu_torch as bt
    from chip_smoke import build_filt
    kw = dict(hexN=2, nside=8, nfreq=64, fmax=200e6, ntime=2, pix_chunk=512,
              noise=1e-2)
    cpu, _, _ = build_filt(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _, _ = build_filt(bt, device=cuda, dtype=torch.float32, **kw)
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(cuda)
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    vg, gg = gpu.value_and_grad()
    assert (rime_cuda.launches - n0[0],
            rime_cuda.dtau_launches - n0[1]) == (2, 2)
    vc, gc = cpu.value_and_grad()
    assert abs(float(vg) - float(vc)) / abs(float(vc)) <= 1e-4
    for k in gc.keys():
        assert _relerr(gg[k].cpu().numpy(), gc[k].numpy()) <= 1e-4, k


def _repo_on_path():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


@pytest.mark.cuda
def test_vismapper_kernel_route_on_card(cuda):
    """VisMapper on the card (float32, the kernel route) over the hex-2
    hera-filt cube against its plain version in float64 on the card:
    the maps, the diagonal and row-sum P, compute_Am and compute_Pm; the
    launches are times x chunks a launch kind, none of rime_dtau."""
    _repo_on_path()
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.utils import healpix as hp
    from chip_smoke import build_filt
    kw = dict(hexN=2, nside=8, nfreq=16, fmax=200e6, ntime=2, pix_chunk=512)
    _, _, info = build_filt(bt, device=cuda, dtype=torch.float32, **kw)
    vd = info["unfiltered"]
    theta, phi = hp.pix2ang(8, np.arange(hp.nside2npix(8)))
    ra, dec = np.rad2deg(phi), 90 - np.rad2deg(theta)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, vd.freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, parameter=False, device=cuda,
                        dtype=torch.float32)
    m32 = bt.VisMapper(vd, ra, dec, beam=beam, pix_chunk=64)
    v64 = vd.copy()
    v64.data = vd.data.to(torch.complex128)
    m64 = bt.VisMapper(v64, ra, dec, beam=beam, use_kernel=False)
    assert m32._kernel_route() and not m64._kernel_route()
    nchunk = len(m32._chunks(True))
    with torch.no_grad():
        for contract in ("diag", "rowsum"):
            n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
            a, Pa = m32.make_map(contract=contract)
            per = 1 if contract == "diag" else 3
            assert (rime_cuda.launches - n0[0],
                    rime_cuda.dtau_launches - n0[1]) == (per * 2 * nchunk, 0)
            b, Pb = m64.make_map(contract=contract)
            assert _relerr(a.cpu().numpy(), b.cpu().numpy()) <= 1e-4
            assert _relerr(Pa.cpu().numpy(), Pb.cpu().numpy()) <= 1e-4
        for fn in ("compute_Am", "compute_Pm"):
            x = getattr(m32, fn)(a)
            y = getattr(m64, fn)(b)
            assert _relerr(x.cpu().numpy(), y.cpu().numpy()) <= 1e-4


@pytest.mark.cuda
def test_small_hessian_on_card(cuda):
    """compute_hessian of the hex-2 hera-cal chain in float64 on the
    card against the CPU (1e-9), with no kernel launch; a double
    backward through the float32 chain's fused kernels raises the error
    naming force_chunked."""
    _repo_on_path()
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.inference import hessian
    from chip_smoke import ANTVECS, build_cal
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512,
              ant_sigma=0.05, gain_sigma=0.1)
    cpu, _ = build_cal(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _ = build_cal(bt, device=cuda, dtype=torch.float64, **kw)
    gpu.target[0].data = cpu.target[0].data.to(cuda)
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    Hg, _ = hessian.compute_hessian(gpu, keys=[ANTVECS])
    assert (rime_cuda.launches, rime_cuda.dtau_launches) == n0
    Hc, _ = hessian.compute_hessian(cpu, keys=[ANTVECS])
    assert _relerr(Hg.cpu().numpy(), Hc.numpy()) <= 1e-9
    g32, _ = build_cal(bt, device=cuda, dtype=torch.float32, **kw)
    x = g32.model.rime.array.antvecs.detach().clone().requires_grad_(True)
    g, = torch.autograd.grad(g32(bt.ParamDict({ANTVECS: x})), x,
                             create_graph=True)
    assert rime_cuda.launches > n0[0]
    with pytest.raises(RuntimeError, match="force_chunked"):
        torch.autograd.grad(g.sum(), x)


@pytest.mark.cuda
def test_small_factored_inv_hessian_on_card(cuda):
    """FactoredInvHessian.from_lbfgs after 3 L-BFGS steps of the hex-2
    hera-cal chain in float64, built on the card and on the CPU:
    t_hist, to_dense() and chol() agree (1e-9), and L L^T = H."""
    _repo_on_path()
    import bayeslim_tpu_torch as bt
    from chip_smoke import build_cal, small_fih
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512,
              ant_sigma=0.05, gain_sigma=0.1)
    cpu, _ = build_cal(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _ = build_cal(bt, device=cuda, dtype=torch.float64, **kw)
    gpu.target[0].data = cpu.target[0].data.to(cuda)
    fg, tg = small_fih(bt, torch, gpu)
    fc, tc = small_fih(bt, torch, cpu)
    assert len(fg.u) == len(fc.u) > 0
    assert _relerr(np.asarray(tg), np.asarray(tc)) <= 1e-9
    H = fg.to_dense()
    assert _relerr(H.cpu().numpy(), fc.to_dense().numpy()) <= 1e-9
    L = fg.chol()
    assert _relerr(L.cpu().numpy(), fc.chol().numpy()) <= 1e-9
    assert _relerr((L @ L.T).cpu().numpy(), H.cpu().numpy()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("ps_real,conj,out_imag", [(True, False, True),
                                                   (False, True, False)])
def test_kernel_delay_residual(cuda, ps_real, conj, out_imag):
    """rime_fwd with tauT_lo (a float64 delay as float32 plus its
    rounding's residual) against the plain version in float64 on the
    float64 delay, at delays up to hex-11's longest and 1024 channels to
    200 MHz: within 1e-5, where the float32 delay alone is further."""
    rng = np.random.default_rng(9)
    nf, K, N = 1024, 700, 96
    f0, df = 100e6, 100e6 / 1023
    tau = rng.uniform(-1.1e-6, 1.1e-6, (K, N))
    ps = rng.standard_normal((nf, K))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal((nf, K))
    hi = torch.as_tensor(tau, dtype=torch.float32, device=cuda)
    lo = (torch.as_tensor(tau, device=cuda) - hi.double()).float()
    cps = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                          else torch.complex64, device=cuda)
    kw = dict(conj=conj, out_imag=out_imag)
    a = rime_cuda.rime_fwd(cps, hi, f0, df, nf, tauT_lo=lo, **kw)
    ref = rime_cuda.rime_fwd_plain(
        cps.to(torch.float64 if ps_real else torch.complex128),
        torch.as_tensor(tau, device=cuda), f0, df, nf, **kw)
    no_lo = rime_cuda.rime_fwd(cps, hi, f0, df, nf, **kw)
    err = _relerr(a.cpu().numpy(), ref.cpu().numpy())
    assert err <= 1e-5
    assert err < _relerr(no_lo.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_hera_avg_small_on_card(cuda):
    """hera-avg's hex-2 chain (chip_smoke.build_avg_chain:
    Sequential(RIME -> RedVisInflate -> JonesModel -> RedVisAvg) from
    unit gains against its group-averaged cube): card float32 against
    CPU float64, the loss and the sky, beam and gain gradients through
    the segment sums; one rime_fwd a time forward and one backward, no
    rime_dtau. Then the data layer's operations on the card's cube
    against the CPU in float64."""
    _repo_on_path()
    import bayeslim_tpu_torch as bt
    from chip_smoke import build_avg_chain
    cpu = build_avg_chain(bt, torch, "cpu", torch.float64)
    gpu = build_avg_chain(bt, torch, cuda, torch.float32)
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(cuda)
    bt.load_numpy_pdict(gpu.model, {k: v.detach().numpy() for k, v in
                                    cpu.collect_main_params().items()})
    n0 = (rime_cuda.launches, rime_cuda.dtau_launches)
    vg, gg = gpu.value_and_grad()
    assert (rime_cuda.launches - n0[0],
            rime_cuda.dtau_launches - n0[1]) == (4, 0)
    vc, gc = cpu.value_and_grad()
    assert abs(float(vg) - float(vc)) / abs(float(vc)) <= 1e-4
    for k in gc.keys():
        assert _relerr(gg[k].cpu().numpy(), gc[k].numpy()) <= 1e-4, k
    vd = cpu.target[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 1, vd.Nbls, 4, vd.Nfreqs)) * (1 + 1j)
    v64 = bt.VisData()
    v64.setup_meta(vd.telescope, vd.antpos)
    v64.setup_data(vd.bls, 2458168.3 + np.arange(4) * 5e-4, vd.freqs,
                   pol="ee", data=torch.as_tensor(x),
                   icov=torch.as_tensor(rng.uniform(1, 2, x.shape)))
    v32 = v64.copy()
    v32.data = v64.data.to(torch.complex64).to(cuda)
    v32.icov = v64.icov.float().to(cuda)
    for fn in (lambda v: v.time_average([[0, 1], [2, 3]], rephase=True),
               lambda v: v.bl_average(),
               lambda v: v.reduce_by_redundancy()[0],
               lambda v: v.lst_rephase(dLST=0.01)):
        a, b = fn(v32), fn(v64)
        assert a.data.is_cuda
        assert _relerr(a.data.cpu().numpy(), b.data.numpy()) <= 1e-5


@pytest.mark.cuda
def test_hera_io_small_on_card(cuda, tmp_path):
    """hera-io's hex-2 chain on the card through the file layer
    (chip_smoke.io_seq_dict: the sky a pickle, the rest kwargs dicts,
    build_prob against io_target): Adam steps checkpointed, a fresh
    build restored and resumed bit-equal to the uninterrupted run (under
    torch.use_deterministic_algorithms); the optimizer's moments restored
    on the card and Adam's step counts on the CPU; the chain pickled on
    the card and read onto the CPU (its float32 loss within 1e-4 of the
    card's); the gains through write_calfits / read_calfits on the card,
    exact."""
    _repo_on_path()
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.data import io
    from bayeslim_tpu_torch.data import uvdata_interface as uv
    from bayeslim_tpu_torch.utils import checkpoint as ck
    from chip_smoke import build_sky_beam, io_seq_dict, io_target
    dt = torch.float32
    _, _, sky, _, _ = build_sky_beam(bt, 2, 8, 16, 120e6, 0.5, True, cuda,
                                     dt, np.random.default_rng(0), amp=1e4)
    sky_pkl = str(tmp_path / "sky.pkl")
    io.write_pkl(sky_pkl, sky)
    sd = io_seq_dict(sky_pkl, hexN=2, nfreq=16, fmax=120e6, ntime=2,
                     pix_chunk=512)
    tgt = io_target(bt, torch, io, sd, cuda, dt)

    def trainer():
        prob = io.build_prob(seq_dict=sd, data=tgt, device=cuda, dtype=dt)
        return bt.Trainer(prob, optimizer=lambda p: torch.optim.Adam(
            p, lr=1e-3), verbose=False)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = trainer()
        ref.train(3)
        mgr = ck.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
        first = trainer()
        for step in range(2):
            first.train(1)
            mgr.maybe_save(step, first.pdict, first.opt,
                           extra={"losses": list(first.loss_history)})
        again = trainer()
        st = mgr.restore_latest(like={"params": again.pdict,
                                      "opt_state": again.opt})
        again.loss_history = st["extra"]["losses"]
        again.train(1)
    finally:
        torch.use_deterministic_algorithms(det)
    assert again.loss_history == ref.loss_history
    for k, v in ref.pdict.items():
        assert torch.equal(again.pdict[k], v), k
    for s in again.opt.state.values():
        assert s["exp_avg"].is_cuda and s["step"].device.type == "cpu"
    chain_pkl = str(tmp_path / "chain.pkl")
    io.write_pkl(chain_pkl, ref.prob.model)
    cpu_chain = io.read_pkl(chain_pkl, device="cpu")
    tc = tgt.copy()
    tc.push("cpu")
    with torch.no_grad():
        lg = float(ref.prob())
        lc = float(bt.LogProb(cpu_chain, tc)())
    assert abs(lg - lc) <= 1e-4 * abs(lg)
    rime = ref.prob.model.rime
    cd = ref.prob.model.cal.to_CalData(rime.freqs, rime.all_sim_times[:1],
                                       pol="ee",
                                       antpos=rime.array.to_antpos())
    cd.data = cd.data.to(torch.complex128)
    f = str(tmp_path / "gains.calfits")
    uv.write_calfits(cd, f)
    back = uv.read_calfits(f, device=cuda)
    assert back.data.is_cuda and torch.equal(back.data, cd.data)


# ---- the per-time sky and Airy power beam (models/airy_psky.py)

def _psky_case(label, device, dtype):
    _repo_on_path()
    from chip_smoke import PSKY_SHAPES, psky_case
    _, nf, nside, trained = {s[0]: s for s in PSKY_SHAPES}[label]
    return psky_case(torch, nf, nside, trained, device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["hex11", "alm64"])
def test_airy_psky_kernels_vs_eager_at_cell_shapes(cuda, label):
    """The kernels at the benchmark cells' per-time shapes (hex11: 1024
    channels x 6,144 FOV pixels, a fixed 14 m beam; alm64: 128 x 26,624,
    an elliptical beam off 14 m): psky, the sky gradient and dD against
    the eager path in float64 of the same float32 inputs, within
    chip_smoke.PSKY_TOL (float32 rounding of the approximant, ~4e-7 for
    the eager path itself); two backward calls bit-equal."""
    from chip_smoke import PSKY_TOL, psky_eager
    from bayeslim_tpu_torch.models import airy_psky as ap
    a32, g32 = _psky_case(label, cuda, torch.float32)
    ref = psky_eager(torch, ap, a32, g32, torch.float64)
    ker = (ap.airy_psky_fwd(*a32),) + ap.airy_psky_bwd(g32, *a32)
    for q, k, r in zip(PSKY_TOL, ker, ref):
        assert _relerr(k.cpu().numpy(), r.cpu().numpy()) <= PSKY_TOL[q], q
    again = ap.airy_psky_bwd(g32, *a32)
    assert all(torch.equal(a, b) for a, b in zip(ker[1:], again))


def _psky_rime(bt, ntime, trained, device):
    """A hex-2 float32 RIME with build_sky_beam's sky and Airy beam:
    trained (its sky and beam) or fixed (the antennas trained), over
    ntime times; returns its LogProb at its own forward."""
    from chip_smoke import build_sky_beam
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, 2, 8, 16, 200e6, 1.0, not trained, device, torch.float32,
        np.random.default_rng(0))
    bls = arr.get_bls(keep_autos=False)
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, bls, times, freqs, pix_chunk=256)
    with torch.no_grad():
        data = rime().data * 1.1
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=data)
    return bt.LogProb(rime, tgt)


@pytest.mark.cuda
@pytest.mark.parametrize("trained,launches", [(False, (16, 0)),
                                              (True, (16, 16))])
def test_airy_psky_counters_at_sixteen_times(cuda, trained, launches):
    """One evaluation at the cells' 16 times: 16 forward kernel calls
    and no backward one with the sky and beam fixed (hex11.cal-lbfgs),
    16 and 16 with both trained (alm64.adam)."""
    _repo_on_path()
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.models import airy_psky as ap
    prob = _psky_rime(bt, 16, trained, cuda)
    n0 = (ap.launches, ap.bwd_launches)
    prob.value_and_grad()
    assert (ap.launches - n0[0], ap.bwd_launches - n0[1]) == launches


@pytest.mark.cuda
def test_airy_psky_rime_fused_vs_eager_on_card(cuda, monkeypatch):
    """A whole RIME forward and backward (sky and beam trained) on the
    fused path and, with the predicate turned off, on the eager,
    checkpointed one: the loss and every gradient agree to 1e-5 of their
    largest magnitude (each path's float32 rounding, ~6e-7 of it)."""
    _repo_on_path()
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.models import airy_psky as ap
    prob = _psky_rime(bt, 2, True, cuda)
    n0 = ap.launches
    loss, grads = prob.value_and_grad()
    assert ap.launches == n0 + 2
    monkeypatch.setattr(ap, "fused_eligible", lambda *a: False)
    eloss, egrads = prob.value_and_grad()
    assert ap.launches == n0 + 2
    assert abs(float(loss) - float(eloss)) <= 1e-5 * abs(float(eloss))
    for k, v in egrads.items():
        assert _relerr(grads[k].cpu().numpy(), v.cpu().numpy()) <= 1e-5, k


@pytest.mark.cuda
def test_airy_psky_second_derivative_raises(cuda):
    """A create_graph backward through the fused path gives first
    derivatives; differentiating them again raises the error that names
    force_chunked."""
    from bayeslim_tpu_torch.models import airy_psky as ap
    args, _ = _psky_case("alm64", cuda, torch.float32)
    sky = args[0].clone().requires_grad_(True)
    D = args[5].clone().requires_grad_(True)
    psky = ap.AiryPsky.apply(sky, *args[1:5], D, *args[6:])
    g, = torch.autograd.grad((psky ** 2).sum(), D, create_graph=True)
    with pytest.raises(RuntimeError, match="force_chunked"):
        torch.autograd.grad(g.sum(), sky)
