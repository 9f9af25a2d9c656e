"""The port's microbenchmark spikes (bayeslim_tpu_torch/scripts/
mosaic_spike.py) against the TPU kernels of scripts/mosaic_spike.py.

The JAX script is loaded from its file, its module globals are set to
small sizes, and each of its seven kernel bodies runs through
pl.pallas_call in interpret mode, as its run_* functions call them. The
port's run_* on CPU tensors (the plain versions) take the same
numpy-seeded inputs. The CUDA kernels themselves are tested on the card
by tests/test_torch_cuda.py.
"""
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bayeslim_tpu_torch.scripts import mosaic_spike as spike
from bayeslim_tpu_torch.scripts import (bd_fwd_variants, rot_variants,
                                        sgemm_variants, vt_lr_variants)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC, TB, NF, G = 16, 24, 32, 4
NAMES = [name for name, _ in spike.SPIKES]


@pytest.fixture(scope="module")
def jax_spike():
    """scripts/mosaic_spike.py as a module, at the test sizes."""
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_spike", os.path.join(REPO, "scripts", "mosaic_spike.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.TC, mod.TB, mod.NF, mod.G = TC, TB, NF, G
    return mod


def _pallas(body, args, outs, scratch=()):
    """pl.pallas_call as the JAX script's run_* make it, interpreted."""
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    shapes = [jax.ShapeDtypeStruct(s, jnp.float32) for s in outs]
    multi = len(outs) > 1
    return pl.pallas_call(
        body, out_shape=shapes if multi else shapes[0],
        in_specs=[vmem] * len(args),
        out_specs=[vmem] * len(outs) if multi else vmem,
        scratch_shapes=[pltpu.VMEM(s, jnp.float32) for s in scratch],
        interpret=True)(*args)


# outputs and scratch of each JAX body (scripts/mosaic_spike.py run_*)
JAX_CALLS = {
    "k_nn": ([(NF, TB)], ()),
    "k_nt": ([(NF, TC)], ()),
    "k_vt": ([(TC, TB)], ()),
    "k_lr": ([(NF, TC)], ()),
    "k_bd": ([(NF, TB)], [(G * TC, TB)]),
    "k_rot": ([(TC, TB)], ()),
    "k_fwd": ([(NF, TB)] * 2, [(G * TC, TB)] * 2),
}


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jax_interpret(jax_spike, name):
    args = spike.make_args(name, NF, TC, TB, G, device="cpu", seed=3)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    outs, scratch = JAX_CALLS[name]
    ref = _pallas(getattr(jax_spike, name),
                  [jnp.asarray(t.numpy()) for t in tensors], outs, scratch)
    got = spike.RUN[name](*args)
    ref = list(ref) if isinstance(ref, (list, tuple)) else [ref]
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(ref) == len(outs)
    for r, g, shape in zip(ref, got, outs):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        assert np.isfinite(np.asarray(r)).all()
        # float32 sums in another order than the interpreted bodies
        assert _relerr(g.numpy(), r) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_compare_holds_plain_float32_against_float64(name):
    """compare() (the card's check) on CPU tensors: the plain version in
    float32 against itself in float64, and no kernel launch."""
    rel, err, n = spike.compare(name, NF, TC, TB, G, device="cpu", seed=2)
    assert n == 0 and np.isfinite(err)
    assert rel <= 1e-5


def test_mk_is_the_jax_scripts_mk(jax_spike):
    for shape, seed in (((NF, TC), 0), ((TC, TB), 5)):
        np.testing.assert_array_equal(
            spike.mk(shape, seed, device="cpu").numpy(),
            np.asarray(jax_spike.mk(shape, seed)))


def test_rot_is_finite_on_normal_inputs():
    m = spike.mk((TC, TB), 0, device="cpu")
    out = spike.run_rot(m, NF)
    assert out.shape == (TC, TB) and torch.isfinite(out).all()


def test_unit_inputs_keep_the_rotation_bounded():
    """unit_m's chains stay within e^(+-1) of unit modulus over 1024
    steps, so the card's check of k_rot compares finite numbers."""
    m = spike.unit_m((TC, TB), 1, device="cpu").double()
    modulus = (m.abs() * np.sqrt(0.82)) ** 1024
    assert float(modulus.min()) > np.exp(-1.1)
    assert float(modulus.max()) < np.exp(1.1)
    out = spike.run_rot_plain(m, 1024)
    assert torch.isfinite(out).all() and float(out.abs().max()) < 10


@pytest.mark.parametrize("run", [spike.run_bd, spike.run_fwd])
def test_rows_not_a_multiple_of_g_raise(run):
    a = spike.mk((NF + 2, TC), 0, device="cpu")
    b = spike.mk((TC, TB), 1, device="cpu")
    args = (a, b, G) if run is spike.run_bd else (b, a, G)
    with pytest.raises(ValueError, match="multiple of G"):
        run(*args)


@pytest.mark.parametrize("name", NAMES)
def test_non_float32_raises(name):
    args = spike.make_args(name, NF, TC, TB, G, device="cpu")
    args = [a.double() if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(TypeError, match="float32"):
        spike.RUN[name](*args)


def test_mismatched_shapes_raise():
    ps = spike.mk((NF, TC), 0, device="cpu")
    with pytest.raises(ValueError):
        spike.run_nn(ps, spike.mk((TC + 1, TB), 0, device="cpu"))
    with pytest.raises(ValueError):
        spike.run_nt(spike.mk((NF, TB), 0, device="cpu"),
                     spike.mk((TC, TB + 1), 0, device="cpu"))
    with pytest.raises(ValueError):
        spike.run_fwd(spike.mk((TC + 1, TB), 0, device="cpu"), ps, G)


def test_main_times_only_on_the_card():
    """main(device=None) raises without a GPU (tests/test_torch_slice.py);
    asked for the CPU, it refuses rather than time plain versions."""
    with pytest.raises(ValueError, match="on the card"):
        spike.main(device="cpu")


@pytest.mark.parametrize("name,sizes,ms,by", [
    ("k_nn", (1024, 256, 256), 2.003e-3, "operations"),
    ("k_lr", (1024, 256, 256), 2.003e-3, "operations"),
    ("k_vt", (1024, 256, 256), 4.695e-4, "bytes"),
    # the recurrence's result needs ~11 complex products by squaring
    ("k_rot", (1024, 256, 256), 1.5650e-4, "bytes"),
    ("k_fwd", (1024, 256, 256), 4.006e-3, "operations"),
    ("k_rot", (1024, 6144, 630), 9.2435e-3, "bytes"),
    # the contraction alone: rime_fwd's bound at the same shape
    ("k_fwd", (1024, 6144, 630), 0.23663, "operations"),
])
def test_bounds(name, sizes, ms, by):
    got, got_by = spike.bound_ms(name, *sizes)
    assert got_by == by
    assert got == pytest.approx(ms, rel=1e-3)


@pytest.mark.parametrize("name,per_triple", [("k_vt", 2), ("k_rot", 6),
                                             ("k_fwd", 10), ("k_nn", 2)])
def test_loop_flops_count_the_tpu_bodys_loop(name, per_triple):
    assert spike.loop_flops(name, 1024, 256, 256) == per_triple * 1024 * 256 ** 2
    assert spike.loop_flops(name) >= spike.work(name)[0]


@pytest.mark.parametrize("name", ["k_nn", "k_nt", "k_lr", "k_fwd"])
def test_compare_draws_each_operand_from_its_own_seed(name):
    """The script's inputs share one seed, so ct[:TC] is m; the card's
    check must not, or a kernel that swaps indices of a symmetric block
    would pass."""
    shared = spike.make_args(name, NF, TC, TB, G, device="cpu")
    own = spike.make_args(name, NF, TC, TB, G, device="cpu", distinct=True)
    a, b = [[t.flatten() for t in args if isinstance(t, torch.Tensor)]
            for args in (shared, own)]
    n = min(len(a[0]), len(a[1]))               # the common stream prefix
    assert torch.equal(a[0][:n], a[1][:n])
    assert not torch.equal(b[0][:n], b[1][:n])


def test_roofline_is_the_larger_time():
    from bayeslim_tpu_torch.ops import rime_cuda
    assert rime_cuda.roofline_ms(67e9, 0.0) == (pytest.approx(1.0),
                                                "operations")
    assert rime_cuda.roofline_ms(1.0, 3.35e9) == (pytest.approx(1.0),
                                                  "bytes")


@pytest.mark.parametrize("nf,tc,tb", [(1024, 256, 256), (1024, 6144, 630),
                                      (96, 200, 100), (32, 16, 24),
                                      (104, 203, 101), (97, 203, 101),
                                      (5, 3, 1), (4096, 33, 7)])
def test_fwd_slices_cover_the_c_axis(nf, tc, tb):
    """fwd_plan's slices of c: whole tiles, at most FWD_SLICES of them,
    none empty, together covering every c once."""
    plan = spike.fwd_plan(nf, tc, tb)
    cslice, S = plan["cslice"], plan["grid"][2]
    assert 1 <= S <= spike.FWD_SLICES
    assert cslice % spike.FWD_TK == 0 and cslice * S >= tc
    assert cslice * (S - 1) < tc                # no empty slice
    (tr, tn) = plan["tile"]
    assert plan["grid"][:2] == (-(-tb // tn), -(-nf // tr))


def _sgemm_cells(nt, M, N, K):
    """(rows, columns) of every output that a (block, thread, i, j) of
    sgemm_plan's launch stores, by the .cu's mapping: thread t owns rows
    ty + TY i and columns tx + TX j (k_nt) or 4 tx + j (k_nn), tx = t %
    TX, ty = t // TX, i, j < 4, TX = BN / 4, TY = BM / 4, stores masked
    at (M, N)."""
    plan = spike.sgemm_plan(nt, M, N, K)
    (gx, gy), (bm, bn, _) = plan["grid"], plan["tile"]
    TX, TY = bn // 4, bm // 4
    t = np.arange(plan["threads"])
    tx, ty = t % TX, t // TX
    assert len(t) == TX * TY
    rows = (ty[:, None] + TY * np.arange(4)[None]).repeat(4, 1)
    cols = np.tile(tx[:, None] + TX * np.arange(4)[None] if nt
                   else 4 * tx[:, None] + np.arange(4)[None], (1, 4))
    assert rows.max() < bm and cols.max() < bn
    by, bx = np.divmod(np.arange(gx * gy), gx)
    r = (by[:, None] * bm + rows.ravel()[None]).ravel()
    c = (bx[:, None] * bn + cols.ravel()[None]).ravel()
    keep = (r < M) & (c < N)
    return r[keep], c[keep]


def _owners(nt, M, N, K):
    """How many (block, thread) pairs store each output of the SGEMM of
    k_nn / k_nt under sgemm_plan's launch (_sgemm_cells' mapping)."""
    count = np.zeros((M, N), dtype=int)
    np.add.at(count, _sgemm_cells(nt, M, N, K), 1)
    return count


@pytest.mark.parametrize("nt", [False, True])
@pytest.mark.parametrize("M,N,K", [(1024, 256, 256), (96, 100, 200),
                                   (97, 101, 203), (5, 3, 1), (200, 40, 6144)])
def test_sgemm_grid_stores_every_output_once(nt, M, N, K):
    assert (_owners(nt, M, N, K) == 1).all()


@pytest.mark.parametrize("nt", [False, True])
def test_sgemm_fills_the_card_at_the_spike_shape(nt):
    plan = spike.sgemm_plan(nt, spike.NF, spike.TC, spike.TB)
    gx, gy = plan["grid"]
    assert gx * gy == 128 and plan["threads"] == 128
    assert plan["chunk"] == 16


@pytest.mark.parametrize("nt", [False, True])
@pytest.mark.parametrize("K", [1, 3, 64, 256, 1001, 6144, 1 << 20])
def test_sgemm_shared_memory_fits_any_k(nt, K):
    """The ring holds SG_STAGES slices of SG_BK k whatever K is: at most
    227 KB (232,448 bytes) a block, above 48 KB (the launcher sets the
    attribute)."""
    smem = spike.sgemm_plan(nt, 1024, 256, K)["smem"]
    assert 48 * 1024 < smem <= 232448
    assert smem == spike.sgemm_plan(nt, 7, 9, 6144)["smem"]


@pytest.mark.parametrize("nt,M,N,K,ptrs,chunk", [
    (True, 96, 100, 200, (0, 0), 16),
    (False, 96, 100, 200, (0, 0), 16),
    (True, 97, 101, 200, (0, 0), 16),          # k_nt: N need not be
    (False, 97, 101, 200, (0, 0), 4),          # k_nn: B's rows are N long
    (True, 96, 100, 203, (0, 0), 4),           # K % 4 != 0
    (False, 96, 100, 203, (0, 0), 4),
    (True, 96, 100, 200, (4, 0), 4),           # A not 16-byte aligned
    (False, 96, 100, 200, (0, 8), 4),          # B not 16-byte aligned
    (True, 96, 100, 200, (32, 48), 16),
])
def test_sgemm_16_byte_chunks_only_when_rows_and_pointers_align(
        nt, M, N, K, ptrs, chunk):
    assert spike.sgemm_plan(nt, M, N, K, ptrs)["chunk"] == chunk


@pytest.mark.parametrize("variant", list(sgemm_variants.EDITS))
def test_sgemm_variants_edit_the_kernel_source(variant):
    """Each design alternative of scripts/sgemm_variants.py is a text edit
    of csrc/mosaic_spike.cu: every text it replaces is there exactly once,
    so the variant changes the one place it names."""
    src = open(os.path.join(REPO, "bayeslim_tpu_torch", "csrc",
                            "mosaic_spike.cu")).read()
    for old, new in sgemm_variants.EDITS[variant]:
        assert src.count(old) == 1 and old != new


# ---- k_vt and k_lr: launch plans and host emulations of the kernels'
# fixed summation order, through the index formulas of
# csrc/mosaic_spike.cu (k_vt, k_lr, lr_scatter) under vt_plan / lr_plan

VT_LR_SIZES = [(1024, 256, 256), (96, 200, 100), (97, 203, 101), (5, 3, 1),
               (NF, TC, TB)]


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _vt_emulate(ps, m, ptrs=(0, 0, 0)):
    """k_vt in float32 as the .cu orders it. Returns (out, times each
    (j, c) entered a column sum, times each output was stored)."""
    (nf, tc), tb = ps.shape, m.shape[1]
    plan = spike.vt_plan(nf, tc, tb, ptrs)
    CL, GC, T = plan["cluster"], plan["group"], plan["threads"]
    W = plan["chunk"] // 4
    LPR, NW, RPB = GC // W, T // 32, GC // CL
    RPP = T // LPR
    rows = -(-nf // CL)
    t = np.arange(T)
    tx, ty, lane, warp = t % LPR, t // LPR, t % 32, t // 32
    out = np.full((tc, tb), np.nan, dtype=np.float32)
    seen = np.zeros((nf, tc), dtype=int)
    stores = np.zeros((tc, tb), dtype=int)
    for grp in range(plan["grid"][0] // CL):
        c0 = grp * GC
        part = np.zeros((CL, GC), dtype=np.float32)
        for rank in range(CL):
            j1 = min(nf, (rank + 1) * rows)
            cols = c0 + tx[:, None] * W + np.arange(W)        # (T, W)
            acc = np.zeros((T, W), dtype=np.float32)
            for i in range(-(-rows // RPP)):
                j = rank * rows + ty + RPP * i
                ok = ((j < j1) & (c0 + tx * W < tc))[:, None] & (cols < tc)
                jj, cc = np.where(ok, j[:, None], 0), np.where(ok, cols, 0)
                acc = _f32(acc + np.where(ok, ps[jj, cc], 0))
                np.add.at(seen, (jj[ok], cc[ok]), 1)
            off = 16
            while off >= LPR:
                acc = _f32(acc + acc[t ^ off])
                off //= 2
            wpart = np.zeros((NW, GC), dtype=np.float32)
            keep = lane < LPR
            wpart[warp[keep][:, None], lane[keep][:, None] * W
                  + np.arange(W)] = acc[keep]
            s = np.float32(0)
            for k in range(NW):
                s = _f32(s + wpart[k])
            part[rank] = s
        for rank in range(CL):
            cc = rank * RPB + np.arange(RPB)
            s = np.zeros(RPB, dtype=np.float32)
            for r in range(CL):
                s = _f32(s + part[r, cc])
            for cr, sr in zip(c0 + cc, s):
                if cr < tc:
                    out[cr] = _f32(sr * m[cr])
                    stores[cr] += 1
    return out, seen, stores


def _lr_lanes(plan):
    """(q, rows (T, TI), columns (T, TJ)) of each thread of a k_lr block,
    within its output tile."""
    bm, bn, _ = plan["tile"]
    S, (ti, tj) = plan["split"], plan["lane"]
    t = np.arange(plan["threads"])
    q, g = t % S, t // S
    RY, CX = bm // ti, bn // tj
    return (q, (g // CX)[:, None] + RY * np.arange(ti),
            (g % CX)[:, None] + CX * np.arange(tj))


def _lr_emulate(ct, m, ptrs=(0, 0)):
    """k_lr in float32 as the .cu orders it (each fmaf as one rounding of
    the exact float64 product and sum). Returns (out, times each output
    was stored)."""
    (nf, tb), tc = ct.shape, m.shape[0]
    plan = spike.lr_plan(nf, tc, tb, ptrs)
    (gx, gy), (bm, bn, bk) = plan["grid"], plan["tile"]
    S, (ti, tj) = plan["split"], plan["lane"]
    q, rows, cols = _lr_lanes(plan)
    nk = -(-tb // bk)
    A = np.zeros((gy * bm, nk * bk))
    A[:nf, :tb] = ct
    B = np.zeros((gx * bn, nk * bk))
    B[:tc, :tb] = m
    by, bx = np.divmod(np.arange(gx * gy), gx)
    R = by[:, None, None] * bm + rows[None]                   # (nb, T, TI)
    C = bx[:, None, None] * bn + cols[None]                   # (nb, T, TJ)
    acc = np.zeros(R.shape + (tj,), dtype=np.float32)
    for kt in range(nk):
        for kk in range(0, bk, 4 * S):
            for e in range(4):
                b = kt * bk + kk + 4 * q + e                 # (T,)
                a = A[R, b[None, :, None]]
                v = B[C, b[None, :, None]]
                acc = _f32(acc + a[..., None] * v[..., None, :])
    acc = acc.reshape(acc.shape[0], acc.shape[1], ti * tj)
    t = np.arange(plan["threads"])
    step, start = 1, np.zeros_like(q)
    while step < S:
        h = acc.shape[2] // 2
        up = (q & step) != 0
        send = np.where(up[None, :, None], acc[:, :, :h], acc[:, :, h:])
        keep = np.where(up[None, :, None], acc[:, :, h:], acc[:, :, :h])
        acc = _f32(keep + send[:, t ^ step])
        start = start + np.where(up, h, 0)
        step *= 2
    out = np.full((nf, tc), np.nan, dtype=np.float32)
    stores = np.zeros((nf, tc), dtype=int)
    for e in range(acc.shape[2]):
        idx = start + e
        r = R[:, t, idx // tj]
        c = C[:, t, idx % tj]
        ok = (r < nf) & (c < tc)
        out[r[ok], c[ok]] = acc[:, :, e][ok]
        np.add.at(stores, (r[ok], c[ok]), 1)
    return out, stores


@pytest.mark.parametrize("nf,tc,tb", VT_LR_SIZES)
def test_vt_emulation_sums_every_row_once_and_stores_every_output_once(
        nf, tc, tb):
    ps = spike.mk((nf, tc), 1, device="cpu").numpy()
    m = spike.mk((tc, tb), 2, device="cpu").numpy()
    out, seen, stores = _vt_emulate(ps, m)
    assert (seen == 1).all() and (stores == 1).all()
    ref = spike.run_vt_plain(torch.as_tensor(ps).double(),
                             torch.as_tensor(m).double()).numpy()
    assert _relerr(out, ref) <= 1e-6


@pytest.mark.parametrize("nf,tc,tb", VT_LR_SIZES)
def test_lr_emulation_stores_every_output_once_against_float64(nf, tc, tb):
    ct = spike.mk((nf, tb), 1, device="cpu").numpy()
    m = spike.mk((tc, tb), 2, device="cpu").numpy()
    out, stores = _lr_emulate(ct, m)
    assert (stores == 1).all()
    ref = spike.run_lr_plain(torch.as_tensor(ct).double(),
                             torch.as_tensor(m).double()).numpy()
    assert _relerr(out, ref) <= 1e-6


@pytest.mark.parametrize("ptrs", [(4, 0, 0), (0, 0, 8)])
def test_vt_emulation_with_4_byte_loads(ptrs):
    """Unaligned operands take one column a load: the same sums."""
    ps = spike.mk((96, 200), 1, device="cpu").numpy()
    m = spike.mk((200, 100), 2, device="cpu").numpy()
    assert spike.vt_plan(96, 200, 100, ptrs)["chunk"] == 4
    out, seen, stores = _vt_emulate(ps, m, ptrs)
    assert (seen == 1).all() and (stores == 1).all()
    assert _relerr(out, ps.astype(np.float64).sum(0)[:, None] * m) <= 1e-6


@pytest.mark.parametrize("name", ["k_vt", "k_lr"])
def test_emulation_matches_jax_interpret(jax_spike, name):
    """The kernels' summation orders against the TPU bodies, run by
    pl.pallas_call in interpret mode as test_plain_matches_jax_interpret
    runs them."""
    args = spike.make_args(name, NF, TC, TB, G, device="cpu", seed=3,
                           distinct=True)
    outs, scratch = JAX_CALLS[name]
    ref = _pallas(getattr(jax_spike, name),
                  [jnp.asarray(t.numpy()) for t in args], outs, scratch)
    emulate = _vt_emulate if name == "k_vt" else _lr_emulate
    got = emulate(*(t.numpy() for t in args))[0]
    assert got.shape == outs[0]
    assert _relerr(got, ref) <= 1e-5


@pytest.mark.parametrize("nf,tc,tb", VT_LR_SIZES)
def test_lr_lanes_split_b_once_and_own_each_output(nf, tc, tb):
    """Each output of a k_lr tile belongs to LR_SPLIT lanes with distinct
    q, and their b sequences (4 q + 4 LR_SPLIT s + e, e < 4) cover every
    b of every slice exactly once."""
    plan = spike.lr_plan(nf, tc, tb)
    (bm, bn, bk), S = plan["tile"], plan["split"]
    q, rows, cols = _lr_lanes(plan)
    assert rows.max() < bm and cols.max() < bn
    owners = np.zeros((bm, bn, S), dtype=int)
    for t in range(plan["threads"]):
        owners[np.ix_(rows[t], cols[t], [q[t]])] += 1
    assert (owners == 1).all()
    b = np.array([kk + 4 * qq + e for qq in range(S)
                  for kk in range(0, bk, 4 * S) for e in range(4)])
    assert np.array_equal(np.sort(b), np.arange(bk))


@pytest.mark.parametrize("name", ["k_vt", "k_lr"])
def test_vt_lr_grids_at_the_spike_shape(name):
    """The grids measured fastest on the card (scripts/vt_lr_variants.py):
    k_vt 16 clusters of 4 blocks (clusters of 8, 128 blocks, were
    slower), k_lr 256 blocks of 128 threads, two an SM (128 blocks, a
    split of 4 over 64 x 32 tiles, were slower)."""
    NFs, TCs, TBs = spike.NF, spike.TC, spike.TB
    if name == "k_vt":
        plan = spike.vt_plan(NFs, TCs, TBs)
        assert plan["grid"] == (64,) and plan["cluster"] == 4
        assert plan["grid"][0] % plan["cluster"] == 0
    else:
        plan = spike.lr_plan(NFs, TCs, TBs)
        assert np.prod(plan["grid"]) == 256 and plan["threads"] == 128
        assert 2 * plan["smem"] <= 232448
    assert plan["chunk"] == 16


@pytest.mark.parametrize("nf,tc,tb", VT_LR_SIZES + [(1, 1 << 20, 1),
                                                    (7, 9, 6144)])
def test_vt_lr_shared_memory_fits(nf, tc, tb):
    """At most 227 KB (232,448 bytes) a block whatever the sizes; the
    cluster's grid is always a multiple of its size."""
    vt, lr = spike.vt_plan(nf, tc, tb), spike.lr_plan(nf, tc, tb)
    assert vt["smem"] <= 48 * 1024 and lr["smem"] <= 232448
    assert vt["grid"][0] % vt["cluster"] == 0
    assert vt["grid"][0] // vt["cluster"] * vt["group"] >= tc


@pytest.mark.parametrize("nf,tc,tb,ptrs,chunk", [
    (96, 200, 100, (0, 0, 0), 16),
    (96, 203, 100, (0, 0, 0), 4),              # TC % 4 != 0
    (96, 200, 101, (0, 0, 0), 4),              # TB % 4 != 0
    (97, 200, 100, (0, 0, 0), 16),             # NF need not be
    (96, 200, 100, (4, 0, 0), 4),              # ps not 16-byte aligned
    (96, 200, 100, (0, 8, 0), 4),              # m
    (96, 200, 100, (0, 0, 12), 4),             # out
    (96, 200, 100, (32, 48, 64), 16),
])
def test_vt_16_byte_loads_only_when_rows_and_pointers_align(
        nf, tc, tb, ptrs, chunk):
    assert spike.vt_plan(nf, tc, tb, ptrs)["chunk"] == chunk


@pytest.mark.parametrize("nf,tc,tb,ptrs,chunk", [
    (96, 200, 100, (0, 0), 16),
    (97, 203, 100, (0, 0), 16),                # only TB's rows are copied
    (96, 200, 101, (0, 0), 4),                 # TB % 4 != 0
    (96, 200, 100, (4, 0), 4),                 # ct not 16-byte aligned
    (96, 200, 100, (0, 8), 4),                 # m
    (96, 200, 100, (32, 48), 16),
])
def test_lr_16_byte_chunks_only_when_rows_and_pointers_align(
        nf, tc, tb, ptrs, chunk):
    assert spike.lr_plan(nf, tc, tb, ptrs)["chunk"] == chunk


def _constants(text, prefix):
    return {k: int(v) for k, v in re.findall(rf"({prefix}_\w+) = (\d+)",
                                             text)}


@pytest.mark.parametrize("name,variant", [
    (name, v) for name, edits in vt_lr_variants.EDITS.items()
    for v in edits])
def test_vt_lr_variants_edit_the_kernel_source(name, variant):
    """Each design alternative of scripts/vt_lr_variants.py is a text edit
    of csrc/mosaic_spike.cu that finds its text exactly once; an edit of
    the constants keeps the kernel's static_asserts true."""
    src = open(os.path.join(REPO, "bayeslim_tpu_torch", "csrc",
                            "mosaic_spike.cu")).read()
    for old, new in vt_lr_variants.EDITS[name][variant]:
        assert src.count(old) == 1 and old != new
        k = _constants(new, "LR")
        if k:
            ry, cx = k["LR_BM"] // k["LR_TI"], k["LR_BN"] // k["LR_TJ"]
            assert ry * cx * k["LR_S"] == 128
            assert k["LR_BK"] % (4 * k["LR_S"]) == 0
            assert k["LR_TI"] * k["LR_TJ"] % k["LR_S"] == 0
        k = _constants(new, "VT")
        if k:
            assert k["VT_GC"] % k["VT_CL"] == 0 and k["VT_CL"] <= 16


# ---- k_bd and k_fwd: host emulations of the kernels' arithmetic and
# order, through the index formulas of csrc/mosaic_spike.cu (sgemm_ring's
# epilogue with SCALE; k_fwd, fw_seed) under bd_plan / fwd_plan

BD_FWD_SIZES = [(1024, 256, 256), (96, 200, 100), (104, 203, 101),
                (97, 203, 101), (NF, TC, TB)]


def _fma(a, b, c):
    """fmaf on float32 values: a * b is exact in float64, the sum rounds
    once to float32 (its float64 rounding first is below 2^-29 of it)."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


def _bd_emulate(ps, m, G, ptrs=(0, 0)):
    """k_bd in float32 as the .cu orders it: one fmaf chain over c = 0 ..
    TC - 1 an output (zero-filled c add exact zeros), then the epilogue's
    scale 1 + (r mod G), one product, as the output is stored. Returns
    (out, times each output was stored, times it was scaled)."""
    (nf, tc), tb = ps.shape, m.shape[1]
    assert spike.bd_plan(nf, tc, tb, ptrs) == spike.sgemm_plan(
        False, nf, tb, tc, ptrs)
    acc = np.zeros((nf, tb), dtype=np.float32)
    for k in range(tc):
        acc = _fma(ps[:, k:k + 1], m[k:k + 1], acc)
    r, c = _sgemm_cells(False, nf, tb, tc)
    out = np.full((nf, tb), np.nan, dtype=np.float32)
    stores = np.zeros((nf, tb), dtype=int)
    scaled = np.zeros((nf, tb), dtype=int)
    scale = _f32(1 + r % G)
    out[r, c] = _f32(scale * acc[r, c])
    np.add.at(stores, (r, c), 1)
    np.add.at(scaled, (r, c), 1)
    return out, stores, scaled


@pytest.mark.parametrize("nf,tc,tb,g", [
    size + (g,) for size in BD_FWD_SIZES for g in (1, 8) if size[0] % g == 0])
def test_bd_emulation_stores_and_scales_every_output_once(nf, tc, tb, g):
    ps = spike.mk((nf, tc), 1, device="cpu").numpy()
    m = spike.mk((tc, tb), 2, device="cpu").numpy()
    out, stores, scaled = _bd_emulate(ps, m, g)
    assert (stores == 1).all() and (scaled == 1).all()
    ref = spike.run_bd_plain(torch.as_tensor(ps).double(),
                             torch.as_tensor(m).double(), g).numpy()
    assert _relerr(out, ref) <= 1e-6


@pytest.mark.parametrize("ptrs", [(4, 0), (0, 8)])
def test_bd_emulation_with_4_byte_chunks(ptrs):
    """Unaligned operands take 4-byte chunks: the same order, the same
    sums."""
    ps = spike.mk((104, 200), 1, device="cpu").numpy()
    m = spike.mk((200, 100), 2, device="cpu").numpy()
    assert spike.bd_plan(104, 200, 100, ptrs)["chunk"] == 4
    out, stores, _ = _bd_emulate(ps, m, 8, ptrs)
    assert (stores == 1).all()
    np.testing.assert_array_equal(out, _bd_emulate(ps, m, 8)[0])


def test_bd_plan_is_k_nns_sgemm_at_the_spike_shape():
    """k_bd runs on k_nn's SGEMM: 128 blocks of 128 threads, 16-byte
    chunks, its M, N, K = NF, TB, TC (the launcher's argument order)."""
    plan = spike.bd_plan(1024, 200, 256)
    assert plan == spike.sgemm_plan(False, 1024, 256, 200)
    assert np.prod(spike.bd_plan(spike.NF, spike.TC, spike.TB)["grid"]) == 128


# k_fwd's constants (csrc/mosaic_spike.cu fw_seed): 2 pi in three parts
FW_P1, FW_P2, FW_P3 = _f32(6.28125), _f32(1.9353072e-3), _f32(1.0253132e-11)
FW_INV2PI = _f32(0.159154943)
# the SFU's __sincosf on [-pi, pi]: at most 2^-21.41 absolute error
SFU_ERR = 2.0 ** -21.41


def _sincos_sfu(x):
    """__sincosf(x), |x| <= pi (+ rounding), as the correctly rounded
    values each moved away from zero by the error bound."""
    s, c = np.sin(np.float64(x)), np.cos(np.float64(x))
    return _f32(s + np.sign(s) * SFU_ERR), _f32(c + np.sign(c) * SFU_ERR)


def _fw_seed(k, t):
    """fw_seed: e^{i k t} from the exact split k t = x + xe, x reduced by
    2 pi in three parts, then the SFU. Returns (cos, sin, |reduced|)."""
    x = _f32(np.float64(k) * np.float64(t))
    xe = _fma(k, t, -x)
    q = _f32(np.rint(_f32(np.float64(x) * np.float64(FW_INV2PI))))
    hi = _fma(-q, FW_P1, x)
    lo = _fma(-q, FW_P3, _fma(-q, FW_P2, xe))
    r = _f32(np.float64(hi) + np.float64(lo))
    s, c = _sincos_sfu(r)
    return c, s, np.abs(r)


def _fw_sincos(x):
    """fw_sincos in float32, step by step: x - j pi/2 in three parts,
    Cephes' polynomials on [-pi/4, pi/4], the quadrant. Returns (sin,
    cos)."""
    x = _f32(x)
    j = _f32(np.rint(_f32(np.float64(x) * np.float64(_f32(0.636619747)))))
    r = _fma(-j, _f32(1.57079625), x)
    r = _fma(-j, _f32(7.54978942e-8), r)
    r = _fma(-j, _f32(5.39030253e-15), r)
    r2 = _f32(np.float64(r) * np.float64(r))
    ps = _fma(r2, _f32(-1.95152959e-4), _f32(8.33216087e-3))
    ps = _fma(r2, ps, _f32(-1.66666546e-1))
    sr = _fma(_f32(np.float64(r) * np.float64(r2)), ps, r)
    pc = _fma(r2, _f32(2.44331571e-5), _f32(-1.38873163e-3))
    pc = _fma(r2, pc, _f32(4.16666456e-2))
    pc = _fma(r2, pc, _f32(-0.5))
    cr = _fma(r2, pc, _f32(1.0))
    q = j.astype(np.int64) & 3
    s = np.where(q & 1, cr, sr)
    c = np.where(q & 1, sr, cr)
    return (_f32(np.where(q & 2, -s, s)),
            _f32(np.where((q + 1) & 2, -c, c)))


@pytest.mark.parametrize("tmax", [1e-3, 1.0, 24.0, 1e3])
def test_fw_sincos_within_a_few_ulp(tmax):
    """The table's sin and cos (and D^CH's, at CH t up to 4 x 5.5)
    within 3e-7 absolute of float64."""
    rng = np.random.default_rng(5)
    x = _f32(np.concatenate([rng.uniform(-tmax, tmax, 20000),
                             [0.0, tmax, -tmax, np.pi / 4, 3 * np.pi / 4]]))
    s, c = _fw_sincos(x)
    assert np.abs(s - np.sin(np.float64(x))).max() <= 3e-7
    assert np.abs(c - np.cos(np.float64(x))).max() <= 3e-7


def _fw_phasors(k0, t, RT=spike.FWD_RUN, CH=spike.FWD_CHAINS):
    """The phasors e^{i k t} of rows k0 .. k0 + RT - 1 (k0 (R, 1), t
    (n,)) as the kernel forms them: the table's D and D^CH (fw_sincos),
    the seed, rows 1 .. CH - 1 by D^(2^h), rows CH .. 2 CH - 1 by D^CH,
    then CH two-term chains. Returns cos and
    sin, each (R, RT, n)."""
    t = _f32(t)
    s1, c1 = _fw_sincos(t)
    sn, cn = _fw_sincos(_f32(CH * t))
    c1, s1, cn, sn = (np.broadcast_to(v, (k0.shape[0], t.size))
                      for v in (c1, s1, cn, sn))
    pc, pw = [c1], [s1]
    h = 1
    while (1 << h) < CH:
        pc.append(_fma(pc[-1], pc[-1], -_f32(pw[-1] * pw[-1])))
        pw.append(_f32(_f32(2 * pc[-2]) * pw[-1]))
        h += 1
    ec, es = [None] * (2 * CH), [None] * (2 * CH)
    ec[0], es[0], _ = _fw_seed(_f32(np.broadcast_to(k0, (k0.shape[0], t.size))),
                               np.broadcast_to(t, (k0.shape[0], t.size)))
    for g in range(1, CH):
        h = g.bit_length() - 1
        f = g - (1 << h)
        ec[g] = _fma(ec[f], pc[h], -_f32(es[f] * pw[h]))
        es[g] = _fma(es[f], pc[h], _f32(ec[f] * pw[h]))
    for g in range(CH):
        ec[CH + g] = _fma(ec[g], cn, -_f32(es[g] * sn))
        es[CH + g] = _fma(es[g], cn, _f32(ec[g] * sn))
    w = _f32(2 * cn)
    rows_c, rows_s = list(ec[:CH]), list(es[:CH])
    for j in range(1, RT // CH):
        if j >= 2:
            for g in range(CH):
                nc = _fma(w, ec[CH + g], -ec[g])
                ns = _fma(w, es[CH + g], -es[g])
                ec[g], es[g] = ec[CH + g], es[CH + g]
                ec[CH + g], es[CH + g] = nc, ns
        rows_c += ec[CH:]
        rows_s += es[CH:]
    return np.stack(rows_c, 1), np.stack(rows_s, 1)


def _fwd_emulate(tau, ps):
    """k_fwd in float32 as the .cu orders it, under fwd_plan: each
    slice's partial sums (one fmaf chain a row and column over its c in
    order), then the slices added in order (the sum kernel). Returns
    (re, im)."""
    (nf, tc), tb = ps.shape, tau.shape[1]
    plan = spike.fwd_plan(nf, tc, tb)
    RT, S, cslice = plan["run"], plan["grid"][2], plan["cslice"]
    nruns = -(-nf // RT)
    k0 = (RT * np.arange(nruns, dtype=np.float32))[:, None]
    psp = np.zeros((nruns * RT, tc), dtype=np.float32)
    psp[:nf] = ps
    psp = psp.reshape(nruns, RT, tc)
    out = None
    for z in range(S):
        acc = np.zeros((2, nruns, RT, tb), dtype=np.float32)
        for c in range(z * cslice, min(tc, (z + 1) * cslice)):
            ec, es = _fw_phasors(k0, tau[c])
            p = psp[:, :, c, None]
            acc[0] = _fma(p, ec, acc[0])
            acc[1] = _fma(p, es, acc[1])
        out = acc if out is None else _f32(out + acc)
    out = out.reshape(2, nruns * RT, tb)[:, :nf]
    return out[0], out[1]


@pytest.mark.parametrize("nf,tc,tb", BD_FWD_SIZES)
def test_fwd_emulation_against_float64(nf, tc, tb):
    """The kernel's whole sum, seeds, chains and slices, within 1e-4 of
    float64 (the card's bar); its worst here is ~1e-6."""
    tau = spike.mk((tc, tb), 1, device="cpu").numpy()
    ps = spike.mk((nf, tc), 2, device="cpu").numpy()
    re, im = _fwd_emulate(tau, ps)
    rre, rim = (x.numpy() for x in spike.run_fwd_plain(
        torch.as_tensor(tau).double(), torch.as_tensor(ps).double(), 1))
    scale = max(np.abs(rre).max(), np.abs(rim).max())
    err = max(np.abs(re - rre).max(), np.abs(im - rim).max()) / scale
    assert err <= 2e-6


@pytest.mark.parametrize("tmax", [1e-3, 1.0, 5.5])
def test_fwd_phasors_worst_error(tmax):
    """Every row's phasor e^{i k t} against float64 for k up to 1023 and
    t up to the edges of N(0, 1) (|t| = 5.5: k t reaches 5,600 rad):
    within 4e-6 absolute (the SFU seed at its error bound ~4e-7, the
    reduction's roundings ~2e-7, the fill's products and 6 chain steps
    the rest), and the reduced argument of every seed within pi + 1e-5."""
    rng = np.random.default_rng(7)
    t = _f32(np.concatenate([rng.uniform(-tmax, tmax, 509), [tmax, -tmax, 0]]))
    k0 = (32 * np.arange(32, dtype=np.float32))[:, None]
    ec, es = _fw_phasors(k0, t)
    k = (k0[:, :, None] + np.arange(32)[None, :, None]).astype(np.float64)
    ph = k * np.float64(t)[None, None]
    err = max(np.abs(ec - np.cos(ph)).max(), np.abs(es - np.sin(ph)).max())
    assert err <= 4e-6
    _, _, red = _fw_seed(_f32(np.broadcast_to(k0, (32, t.size))),
                         np.broadcast_to(t, (32, t.size)))
    assert red.max() <= np.pi + 1e-5


def test_fwd_seed_reduction_first_step_is_exact():
    """x - q FW_P1 is exact (FW_P1 has 8 significant bits, |q| < 2^16,
    and Sterbenz), so only the small parts round."""
    assert float(FW_P1) * 32 == 201 and float(FW_P1) + float(FW_P2) + float(
        FW_P3) == pytest.approx(2 * np.pi, abs=1e-15)
    rng = np.random.default_rng(3)
    x = _f32(rng.uniform(-4e5, 4e5, 10000))
    q = _f32(np.rint(_f32(np.float64(x) * np.float64(FW_INV2PI))))
    exact = np.float64(x) - np.float64(q) * np.float64(FW_P1)
    np.testing.assert_array_equal(_fma(-q, FW_P1, x), exact)


def test_fwd_plan_fills_whole_waves():
    """The spike's shape: 32 output tiles in 8 slices of one c tile (256
    blocks, one wave at two an SM); hera-stat's forward
    shape: 80 tiles in 3 slices (240 blocks, one wave: 4 slices would
    leave a second wave of 56)."""
    assert spike.fwd_plan(1024, 256, 256)["grid"] == (8, 4, 8)
    assert spike.fwd_plan(1024, 6144, 630)["grid"] == (20, 4, 3)
    for size in [(1024, 256, 256), (1024, 6144, 630), (97, 203, 101)]:
        plan = spike.fwd_plan(*size)
        assert 2 * plan["smem"] <= 233472 and plan["threads"] == 256


@pytest.mark.parametrize("name", ["k_bd", "k_fwd"])
def test_bd_fwd_emulation_matches_jax_interpret(jax_spike, name):
    """k_bd's and k_fwd's arithmetic against the TPU bodies, run by
    pl.pallas_call in interpret mode (G = 4 chains in the JAX body; the
    kernel's own chains are the same function)."""
    args = spike.make_args(name, NF, TC, TB, G, device="cpu", seed=3,
                           distinct=True)
    tensors = [a.numpy() for a in args if isinstance(a, torch.Tensor)]
    outs, scratch = JAX_CALLS[name]
    ref = _pallas(getattr(jax_spike, name),
                  [jnp.asarray(t) for t in tensors], outs, scratch)
    if name == "k_bd":
        got, ref = [_bd_emulate(*tensors, G)[0]], [ref]
    else:
        got = _fwd_emulate(*tensors)
    for g, r, shape in zip(got, ref, outs):
        assert g.shape == shape
        assert _relerr(g, r) <= 1e-5


@pytest.mark.parametrize("name,variant", [
    (name, v) for name, edits in bd_fwd_variants.EDITS.items()
    for v in edits])
def test_bd_fwd_variants_edit_the_kernel_source(name, variant):
    """Each design alternative of scripts/bd_fwd_variants.py is a text
    edit of csrc/mosaic_spike.cu that finds its text exactly once and
    changes it."""
    src = open(os.path.join(REPO, "bayeslim_tpu_torch", "csrc",
                            "mosaic_spike.cu")).read()
    for old, new in bd_fwd_variants.EDITS[name][variant]:
        assert src.count(old) == 1 and old != new
        k = _constants(new, "FW")
        if k:
            assert k["FW_RT"] % k["FW_CH"] == 0 and k["FW_RT"] >= 2 * k["FW_CH"]


# ---- k_rot: A_NF m (rho m)^NF by a float-float power (csrc/mosaic_spike.cu)

def _fmul(a, b):
    """__fmul_rn: the float32 product, exact in float64, rounded once."""
    return _f32(np.float64(a) * np.float64(b))


def _fadd(a, b):
    """__fadd_rn on the pair arithmetic's operands (their exponents are a
    few apart, so the float64 sum is exact and rounds once)."""
    return _f32(np.float64(a) + np.float64(b))


def _ff_mul1(a, b):
    """ff_mul1: the pair a times the float32 b."""
    t = _fmul(a[1], b)
    h = _fma(a[0], b, t)
    return h, _fadd(_fma(a[0], b, -h), t)


def _ff_mul(a, b):
    """ff_mul: the pair a times the pair b (a.l b.l dropped)."""
    t = _fma(a[0], b[1], _fmul(a[1], b[0]))
    h = _fma(a[0], b[0], t)
    return h, _fadd(_fma(a[0], b[0], -h), t)


def _ff_sqr(a):
    """ff_sqr: the pair a squared."""
    t = _fmul(a[0], _fadd(a[1], a[1]))
    h = _fma(a[0], a[0], t)
    return h, _fadd(_fma(a[0], a[0], -h), t)


def _rot_emulate(m, nf):
    """k_rot in float32, step by step as rot_pow: r = A_NF m and b = rho
    m as pairs, then for each bit of NF above the highest a product into
    r (bit set) and a squaring of b, and last r times b, of which only
    the rounded h is kept (NF = 0: r's h)."""
    ah, al, rh, rl = (np.float32(c) for c in spike.rot_consts(nf))
    m = _f32(m)
    r, b = _ff_mul1((ah, al), m), _ff_mul1((rh, rl), m)
    k = nf
    while k > 1:
        if k & 1:
            r = _ff_mul(r, b)
        b = _ff_sqr(b)
        k >>= 1
    return _fma(r[0], b[0], _fma(r[0], b[1], _fmul(r[1], b[0]))) if k else r[0]


ROT_NF = [0, 1, 2, 3, 7, 32, 1023, 1024, 4096, 16384]


@pytest.mark.parametrize("tc,tb", [(256, 256), (200, 100), (203, 101)])
@pytest.mark.parametrize("nf", ROT_NF)
def test_rot_emulation_against_float64(nf, tc, tb):
    """The kernel's float-float power within 1e-6 of the float64 loop on
    unit_m's inputs at every NF (its worst is the final float32
    rounding, ~5e-8; the first design's float32 loop: 4.8e-5 at 1024,
    2.2e-4 at 4096)."""
    m = spike.unit_m((tc, tb), 2, device="cpu")
    ref = spike.run_rot_plain(m.double(), nf).numpy()
    got = _rot_emulate(m.numpy(), nf)
    assert got.dtype == np.float32 and got.shape == (tc, tb)
    assert _relerr(got, ref) <= 1e-6


@pytest.mark.parametrize("unit", [False, True])
def test_rot_emulation_matches_jax_interpret(jax_spike, unit):
    """The kernel's arithmetic against the TPU body's float32 loop, run
    by pl.pallas_call in interpret mode at the test sizes (NF = 32), on
    mk's and on unit_m's inputs."""
    m, nf = spike.make_args("k_rot", NF, TC, TB, G, device="cpu", seed=3,
                            unit_rot=unit)
    ref = _pallas(jax_spike.k_rot, [jnp.asarray(m.numpy())], [(TC, TB)])
    assert nf == NF and np.isfinite(np.asarray(ref)).all()
    assert _relerr(_rot_emulate(m.numpy(), NF), ref) <= 1e-5


@pytest.mark.parametrize("nf", ROT_NF + [2 ** 31 - 1])
def test_rot_consts_split_their_float64_values(nf):
    """A_NF and rho as float32 pairs: hi is float32(x), |lo| within half
    an ulp of hi, hi + lo within 1e-14 of x."""
    theta = np.arctan2(0.1, 0.9)
    want = (1.5 * np.cos(nf * theta) + 0.5 * np.sin(nf * theta),
            np.sqrt(0.82))
    c = spike.rot_consts(nf)
    for (hi, lo), x in zip((c[:2], c[2:]), want):
        assert hi == float(np.float32(x)) and lo == float(np.float32(lo))
        assert abs(lo) <= abs(np.spacing(np.float32(hi))) / 2
        assert abs(hi + lo - x) <= 1e-14 * abs(x)


def test_rot_takes_nf_below_2_to_the_31():
    m = spike.unit_m((TC, TB), 0, device="cpu")
    for nf in (-1, 2 ** 31):
        with pytest.raises(ValueError, match="NF"):
            spike.run_rot(m, nf)


@pytest.mark.parametrize("variant", list(rot_variants.EDITS))
def test_rot_variants_edit_the_kernel_source(variant):
    """Each design alternative of scripts/rot_variants.py is a text edit
    of csrc/mosaic_spike.cu that finds its text exactly once and
    changes it."""
    src = open(os.path.join(REPO, "bayeslim_tpu_torch", "csrc",
                            "mosaic_spike.cu")).read()
    for old, new in rot_variants.EDITS[variant]:
        assert src.count(old) == 1 and old != new
