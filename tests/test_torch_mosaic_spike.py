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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bayeslim_tpu_torch.scripts import mosaic_spike as spike
from bayeslim_tpu_torch.scripts import sgemm_variants

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
                                      (96, 200, 100), (32, 16, 24)])
def test_fwd_slices_cover_the_c_axis(nf, tc, tb):
    cslice = spike._fwd_slice(nf, tc, tb)
    nslices = -(-tc // cslice)
    assert cslice % 32 == 0 and cslice * nslices >= tc
    assert cslice * (nslices - 1) < tc          # no empty slice


def _owners(nt, M, N, K):
    """How many (block, thread) pairs store each output of the SGEMM of
    k_nn / k_nt under sgemm_plan's launch, by the .cu's mapping: thread
    t owns rows ty + TY i and columns tx + TX j (k_nt) or 4 tx + j
    (k_nn), tx = t % TX, ty = t // TX, i, j < 4, TX = BN / 4, TY = BM /
    4, stores masked at (M, N)."""
    plan = spike.sgemm_plan(nt, M, N, K)
    (gx, gy), (bm, bn, _) = plan["grid"], plan["tile"]
    TX, TY = bn // 4, bm // 4
    t = np.arange(plan["threads"])
    assert len(t) == TX * TY
    tx, ty = t % TX, t // TX
    rows = (ty[:, None] + TY * np.arange(4)[None]).repeat(4, 1)   # (T, 16)
    cols = (tx[:, None] + TX * np.arange(4)[None] if nt
            else 4 * tx[:, None] + np.arange(4)[None])
    cols = np.tile(cols, (1, 4))
    assert rows.max() < bm and cols.max() < bn
    count = np.zeros((M, N), dtype=int)
    for by in range(gy):
        for bx in range(gx):
            r, c = by * bm + rows.ravel(), bx * bn + cols.ravel()
            keep = (r < M) & (c < N)
            np.add.at(count, (r[keep], c[keep]), 1)
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
