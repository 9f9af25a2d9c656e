"""
Contraction and phasor-rotation microbenchmarks on the card: the seven
spikes from which the RIME kernel was designed, as hand-written Hopper
kernels (``csrc/mosaic_spike.cu``), each timed beside its bound.

    python -m bayeslim_tpu_torch.scripts.mosaic_spike

Counterpart of scripts/mosaic_spike.py. Each ``run_*`` computes the
function of the TPU kernel of the same name (float32 in, float32 out),
with sizes taken from its arguments (ps (NF, TC), ct (NF, TB), m and
tau (TC, TB)):

- ``run_nn(ps, m)``    out[j, b] = sum_c ps[j, c] m[c, b]          (k_nn)
- ``run_nt(ct, m)``    out[j, c] = sum_b ct[j, b] m[c, b]          (k_nt)
- ``run_vt(ps, m)``    out[c, b] = m[c, b] sum_j ps[j, c]          (k_vt)
- ``run_lr(ct, m)``    as run_nt, the sum over b split over lanes  (k_lr)
- ``run_bd(ps, m, G)`` out[j, b] = (1 + j mod G) (ps @ m)[j, b]    (k_bd)
- ``run_rot(m, NF)``   NF rotations (c, s) <- (c cd - s sd, s cd + c sd)
  from (m, m/2), cd = 0.9 m, sd = 0.1 m; out = c + s; the kernel
  computes it as A_NF m (rho m)^NF by a float-float power, its
  constants from ``rot_consts(NF)``                                (k_rot)
- ``run_fwd(tau, ps, G)`` (out_re, out_im)[k, b] = sum_c ps[k, c]
  (cos, sin)(k tau[c, b]), tau in radians; the plain version takes
  the phases from G chains that start at g tau and advance by G tau,
  the kernel from its own runs and chains                         (k_fwd)

A CUDA tensor launches the kernel and a CPU tensor runs the plain
version ``run_*_plain``; there is no fallback from one to the other.
Any dtype other than float32 raises, and so does NF % G != 0 (where the
TPU loop would drop the last rows). ``launches`` counts each kernel's
launches. ``sgemm_plan`` gives the launch of k_nn's and k_nt's
ring-buffered SGEMM (grid, tile, cp.async chunk, shared memory),
``bd_plan`` k_bd's (the same SGEMM), ``vt_plan``, ``lr_plan`` and
``fwd_plan`` those of k_vt, k_lr and k_fwd. ``timeit`` times a kernel
with L2 warm, ``timeit_flushed`` with L2 emptied before each launch.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..ops import rime_cuda
from ..utils.dtypes import resolve_device

__all__ = ["TC", "TB", "G", "NF", "SPIKES", "launches", "mk", "unit_m",
           "timeit", "timeit_flushed", "rot_consts", "run_nn", "run_nt",
           "run_vt", "run_lr", "run_bd", "run_rot", "run_fwd",
           "run_nn_plain", "run_nt_plain", "run_vt_plain", "run_lr_plain",
           "run_bd_plain", "run_rot_plain",
           "run_fwd_plain", "RUN", "PLAIN", "LIBRARY", "make_args",
           "compare", "work", "loop_flops", "bound_ms", "FWD_G", "main",
           "sgemm_plan", "card_sgemm_plan", "bd_plan", "card_bd_plan",
           "vt_plan", "card_vt_plan", "lr_plan", "card_lr_plan", "fwd_plan",
           "card_fwd_plan"]

TC, TB, G, NF = 256, 256, 8, 1024

# (kernel, the line label of scripts/mosaic_spike.py), in its order
SPIKES = (
    ("k_rot", "rotation only (6 ops/elt VPU floor)"),
    ("k_nn", "NN matvec (1,TC)@(TC,TB) per k"),
    ("k_nt", "NT dot (1,TB)x(TC,TB) lanes per k"),
    ("k_vt", "reshape (1,TC)->(TC,1) + FMA per k"),
    ("k_lr", "bcast mul + lane-reduce per k"),
    ("k_bd", "G-batch blockdiag dot per G freqs"),
    ("k_fwd", "candidate fwd loop (rot+2 bd-dots)"),
)

# launches of each CUDA kernel (incremented once per launch, nowhere else)
launches = dict.fromkeys((name for name, _ in SPIKES), 0)

# the chain counts G of the plain version that k_fwd's kernel is held
# against (the kernel runs its own FWD_CHAINS chains whatever G is)
FWD_G = (1, 2, 4, 8, 16, 32)
# k_fwd: a block owns FWD_TILE = (rows, columns) of the output, a thread
# one column and FWD_RUN rows in FWD_CHAINS chains; c in tiles of FWD_TK,
# split into at most FWD_SLICES slices, chosen to fill whole waves of
# FWD_WAVE blocks (two an SM on 132 SMs)
FWD_TILE, FWD_RUN, FWD_CHAINS, FWD_TK = (256, 32), 32, 4, 32
FWD_SLICES, FWD_WAVE = 8, 264
# the SGEMM of k_nn and k_nt (csrc/mosaic_spike.cu): output tile (rows,
# columns), k a slice, slices in the shared-memory ring; a thread owns
# 4 x 4 outputs
SG_TILE, SG_BK, SG_STAGES = (64, 32), 64, 2
# k_vt: a cluster of VT_CLUSTER blocks of VT_THREADS threads sums
# VT_GROUP columns of ps
VT_GROUP, VT_CLUSTER, VT_THREADS = 16, 4, 256
# k_lr: output tile (rows j, columns c) of 128 threads, b a slice, slices
# in the ring; each output split over LR_SPLIT lanes, each of which owns
# LR_LANE = (rows, columns) partial sums
LR_TILE, LR_BK, LR_STAGES, LR_SPLIT, LR_LANE = (32, 32), 64, 2, 8, (8, 8)
_SRC = "mosaic_spike.cu"
# argument types of csrc/mosaic_spike.cu's C launchers
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "k_nn": [_P, _P, _P, _I, _I, _I, _P],
    "k_nt": [_P, _P, _P, _I, _I, _I, _P],
    "k_vt": [_P, _P, _P, _I, _I, _I, _P],
    "k_lr": [_P, _P, _P, _I, _I, _I, _P],
    "k_bd": [_P, _P, _P, _I, _I, _I, _I, _P],
    "k_rot": [_P, _P, _I, _I, _F, _F, _F, _F, _P],
    "k_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def mk(shape, seed=0, device=None):
    """N(0, 1) float32 from numpy's default_rng(seed), as the JAX
    script's mk."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=resolve_device(device))


def unit_m(shape, seed=0, device=None):
    """Inputs of run_rot whose chains stay near unit modulus:
    m = +-(1 + 1e-3 u) / sqrt(0.82), u ~ U(-1, 1), so |D| = 0.9055 |m|
    is within 1e-3 of 1 and |D|^1024 within e^(+-1). (On mk's N(0, 1)
    inputs the chain overflows past |m| ~ 1.104; those time only.)"""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    m = sign * (1 + 1e-3 * rng.uniform(-1, 1, shape)) / np.sqrt(0.82)
    return torch.as_tensor(m, dtype=torch.float32,
                           device=resolve_device(device))


def _graph_ms(body, n):
    """ms of n back-to-back calls of body() on the card's clock: after
    one warm-up call, the n calls are captured in one CUDA graph, which
    is replayed once to load it and once more between two CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            body()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def timeit(f, *args, n=400):
    """Mean ms per call of n back-to-back calls of f(*args) in one CUDA
    graph (_graph_ms). The host's launch time is thus left out, as the
    JAX script's timeit leaves it out by running its n calls in one
    compiled scan. Inputs that fit in the 50 MB L2 stay there from one
    call to the next."""
    return _graph_ms(lambda: f(*args), n) / n


def timeit_flushed(f, *args, n=20, flush_mb=100):
    """Mean ms per call of f(*args) with the L2 emptied before each call:
    n pairs (a sum over flush_mb MB, then f) in one CUDA graph, less n
    sums alone in another. A read, not a write, empties it, so no dirty
    lines of the flush are written back during f."""
    buf = torch.ones(flush_mb * 2 ** 18, device=torch.cuda.current_device())
    pair = _graph_ms(lambda: (buf.sum(), f(*args)), n)
    return (pair - _graph_ms(buf.sum, n)) / n


def _operands(name, *ts):
    """Check the tensors a wrapper takes; True if they lie on the card."""
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} takes 2-d tensors, got shape "
                             f"{tuple(t.shape)}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {t.numel()} elements exceed the "
                             f"kernels' 32-bit sizes")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: tensors on different devices")
    return ts[0].is_cuda


def _same(name, a, b, what):
    if a != b:
        raise ValueError(f"{name}: {what} differ ({a} != {b})")


def _rows(name, NF, G):
    if G < 1 or NF % G:
        raise ValueError(f"{name}: NF={NF} is not a multiple of G={G}")


def _launch(name, dev, *args):
    """Launch csrc/mosaic_spike.cu's ``{name}_launch`` on the current
    stream (tensors passed as pointers) and count it."""
    keep = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args]
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor)
            else a if isinstance(a, float) else int(a) for a in keep]
    rc = rime_cuda._lib(_SRC, f"{name}_launch", _ARGTYPES[name])(
        *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def sgemm_plan(nt, M, N, K, ptrs=(0, 0)):
    """The launch of csrc/mosaic_spike.cu's ring-buffered SGEMM for C
    (M, N) = A (M, K) B: k_nn (nt False, B (K, N)) or k_nt (nt True, B
    (N, K)), A and B at the addresses ptrs. Returns {"grid": (gx, gy),
    "threads", "tile": (BM, BN, BK), "chunk": bytes a cp.async (16 when
    K, for k_nn also N, is a multiple of 4 and both addresses are
    16-byte aligned, else 4), "smem": dynamic shared memory in bytes}.
    Mirrors the .cu's sgemm_plan_of, which the launcher follows."""
    bm, bn = SG_TILE
    vec = K % 4 == 0 and (nt or N % 4 == 0) and all(p % 16 == 0
                                                    for p in ptrs)
    b_words = bn * (SG_BK + 4) if nt else SG_BK * (bn + 4)
    return {"grid": (-(-N // bn), -(-M // bm)), "threads": bm * bn // 16,
            "tile": (bm, bn, SG_BK), "chunk": 16 if vec else 4,
            "smem": 4 * SG_STAGES * (bm * (SG_BK + 4) + b_words)}


def _card_plan(symbol, argtypes, *args, n=4):
    """The n ints that csrc/mosaic_spike.cu's plan export `symbol`
    (argument types argtypes, then n int pointers) writes back."""
    vals = [ctypes.c_int() for _ in range(n)]
    rime_cuda._lib(_SRC, symbol, argtypes + [ctypes.POINTER(_I)] * n)(
        *args, *(ctypes.byref(v) for v in vals))
    return [v.value for v in vals]


def card_sgemm_plan(nt, M, N, K, ptrs):
    """The launch that the C launcher of k_nn / k_nt makes, asked of the
    built library (the card's check of sgemm_plan), as sgemm_plan's
    dict without "threads" and "tile"."""
    gx, gy, chunk, smem = _card_plan("sgemm_plan", [_I, _P, _P, _I, _I, _I],
                                     int(nt), *ptrs, M, N, K)
    return {"grid": (gx, gy), "chunk": chunk, "smem": smem}


def bd_plan(NF, TC, TB, ptrs=(0, 0)):
    """The launch of k_bd for ps (NF, TC) and m (TC, TB) at the addresses
    ptrs = (ps, m): k_nn's SGEMM, sgemm_plan(False, M=NF, N=TB, K=TC)."""
    return sgemm_plan(False, NF, TB, TC, ptrs)


def card_bd_plan(NF, TC, TB, ptrs):
    """The launch that k_bd's C launcher makes (it asks sgemm_plan_of
    with nt = 0), as card_sgemm_plan's dict."""
    return card_sgemm_plan(False, NF, TB, TC, ptrs)


def vt_plan(NF, TC, TB, ptrs=(0, 0, 0)):
    """The launch of csrc/mosaic_spike.cu's k_vt for ps (NF, TC), m and
    out (TC, TB) at the addresses ptrs = (ps, m, out). Returns {"grid":
    (gx,) (a multiple of the cluster), "cluster": blocks a cluster,
    "threads", "group": columns c a cluster sums, "chunk": bytes a load
    (16 when TC and TB are multiples of 4 and all three addresses are
    16-byte aligned, else 4), "smem": dynamic shared memory in bytes}.
    Mirrors the .cu's vt_plan_of, which the launcher follows."""
    vec = TC % 4 == 0 and TB % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    return {"grid": (-(-TC // VT_GROUP) * VT_CLUSTER,),
            "cluster": VT_CLUSTER, "threads": VT_THREADS,
            "group": VT_GROUP, "chunk": 16 if vec else 4,
            "smem": 4 * (VT_THREADS // 32 + 2) * VT_GROUP}


def card_vt_plan(NF, TC, TB, ptrs):
    """The launch that k_vt's C launcher makes, asked of the built
    library, as vt_plan's dict without "threads" and "group"."""
    gx, cluster, chunk, smem = _card_plan("vt_plan", [_P, _P, _P, _I, _I, _I],
                                          *ptrs, NF, TC, TB)
    return {"grid": (gx,), "cluster": cluster, "chunk": chunk, "smem": smem}


def lr_plan(NF, TC, TB, ptrs=(0, 0)):
    """The launch of csrc/mosaic_spike.cu's k_lr for ct (NF, TB) and m
    (TC, TB) at the addresses ptrs = (ct, m). Returns {"grid": (gx, gy),
    "threads", "tile": (BM, BN, BK), "split": lanes an output, "lane":
    (rows, columns) a lane, "chunk": bytes a cp.async (16 when TB is a
    multiple of 4 and both addresses are 16-byte aligned, else 4),
    "smem": dynamic shared memory in bytes}. Mirrors the .cu's
    lr_plan_of, which the launcher follows."""
    bm, bn = LR_TILE
    vec = TB % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    ti, tj = LR_LANE
    return {"grid": (-(-TC // bn), -(-NF // bm)),
            "threads": bm * bn * LR_SPLIT // (ti * tj),
            "tile": (bm, bn, LR_BK), "split": LR_SPLIT, "lane": LR_LANE,
            "chunk": 16 if vec else 4,
            "smem": 4 * LR_STAGES * (bm + bn) * (LR_BK + 16)}


def card_lr_plan(NF, TC, TB, ptrs):
    """The launch that k_lr's C launcher makes, asked of the built
    library, as lr_plan's dict with only "grid", "chunk" and "smem"."""
    gx, gy, chunk, smem = _card_plan("lr_plan", [_P, _P, _I, _I, _I],
                                     *ptrs, NF, TB, TC)
    return {"grid": (gx, gy), "chunk": chunk, "smem": smem}


def fwd_plan(NF, TC, TB):
    """The launch of csrc/mosaic_spike.cu's k_fwd for tau (TC, TB) and ps
    (NF, TC). Returns {"grid": (gx, gy, S), "cslice": c a slice (whole
    tiles), "threads", "tile": (rows, columns) a block, "run": rows a
    thread, "chains", "smem": dynamic shared memory in bytes}. S slices
    of c (the sum kernel adds them) minimise waves / S over 1 ..
    min(FWD_SLICES, c tiles), ties to the fewer. Mirrors the .cu's
    fwd_plan_of, which the launcher follows."""
    def cdiv(a, b):
        return -(-a // b)
    (tr, tn), tk = FWD_TILE, FWD_TK
    tiles = cdiv(TB, tn) * cdiv(NF, tr)
    ntk = max(1, cdiv(TC, tk))
    best = 1
    for s in range(2, min(FWD_SLICES, ntk) + 1):
        if (cdiv(tiles * s, FWD_WAVE) * best
                < cdiv(tiles * best, FWD_WAVE) * s):
            best = s
    cslice = cdiv(ntk, best) * tk
    S = max(1, cdiv(TC, cslice))
    slot = tk * (tr + 4) + tk * tn
    return {"grid": (cdiv(TB, tn), cdiv(NF, tr), S), "cslice": cslice, "threads": tr * tn // FWD_RUN,
            "tile": FWD_TILE, "run": FWD_RUN, "chains": FWD_CHAINS,
            "smem": 4 * (2 * slot + 4 * tk * tn)}


def card_fwd_plan(NF, TC, TB):
    """The launch that k_fwd's C launcher makes, asked of the built
    library, as fwd_plan's dict with only "grid", "cslice" and "smem"."""
    gx, gy, gz, cslice, smem = _card_plan("fwd_plan", [_I, _I, _I], NF, TC,
                                          TB, n=5)
    return {"grid": (gx, gy, gz), "cslice": cslice, "smem": smem}


def _sgemm(name, a, b, nt):
    """Launch k_nn / k_nt: out (M, N) = a b or a b^T, as sgemm_plan
    says (the grid's rows must fit grid.y)."""
    a, b = a.contiguous(), b.contiguous()
    (M, K), N = a.shape, b.shape[0] if nt else b.shape[1]
    plan = sgemm_plan(nt, M, N, K, (a.data_ptr(), b.data_ptr()))
    if plan["grid"][1] > 65535:
        raise ValueError(f"{name}: {M} rows exceed the kernel's grid "
                         f"({plan['grid'][1]} row tiles > 65535)")
    out = _empty((M, N), a)
    _launch(name, a.device, a, b, out, M, K, N)
    return out


def run_nn(ps, m):
    """ps (NF, TC) @ m (TC, TB) -> (NF, TB)."""
    cuda = _operands("run_nn", ps, m)
    _same("run_nn", ps.shape[1], m.shape[0], "ps columns and m rows")
    if not cuda:
        return run_nn_plain(ps, m)
    return _sgemm("k_nn", ps, m, nt=False)


def run_nt(ct, m):
    """ct (NF, TB) @ m (TC, TB)^T -> (NF, TC), as a tiled product."""
    cuda = _operands("run_nt", ct, m)
    _same("run_nt", ct.shape[1], m.shape[1], "ct and m columns")
    if not cuda:
        return run_nt_plain(ct, m)
    return _sgemm("k_nt", ct, m, nt=True)


def run_vt(ps, m):
    """out[c, b] = m[c, b] sum_j ps[j, c] -> (TC, TB)."""
    cuda = _operands("run_vt", ps, m)
    _same("run_vt", ps.shape[1], m.shape[0], "ps columns and m rows")
    if not cuda:
        return run_vt_plain(ps, m)
    (nf, tc), tb = ps.shape, m.shape[1]
    out = _empty((tc, tb), ps)
    _launch("k_vt", ps.device, ps, m, out, nf, tc, tb)
    return out


def run_lr(ct, m):
    """As run_nt, each output's sum over b split over lanes."""
    cuda = _operands("run_lr", ct, m)
    _same("run_lr", ct.shape[1], m.shape[1], "ct and m columns")
    if not cuda:
        return run_lr_plain(ct, m)
    (nf, tb), tc = ct.shape, m.shape[0]
    out = _empty((nf, tc), ct)
    _launch("k_lr", ct.device, ct, m, out, nf, tb, tc)
    return out


def run_bd(ps, m, G):
    """(1 + j mod G) (ps @ m)[j, b] -> (NF, TB)."""
    cuda = _operands("run_bd", ps, m)
    _same("run_bd", ps.shape[1], m.shape[0], "ps columns and m rows")
    _rows("run_bd", ps.shape[0], G)
    if not cuda:
        return run_bd_plain(ps, m, G)
    (nf, tc), tb = ps.shape, m.shape[1]
    out = _empty((nf, tb), ps)
    _launch("k_bd", ps.device, ps, m, out, nf, tc, tb, G)
    return out


def rot_consts(NF):
    """k_rot's constants (A_NF hi, lo, rho hi, lo): A_NF = 1.5 cos(NF
    theta) + 0.5 sin(NF theta), theta = atan2(0.1, 0.9), and rho =
    sqrt(0.82), each taken in float64 and split into float32 values hi
    = float32(x), lo = float32(x - hi)."""
    theta = math.atan2(0.1, 0.9)
    out = []
    for x in (1.5 * math.cos(NF * theta) + 0.5 * math.sin(NF * theta),
              math.sqrt(0.82)):
        hi = float(np.float32(x))
        out += [hi, float(np.float32(x - hi))]
    return tuple(out)


def run_rot(m, NF):
    """NF phasor rotations of every element of m (TC, TB); the kernel
    takes 0 <= NF < 2^31."""
    cuda = _operands("run_rot", m)
    if NF < 0:
        raise ValueError(f"run_rot: NF={NF} < 0")
    if NF >= 2 ** 31:
        raise ValueError(f"run_rot: NF={NF} exceeds the kernel's 32-bit NF")
    if not cuda:
        return run_rot_plain(m, NF)
    out = torch.empty_like(m, memory_format=torch.contiguous_format)
    if m.numel():
        _launch("k_rot", m.device, m, out, m.numel(), NF, *rot_consts(NF))
    return out


def run_fwd(tau, ps, G):
    """(out_re, out_im), each (NF, TB): sum_c ps[k, c] (cos, sin)(k tau)."""
    cuda = _operands("run_fwd", tau, ps)
    _same("run_fwd", ps.shape[1], tau.shape[0], "ps columns and tau rows")
    _rows("run_fwd", ps.shape[0], G)
    if not cuda:
        return run_fwd_plain(tau, ps, G)
    if G not in FWD_G:
        raise ValueError(f"run_fwd kernel takes G in {FWD_G}, got {G}")
    (nf, tc), tb = ps.shape, tau.shape[1]
    _, gy, S = fwd_plan(nf, tc, tb)["grid"]
    if gy > 65535:
        raise ValueError(f"run_fwd: {nf} rows exceed the kernel's grid")
    ore, oim = _empty((nf, tb), ps), _empty((nf, tb), ps)
    # the slices' partial sums, added in order by the sum kernel
    part = _empty((S, 2, nf, tb), ps) if S > 1 else 0
    _launch("k_fwd", ps.device, tau, ps, ore, oim, part, tc, tb, nf)
    return ore, oim


# ---- plain PyTorch versions (any float dtype; no TF32)

def run_nn_plain(ps, m):
    with rime_cuda.no_tf32():
        return ps @ m


def run_nt_plain(ct, m):
    with rime_cuda.no_tf32():
        return ct @ m.T


def run_vt_plain(ps, m):
    return ps.sum(0)[:, None] * m


run_lr_plain = run_nt_plain


def _bd_scale(nf, G, like):
    return 1.0 + (torch.arange(nf, device=like.device) % G).to(like.dtype)


def run_bd_plain(ps, m, G):
    return run_nn_plain(ps, m) * _bd_scale(ps.shape[0], G, ps)[:, None]


def run_rot_plain(m, NF):
    cd, sd = m * 0.9, m * 0.1
    c, s = m, m * 0.5
    for _ in range(NF):
        c, s = c * cd - s * sd, s * cd + c * sd
    return c + s


def run_fwd_plain(tau, ps, G):
    """The JAX body's loop: G chains from angle g tau (filled by the
    step tau), each advanced by G tau per G rows. cos/sin are taken in
    float64 and cast (CPU float32 trigonometry is kept out of reference
    values)."""
    nf = ps.shape[0]

    def cs(x):
        x = x.double()
        return torch.cos(x).to(tau.dtype), torch.sin(x).to(tau.dtype)
    cd, sd = cs(tau)
    cdg, sdg = cs(tau * G)
    c, s = [torch.ones_like(tau)], [torch.zeros_like(tau)]
    for _ in range(1, G):
        cp, sp = c[-1], s[-1]
        c.append(cp * cd - sp * sd)
        s.append(sp * cd + cp * sd)
    c, s = torch.stack(c), torch.stack(s)               # (G, TC, TB)
    ore, oim = [], []
    with rime_cuda.no_tf32():
        for j in range(nf // G):
            rows = ps[j * G:(j + 1) * G, :, None]       # (G, TC, 1)
            ore.append(torch.bmm(rows.transpose(1, 2), c)[:, 0])
            oim.append(torch.bmm(rows.transpose(1, 2), s)[:, 0])
            c, s = c * cdg - s * sdg, s * cdg + c * sdg
    return torch.cat(ore), torch.cat(oim)


RUN = {"k_rot": run_rot, "k_nn": run_nn, "k_nt": run_nt, "k_vt": run_vt,
       "k_lr": run_lr, "k_bd": run_bd, "k_fwd": run_fwd}
PLAIN = {"k_rot": run_rot_plain, "k_nn": run_nn_plain,
         "k_nt": run_nt_plain, "k_vt": run_vt_plain, "k_lr": run_lr_plain,
         "k_bd": run_bd_plain, "k_fwd": run_fwd_plain}
# one PyTorch call computing the same function, timed beside the kernel
# as a yardstick (never called by the kernels' path); none computes an
# NF-step recurrence or the fused phasor contraction
LIBRARY = {
    "k_rot": None,
    "k_nn": lambda ps, m: torch.matmul(ps, m),
    "k_nt": lambda ct, m: torch.matmul(ct, m.T),
    "k_vt": lambda ps, m: torch.einsum("jc,cb->cb", ps, m),
    "k_lr": lambda ct, m: torch.matmul(ct, m.T),
    "k_bd": lambda ps, m, G: torch.matmul(
        ps * _bd_scale(ps.shape[0], G, ps)[:, None], m),
    "k_fwd": None,
}


def make_args(name, NF=NF, TC=TC, TB=TB, G=G, device=None, seed=0,
              unit_rot=False, distinct=False):
    """The arguments of RUN[name], made by mk as the JAX script makes
    them: every array from the same seed (tau is mk((TC, TB))), or with
    distinct, m / tau from seed and ps / ct from seed + 1. With
    unit_rot, run_rot gets unit_m's inputs instead."""
    if name == "k_rot":
        return ((unit_m if unit_rot else mk)((TC, TB), seed, device), NF)
    m = mk((TC, TB), seed, device)
    seed2 = seed + 1 if distinct else seed
    if name in ("k_nt", "k_lr"):
        return mk((NF, TB), seed2, device), m
    ps = mk((NF, TC), seed2, device)
    if name == "k_bd":
        return ps, m, G
    if name == "k_fwd":
        return m, ps, G
    return ps, m


def compare(name, NF=NF, TC=TC, TB=TB, G=G, device=None, seed=0):
    """RUN[name] on float32 inputs against its plain version in float64
    on the same inputs and device. The operands are drawn from distinct
    seeds (with the script's shared seed, ct[:TC] would be m, and
    ct m^T partly a symmetric Gram matrix that hides swapped indices);
    run_rot takes unit_m's inputs. Returns (max |error| / max
    |reference|, max |error|, launches of the kernel during the call)."""
    args = make_args(name, NF, TC, TB, G, device, seed, unit_rot=True,
                     distinct=True)
    n0 = launches[name]
    got = RUN[name](*args)
    n = launches[name] - n0
    ref = PLAIN[name](*[a.double() if isinstance(a, torch.Tensor) else a
                        for a in args])
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return err / (scale + 1e-30), err, n


def work(name, NF=NF, TC=TC, TB=TB):
    """(FP32 operations, bytes) that the function of one call needs:
    its least operations, each input read once and each output written
    once. This is what bounds the call, not what the TPU body's loop
    does (loop_flops)."""
    prod = 2.0 * NF * TC * TB
    # (m + i m/2) D^NF, D = 0.9 m + 0.1 i m, by repeated squaring:
    # bit_length(NF) - 1 squarings and popcount(NF) products of 6 FLOP
    nmul = max(NF.bit_length() - 1, 0) + bin(NF).count("1")
    flops, words = {
        "k_nn": (prod, NF * TC + TC * TB + NF * TB),
        "k_nt": (prod, NF * TB + TC * TB + NF * TC),
        "k_lr": (prod, NF * TB + TC * TB + NF * TC),
        "k_bd": (prod + NF * TB, NF * TC + TC * TB + NF * TB),
        # a column sum of ps and one product per output
        "k_vt": (NF * TC + TC * TB, NF * TC + 2 * TC * TB),
        "k_rot": ((6.0 * nmul + 1) * TC * TB, 2 * TC * TB),
        # the contraction's two multiply-adds per (k, c, b), as the bound
        # of rime_fwd counts them (the phasors are left out)
        "k_fwd": (2 * prod, TC * TB + NF * TC + 2 * NF * TB),
    }[name]
    return float(flops), 4.0 * words


def loop_flops(name, NF=NF, TC=TC, TB=TB):
    """FP32 operations that the TPU body's loop does: NF multiply-adds
    per output in k_vt, 6 FLOP per element per step in k_rot, a rotation
    (6) and two multiply-adds (4) per (k, c, b) in k_fwd, the product's
    in the others. k_vt's kernel does the column sum that work() counts,
    k_rot's a float-float power of O(log NF) operations per element,
    and k_fwd's a two-term recurrence of 4 FLOP per triple beside the
    sum's 4, so for those three the rate is only the pace at which they
    cover the TPU body's loop."""
    trip = float(NF) * TC * TB
    return {"k_vt": 2 * trip, "k_rot": 6 * trip,
            "k_fwd": 10 * trip}.get(name, work(name, NF, TC, TB)[0])


def bound_ms(name, NF=NF, TC=TC, TB=TB):
    """The least time of one call on an H100 SXM (work at the card's
    peaks, ops/rime_cuda.py::roofline_ms), in ms, and whether
    "operations" or "bytes" set it."""
    return rime_cuda.roofline_ms(*work(name, NF, TC, TB))


def main(device=None, n=400):
    """Time the seven kernels at the script's sizes (n back-to-back
    launches each) and print one line each in the JAX script's order,
    with the bound, the pace at which it covers the TPU body's loop
    (loop_flops) and the library call's time. Returns {name: {"ms",
    "bound_ms", "bound_by", "loop_tflops", "library_ms"}}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("mosaic_spike times kernels on the card; pass a "
                         "CUDA device")
    print(f"device={torch.cuda.get_device_name(dev)} TC={TC} TB={TB} "
          f"NF={NF} G={G}", flush=True)
    res = {}
    with torch.cuda.device(dev), rime_cuda.no_tf32():
        for name, label in SPIKES:
            args = make_args(name, device=dev)
            ms = timeit(RUN[name], *args, n=n)
            lib = LIBRARY[name]
            lms = timeit(lib, *args, n=n) if lib else None
            bms, by = bound_ms(name)
            tflops = loop_flops(name) / ms / 1e9
            res[name] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                         "loop_tflops": tflops, "library_ms": lms}
            lib_txt = (f"library {lms:.4f} ms" if lib else
                       "library: no single PyTorch call")
            print(f"  {label:44s} {ms:8.4f} ms/iter  bound {bms:.5f} ms "
                  f"({by}, kernel at {bms / ms:.1%})  TPU loop {tflops:.2f} "
                  f"TFLOP/s  {lib_txt}", flush=True)
    return res


if __name__ == "__main__":
    main()
