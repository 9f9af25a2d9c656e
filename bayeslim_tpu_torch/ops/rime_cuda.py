"""
The fused RIME kernels on the card, their plain PyTorch versions, and
the autograd Function that puts them on the RIME path.

Counterpart of bayeslim_tpu/ops/rime_pallas.py (`_fwd_pallas` :619,
`_dtau_pallas` :773, `rime_fused` :880-938, `rime_fused_bs` :941-1018,
`rime_pallas_reduce` :1022-1045).

Contract (`rime_fwd`): for ps rows (R, K), real or complex, and
tauT (K, N) float,

    out[r, n] = sum_c ps[r, c] exp(+-2 pi i f_r tauT[c, n])
    f_r = f0 + (r mod nf) df          (R = nstack * nf stacked rows)

returned complex (R, N), or real (R, N) holding only the real plane
when ``out_imag=False``. ``tauT_lo`` (optional, float32 like tauT) is
the residual of a delay known more precisely than float32: the delay
is then tauT + tauT_lo (a float32 delay alone is rounded by up to
~6e-14 s, 7.5e-5 rad at 200 MHz).

Contract (`rime_dtau`, the delay cotangent): for ct (R, N) complex,

    dtauT[c, n] = sum_r w_r Im(ct[r, n] ps[r, c] E[r, c, n]),
    E = exp(i s 2 pi f_r tauT[c, n]),  w_r = -s 2 pi f_r,

with s = -1 if conj else +1, returned real (K, N). The backward passes
ct = conj(g) for PyTorch's incoming gradient g.

A CUDA tensor launches the hand-written kernel (``csrc/rime_fwd.cu``,
``csrc/rime_dtau.cu``; float32 / complex64 only, anything else
raises); a CPU tensor runs the plain version. There is no fallback from
one to the other.

The kernels are compiled with nvcc for sm_90a into ``build/kernels/``
at first use and loaded with ctypes; ``launches`` and ``dtau_launches``
count their calls (one per call, whatever the CUDA launches behind it:
``rime_fwd`` splits its contraction into K slices by ``fwd_plan`` and
adds them in a fixed order, with no atomics; ``rime_dtau`` first writes
w_r ct to a scratch, then walks the rows in the passes of
``dtau_plan``). ``SOURCES`` also lists ``csrc/mosaic_spike.cu``,
the microbenchmark kernels wrapped by ``scripts/mosaic_spike.py``, and
``csrc/airy_psky.cu``, the per-time sky and Airy beam wrapped by
``models/airy_psky.py``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .phase import _split_f32, fringe_cycles

__all__ = ["rime_fwd", "rime_fwd_plain", "rime_dtau", "rime_dtau_plain",
           "rime_fused", "RimeFused", "rime_fused_bs", "RimeFusedBS",
           "rime_pallas_reduce", "build", "launches",
           "dtau_launches", "no_tf32", "roofline_ms", "fwd_plan", "fwd_info",
           "dtau_plan", "dtau_info"]

# launches of each CUDA kernel (incremented once per launch, nowhere else)
launches = 0
dtau_launches = 0

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("rime_fwd.cu", "rime_dtau.cu", "mosaic_spike.cu",
           "airy_psky.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = {}


@contextlib.contextmanager
def no_tf32():
    """Run float32 matmuls in true fp32 inside the block (TF32 keeps ~3
    digits; the delay matrix feeds phases of ~1e4 rad)."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def _nvcc():
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return exe


def build(sources=SOURCES):
    """Compile each CUDA source into its own shared library, all nvcc
    processes started together. Libraries are named by a hash of their
    source, every header in csrc/ and the flags, so a built one is
    reused and a changed header rebuilds. Returns
    {source: (path, seconds, ptxas report)}."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    jobs = {}
    for src in sources:
        path = _CSRC / src
        key = hashlib.sha1(path.read_bytes() + headers
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        lib = _BUILD / f"{path.stem}-{key}.so"
        tmp = _BUILD / f"{path.stem}-{key}.{os.getpid()}.tmp"
        proc = None
        if not lib.exists():
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[src] = (lib, tmp, proc, time.time())
    out = {}
    for src, (lib, tmp, proc, t0) in jobs.items():
        report = ""
        if proc is not None:
            report, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{report}")
            os.replace(tmp, lib)
        out[src] = (lib, time.time() - t0, report)
    return out


# published H100 SXM peaks (NVIDIA data sheet, at 700 W)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def roofline_ms(flops, nbytes):
    """The least time of a call on an H100 SXM, in ms: the larger of its
    FP32 operations at the FP32 rate and its bytes at the memory rate;
    and which of the two it is ("operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


# argument types of the C launchers (pointers and the stream as
# c_void_p, so ctypes does not cut them to 32 bits)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_F] * 6 + [_I] * 3 + [_P]
_DTAU_ARGS = [_P] * 5 + [_I] * 5 + [_F] * 8 + [_I] * 2 + [_P]

# rime_fwd's tiling (csrc/rime_fwd.cu): rows of a run (one thread's),
# runs and columns of a block, the contraction tile
FWD_RUN, FWD_RUNS_PER_BLOCK, FWD_COLS_PER_BLOCK, FWD_TILE_K = 32, 8, 32, 32
# the most K slices a launch takes (its scratch is S x R x N outputs)
FWD_MAX_SLICES = 16
# the run seed takes k0 c1 exactly for a first channel k0 < 2^24
FWD_MAX_NF = 1 << 24
# rime_dtau's rows of a pass (one seed per output) and of a two-term
# block (csrc/rime_dtau.cu)
DTAU_RUN, DTAU_LB = 32, 8


def _check_nf(kernel, R, nf):
    if nf < 1 or R % nf:
        raise ValueError(f"{kernel}: {R} rows are not a multiple of nf={nf}")
    if nf > FWD_MAX_NF:
        raise ValueError(f"{kernel}: nf={nf} channels exceed the kernel's "
                         f"limit of {FWD_MAX_NF} (2^24: its run seeds take "
                         f"k0 * c1 exactly only for k0 < 2^24)")


def fwd_plan(R, K, N, nf, sms, blocks_per_sm):
    """Split of one rime_fwd launch's contraction over grid.z:
    (S, cslice), S slices of cslice columns of K (a multiple of the K
    tile; the last may be short). Each stacked block of nf rows is cut
    into runs of FWD_RUN channels that never cross it, FWD_RUNS_PER_BLOCK
    runs and FWD_COLS_PER_BLOCK columns to a block. With sms x
    blocks_per_sm blocks resident at a time, S is the smallest in
    1 .. FWD_MAX_SLICES that minimises waves x tiles per slice, the
    launch's time in units of one block's work on one tile."""
    _check_nf("rime_fwd", R, nf)
    runs = (R // nf) * -(-nf // FWD_RUN)
    blocks = -(-N // FWD_COLS_PER_BLOCK) * -(-runs // FWD_RUNS_PER_BLOCK)
    resident = max(1, sms * blocks_per_sm)
    tiles = max(1, -(-K // FWD_TILE_K))
    best = None
    for s in range(1, min(FWD_MAX_SLICES, tiles) + 1):
        per = -(-tiles // s)
        s_eff = -(-tiles // per)
        cost = -(-blocks * s_eff // resident) * per
        if best is None or cost < best[0]:
            best = (cost, s_eff, per * FWD_TILE_K)
    return best[1], best[2]


def dtau_plan(R, nf):
    """The passes of one rime_dtau launch: (rps, npass). Each stacked
    block of nf rows is cut into rps = ceil(nf / DTAU_RUN) passes that
    never cross it, npass = (R / nf) rps in all; pass p covers channels
    k0 .. k0 + len - 1 of stacked block p // rps, with k0 = (p % rps)
    DTAU_RUN and len = min(DTAU_RUN, nf - k0) (the kernel's Pass)."""
    _check_nf("rime_dtau", R, nf)
    rps = -(-nf // DTAU_RUN)
    return rps, (R // nf) * rps


_INFO = {}


def _info(source, symbol, flags, device):
    """(registers per thread, shared memory per block in bytes, resident
    blocks per SM, SMs) of a kernel variant, asked of the library's
    ``symbol`` on a CUDA device."""
    device = torch.device(device)
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (symbol, idx) + tuple(int(bool(f)) for f in flags)
    if key not in _INFO:
        vals = [_I() for _ in range(3)]
        argtypes = [_I] * len(flags) + [ctypes.POINTER(_I)] * 3
        with torch.cuda.device(idx):
            rc = _lib(source, symbol, argtypes)(
                *key[2:], *(ctypes.byref(v) for v in vals))
        if rc != 0:
            raise RuntimeError(f"{symbol} failed: CUDA error {rc}")
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _INFO[key] = tuple(v.value for v in vals) + (sms,)
    return _INFO[key]


def fwd_info(device, ps_real, out_imag):
    """(registers per thread, shared memory per block in bytes, resident
    blocks per SM, SMs) of the rime_fwd kernel variant on a CUDA
    device."""
    return _info("rime_fwd.cu", "rime_fwd_info", (ps_real, out_imag), device)


def dtau_info(device, ps_real):
    """The same for the rime_dtau kernel variant."""
    return _info("rime_dtau.cu", "rime_dtau_info", (ps_real,), device)


def _lib(source, symbol, argtypes):
    """The C launcher ``symbol`` of csrc/``source``, taking ``argtypes``
    and returning a CUDA error code, built at first use."""
    if (source, symbol) not in _LIB:
        path = build((source,))[source][0]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIB[source, symbol] = fn
    return _LIB[source, symbol]


def rime_fwd(ps, tauT, f0, df, nf, conj=False, out_imag=True,
             tauT_lo=None):
    """The fused reduction (contract in the module docstring)."""
    if not ps.is_cuda:
        return rime_fwd_plain(ps, tauT, f0, df, nf, conj=conj,
                              out_imag=out_imag, tauT_lo=tauT_lo)
    global launches
    if not tauT.is_cuda or tauT.device != ps.device:
        raise ValueError("rime_fwd: ps and tauT must be on one CUDA device")
    if ps.dtype not in (torch.float32, torch.complex64) \
            or tauT.dtype != torch.float32:
        raise TypeError(f"rime_fwd kernel takes float32/complex64 ps and "
                        f"float32 tauT, got {ps.dtype}, {tauT.dtype}")
    if ps.ndim != 2 or tauT.ndim != 2 or ps.shape[1] != tauT.shape[0]:
        raise ValueError(f"rime_fwd: bad shapes {tuple(ps.shape)}, "
                         f"{tuple(tauT.shape)}")
    if tauT_lo is not None and (tauT_lo.shape != tauT.shape
                                or tauT_lo.dtype != tauT.dtype
                                or tauT_lo.device != tauT.device):
        raise ValueError("rime_fwd: tauT_lo must match tauT's shape, dtype "
                         "and device")
    R, K = ps.shape
    N = tauT.shape[1]
    ps_real = not ps.is_complex()
    _, _, per_sm, sms = fwd_info(ps.device, ps_real, out_imag)
    S, cslice = fwd_plan(R, K, N, int(nf), sms, per_sm)
    out = _launch_fwd(ps, tauT, f0, df, nf, conj, out_imag, S, cslice,
                      tauT_lo)
    launches += 1
    return out


def _launch_fwd(ps, tauT, f0, df, nf, conj, out_imag, S, cslice,
                tauT_lo=None):
    """One rime_fwd kernel launch with the K split (S, cslice) (see
    fwd_plan); the slices' partial sums go to a scratch (S, R, N) and are
    added in order by a second launch. Counts nothing: rime_fwd does."""
    R, K = ps.shape
    N = tauT.shape[1]
    # a conjugate view shares its memory with the unconjugated tensor:
    # resolve it before the kernel reads the raw buffer
    ps = ps.resolve_conj().contiguous()
    tauT = tauT.contiguous()
    if tauT_lo is not None:
        tauT_lo = tauT_lo.contiguous()
    odt = torch.complex64 if out_imag else torch.float32
    out = torch.empty((R, N), device=ps.device, dtype=odt)
    part = torch.empty((S, R, N), device=ps.device, dtype=odt) \
        if S > 1 else None
    stream = torch.cuda.current_stream(ps.device).cuda_stream
    rc = _lib("rime_fwd.cu", "rime_fwd_launch", _FWD_ARGS)(
        ps.data_ptr(), tauT.data_ptr(),
        None if tauT_lo is None else tauT_lo.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), R, K, N, int(nf), S,
        cslice, *_split_f32(f0), *_split_f32(df), int(bool(conj)),
        int(not ps.is_complex()), int(bool(out_imag)), stream)
    if rc != 0:
        raise RuntimeError(f"rime_fwd kernel launch failed: CUDA error {rc}")
    return out


def rime_dtau(ct, ps, tauT, f0, df, nf, conj=False):
    """The delay cotangent (contract in the module docstring)."""
    if not ps.is_cuda:
        return rime_dtau_plain(ct, ps, tauT, f0, df, nf, conj=conj)
    global dtau_launches
    if not (ct.is_cuda and tauT.is_cuda) \
            or not ct.device == tauT.device == ps.device:
        raise ValueError("rime_dtau: ct, ps and tauT must be on one CUDA "
                         "device")
    if ct.dtype != torch.complex64 or tauT.dtype != torch.float32 \
            or ps.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"rime_dtau kernel takes complex64 ct, float32/"
                        f"complex64 ps and float32 tauT, got {ct.dtype}, "
                        f"{ps.dtype}, {tauT.dtype}")
    if ct.ndim != 2 or ps.ndim != 2 or tauT.ndim != 2 \
            or ps.shape != (ct.shape[0], tauT.shape[0]) \
            or ct.shape[1] != tauT.shape[1]:
        raise ValueError(f"rime_dtau: bad shapes {tuple(ct.shape)}, "
                         f"{tuple(ps.shape)}, {tuple(tauT.shape)}")
    out = _launch_dtau(_lib("rime_dtau.cu", "rime_dtau_launch", _DTAU_ARGS),
                       ct, ps, tauT, f0, df, nf, conj)
    dtau_launches += 1
    return out


def _launch_dtau(launcher, ct, ps, tauT, f0, df, nf, conj):
    """One call of a rime_dtau C launcher (csrc/rime_dtau.cu's
    rime_dtau_launch, or a variant of it with the same arguments) on
    checked inputs. Counts nothing: rime_dtau does."""
    R, K = ps.shape
    N = tauT.shape[1]
    _, npass = dtau_plan(R, int(nf))
    if 64 * max(K, N) >= 2 ** 31:
        raise ValueError(f"rime_dtau: K={K} or N={N} too large for the "
                         f"kernel's 32-bit offsets within a pass")
    ct = ct.resolve_conj().contiguous()
    ps = ps.resolve_conj().contiguous()
    tauT = tauT.contiguous()
    out = torch.empty((K, N), device=ps.device, dtype=torch.float32)
    ctw = torch.empty_like(ct)              # the kernel's scratch: w_r ct
    stream = torch.cuda.current_stream(ps.device).cuda_stream
    # w_r = -sgn 2 pi (f0 + k df) = w0 + k w1, both rounded to float32
    sgn = -1.0 if conj else 1.0
    rc = launcher(
        ct.data_ptr(), ctw.data_ptr(), ps.data_ptr(), tauT.data_ptr(),
        out.data_ptr(), R, K, N, int(nf), npass, *_split_f32(f0),
        *_split_f32(df), -sgn * 2 * np.pi * float(f0),
        -sgn * 2 * np.pi * float(df), int(bool(conj)),
        int(not ps.is_complex()), stream)
    if rc != 0:
        raise RuntimeError(f"rime_dtau kernel launch failed: CUDA error {rc}")
    return out


# elements of one (chunk, N, nf) cos/sin block in the plain versions
_PLAIN_ELEMS = 1 << 24


def _phasors(tauT, freqs, sgn, dtype, tauT_lo=None):
    """cos and sgn * sin of 2 pi f tau, (K, N, nf): the phases f tau mod 1
    and their cos/sin are formed in float64 (the kernels also reduce
    phases in double), then cast to the working dtype. tau = tauT (+
    tauT_lo)."""
    tau = tauT.double() if tauT_lo is None \
        else tauT.double() + tauT_lo.double()
    ang = (2 * np.pi) * fringe_cycles(tau, freqs)
    return torch.cos(ang).to(dtype), (sgn * torch.sin(ang)).to(dtype)


def rime_fwd_plain(ps, tauT, f0, df, nf, conj=False, out_imag=True,
                   tauT_lo=None):
    """Plain PyTorch version of ``rime_fwd``: chunked over K, it
    materialises cos/sin of each chunk's phases and contracts them in
    the inputs' dtype (true fp32 or fp64). Differentiable."""
    R, K = ps.shape
    N = tauT.shape[1]
    nstack = R // nf
    freqs = float(f0) + np.arange(nf) * float(df)
    ps3 = ps.reshape(nstack, nf, K)
    sgn = -1.0 if conj else 1.0
    chunk = max(1, _PLAIN_ELEMS // max(N * nf, 1))
    re = im = None
    with no_tf32():
        for i in range(0, K, chunk):
            cosf, sinf = _phasors(tauT[i:i + chunk], freqs, sgn, tauT.dtype,
                                  None if tauT_lo is None
                                  else tauT_lo[i:i + chunk])  # (C, N, nf)
            p = ps3[..., i:i + chunk]                   # (S, nf, C)

            def es(a, b):
                return torch.einsum("skc,cnk->skn", a, b)
            if p.is_complex():
                r = es(p.real, cosf) - es(p.imag, sinf)
                m = es(p.real, sinf) + es(p.imag, cosf) if out_imag else None
            else:
                r = es(p, cosf)
                m = es(p, sinf) if out_imag else None
            re = r if re is None else re + r
            if out_imag:
                im = m if im is None else im + m
    re = re.reshape(R, N)
    return torch.complex(re, im.reshape(R, N)) if out_imag else re


def rime_dtau_plain(ct, ps, tauT, f0, df, nf, conj=False):
    """Plain PyTorch version of ``rime_dtau``: chunked over K, the sum
    over the stacked blocks is a batched product per frequency,
    A[k, c, n] = sum_s ps[s, k, c] (w ct)[s, k, n], and the phasors
    contract A's real and imaginary planes: Im(A E) = Re A sin + Im A cos."""
    R, K = ps.shape
    N = tauT.shape[1]
    nstack = R // nf
    freqs = float(f0) + np.arange(nf) * float(df)
    sgn = -1.0 if conj else 1.0
    rdt = tauT.dtype
    w = torch.as_tensor(np.tile(-sgn * 2 * np.pi * freqs, nstack),
                        dtype=rdt, device=ct.device)
    ctw = ct * w[:, None]

    def by_freq(x, n):                                  # (R, n) -> (nf, S, n)
        return x.reshape(nstack, nf, n).transpose(0, 1)
    cr, ci = by_freq(ctw.real, N), by_freq(ctw.imag, N)
    chunk = max(1, _PLAIN_ELEMS // max(N * nf, 1))
    out = []
    with no_tf32():
        for i in range(0, K, chunk):
            cosf, sinf = _phasors(tauT[i:i + chunk], freqs, sgn, rdt)
            p = by_freq(ps[:, i:i + chunk], cosf.shape[0]).transpose(1, 2)
            if p.is_complex():                          # (nf, C, S)
                are = p.real @ cr - p.imag @ ci
                aim = p.real @ ci + p.imag @ cr
            else:
                are, aim = p @ cr, p @ ci               # (nf, C, N)
            out.append(torch.einsum("kcn,cnk->cn", are, sinf)
                       + torch.einsum("kcn,cnk->cn", aim, cosf))
    return torch.cat(out, dim=0)


# cap on transient delay-matrix elements: chunk the pixel axis so no
# single (Nbls, chunk) buffer exceeds 2^28 elements
_TAU_ELEM_BUDGET = 1 << 28


def _pix_chunks(nbl, npx):
    """Pixel-chunk slices keeping nbl * chunk <= budget."""
    if nbl * npx <= _TAU_ELEM_BUDGET:
        return [slice(None)]
    chunk = max(128, (_TAU_ELEM_BUDGET // max(nbl, 1)) // 128 * 128)
    return [slice(i, min(i + chunk, npx)) for i in range(0, npx, chunk)]


def _mm(a, b):
    """a @ b in true fp32/fp64 (delays: a, b are blvecs and s/c)."""
    with no_tf32():
        return a @ b


SECOND_ORDER_ERROR = (
    "the fused RIME kernels have no second derivative: take Hessians and "
    "Hessian-vector products inside "
    "bayeslim_tpu_torch.ops.rime_kernel.force_chunked(), which runs the "
    "chunked PyTorch path (inference.hessian.compute_hessian enters it)")


class _SecondOrderRefused(torch.autograd.Function):
    """x, as a function of x and of deps (the tensors it was computed
    from), whose derivative raises SECOND_ORDER_ERROR."""

    @staticmethod
    def forward(ctx, x, *deps):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(SECOND_ORDER_ERROR)

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(SECOND_ORDER_ERROR)


def _first_order(backward):
    """Decorate a fused Function's backward as once_differentiable does,
    with an error that names force_chunked: the backward runs without
    recording a graph, and under create_graph its gradients are marked
    so that differentiating them raises."""
    @functools.wraps(backward)
    def wrapped(ctx, *grads):
        with torch.no_grad():
            outs = backward(ctx, *grads)
        deps = [t for t in (*ctx.saved_tensors, *grads)
                if isinstance(t, torch.Tensor) and t.requires_grad]
        if not (torch.is_grad_enabled() and deps):
            return outs
        return tuple(None if o is None else _SecondOrderRefused.apply(
            o, *deps) for o in outs)
    return wrapped


class RimeFusedBS(torch.autograd.Function):
    """``rime_fwd`` with the delay factored as tau = blvecs @ s_c, built
    pixel-chunk by chunk in both passes and never saved for the
    backward (counterpart of rime_fused_bs, rime_pallas.py:941).

    ps2d : (nstack * nf, Npix) real or complex; blvecs : (Nbls, 3);
    s_c : (3, Npix). Returns (nstack * nf, Nbls) complex.

    Backward, per pixel chunk, each kernel launched only for a gradient
    that is asked for (rime_pallas.py::_bs_bwd :984):

    - dps[r, c] = sum_b g[r, b] conj(E[b, c, r]) is ``rime_fwd`` with
      baselines and pixels swapped and ``conj`` flipped (PyTorch hands
      the backward dL/dz-bar; the JAX custom_vjp receives the conjugate
      convention and uses E itself);
    - the delay cotangent dtauT = ``rime_dtau`` with ct = conj(g),
      contracted at once to dblvecs = (s_c dtauT)^T and
      ds_c = (dtauT blvecs)^T in true fp32 / fp64.

    The backward is first-order only: a second derivative (a double
    backward, or forward-mode over it) raises SECOND_ORDER_ERROR, which
    names ``ops.rime_kernel.force_chunked``.
    """

    @staticmethod
    def forward(ctx, ps2d, blvecs, s_c, f0, df, nf, conj):
        ctx.save_for_backward(ps2d, blvecs, s_c)
        ctx.meta = (f0, df, nf, conj)
        out = None
        for sl in _pix_chunks(blvecs.shape[0], ps2d.shape[1]):
            tauT = _mm(s_c[:, sl].t(), blvecs.t())
            o = rime_fwd(ps2d[:, sl], tauT, f0, df, nf, conj=conj)
            out = o if out is None else out + o
        return out

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(SECOND_ORDER_ERROR)

    @staticmethod
    @_first_order
    def backward(ctx, g):
        ps2d, blvecs, s_c = ctx.saved_tensors
        f0, df, nf, conj = ctx.meta
        need_ps, need_bv, need_sc = ctx.needs_input_grad[:3]
        g = g.contiguous()
        ct = g.conj_physical() if (need_bv or need_sc) else None
        dps_parts, dbv, dsc_parts = [], None, []
        for sl in _pix_chunks(blvecs.shape[0], ps2d.shape[1]):
            tauT = _mm(s_c[:, sl].t(), blvecs.t())      # (C, Nbls)
            if need_ps:
                dps_parts.append(rime_fwd(g, tauT.t(), f0, df, nf,
                                          conj=not conj,
                                          out_imag=ps2d.is_complex()))
            if need_bv or need_sc:
                dtauT = rime_dtau(ct, ps2d[:, sl], tauT, f0, df, nf,
                                  conj=conj).to(blvecs.dtype)
                if need_bv:
                    db = _mm(s_c[:, sl], dtauT).t()
                    dbv = db if dbv is None else dbv + db
                if need_sc:
                    dsc_parts.append(_mm(dtauT, blvecs).t())
        dps = torch.cat(dps_parts, dim=1).to(ps2d.dtype) if need_ps else None
        dsc = torch.cat(dsc_parts, dim=1) if need_sc else None
        return dps, dbv, dsc, None, None, None, None


def rime_fused_bs(ps2d, blvecs, s_c, f0, df, nf, conj=False):
    """Differentiable fused reduction with factored delays (see
    RimeFusedBS)."""
    return RimeFusedBS.apply(ps2d, blvecs, s_c, float(f0), float(df),
                             int(nf), bool(conj))


class RimeFused(torch.autograd.Function):
    """``rime_fwd`` with the delays given as an (Nbls, Npix) matrix tau
    (counterpart of rime_fused, rime_pallas.py:880).

    ps2d : (nstack * nf, Npix) real or complex; tau : (Nbls, Npix).
    Returns (nstack * nf, Nbls) complex.

    Backward, each kernel launched only for a gradient that is asked
    for (rime_pallas.py::_rime_fused_bwd :916): dps is ``rime_fwd`` with
    baselines and pixels swapped and ``conj`` flipped, as in
    RimeFusedBS; dtau is ``rime_dtau`` with ct = conj(g), transposed to
    (Nbls, Npix) and not contracted further. First-order only, as
    RimeFusedBS.
    """

    @staticmethod
    def forward(ctx, ps2d, tau, f0, df, nf, conj):
        ctx.save_for_backward(ps2d, tau)
        ctx.meta = (f0, df, nf, conj)
        return rime_fwd(ps2d, tau.t(), f0, df, nf, conj=conj)

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(SECOND_ORDER_ERROR)

    @staticmethod
    @_first_order
    def backward(ctx, g):
        ps2d, tau = ctx.saved_tensors
        f0, df, nf, conj = ctx.meta
        need_ps, need_tau = ctx.needs_input_grad[:2]
        g = g.contiguous()
        dps = dtau = None
        if need_ps:
            dps = rime_fwd(g, tau, f0, df, nf, conj=not conj,
                           out_imag=ps2d.is_complex()).to(ps2d.dtype)
        if need_tau:
            dtau = rime_dtau(g.conj_physical(), ps2d, tau.t(), f0, df, nf,
                             conj=conj).t().to(tau.dtype)
        return dps, dtau, None, None, None, None


def rime_fused(ps2d, tau, f0, df, nf, conj=False):
    """Differentiable fused reduction with the delay matrix given (see
    RimeFused)."""
    return RimeFused.apply(ps2d, tau, float(f0), float(df), int(nf),
                           bool(conj))


def rime_pallas_reduce(psky, tau, freqs, conj=False):
    """Fused RIME reduction, forward only (counterpart of
    rime_pallas.py::rime_pallas_reduce :1022): psky (Nfreqs, Npix) real
    or complex and tau (Nbls, Npix) on a regular frequency grid ->
    (Nbls, Nfreqs) complex, by one ``rime_fwd`` call."""
    freqs = np.asarray(freqs, dtype=np.float64)
    nf = len(freqs)
    if tuple(psky.shape) != (nf, tau.shape[1]):
        raise ValueError(f"rime_pallas_reduce: psky {tuple(psky.shape)} is "
                         f"not (Nfreqs, Npix) = ({nf}, {tau.shape[1]})")
    df = float(freqs[1] - freqs[0]) if nf > 1 else 0.0
    if nf > 1 and not np.allclose(np.diff(freqs), df, rtol=1e-10):
        raise ValueError("rime_pallas_reduce needs a regular frequency grid")
    return rime_fwd(psky, tau.t(), float(freqs[0]), df, nf, conj=conj).t()
