"""
Design alternatives of the ring-buffered SGEMM of k_nn and k_nt
(``csrc/mosaic_spike.cu``), timed on the card against the kernel as it
is and against ``torch.matmul``, at the spike's sizes (NF, TC, TB =
1024, 256, 256):

    python -m bayeslim_tpu_torch.scripts.sgemm_variants

Each variant is the source with text edits of its tiling constants
(tile, k a slice, slots in the ring) or of the inner loop's unrolling,
built with the same nvcc flags into ``build/kernels/variants/``. Two
are wrong on purpose and time a part alone: ``no inner loop`` (the
copies, barriers and stores) and ``no global loads`` (the inner loop on
whatever shared memory holds). Times are ms per launch, 400 launches in
one CUDA graph (``mosaic_spike.timeit``), in two turns (kernel,
variants, library; then the reverse), each variant beside its relative
error against float64 and its ptxas line.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from ..ops import rime_cuda
from . import mosaic_spike as spike

_TILING = ("constexpr int SG_BM = 64, SG_BN = 32, SG_BK = 64, "
           "SG_STAGES = 2;")
_LOOP = "#pragma unroll\n        for (int kk = 0; kk < SG_BK; kk += 4) {"
_FMA = ("acc[i][j] = fmaf(a[i][q], NT ? b[j][q] : b[q][j],\n"
        "                                         acc[i][j]);")
_FIRST = "if (s < nk) load(s, s);"
_NEXT = "if (kt + SG_STAGES - 1 < nk)\n            load("


def _tiling(bm=64, bn=32, bk=64, stages=2):
    return [(_TILING, f"constexpr int SG_BM = {bm}, SG_BN = {bn}, "
                      f"SG_BK = {bk}, SG_STAGES = {stages};")]


def _unroll(n):
    return [(_LOOP, _LOOP.replace("unroll", f"unroll {n}"))]


EDITS = {
    "4 slots (the first design)": _tiling(stages=4),
    "3 slots": _tiling(stages=3),
    "BK 32, 2 slots": _tiling(bk=32),
    "BK 32, 4 slots": _tiling(bk=32, stages=4),
    "32 x 32 tiles (256 blocks)": _tiling(bm=32),
    "64 x 64 tiles (64 blocks)": _tiling(bn=64),
    "inner loop unrolled 4": _unroll(4),
    # wrong on purpose: what the copies, barriers and stores cost alone,
    # and what the inner loop costs alone
    "no inner loop": [(_FMA, "acc[i][j] += 0.f;")],
    "no global loads": [(_FIRST, "if (false) load(s, s);"),
                        (_NEXT, "if (false)\n            load(")],
}
WRONG = ("no inner loop", "no global loads")


def build_variants(edits=None, symbols=("k_nn_launch", "k_nt_launch"),
                   tag="sg"):
    """{name: (*launchers of symbols, ptxas report)} of every variant of
    csrc/mosaic_spike.cu in edits (default EDITS), nvcc started for all
    at once; the sources and libraries go to build/kernels/variants/ as
    {tag}{i}.cu / .so."""
    edits = EDITS if edits is None else edits
    src = (rime_cuda._CSRC / "mosaic_spike.cu").read_text()
    out_dir = rime_cuda._BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, changes) in enumerate(edits.items()):
        text = src
        for old, new in changes:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: csrc/mosaic_spike.cu "
                                   f"no longer holds {old[:40]!r}")
            text = text.replace(old, new)
        cu, lib = out_dir / f"{tag}{i}.cu", out_dir / f"{tag}{i}.so"
        cu.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [rime_cuda._nvcc(), *rime_cuda.NVCC_FLAGS, "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{report}")
        cdll = ctypes.CDLL(str(lib))
        fns = []
        for sym in symbols:
            fn = getattr(cdll, sym)
            fn.argtypes = spike._ARGTYPES[sym[:-len("_launch")]]
            fn.restype = ctypes.c_int
            fns.append(fn)
        out[name] = (*fns, report)
    return out


def _usage(report, kernel):
    """ptxas's 'Used ...' line of the 16-byte-chunk instance of kernel."""
    lines = report.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and f"{kernel}ILi16E" in ln:
            for nxt in lines[i + 1:i + 5]:
                if "Used" in nxt:
                    return nxt.split(":", 1)[1].strip()
    return "?"


def main(seed=0):
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernel = tuple(rime_cuda._lib("mosaic_spike.cu", sym,
                                  spike._ARGTYPES[sym[:-len("_launch")]])
                   for sym in ("k_nn_launch", "k_nt_launch"))
    variants = build_variants()
    fns = {"kernel": kernel + ("",), **variants}
    NF, TC, TB = spike.NF, spike.TC, spike.TB
    for nt, name in ((False, "k_nn"), (True, "k_nt")):
        a, m = spike.make_args(name, device=dev, seed=seed, distinct=True)
        out = torch.empty((NF, TC if nt else TB), device=dev)
        dims = (NF, TB, TC) if nt else (NF, TC, TB)
        ref = spike.PLAIN[name](a.double(), m.double())

        def launch(fn):
            rc = fn(a.data_ptr(), m.data_ptr(), out.data_ptr(), *dims,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        lib = spike.LIBRARY[name]
        times = {v: [] for v in fns}
        times["torch.matmul"] = []
        order = list(times)
        with rime_cuda.no_tf32():
            for v in order + order[::-1]:
                if v == "torch.matmul":
                    times[v].append(spike.timeit(lib, a, m))
                else:
                    times[v].append(spike.timeit(launch, fns[v][nt]))
        base = float(np.mean(times["kernel"]))
        for v, t in times.items():
            line = (f"{name} {v}: {np.mean(t):.4f} ms (turns {t[0]:.4f}, "
                    f"{t[1]:.4f}), {np.mean(t) / base:.3f}x the kernel's")
            if v != "torch.matmul":
                launch(fns[v][nt])
                err = float((out.double() - ref).abs().max()
                            / ref.abs().max())
                line += (f"; rel err vs float64 {err:.2e}"
                         + (" (wrong on purpose)" if v in WRONG else ""))
                if v != "kernel":
                    line += f"; ptxas {_usage(fns[v][2], name)}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
