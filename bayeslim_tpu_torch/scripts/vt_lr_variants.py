"""
Design alternatives of k_vt (the cluster-wide column sum) and k_lr (the
lane-split product) in ``csrc/mosaic_spike.cu``, timed on the card
against each kernel as it is and against its library call, at the
spike's sizes (NF, TC, TB = 1024, 256, 256):

    python -m bayeslim_tpu_torch.scripts.vt_lr_variants

Each variant is the source with a text edit of the kernel's constants
(k_vt: blocks a cluster, columns a cluster; k_lr: lanes an output,
outputs a lane, output tile, slots in the ring), built with the same
nvcc flags into ``build/kernels/variants/`` (sgemm_variants'
build_variants). Some are wrong on purpose and time a part alone:
``no column sum`` (k_vt's cluster barriers and its product),
``no product`` (k_vt's column sum and barriers), ``no inner loop``
(k_lr's copies, barriers, reduce-scatter and stores), ``the launch
alone`` (a kernel that returns at once). Times are ms per
launch, 400 launches in one CUDA graph (``mosaic_spike.timeit``), in
two turns (kernel, variants, library; then the reverse), each variant
beside its relative error against float64 and its ptxas line.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops import rime_cuda
from . import mosaic_spike as spike
from .sgemm_variants import _usage, build_variants

_VT = "constexpr int VT_CL = 4, VT_GC = 16, VT_T = 256;"
_LR = ("constexpr int LR_BM = 32, LR_BN = 32, LR_BK = 64, LR_STAGES = 2, "
       "LR_S = 8,\n              LR_TI = 8, LR_TJ = 8;")
_VT_ROWS = "const int j1 = min(NF, (rank + 1) * rows);"
_VT_STORE = "if (cr >= TC) continue;"
_VT_TOP = "    extern __shared__ __align__(16) float vt_smem[];"
_LR_TOP = "    extern __shared__ __align__(16) float lr_smem[];"


def _return_first(top):
    return [(top, "    if (NF >= 0) return;\n" + top)]
_LR_FMA = ("acc[i * LR_TJ + j] = fmaf(a[i][e], b[j][e],\n"
           "                                                  "
           "acc[i * LR_TJ + j]);")


def _vt(cl=4, gc=16):
    return [(_VT, f"constexpr int VT_CL = {cl}, VT_GC = {gc}, "
                  f"VT_T = 256;")]


def _lr(bm=32, bn=32, stages=2, s=8, ti=8, tj=8):
    return [(_LR, f"constexpr int LR_BM = {bm}, LR_BN = {bn}, LR_BK = 64, "
                  f"LR_STAGES = {stages}, LR_S = {s},\n"
                  f"              LR_TI = {ti}, LR_TJ = {tj};")]


EDITS = {
    "k_vt": {
        "cluster 8 (the first design, 128 blocks)": _vt(cl=8),
        "cluster 4, 8 columns a group (128 blocks)": _vt(gc=8),
        "cluster 2 (32 blocks)": _vt(cl=2),
        "cluster 16, non-portable (256 blocks)": _vt(cl=16),
        "no cluster: a block sums a group (16 blocks)": _vt(cl=1),
        "32 columns a group (32 blocks)": _vt(gc=32),
        # wrong on purpose: the parts alone
        "no column sum": [(_VT_ROWS, "const int j1 = 0;")],
        "no product": [(_VT_STORE, "if (true) continue;")],
        "the launch alone": _return_first(_VT_TOP),
    },
    "k_lr": {
        "split 4, 64 x 32 tiles (the first design, 128 blocks)":
            _lr(bm=64, s=4),
        "split 2, 64 x 64 tiles (64 blocks)": _lr(bm=64, bn=64, s=2),
        "split 4, 4 x 8 a lane (256 blocks)": _lr(s=4, ti=4),
        "split 8, 64 x 16 tiles (256 blocks)": _lr(bm=64, bn=16),
        "split 8, 4 x 8 a lane, 32 x 16 tiles (512 blocks)":
            _lr(bn=16, ti=4),
        "split 16, 32 x 16 tiles (512 blocks)": _lr(bn=16, s=16),
        "3 slots": _lr(stages=3),
        # wrong on purpose: the copies, barriers and stores alone
        "no inner loop": [(_LR_FMA, "acc[i * LR_TJ + j] += 0.f;")],
        "the launch alone": _return_first(_LR_TOP),
    },
}
WRONG = ("no column sum", "no product", "no inner loop",
         "the launch alone")
# the launcher's dimension arguments after the three pointers
_DIMS = {"k_vt": lambda NF, TC, TB: (NF, TC, TB),
         "k_lr": lambda NF, TC, TB: (NF, TB, TC)}


def main(seed=0):
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    NF, TC, TB = spike.NF, spike.TC, spike.TB
    for name, edits in EDITS.items():
        sym = f"{name}_launch"
        fns = {"kernel": (rime_cuda._lib("mosaic_spike.cu", sym,
                                         spike._ARGTYPES[name]), ""),
               **build_variants(edits, (sym,), tag=name[2:])}
        a, m = spike.make_args(name, device=dev, seed=seed, distinct=True)
        out = torch.empty((TC, TB) if name == "k_vt" else (NF, TC),
                          device=dev)
        ref = spike.PLAIN[name](a.double(), m.double())
        dims = _DIMS[name](NF, TC, TB)

        def launch(fn):
            rc = fn(a.data_ptr(), m.data_ptr(), out.data_ptr(), *dims,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        lib = spike.LIBRARY[name]
        times = {v: [] for v in fns}
        times["library"] = []
        order = list(times)
        with rime_cuda.no_tf32():
            for v in order + order[::-1]:
                times[v].append(spike.timeit(lib, a, m) if v == "library"
                                else spike.timeit(launch, fns[v][0]))
        base = float(np.mean(times["kernel"]))
        for v, t in times.items():
            line = (f"{name} {v}: {np.mean(t):.4f} ms (turns {t[0]:.4f}, "
                    f"{t[1]:.4f}), {np.mean(t) / base:.3f}x the kernel's")
            if v != "library":
                launch(fns[v][0])
                err = float((out.double() - ref).abs().max()
                            / ref.abs().max())
                line += (f"; rel err vs float64 {err:.2e}"
                         + (" (wrong on purpose)" if v in WRONG else ""))
                if v != "kernel":
                    line += f"; ptxas {_usage(fns[v][1], name)}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
