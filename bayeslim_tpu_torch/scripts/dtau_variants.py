"""
Design alternatives of the rime_dtau kernel (``csrc/rime_dtau.cu``),
timed on the card against the kernel as it is, at the hera-cal shape
(R = nf = 1024 rows, K = 6144 pixels, N = 630 baselines):

    python -m bayeslim_tpu_torch.scripts.dtau_variants

Each variant is the kernel's source with a few text edits, built with
the same nvcc flags into ``build/kernels/variants/``:

- ``rotation``: each row's phasor by a rotation E <- E D (4 FMA-pipe
  instructions a row, one chain a pass) in place of two-term blocks of 8
  rows from rotated anchors (~2.5 a row);
- ``one block an SM``: ``__launch_bounds__(256, 1)``, so no cap of 128
  registers, but 8 warps an SM in place of 16;
- ``no seeds``, ``no barrier``: the pass seeds or the end-of-pass
  barrier left out. Their results are wrong; their times say what the
  part costs.

For real and complex ps it prints each variant's time (ms per launch,
CUDA events over 20 launches, two turns: kernel, variants, variants
reversed, kernel), its ratio to the kernel's, and for the first two the
relative error against the float64 plain version on the card.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from ..ops import rime_cuda

# the two-term block and the anchor step of csrc/rime_dtau.cu
_TWO_TERM = """                    if (j == 0) {
                        ec[o] = ac[o];
                        es[o] = as[o];
                    } else if (j == 1) {
                        pc[o] = ec[o];
                        pz[o] = es[o];
                        cmul(ac[o], as[o], dc[o], ds[o], ec[o], es[o]);
                    } else {"""
_ROTATION = """                    if (lb == 0 && j == 0) {
                        ec[o] = ac[o];
                        es[o] = as[o];
                    } else if (true) {
                        float c, s;
                        cmul(ec[o], es[o], dc[o], ds[o], c, s);
                        ec[o] = c;
                        es[o] = s;
                    } else {"""
_ANCHOR = "            if (lb + 1 < RUN / LB) {"
_BARRIER = "        cp_async_wait_all();\n        __syncthreads();\n    }"

EDITS = {
    "rotation": [(_TWO_TERM, _ROTATION), (_ANCHOR, "            if (false) {")],
    "one block an SM": [("__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 1)")],
    "no seeds": [("run_seed(T.x, T.y, T.z, (float)q.k0, sgn, ac[o], as[o]);",
                  "ac[o] = T.x;\n            as[o] = T.y;")],
    "no barrier": [(_BARRIER, "    }\n    cp_async_wait_all();")],
}
CHECKED = ("rotation", "one block an SM")       # the others are wrong on purpose


def build_variants():
    """{name: C launcher} of every variant, nvcc started for all at once."""
    src = (rime_cuda._CSRC / "rime_dtau.cu").read_text()
    out_dir = rime_cuda._BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(EDITS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: csrc/rime_dtau.cu no "
                                   f"longer holds {old[:40]!r}")
            text = text.replace(old, new)
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [rime_cuda._nvcc(), *rime_cuda.NVCC_FLAGS, "-I",
             str(rime_cuda._CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{report}")
        fn = ctypes.CDLL(str(lib)).rime_dtau_launch
        fn.argtypes = rime_cuda._DTAU_ARGS
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(R=1024, K=6144, N=630, seed=0):
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernel = rime_cuda._lib("rime_dtau.cu", "rime_dtau_launch",
                            rime_cuda._DTAU_ARGS)
    fns = {"kernel": kernel, **build_variants()}
    f0, df = 100e6, 100e6 / (R - 1)
    rng = np.random.default_rng(seed)
    for ps_real in (True, False):
        ps = rng.standard_normal((R, K))
        if not ps_real:
            ps = ps + 1j * rng.standard_normal((R, K))
        ct = rng.standard_normal((R, N)) + 1j * rng.standard_normal((R, N))
        ps = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                             else torch.complex64, device=dev)
        ct = torch.as_tensor(ct, dtype=torch.complex64, device=dev)
        tau = torch.as_tensor(rng.uniform(-1e-6, 1e-6, (K, N)),
                              dtype=torch.float32, device=dev)

        def run(name):
            return rime_cuda._launch_dtau(fns[name], ct, ps, tau, f0, df, R,
                                          False)
        ref = rime_cuda.rime_dtau_plain(
            ct.to(torch.complex128),
            ps.to(torch.float64 if ps_real else torch.complex128),
            tau.double(), f0, df, R)
        times = {name: [] for name in fns}
        order = list(fns)
        for name in order + order[::-1]:
            times[name].append(_ms(lambda: run(name)))
        base = float(np.mean(times["kernel"]))
        for name, t in times.items():
            line = (f"rime_dtau {name} ps_real={ps_real} R={R} K={K} N={N}: "
                    f"{np.mean(t):.4f} ms (turns {t[0]:.4f}, {t[1]:.4f}), "
                    f"{np.mean(t) / base:.3f}x the kernel's")
            if name == "kernel" or name in CHECKED:
                err = float((run(name).double() - ref).abs().max()
                            / ref.abs().max())
                line += f"; rel err vs float64 {err:.2e}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
