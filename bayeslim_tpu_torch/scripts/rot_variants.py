"""
Design alternatives of k_rot (``csrc/mosaic_spike.cu``: A_NF m (rho
m)^NF by a float-float power), timed on the card against the kernel as
it is:

    python -m bayeslim_tpu_torch.scripts.rot_variants

Each variant is the source with a text edit, built with the same nvcc
flags into ``build/kernels/variants/`` (sgemm_variants' build_variants):

- other algorithms: the first design (the TPU body's NF-step loop, one
  element a thread; the phasor recurrence's floor that rime_fwd was
  once held against), a complex float-float power of w = m (0.9 + 0.1
  i) (the general rotation, no closed form), and a plain float32 power
  of w (repeated squaring; its error shows why float-float is needed);
- other layouts: one element a thread (4-byte loads), 8 elements a
  thread (two float4s), one group a thread (a grid of n / 4 threads, no
  grid-stride loop), no prefetch (each group loaded at the top of its
  own iteration), and the loop over NF's bits unrolled by 1 (not at
  all), 2 or 8 instead of 4;
- wrong on purpose, parts alone: memory alone (the loads and stores, no
  power) and the launch alone (a kernel that returns at once).

Times are ms per launch at NF = 1024, 400 launches in one CUDA graph
(``mosaic_spike.timeit``) at the script's shape (256 x 256) on mk's
inputs, and 100 at hera-stat's forward shape (6144 x 630) on mk's and
unit_m's inputs, L2 warm, and 20 there with L2 emptied before each
launch (``mosaic_spike.timeit_flushed``); each in two turns (kernel,
variants; then the reverse), beside the variant's relative error
against float64 on unit_m's inputs at NF = 1024 and 16384 and its ptxas
line. The last line names the fastest variant at hera-stat's shape that
holds 1e-6 at both NF.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops import rime_cuda
from . import mosaic_spike as spike
from .sgemm_variants import build_variants

_POW = "__device__ __forceinline__ void rot_pow(float (&v)[V], unsigned NF, FF a,"
_LOADS = "// group g of V elements: V / 4 float4s, or one float"
_FWD = "// ---- k_fwd: the forward loop"
_TOP = ('    static_assert(V == 1 || V % 4 == 0, "one element or float4s a '
        'thread");')
_CALL = "        rot_pow<V>(v, (unsigned)NF, a, rho);"
_PREFETCH = """    float next[V];
    if (g < groups) rot_load<V>(next, m, g);
    for (; g < groups; g += stride) {
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = next[e];
        if (g + stride < groups) rot_load<V>(next, m, g + stride);"""
_NO_PREFETCH = """    for (; g < groups; g += stride) {
        float v[V];
        rot_load<V>(v, m, g);"""
_BITS = "#pragma unroll 4\n    for (; k > 1; k >>= 1) {"
_VEC = "    const bool vec = aligned16(m) && aligned16(out);"
_V4 = """    const int V = vec ? 4 : 1;
    auto kernel = vec ? k_rot<4> : k_rot<1>;"""
_GRID = "std::min(cdiv(n / V, ROT_T), wave[vec])"
_DISPATCH = """    kernel<<<grid, ROT_T, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(m), static_cast<float*>(out), n, NF, a_hi,
        a_lo, rho_hi, rho_lo);"""

# the first design: one thread per element, the TPU body's NF rotations
_LOOP = """// variant: the first design, the NF-step loop
__global__ void __launch_bounds__(ROT_T)
k_rot_loop(const float* __restrict__ m, float* __restrict__ out, int n,
           int NF)
{
    const int i = blockIdx.x * ROT_T + threadIdx.x;
    if (i >= n) return;
    const float mv = m[i];
    const float cd = mv * 0.9f, sd = mv * 0.1f;
    float c = mv, s = mv * 0.5f;
    for (int j = 0; j < NF; ++j) {
        const float cn = c * cd - s * sd;
        s = s * cd + c * sd;
        c = cn;
    }
    out[i] = c + s;
}

"""
_LOOP_DISPATCH = """    (void)grid;
    k_rot_loop<<<cdiv(n, ROT_T), ROT_T, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(m), static_cast<float*>(out), n, NF);"""


def _hex(x):
    return float(np.float32(x)).hex() + "f"


def _pair(x):
    hi = np.float32(x)
    return _hex(hi), _hex(x - float(hi))


# the general rotation: z0 w^NF in complex float-float, z0 = m (1 + i/2),
# w = m (0.9 + 0.1 i) with 0.9 and 0.1 as float pairs
_CPOW = """// variant: a complex float-float power of w
__device__ __forceinline__ FF ff_add(FF a, FF b)
{
    const float s = __fadd_rn(a.h, b.h);
    const float bb = __fsub_rn(s, a.h);
    const float e = __fadd_rn(__fadd_rn(__fsub_rn(a.h, __fsub_rn(s, bb)),
                                        __fsub_rn(b.h, bb)),
                              __fadd_rn(a.l, b.l));
    const float h = __fadd_rn(s, e);
    return {h, __fsub_rn(e, __fsub_rn(h, s))};
}

template <int V>
__device__ __forceinline__ void rot_pow(float (&v)[V], unsigned NF, FF, FF)
{
    const FF c9 = {%s, %s}, c1 = {%s, %s};
    FF zr[V], zi[V], wr[V], wi[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
        zr[e] = {v[e], 0.f};
        zi[e] = {__fmul_rn(0.5f, v[e]), 0.f};
        wr[e] = ff_mul1(c9, v[e]);
        wi[e] = ff_mul1(c1, v[e]);
    }
    for (unsigned k = NF; k; k >>= 1) {
        if (k & 1) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const FF bd = ff_mul(zi[e], wi[e]);
                const FF re = ff_add(ff_mul(zr[e], wr[e]), {-bd.h, -bd.l});
                zi[e] = ff_add(ff_mul(zr[e], wi[e]), ff_mul(zi[e], wr[e]));
                zr[e] = re;
            }
        }
        if (k > 1) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const FF b2 = ff_sqr(wi[e]);
                const FF t = ff_mul(wr[e], wi[e]);
                wr[e] = ff_add(ff_sqr(wr[e]), {-b2.h, -b2.l});
                wi[e] = {__fmul_rn(2.f, t.h), __fmul_rn(2.f, t.l)};
            }
        }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = ff_add(zr[e], zi[e]).h;
}

""" % (*_pair(0.9), *_pair(0.1))

# a plain float32 complex power of w by repeated squaring
_FPOW = """// variant: a plain float32 power of w
template <int V>
__device__ __forceinline__ void rot_pow(float (&v)[V], unsigned NF, FF, FF)
{
    float zr[V], zi[V], wr[V], wi[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
        zr[e] = v[e];
        zi[e] = 0.5f * v[e];
        wr[e] = 0.9f * v[e];
        wi[e] = 0.1f * v[e];
    }
    for (unsigned k = NF; k; k >>= 1) {
        if (k & 1) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const float re = zr[e] * wr[e] - zi[e] * wi[e];
                zi[e] = zr[e] * wi[e] + zi[e] * wr[e];
                zr[e] = re;
            }
        }
        if (k > 1) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const float re = wr[e] * wr[e] - wi[e] * wi[e];
                wi[e] = 2.f * wr[e] * wi[e];
                wr[e] = re;
            }
        }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = zr[e] + zi[e];
}

"""


def _unroll(n):
    return [(_BITS, _BITS.replace("unroll 4", f"unroll {n}"))]


def _replace_pow(text):
    """The kernel's rot_pow renamed out of the way and text, another
    rot_pow of the same signature, put before the kernel."""
    return [(_POW, _POW.replace("rot_pow(", "rot_pow_unused(")),
            (_LOADS, text + _LOADS)]


EDITS = {
    "the first design (the NF-step loop, one element a thread)": [
        (_FWD, _LOOP + _FWD), (_DISPATCH, _LOOP_DISPATCH)],
    "a complex float-float power of w": _replace_pow(_CPOW),
    "a plain float32 power of w": _replace_pow(_FPOW),
    "one element a thread (4-byte loads)": [
        (_VEC, "    const bool vec = false;")],
    "8 elements a thread (two float4s)": [(_V4, _V4.replace("4", "8"))],
    "one group a thread (no grid-stride loop)": [(_GRID, "cdiv(n / V, ROT_T)")],
    "no prefetch": [(_PREFETCH, _NO_PREFETCH)],
    "the bit loop not unrolled": _unroll(1),
    "the bit loop unrolled by 2": _unroll(2),
    "the bit loop unrolled by 8": _unroll(8),
    # wrong on purpose: the parts alone
    "memory alone (no power)": [(_CALL, """#pragma unroll
        for (int e = 0; e < V; ++e) v[e] *= a_hi;""")],
    "the launch alone": [(_TOP, "    if (NF >= 0) return;\n" + _TOP)],
}
WRONG = ("memory alone (no power)", "the launch alone")
ERR_NF = (1024, 16384)
HERA = (6144, 630)


def _usage(report):
    """ptxas's 'Used ...' lines of k_rot's instances (and k_rot_loop)."""
    lines, out = report.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "k_rot" in ln:
            for nxt in lines[i + 1:i + 5]:
                if "Used" in nxt:
                    out.append(nxt.split(":", 1)[1].strip())
                    break
    return " | ".join(out) or "?"


def main(seed=0):
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fns = {"kernel": (rime_cuda._lib("mosaic_spike.cu", "k_rot_launch",
                                     spike._ARGTYPES["k_rot"]), ""),
           **build_variants(EDITS, ("k_rot_launch",), tag="rot")}

    def launcher(fn, m, out, nf):
        consts = spike.rot_consts(nf)

        def launch():
            rc = fn(m.data_ptr(), out.data_ptr(), m.numel(), nf, *consts,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return launch

    # errors on unit_m's inputs at the script's shape
    m = spike.unit_m((spike.TC, spike.TB), seed, dev)
    out = torch.empty_like(m)
    errs = {v: [] for v in fns}
    for nf in ERR_NF:
        ref = spike.run_rot_plain(m.double(), nf)
        for v, (fn, _) in fns.items():
            launcher(fn, m, out, nf)()
            torch.cuda.synchronize()
            errs[v].append(float((out.double() - ref).abs().max()
                                 / ref.abs().max()))

    # times at NF = 1024: (label, input, n, timer)
    runs = [("script mk", spike.mk((spike.TC, spike.TB), seed, dev), 400,
             spike.timeit),
            ("hera mk", spike.mk(HERA, seed, dev), 100, spike.timeit),
            ("hera unit_m", spike.unit_m(HERA, seed, dev), 100, spike.timeit),
            ("hera mk L2 flushed", spike.mk(HERA, seed, dev), 20,
             spike.timeit_flushed)]
    times = {(r, v): [] for r, *_ in runs for v in fns}
    order = list(fns)
    for v in order + order[::-1]:
        for label, x, n, timer in runs:
            o = torch.empty_like(x)
            times[label, v].append(timer(launcher(fns[v][0], x, o, 1024),
                                         n=n))
    for label, *_ in runs:
        base = float(np.mean(times[label, "kernel"]))
        for v in fns:
            t = times[label, v]
            line = (f"k_rot {label} {v}: {np.mean(t):.5f} ms (turns "
                    f"{t[0]:.5f}, {t[1]:.5f}), {np.mean(t) / base:.3f}x the "
                    f"kernel's; rel err vs float64 at NF = "
                    + ", ".join(f"{nf}: {e:.2e}" for nf, e in
                                zip(ERR_NF, errs[v]))
                    + (" (wrong on purpose)" if v in WRONG else ""))
            if v != "kernel":
                line += f"; ptxas {_usage(fns[v][1])}"
            print(line, flush=True)
    held = [v for v in fns if v not in WRONG and max(errs[v]) <= 1e-6]
    best = min(held, key=lambda v: np.mean(times["hera mk", v]))
    print(f"k_rot: fastest at hera-stat's shape within 1e-6 of float64: "
          f"{best}", flush=True)


if __name__ == "__main__":
    main()
