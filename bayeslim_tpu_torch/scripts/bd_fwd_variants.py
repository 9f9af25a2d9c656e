"""
Design alternatives of k_bd (the scaled product) and k_fwd (the forward
loop) in ``csrc/mosaic_spike.cu``, timed on the card against each kernel
as it is, at the spike's sizes (NF, TC, TB, G = 1024, 256, 256, 8):

    python -m bayeslim_tpu_torch.scripts.bd_fwd_variants

Each variant is the source with a text edit, built with the same nvcc
flags into ``build/kernels/variants/`` (sgemm_variants' build_variants):

- k_bd: candidate (b), k_lr's lane split adapted to m stored [c][b]
  (32 x 32 tiles, 8 lanes an output, m's rows staged with their 16-byte
  chunks XOR-swizzled by row so that a quarter warp reads 8 rows
  without a bank conflict), against the kernel, candidate (a);
- k_fwd: chains a run (2, 8), rows a run (16), slices of c (1, 2, 4),
  the S slices of an output tile as a thread-block cluster that adds
  them through distributed shared memory in one launch (no scratch, no
  sum kernel), and seeds by fw_sincos (a few ulp) instead of the SFU;
- wrong on purpose, parts alone: k_fwd's seeds and table without the
  sum, its seeds and table without the chains and the sum, its loop on
  whatever shared memory holds (no staging), and each kernel's launch
  alone (a kernel that returns at once).

Times are ms per launch, 400 launches in one CUDA graph
(``mosaic_spike.timeit``), in two turns (kernel, variants, library;
then the reverse), each variant beside its relative error against
float64 and its ptxas line. At hera-stat's forward shape (1024, 6144,
630) k_fwd and its slice variants are timed once more, 20 launches.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops import rime_cuda
from . import mosaic_spike as spike
from .sgemm_variants import build_variants

# ---- k_bd candidate (b): k_lr's lane split with m staged [c][b]
_K_ROT = "// ---- k_rot: A_NF m (rho m)^NF by a float-float power"
_BD_LANES = r'''// variant: k_lr's lane split for k_bd, m staged [c][b] with its
// 16-byte chunks swizzled by (row / 4) mod 8
constexpr int BL_BM = 32, BL_BN = 32, BL_BK = 64, BL_LDA = BL_BK + 16;
constexpr int BL_STAGE = BL_BM * BL_LDA + BL_BK * BL_BN;

template <int CH>
__global__ void __launch_bounds__(LR_T)
k_bd_lanes(const float* __restrict__ ps, const float* __restrict__ m,
           float* __restrict__ out, int NF, int TC, int TB, int G)
{
    extern __shared__ __align__(16) float bl_smem[];
    const int q = threadIdx.x % LR_S, g = threadIdx.x / LR_S;
    const int cx = g % 4, ry = g / 4;
    const int m0 = blockIdx.y * BL_BM, n0 = blockIdx.x * BL_BN;
    const int nk = cdiv(TC, BL_BK);
    auto stage = [&](int slot, int kt) {
        float* As = bl_smem + slot * BL_STAGE;
        float* Bs = As + BL_BM * BL_LDA;
        const int k0 = kt * BL_BK;
        sg_stage<CH, BL_BM, BL_BK>(As, BL_LDA, ps, TC, m0, k0, NF, TC);
        constexpr int W = CH / 4, PER_ROW = BL_BN / W;
#pragma unroll
        for (int it = 0; it < BL_BK * PER_ROW / LR_T; ++it) {
            const int i = it * LR_T + threadIdx.x;
            const int r = i / PER_ROW, c = (i % PER_ROW) * W;
            const bool in = k0 + r < TC && n0 + c < TB;
            const int sw = ((c / 4) ^ ((r >> 2) & 7)) * 4 + c % 4;
            cp_async<CH>(Bs + r * BL_BN + sw,
                         in ? m + (size_t)(k0 + r) * TB + n0 + c : m, in);
        }
    };
    if (nk > 0) stage(0, 0);
    cp_async_commit();
    float acc[LR_N] = {};
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<0>();
        __syncthreads();
        if (kt + 1 < nk) stage((kt + 1) % 2, kt + 1);
        cp_async_commit();
        const float* As = bl_smem + (kt % 2) * BL_STAGE;
        const float* Bs = As + BL_BM * BL_LDA;
#pragma unroll
        for (int kk = 0; kk < BL_BK; kk += 4 * LR_S) {
            float a[8][4], b[4][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                *reinterpret_cast<float4*>(a[i]) =
                    *reinterpret_cast<const float4*>(
                        &As[(ry + 4 * i) * BL_LDA + kk + 4 * q]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = kk + 4 * q + e, sw = (k >> 2) & 7;
                *reinterpret_cast<float4*>(b[e]) =
                    *reinterpret_cast<const float4*>(
                        &Bs[k * BL_BN + ((2 * cx) ^ sw) * 4]);
                *reinterpret_cast<float4*>(b[e] + 4) =
                    *reinterpret_cast<const float4*>(
                        &Bs[k * BL_BN + ((2 * cx + 1) ^ sw) * 4]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i * 8 + j] = fmaf(a[i][e], b[e][j],
                                              acc[i * 8 + j]);
        }
    }
    lr_scatter<1, LR_N / 2>(acc, q);
    int start = 0;
#pragma unroll
    for (int s = 1, h = LR_N / 2; s < LR_S; s *= 2, h /= 2)
        if (q & s) start += h;
#pragma unroll
    for (int e = 0; e < LR_N / LR_S; ++e) {
        const int idx = start + e;
        const int r = m0 + ry + 4 * (idx / 8), c = n0 + 8 * cx + idx % 8;
        if (r < NF && c < TB)
            out[(size_t)r * TB + c] = (1.f + (float)(r % G)) * acc[e];
    }
}

'''
_BD_LAUNCH = '''    return launch_sgemm<false>(k_bd<16>, k_bd<4>, ps, m, out, NF, TB, TC,
                               static_cast<cudaStream_t>(stream), G);'''
_BD_LAUNCH_LANES = '''    const bool vec = TC % 4 == 0 && TB % 4 == 0 && aligned16(ps)
        && aligned16(m);
    auto kernel = vec ? k_bd_lanes<16> : k_bd_lanes<4>;
    const int smem = 2 * BL_STAGE * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(cdiv(TB, BL_BN), cdiv(NF, BL_BM)), LR_T, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ps), static_cast<const float*>(m),
        static_cast<float*>(out), NF, TC, TB, G);
    return static_cast<int>(cudaGetLastError());'''
_SG_TOP = "    extern __shared__ __align__(16) float sg_smem[];"

# ---- k_fwd
_FW = ("constexpr int FW_RT = 32;              // rows k a run\n"
       "constexpr int FW_CH = 4;               // chains of a run")
_FW_SLICES = "    const int cslice = cdiv(ntk, best) * FW_TK;"
_FW_TOP = "    extern __shared__ __align__(16) float fw_smem[];"
_FW_SEED = "    __sincosf(hi + lo, &s, &c);"
_FW_LOOP = "                for (int j = 0; j < FW_RT / FW_CH; ++j) {"
_FW_SUM = ("                        acc_re[r] = fmaf(p, ec[g0 + g], acc_re[r]);\n"
           "                        acc_im[r] = fmaf(p, es[g0 + g], acc_im[r]);")
_FW_FIRST = "    if (ntile > 0) stage(0, 0);"
_FW_NEXT = "        if (it + 1 < ntile) stage((it + 1) % 2, it + 1);"
_FW_TAIL = '''    // this slice's sums: straight to the output when the plan has one
    // slice, else to slice z of the scratch part [z][re, im][k][b], which
    // fw_sum adds in order
    if (k0 < NF && b0 + tx < TB) {'''
_FW_TAIL_CLUSTER = '''    // variant: the S blocks of an output tile are a cluster; each writes
    // its partial sums to its shared memory, then adds a 1 / S share of
    // the tile's outputs over the ranks in rank order
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    __syncthreads();                           // the slots are free
    float* pt = fw_smem;                       // [re, im][row][b]
#pragma unroll
    for (int r = 0; r < FW_RT; ++r) {
        pt[(ty * FW_RT + r) * FW_TN + tx] = acc_re[r];
        pt[FW_TR * FW_TN + (ty * FW_RT + r) * FW_TN + tx] = acc_im[r];
    }
    cluster.sync();
    const int per = cdiv(FW_TR, S);
    const int r_lo = min(FW_TR, rank * per), r_hi = min(FW_TR, r_lo + per);
    constexpr int V = FW_TN / 4;
    for (int i = tid; i < 2 * (r_hi - r_lo) * V; i += FW_T) {
        const int plane = i / ((r_hi - r_lo) * V);
        const int e = i % ((r_hi - r_lo) * V);
        const int r = r_lo + e / V, n = (e % V) * 4;
        const int o = (plane * FW_TR + r) * FW_TN + n;
        float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(pt, 0) + o);
        for (int z = 1; z < S; ++z) {
            const float4 u = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(pt, z) + o);
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
        }
        const int k = row0 + r;
        if (k < NF) {
            float* dst = (plane ? oim : ore) + (size_t)k * TB + b0 + n;
            const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (b0 + n + q < TB) dst[q] = vs[q];
        }
    }
    cluster.sync();
    if (NF >= 0) return;
    if (k0 < NF && b0 + tx < TB) {'''
_FW_LAUNCH = '''    k_fwd<<<p.grid, FW_T, p.smem, s>>>(static_cast<const float*>(tau),
                                       static_cast<const float*>(ps), re, im,
                                       pt, TC, TB, NF, p.cslice);
    err = cudaGetLastError();'''
_FW_LAUNCH_CLUSTER = '''    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = p.grid.z;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = p.grid;
    cfg.blockDim = dim3(FW_T);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, k_fwd, static_cast<const float*>(tau),
                             static_cast<const float*>(ps), re, im, pt, TC,
                             TB, NF, p.cslice);
    if (err != cudaSuccess || NF >= 0) return (int)err;
    err = cudaGetLastError();'''


def _return_first(top, dims="NF"):
    return [(top, f"    if ({dims} >= 0) return;\n" + top)]


def _fw(rt=32, ch=4):
    return [(_FW, f"constexpr int FW_RT = {rt};              // rows k a run\n"
                  f"constexpr int FW_CH = {ch};               // chains of a run")]


def _slices(s):
    return [(_FW_SLICES, f"    const int cslice = cdiv(ntk, {s}) * FW_TK;")]


EDITS = {
    "k_bd": {
        "(b) k_lr's lane split, m [c][b] swizzled (256 blocks)": [
            (_K_ROT, _BD_LANES + _K_ROT), (_BD_LAUNCH, _BD_LAUNCH_LANES)],
        "the launch alone": _return_first(_SG_TOP, "M"),
    },
    "k_fwd": {
        "2 chains": _fw(ch=2),
        "8 chains": _fw(ch=8),
        "16 rows a run (4 chains)": _fw(rt=16),
        "1 slice (no scratch, no sum kernel)": _slices(1),
        "2 slices": _slices(2),
        "4 slices": _slices(4),
        "a cluster of the S slices, summed in distributed shared memory "
        "(one launch)": [(_FW_TAIL, _FW_TAIL_CLUSTER),
                         (_FW_LAUNCH, _FW_LAUNCH_CLUSTER)],
        "accurate seeds (fw_sincos of x, then xe)": [(_FW_SEED, (
            "    fw_sincos(x, s, c);\n"
            "    const float s0 = s;\n"
            "    s = fmaf(c, xe, s);\n"
            "    c = fmaf(-s0, xe, c);"))],
        # wrong on purpose: the parts alone
        "no sum (seeds, table, chains)": [(_FW_SUM, (
            "                        if (j == FW_RT / FW_CH - 1) {\n"
            "                            acc_re[g] += ec[g0 + g];\n"
            "                            acc_im[g] += es[g0 + g];\n"
            "                        }"))],
        "seeds and table alone": [(_FW_LOOP, (
            "                acc_re[0] += ec[2 * FW_CH - 1];\n"
            "                acc_im[0] += es[2 * FW_CH - 1];\n"
            "                for (int j = 0; j < 0; ++j) {"))],
        "no staging": [(_FW_FIRST, "    if (false) stage(0, 0);"),
                       (_FW_NEXT, "        if (false) stage(0, 0);")],
        "the launch alone": _return_first(_FW_TOP),
    },
}
WRONG = ("the launch alone", "no sum (seeds, table, chains)",
         "seeds and table alone", "no staging")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _usage(report, kernel):
    """ptxas's 'Used ...' lines of kernel's instances."""
    lines, out = report.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            for nxt in lines[i + 1:i + 5]:
                if "Used" in nxt:
                    out.append(nxt.split(":", 1)[1].strip())
                    break
    return " | ".join(out) or "?"


def _time(name, fns, args, outs, dims, lib, dev, n, sizes, extra=()):
    """Time each launcher of fns on args (and lib) in two turns; print
    each beside its error against float64. extra: pointers the launcher
    takes after the outputs'."""
    ref = spike.PLAIN[name](*[a.double() if isinstance(a, torch.Tensor)
                              else a for a in args])
    ref = ref if isinstance(ref, tuple) else (ref,)
    ptrs = [a.data_ptr() for a in args if isinstance(a, torch.Tensor)]
    ptrs += [o.data_ptr() for o in outs] + list(extra)

    def launch(fn):
        rc = fn(*ptrs, *dims, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    times = {v: [] for v in fns}
    times.update({k: [] for k in lib})
    order = list(times)
    with rime_cuda.no_tf32():
        for v in order + order[::-1]:
            times[v].append(spike.timeit(lib[v], *args, n=n) if v in lib
                            else spike.timeit(launch, fns[v][0], n=n))
    base = float(np.mean(times["kernel"]))
    for v, t in times.items():
        line = (f"{name} {sizes} {v}: {np.mean(t):.5f} ms (turns "
                f"{t[0]:.5f}, {t[1]:.5f}), {np.mean(t) / base:.3f}x the "
                f"kernel's")
        if v not in lib:
            launch(fns[v][0])
            torch.cuda.synchronize()
            err = max(float((o.double() - r).abs().max()) for o, r in
                      zip(outs, ref)) / max(float(r.abs().max()) for r in ref)
            line += (f"; rel err vs float64 {err:.2e}"
                     + (" (wrong on purpose)" if v in WRONG else ""))
            if v != "kernel":
                line += f"; ptxas {_usage(fns[v][1], name)}"
        print(line, flush=True)


def main(seed=0):
    dev = torch.device("cuda")
    print(_card(), flush=True)
    built = {}
    for name, edits in EDITS.items():
        sym = f"{name}_launch"
        built[name] = {"kernel": (rime_cuda._lib("mosaic_spike.cu", sym,
                                                 spike._ARGTYPES[name]), ""),
                       **build_variants(edits, (sym,), tag=name[2:])}
    NF, TC, TB, G = spike.NF, spike.TC, spike.TB, spike.G
    ps, m, _ = spike.make_args("k_bd", device=dev, seed=seed, distinct=True)
    out = torch.empty((NF, TB), device=dev)
    _time("k_bd", built["k_bd"], (ps, m, G), [out], (NF, TC, TB, G),
          {"library (ps * scale) @ m": spike.LIBRARY["k_bd"],
           "torch.matmul(ps, m) alone": lambda ps, m, G: torch.matmul(ps, m)},
          dev, 400, (NF, TC, TB))
    for (nf, tc, tb), n, keep in (((NF, TC, TB), 400, None),
                                  ((1024, 6144, 630), 20,
                                   ("kernel", "1 slice (no scratch, no "
                                    "sum kernel)", "2 slices", "4 slices",
                                    "2 chains", "8 chains",
                                    "a cluster of the S slices, summed in "
                                    "distributed shared memory (one "
                                    "launch)"))):
        tau, psf, _ = spike.make_args("k_fwd", nf, tc, tb, G, device=dev,
                                      seed=seed, distinct=True)
        outs = [torch.empty((nf, tb), device=dev) for _ in range(2)]
        part = torch.empty((8, 2, nf, tb), device=dev)
        fns = {v: f for v, f in built["k_fwd"].items()
               if keep is None or v in keep}
        _time("k_fwd", fns, (tau, psf, G), outs, (tc, tb, nf), {}, dev, n,
              (nf, tc, tb), extra=[part.data_ptr()])


if __name__ == "__main__":
    main()
