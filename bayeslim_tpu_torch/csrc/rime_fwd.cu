// Fused RIME phasor reduction for NVIDIA Hopper (sm_90a).
//
//   out[r, n] = sum_c ps[r, c] * exp(i * sgn * 2 pi * f_r * tauT[c, n])
//   f_r = f0 + (r mod nf) * df,   sgn = -1 if conj else +1
//
// Replaces the TPU kernel bayeslim_tpu/ops/rime_pallas.py::_fwd_kernel
// (:298, launched by _fwd_pallas). The RIME forward calls it with the
// sky rows as ps (R = Nstack * Nfreqs, K = Npix) and tauT = s^T b^T / c
// (K x Nbls); the backward calls it again with the roles swapped (the
// complex cotangent as ps, K = Nbls, N = Npix) for the sky gradient.
//
// ps is float32 (R, K) or interleaved complex64 (R, K); tauT is float32
// (K, N), and tauT_lo, when given (else null), its float32 residual:
// the delay is tauT + tauT_lo. out is interleaved complex64 (R, N), or
// float32 (R, N) with only the real plane when out_imag is 0. All
// row-major, contiguous.
//
// What bounds it on this card: FP32 instruction issue. Every (r, c, n)
// triple needs a unit phasor and 2-4 FMAs, while each input byte is
// read once per tile: about 4e9 triples against ~50 MB of operands at
// the hera-stat shapes, so operations outweigh bytes by three orders of
// magnitude. Whatever is not the FMAs of the sum (the phasor, its seed,
// the staging of tiles) is issue slots or stalls on top of the bound.
// What the design does about it:
//
// - Runs of 32 rows. A thread owns one column n and a run of RT = 32
//   consecutive channels of one stacked block (each block of nf rows is
//   cut into ceil(nf / 32) runs, the last one ragged and masked, so no
//   run crosses a block and nothing wraps), its 32 or 64 sums in
//   registers. Per (c, n) a run needs one seed, then one complex step a
//   row.
// - Exact float seeds, no FP64 (cycles and run_seed, phasor.cuh, shared
//   with rime_dtau.cu). For every (c, n) of a K tile the block
//   tabulates in shared memory c0 = f0 tau mod 1 and c1 = df tau mod 1,
//   from f0 and df split on the host into float parts a + b + lo
//   (rime_cuda._split_f32, the TPU kernel's split): a t and b t are
//   taken exactly as x + xe with xe = fmaf(a, t, -x) (_seed_cycles'
//   rule), summed with TwoSum, and c1 is kept as a pair c1h + c1l, since
//   its error is multiplied by the channel. Beside them the step D and
//   D^4 (sincospif, whose 1-ulp results the chains raise to powers).
//   The table is shared by the block's 8 runs. A run seeds at its first
//   channel k0 with (c0 + k0 c1) mod 1, k0 c1h = p + pe exactly
//   (pe = fmaf(k0, c1h, -p): _phase0's 12-bit split without its
//   k0 < 4096 limit; exact for k0 < 2^24, which the wrapper enforces),
//   reduced to [-1/2, 1/2], and takes its sin/cos from the SFU
//   (__sincosf, at most 2^-21.41 absolute error there, in a few
//   instructions where sincospif takes a polynomial). Remainders are
//   x - rint(x), exact for every float (x - floor(x) rounds for small
//   negative x). A float32 delay of ~1e-6 s is itself rounded by up to
//   6e-14 s, 7.5e-5 rad of phase at 200 MHz; a caller that has the
//   delay in float64 passes the rounding's residual tauT_lo, and the
//   table adds f tau_lo (|f tau_lo| < 2e-5 cycles) to the low parts of
//   c0 and c1 in float32.
// - Chains: rows 1-7 come from the seed by D, D^2 = D D and D^4, three
//   products deep; then 4 chains over rows g + 4j advance by the
//   two-term recurrence e_{j+1} = 2 Re(D^4) e_j - e_{j-1}, one FMA per
//   component and row (a rotation by D^4 takes two). No chain takes more
//   than 6 steps, so its float32 error stays near 1e-6 for every delay,
//   zero included (tests/test_torch_rime_seed.py models it).
// - Tiles: a block owns 32 columns x 8 runs (256 threads, two blocks an
//   SM) and loops over its slice of K in 32-wide tiles, ps staged
//   transposed ([c][row], a warp reads its 32 rows as eight float4
//   broadcasts), tau coalesced along n. Each thread issues all of its
//   staging loads before any store: stores to shared memory would order
//   each next load behind them, one global round trip per element.
//   Shared memory is dynamic (67 KB real ps, 100 KB complex).
// - Enough blocks, deterministic sums: the forward shape has only 80
//   blocks, so K is split over grid.z into S slices that write partial
//   sums to a scratch buffer (S, R, N); rime_fwd_sum adds the slices in
//   a fixed order. No atomics: two launches on the same inputs are
//   bit-equal. S comes from ops/rime_cuda.py::fwd_plan (S = 1 writes
//   the output directly).
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "phasor.cuh"

namespace {

constexpr int RT = 32;           // rows per run (one thread's rows)
constexpr int TN = 32;           // output columns per block (threads in x)
constexpr int RG = 8;            // runs per block (threads in y, one warp each)
constexpr int TR = RG * RT;      // staged rows per block
constexpr int TK = 32;           // contraction tile
constexpr int NT = TN * RG;      // threads per block
constexpr int PS_LD = TR + 4;    // staged ps row stride (float4-aligned)

template <bool PS_REAL, bool OUT_IMAG>
__device__ __forceinline__ void mac(float& re, float& im, float pr, float pi,
                                    float c, float s)
{
    if constexpr (PS_REAL) {
        re = fmaf(pr, c, re);
        if constexpr (OUT_IMAG) im = fmaf(pr, s, im);
    } else {
        re = fmaf(pr, c, fmaf(-pi, s, re));
        if constexpr (OUT_IMAG) im = fmaf(pr, s, fmaf(pi, c, im));
    }
}

constexpr size_t smem_bytes(bool ps_real)
{
    return (size_t)TK * TN * 2 * sizeof(float4)
        + (size_t)TK * PS_LD * sizeof(float) * (ps_real ? 1 : 2)
        + (size_t)TR * sizeof(int);
}

// rps: runs per stacked block, ceil(nf / RT); nruns = nstack * rps.
// Slice z of grid.z covers c in [z * cslice, (z + 1) * cslice) and
// writes at out + z * slice_stride.
template <bool PS_REAL, bool OUT_IMAG>
__global__ void __launch_bounds__(NT, 2)
rime_fwd_kernel(const float* __restrict__ ps, const float* __restrict__ tauT,
                const float* __restrict__ tauT_lo, float* __restrict__ out,
                size_t slice_stride, int K, int N, int nf, int rps,
                int nruns, int cslice, Split sp, float sgn)
{
    static_assert(TK == TN && NT % TK == 0 && (TR / (NT / TK)) % 4 == 0
                  && (TK * TN) % NT == 0, "tiling");
    extern __shared__ float4 smem[];
    float4* tab = smem;                                        // [TK][TN]
    float4* tab2 = tab + TK * TN;                              // [TK][TN]
    float* ps_re = reinterpret_cast<float*>(tab2 + TK * TN);   // [TK][PS_LD]
    float* ps_im = ps_re + TK * PS_LD;                         // complex only
    int* rowof = reinterpret_cast<int*>(ps_im + (PS_REAL ? 0 : TK * PS_LD));

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TN + tx;
    const int n = blockIdx.x * TN + tx;
    const int run = blockIdx.y * RG + ty;
    const bool active = run < nruns;                // uniform over the warp
    const int k0 = (run % rps) * RT;                // first channel of the run
    const float k0f = (float)k0;
    const int c_begin = blockIdx.z * cslice;
    const int c_end = min(K, c_begin + cslice);

    // the ps row of each staged row, -1 where a run is ragged or absent
    for (int i = tid; i < TR; i += NT) {
        const int q = blockIdx.y * RG + i / RT;
        const int k = (q % rps) * RT + i % RT;
        rowof[i] = (q < nruns && k < nf) ? (q / rps) * nf + k : -1;
    }

    float acc_re[RT], acc_im[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        acc_re[i] = 0.f;
        acc_im[i] = 0.f;
    }
    __syncthreads();

    for (int kt = c_begin; kt < c_end; kt += TK) {
        const int kmax = min(TK, c_end - kt);
        // this thread's delays of the tile's phase table (loaded first, so
        // that they are in flight with the ps loads)
        constexpr int TAB = TK * TN / NT;         // entries a thread
        float t[TAB], tl[TAB];
#pragma unroll
        for (int m = 0; m < TAB; ++m) {
            const int i = tid + m * NT, cc = i / TN;
            const int col = blockIdx.x * TN + i % TN;
            const bool in = cc < kmax && col < N;
            const size_t at = (size_t)(kt + cc) * N + col;
            t[m] = in ? tauT[at] : 0.f;
            tl[m] = (in && tauT_lo) ? tauT_lo[at] : 0.f;
        }
        // ps staged transposed: this thread's column c = kt + tx, rows
        // ty, ty + NT / TK, ... (a warp reads 32 consecutive c of a row).
        // All row indices, then all loads of a part are issued before any
        // store, so the loads are in flight together (stores to shared
        // memory would otherwise order each index read after the last
        // store). Complex ps goes in four parts, to stay within 128
        // registers; real ps in two, fewer round trips for a 4-byte spill
        // of the out_imag variant (chip_smoke.py phase 1 reports it).
        const bool c_in = tx < kmax;
        constexpr int PARTS = PS_REAL ? 2 : 4;
        constexpr int PER = TR / (NT / TK) / PARTS;   // elements a part
#pragma unroll
        for (int part = 0; part < PARTS; ++part) {
            int rows[PER];
            float vr[PER], vi[PER];
#pragma unroll
            for (int m = 0; m < PER; ++m)
                rows[m] = rowof[ty + (NT / TK) * (part * PER + m)];
#pragma unroll
            for (int m = 0; m < PER; ++m) {
                vr[m] = 0.f;
                vi[m] = 0.f;
                if (rows[m] >= 0 && c_in) {
                    const size_t idx = (size_t)rows[m] * K + kt + tx;
                    if constexpr (PS_REAL) {
                        vr[m] = ps[idx];
                    } else {
                        const float2 v =
                            reinterpret_cast<const float2*>(ps)[idx];
                        vr[m] = v.x;
                        vi[m] = v.y;
                    }
                }
            }
#pragma unroll
            for (int m = 0; m < PER; ++m) {
                const int rr = ty + (NT / TK) * (part * PER + m);
                ps_re[tx * PS_LD + rr] = vr[m];
                if constexpr (!PS_REAL) ps_im[tx * PS_LD + rr] = vi[m];
            }
        }
        // the tile's phase table: c0, c1 = c1h + c1l, the step D and the
        // 4-row step D^4 (with 2 Re D^4, the two-term coefficient)
#pragma unroll
        for (int m = 0; m < TAB; ++m) {
            float2 c0 = cycles(sp.a0, sp.b0, sp.lo0, t[m]);
            float2 c1 = cycles(sp.a1, sp.b1, sp.lo1, t[m]);
            // the delay's residual: f0 tau_lo and df tau_lo (a + b is
            // float32(f) exactly)
            c0.y = fmaf(sp.a0 + sp.b0, tl[m], c0.y);
            c1.y = fmaf(sp.a1 + sp.b1, tl[m], c1.y);
            float sd, cd, s4, c4;
            sincospif(2.f * (c1.x + c1.y), &sd, &cd);
            // 4 c1h is exact
            sincospif(2.f * (cfrac(4.f * c1.x) + 4.f * c1.y), &s4, &c4);
            tab[tid + m * NT] = make_float4(c0.x + c0.y, c1.x, cd, sgn * sd);
            tab2[tid + m * NT] = make_float4(c1.y, c4, sgn * s4, 2.f * c4);
        }
        __syncthreads();

        if (active) {
            // two c at a time where the registers allow it (no imaginary
            // sums); one for out_imag, which would spill
#pragma unroll(OUT_IMAG ? 1 : 2)
            for (int cc = 0; cc < kmax; ++cc) {
                const float4 A = tab[cc * TN + tx];   // c0, c1h, D
                const float4 B = tab2[cc * TN + tx];  // c1l, D^4, 2 Re D^4
                float c, s;
                run_seed(A.x, A.y, B.x, k0f, sgn, c, s);

                // rows 0 .. 7 of the run from the seed, 3 products deep:
                // D, D^2 = D D and D^4
                float ec[8], es[8];
                float d2c, d2s;
                cmul(A.z, A.w, A.z, A.w, d2c, d2s);
                ec[0] = c;
                es[0] = s;
                cmul(c, s, A.z, A.w, ec[1], es[1]);
                cmul(c, s, d2c, d2s, ec[2], es[2]);
                cmul(ec[1], es[1], d2c, d2s, ec[3], es[3]);
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    cmul(ec[g], es[g], B.y, B.z, ec[g + 4], es[g + 4]);

                // 4 chains over rows g + 4 j: e_{j+1} = 2 Re(D^4) e_j - e_{j-1}
                const float4* pr =
                    reinterpret_cast<const float4*>(ps_re + cc * PS_LD + ty * RT);
                const float4* pm =
                    reinterpret_cast<const float4*>(ps_im + cc * PS_LD + ty * RT);
#pragma unroll
                for (int j = 0; j < RT / 4; ++j) {
                    const int g0 = j < 2 ? 4 * j : 4;     // this step's values
                    if (j >= 2) {
#pragma unroll
                        for (int g = 0; g < 4; ++g) {
                            const float nc = fmaf(B.w, ec[g + 4], -ec[g]);
                            const float ns = fmaf(B.w, es[g + 4], -es[g]);
                            ec[g] = ec[g + 4];
                            es[g] = es[g + 4];
                            ec[g + 4] = nc;
                            es[g + 4] = ns;
                        }
                    }
                    const float4 vr = pr[j];
                    float4 vi = make_float4(0.f, 0.f, 0.f, 0.f);
                    if constexpr (!PS_REAL) vi = pm[j];
                    mac<PS_REAL, OUT_IMAG>(acc_re[4 * j], acc_im[4 * j], vr.x,
                                           vi.x, ec[g0], es[g0]);
                    mac<PS_REAL, OUT_IMAG>(acc_re[4 * j + 1],
                                           acc_im[4 * j + 1], vr.y, vi.y,
                                           ec[g0 + 1], es[g0 + 1]);
                    mac<PS_REAL, OUT_IMAG>(acc_re[4 * j + 2],
                                           acc_im[4 * j + 2], vr.z, vi.z,
                                           ec[g0 + 2], es[g0 + 2]);
                    mac<PS_REAL, OUT_IMAG>(acc_re[4 * j + 3],
                                           acc_im[4 * j + 3], vr.w, vi.w,
                                           ec[g0 + 3], es[g0 + 3]);
                }
            }
        }
        __syncthreads();
    }

    if (active && n < N) {
        const int row0 = (run / rps) * nf + k0;
        const int len = min(RT, nf - k0);
        float* dst = out + blockIdx.z * slice_stride;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            if (i < len) {
                const size_t idx = (size_t)(row0 + i) * N + n;
                if constexpr (OUT_IMAG)
                    reinterpret_cast<float2*>(dst)[idx] =
                        make_float2(acc_re[i], acc_im[i]);
                else
                    dst[idx] = acc_re[i];
            }
        }
    }
}

// out[i] = sum_z part[z * count + i], z in order (count floats a slice)
template <int V>
__global__ void __launch_bounds__(256)
rime_fwd_sum(const float* __restrict__ part, float* __restrict__ out,
             size_t count, int S)
{
    using T = typename std::conditional<V == 4, float4, float>::type;
    const T* p = reinterpret_cast<const T*>(part);
    T* o = reinterpret_cast<T*>(out);
    const size_t m = count / V;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
         i += (size_t)gridDim.x * blockDim.x) {
        T a = p[i];
        for (int z = 1; z < S; ++z) {
            const T b = p[z * m + i];
            if constexpr (V == 4) {
                a.x += b.x;
                a.y += b.y;
                a.z += b.z;
                a.w += b.w;
            } else {
                a += b;
            }
        }
        o[i] = a;
    }
}

template <bool PS_REAL, bool OUT_IMAG>
int launch(const void* ps, const void* tauT, const void* tauT_lo, void* out,
           void* part, int R, int K, int N, int nf, int S, int cslice,
           Split sp, float sgn, cudaStream_t stream)
{
    auto kernel = rime_fwd_kernel<PS_REAL, OUT_IMAG>;
    const size_t smem = smem_bytes(PS_REAL);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int rps = (nf + RT - 1) / RT;
    const int nruns = (R / nf) * rps;
    const size_t count = (size_t)R * N * (OUT_IMAG ? 2 : 1);
    const dim3 block(TN, RG);
    const dim3 grid((N + TN - 1) / TN, (nruns + RG - 1) / RG, S);
    float* dst = static_cast<float*>(S > 1 ? part : out);
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const float*>(ps), static_cast<const float*>(tauT),
        static_cast<const float*>(tauT_lo), dst, S > 1 ? count : 0, K, N, nf,
        rps, nruns, cslice, sp, sgn);
    err = cudaGetLastError();
    if (err != cudaSuccess || S == 1) return (int)err;
    const float* p = static_cast<const float*>(part);
    float* o = static_cast<float*>(out);
    if (count % 4 == 0) {
        const size_t blocks = std::min<size_t>((count / 4 + 255) / 256, 4096);
        rime_fwd_sum<4><<<(unsigned)blocks, 256, 0, stream>>>(p, o, count, S);
    } else {
        const size_t blocks = std::min<size_t>((count + 255) / 256, 4096);
        rime_fwd_sum<1><<<(unsigned)blocks, 256, 0, stream>>>(p, o, count, S);
    }
    return (int)cudaGetLastError();
}

template <bool PS_REAL, bool OUT_IMAG>
int info(int* regs, int* smem, int* blocks_per_sm)
{
    auto kernel = rime_fwd_kernel<PS_REAL, OUT_IMAG>;
    const size_t dyn = smem_bytes(PS_REAL);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            kernel, NT, dyn);
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs;
    *smem = (int)(attr.sharedSizeBytes + dyn);
    return 0;
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success). With
// S > 1 the slices' partial sums go to part (S * R * N floats, twice that
// for out_imag) and are then added into out. tauT_lo may be null.
extern "C" int rime_fwd_launch(const void* ps, const void* tauT,
                               const void* tauT_lo, void* out, void* part,
                               int R, int K, int N, int nf, int S,
                               int cslice, float a0, float b0, float lo0,
                               float a1, float b1, float lo1, int conj,
                               int ps_real, int out_imag, void* stream)
{
    const Split sp{a0, b0, lo0, a1, b1, lo1};
    const float sgn = conj ? -1.f : 1.f;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ps_real)
        return out_imag
            ? launch<true, true>(ps, tauT, tauT_lo, out, part, R, K, N, nf, S,
                                 cslice, sp, sgn, s)
            : launch<true, false>(ps, tauT, tauT_lo, out, part, R, K, N, nf,
                                  S, cslice, sp, sgn, s);
    return out_imag
        ? launch<false, true>(ps, tauT, tauT_lo, out, part, R, K, N, nf, S,
                              cslice, sp, sgn, s)
        : launch<false, false>(ps, tauT, tauT_lo, out, part, R, K, N, nf, S,
                               cslice, sp, sgn, s);
}

// The variant's registers per thread, shared memory per block (static +
// dynamic, bytes) and resident blocks per SM on the current device.
extern "C" int rime_fwd_info(int ps_real, int out_imag, int* regs, int* smem,
                             int* blocks_per_sm)
{
    if (ps_real)
        return out_imag ? info<true, true>(regs, smem, blocks_per_sm)
                        : info<true, false>(regs, smem, blocks_per_sm);
    return out_imag ? info<false, true>(regs, smem, blocks_per_sm)
                    : info<false, false>(regs, smem, blocks_per_sm);
}
