// Delay cotangent of the fused RIME reduction for NVIDIA Hopper (sm_90a).
//
//   dtauT[c, b] = sum_r w_r * Im(ct[r, b] * ps[r, c] * E[r, c, b])
//   E = exp(i * sgn * 2 pi * f_r * tauT[c, b]),   w_r = -sgn * 2 pi * f_r
//   f_r = f0 + (r mod nf) * df,   sgn = -1 if conj else +1
//
// Replaces the TPU kernel bayeslim_tpu/ops/rime_pallas.py::_dtau_kernel
// (:693, launched by _dtau_pallas). The RIME backward calls it, pixel
// chunk by chunk, when antenna positions (blvecs) or pointing vectors
// (s_c) need a gradient: ct is the conjugate of the complex output's
// incoming gradient (R = Nstack * Nfreqs rows, N = Nbls), ps the
// forward's sky rows (K = Npix), tauT = s^T b^T / c (K x N). The caller
// contracts the (K, N) result with s_c and blvecs.
//
// ct is interleaved complex64 (R, N); ps is float32 (R, K) or
// interleaved complex64 (R, K); tauT and out are float32 (K, N). All
// row-major, contiguous.
//
// What bounds it on this card: FP32 instruction issue. Each (r, c, b)
// triple costs 3 FMA-pipe instructions of the sum for real ps (6 for
// complex) and a step of its own phasor, against ~60 MB of operands at
// the hera-cal shape (R = 1024, K = 6144, N = 630). The phasor depends
// on all three indices and runs along the contraction axis (rows), so
// no output shares it: the design keeps its step near 2.5 instructions
// a row and everything else (staging, shared loads, seeds, indices)
// small beside the ~5.5 a triple that the sum and the step need.
//
// - Weights first: rime_dtau_weight writes ctw = w_r ct (R, N) to a
//   scratch buffer, one block a row (r mod nf once a row), so that the
//   main kernel stages both operands untouched.
// - Register blocking: a thread owns 4 pixels x 2 adjacent baselines (8
//   outputs); a block is 32 pixels x 64 baselines (256 threads, two
//   blocks an SM). Per row a thread reads its 2 baselines' ctw as one
//   float4 and its 4 pixels' ps as one float4 broadcast (two for
//   complex ps): 2 shared loads for 8 triples.
// - Passes that never cross a stacked block: each block of nf rows is
//   cut into passes of RUN = 32 channels, the last one ragged (its
//   missing rows are staged as zeros, so nothing wraps and no row tests
//   for a block start); ops/rime_cuda.py::dtau_plan counts them.
// - Staging that does not stall: cp.async copies the next pass's ctw
//   and ps rows (8- and 4-byte copies, zero-filled past the pass's rows
//   or the matrix edges) into the other of two shared buffers while this
//   pass computes; no register holds them, and one barrier ends a pass.
// - No FP64. A thread's delays are fixed for the whole kernel, so c0 =
//   f0 tau mod 1 and the pair c1 = df tau mod 1 (exact split products,
//   phasor.cuh::cycles) are formed once per output and kept in shared
//   memory (each thread reads only its own entries), with D^LB (LB = 8);
//   the step D = exp(i sgn 2 pi c1) stays in registers. Each pass seeds
//   once per output at its first channel k0 (phasor.cuh::run_seed: the
//   k0 c1 pair product and one __sincosf). w_r = w0 + k w1 in float
//   (w0, w1 rounded on the host; a relative error of ~1e-7 in a weight).
// - The phasor: each pass is walked in 4 blocks of LB = 8 rows. A block
//   starts from its anchor A (e_0 = A, e_1 = A D, one rotation) and
//   advances by the two-term recurrence e_{j+1} = 2 Re(D) e_j - e_{j-1}
//   (one FMA per component and row); the next anchor is A D^8. So no
//   two-term chain takes more than 6 steps (its float32 error grows like
//   j^2 eps) and the anchors take at most 3 rotations after each seed
//   (linear growth): within ~3e-6 of float64 at every delay from 0 to
//   3e-6 s (tests/test_torch_dtau_seed.py models it).
// - Deterministic: each output is one thread's sum in row order; no
//   atomics, so two launches on the same inputs are bit-equal.
#include <cuda_runtime.h>
#include <math.h>

#include "phasor.cuh"

namespace {

constexpr int RUN = 32;            // rows of a pass (one seed per output)
constexpr int LB = 8;              // rows of a two-term block (anchor step)
constexpr int BPT = 2;             // adjacent baselines a thread
constexpr int PPT = 4;             // pixels a thread
constexpr int OUTS = BPT * PPT;    // outputs a thread
constexpr int TB = 32 * BPT;       // baselines a block
constexpr int WARPS = 8;           // warps a block (threads in y)
constexpr int TC = WARPS * PPT;    // pixels a block
constexpr int NT = 32 * WARPS;     // threads a block
constexpr int CT_M = RUN * TB / NT;    // ctw elements a thread copies a pass
constexpr int PS_M = RUN * TC / NT;    // ps elements a thread copies a pass

constexpr size_t smem_bytes(bool ps_real)
{
    return (size_t)OUTS * NT * (sizeof(float4) + sizeof(float2))  // tables
        + 2 * (size_t)RUN * TB * sizeof(float2)                   // ctw x 2
        + 2 * (size_t)RUN * TC * sizeof(float) * (ps_real ? 1 : 2);  // ps x 2
}

// cp.async of `bytes` (4 or 8) from global src to shared dst; zeros
// when `in` is false (src-size 0: nothing is read)
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(bytes), "r"(in ? bytes : 0));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The rows of a pass: channels k0 .. k0 + len - 1 of the stacked block
// that starts at row sb; next() steps to the following pass
struct Pass {
    int sb, k0;
    __device__ __forceinline__ int len(int nf) const
    {
        return min(RUN, nf - k0);
    }
    __device__ __forceinline__ void next(int nf)
    {
        k0 += RUN;
        if (k0 >= nf) {
            k0 = 0;
            sb += nf;
        }
    }
};

// Thread tid copies ctw column tid % TB of rows tid / TB + (NT / TB) m
// and ps column tid % TC of rows tid / TC + (NT / TC) m: [row][col] as in
// global memory, coalesced. Offsets from the pass's first row are 32-bit
// (a pass spans 32 rows; the wrapper holds 32 N and 32 K below 2^31).
template <bool PS_REAL>
__device__ __forceinline__ void stage(const float2* __restrict__ ctw,
                                      const float* __restrict__ ps,
                                      float2* ct_s, float* ps_s, Pass q,
                                      int nf, int K, int N, int c_base,
                                      int b_base, int tid)
{
    const int len = q.len(nf), row = q.sb + q.k0;
    const int bcol = b_base + tid % TB, r0 = tid / TB;
    const float2* src = ctw + (size_t)row * N;
    float2* dst = ct_s + r0 * TB + tid % TB;
#pragma unroll
    for (int m = 0; m < CT_M; ++m) {
        const int rr = r0 + (NT / TB) * m;
        const bool in = rr < len && bcol < N;
        cp_async<8>(dst + (NT / TB) * m * TB,
                    src + (in ? (unsigned)(rr * N + bcol) : 0u), in);
    }
    constexpr int E = PS_REAL ? 1 : 2;             // floats an element
    const int ccol = c_base + tid % TC, p0 = tid / TC;
    const float* psrc = ps + (size_t)row * K * E;
    float* pdst = ps_s + (p0 * TC + tid % TC) * E;
#pragma unroll
    for (int m = 0; m < PS_M; ++m) {
        const int rr = p0 + (NT / TC) * m;
        const bool in = rr < len && ccol < K;
        cp_async<4 * E>(pdst + (NT / TC) * m * TC * E,
                        psrc + (in ? (unsigned)(rr * K + ccol) * E : 0u), in);
    }
    cp_async_commit();
}

// ctw[r, b] = w_r ct[r, b], one block a row
__global__ void __launch_bounds__(256)
rime_dtau_weight(const float2* __restrict__ ct, float2* __restrict__ ctw,
                 int N, int nf, float w0, float w1)
{
    const size_t r = blockIdx.x;
    const float w = fmaf((float)(int)(r % nf), w1, w0);
    for (int b = threadIdx.x; b < N; b += blockDim.x) {
        const float2 v = ct[r * N + b];
        ctw[r * N + b] = make_float2(v.x * w, v.y * w);
    }
}

template <bool PS_REAL>
__global__ void __launch_bounds__(NT, 2)
rime_dtau_kernel(const float2* __restrict__ ctw, const float* __restrict__ ps,
                 const float* __restrict__ tauT, float* __restrict__ out,
                 int K, int N, int nf, int npass, Split sp, float sgn)
{
    static_assert(NT % TB == 0 && NT % TC == 0 && RUN % (NT / TB) == 0
                  && RUN % (NT / TC) == 0 && RUN % LB == 0 && LB % 2 == 0
                  && PPT == 4 && BPT == 2, "tiling");
    constexpr int E = PS_REAL ? 1 : 2;
    extern __shared__ float4 smem[];
    float4* tab = smem;                                     // [OUTS][NT]
    float2* tab8 = reinterpret_cast<float2*>(tab + OUTS * NT);  // [OUTS][NT]
    float2* ct_s = tab8 + OUTS * NT;                        // [2][RUN][TB]
    float* ps_s = reinterpret_cast<float*>(ct_s + 2 * RUN * TB);  // [2][RUN][TC]

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * 32 + tx;
    const int c_base = blockIdx.x * TC;
    const int b_base = blockIdx.y * TB;

    Pass q{0, 0}, fetch{0, 0};
    stage<PS_REAL>(ctw, ps, ct_s, ps_s, fetch, nf, K, N, c_base, b_base,
                   tid);
    fetch.next(nf);

    // per output o = j * BPT + i (pixel c_base + PPT ty + j, baseline
    // b_base + BPT tx + i): c0 and the c1 pair and D^LB in shared memory,
    // D in registers
    float dc[OUTS], ds[OUTS];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
            const int o = j * BPT + i;
            const int c = c_base + PPT * ty + j, b = b_base + BPT * tx + i;
            const float t = (c < K && b < N) ? tauT[(size_t)c * N + b] : 0.f;
            const float2 c0 = cycles(sp.a0, sp.b0, sp.lo0, t);
            const float2 c1 = cycles(sp.a1, sp.b1, sp.lo1, t);
            float s, co;
            sincospif(2.f * (c1.x + c1.y), &s, &co);
            dc[o] = co;
            ds[o] = sgn * s;
            // LB c1h is exact
            sincospif(2.f * (cfrac(LB * c1.x) + LB * c1.y), &s, &co);
            tab[o * NT + tid] = make_float4(c0.x + c0.y, c1.x, c1.y, 0.f);
            tab8[o * NT + tid] = make_float2(co, sgn * s);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[OUTS];
#pragma unroll
    for (int o = 0; o < OUTS; ++o) acc[o] = 0.f;

#pragma unroll 1
    for (int p = 0; p < npass; ++p) {
        const int buf = p & 1;
        // the next pass's copies are in flight during this pass's compute
        if (p + 1 < npass) {
            stage<PS_REAL>(ctw, ps, ct_s + (buf ^ 1) * RUN * TB,
                           ps_s + (buf ^ 1) * RUN * TC * E, fetch, nf, K, N,
                           c_base, b_base, tid);
            fetch.next(nf);
        }

        float ac[OUTS], as[OUTS];                   // anchors
#pragma unroll
        for (int o = 0; o < OUTS; ++o) {
            const float4 T = tab[o * NT + tid];
            run_seed(T.x, T.y, T.z, (float)q.k0, sgn, ac[o], as[o]);
        }
        q.next(nf);
        // this thread's 2 baselines and 4 pixels of row 0
        const float4* cts = reinterpret_cast<const float4*>(
            ct_s + buf * RUN * TB + BPT * tx);
        const float4* pss = reinterpret_cast<const float4*>(
            ps_s + (buf * RUN * TC + PPT * ty) * E);
#pragma unroll
        for (int lb = 0; lb < RUN / LB; ++lb) {
            float pc[OUTS], pz[OUTS], ec[OUTS], es[OUTS];  // e_{j-1}, e_j
#pragma unroll
            for (int j = 0; j < LB; ++j) {
                const int r = lb * LB + j;
#pragma unroll
                for (int o = 0; o < OUTS; ++o) {
                    if (j == 0) {
                        ec[o] = ac[o];
                        es[o] = as[o];
                    } else if (j == 1) {
                        pc[o] = ec[o];
                        pz[o] = es[o];
                        cmul(ac[o], as[o], dc[o], ds[o], ec[o], es[o]);
                    } else {
                        const float k2 = 2.f * dc[o];
                        const float nc = fmaf(k2, ec[o], -pc[o]);
                        const float ns = fmaf(k2, es[o], -pz[o]);
                        pc[o] = ec[o];
                        pz[o] = es[o];
                        ec[o] = nc;
                        es[o] = ns;
                    }
                }
                // ctw of baselines 0, 1 and ps of pixels 0 .. 3, row r
                const float4 u = cts[r * (TB / 2)];
                float pr[PPT], pm[PPT];
                if constexpr (PS_REAL) {
                    const float4 v = pss[r * (TC / 4)];
                    pr[0] = v.x, pr[1] = v.y, pr[2] = v.z, pr[3] = v.w;
                } else {
                    const float4 v0 = pss[r * (TC / 2)];
                    const float4 v1 = pss[r * (TC / 2) + 1];
                    pr[0] = v0.x, pm[0] = v0.y, pr[1] = v0.z, pm[1] = v0.w;
                    pr[2] = v1.x, pm[2] = v1.y, pr[3] = v1.z, pm[3] = v1.w;
                }
#pragma unroll
                for (int i = 0; i < BPT; ++i) {
                    const float ux = i ? u.z : u.x, uy = i ? u.w : u.y;
#pragma unroll
                    for (int jp = 0; jp < PPT; ++jp) {
                        const int o = jp * BPT + i;
                        // Im(u p E) with E = ec + i es
                        const float im = fmaf(ux, es[o], uy * ec[o]);
                        if constexpr (PS_REAL) {
                            acc[o] = fmaf(pr[jp], im, acc[o]);
                        } else {
                            const float re = fmaf(ux, ec[o], -uy * es[o]);
                            acc[o] = fmaf(pr[jp], im,
                                          fmaf(pm[jp], re, acc[o]));
                        }
                    }
                }
            }
            // the next block's anchor, A D^LB
            if (lb + 1 < RUN / LB) {
#pragma unroll
                for (int o = 0; o < OUTS; ++o) {
                    const float2 d8 = tab8[o * NT + tid];
                    float c, s;
                    cmul(ac[o], as[o], d8.x, d8.y, c, s);
                    ac[o] = c;
                    as[o] = s;
                }
            }
        }
        cp_async_wait_all();
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
#pragma unroll
        for (int i = 0; i < BPT; ++i) {
            const int c = c_base + PPT * ty + j, b = b_base + BPT * tx + i;
            if (c < K && b < N) out[(size_t)c * N + b] = acc[j * BPT + i];
        }
    }
}

template <bool PS_REAL>
int launch(const void* ct, void* ctw, const void* ps, const void* tauT,
           void* out, int R, int K, int N, int nf, int npass, Split sp,
           float sgn, float w0, float w1, cudaStream_t stream)
{
    auto kernel = rime_dtau_kernel<PS_REAL>;
    const size_t smem = smem_bytes(PS_REAL);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rime_dtau_weight<<<R, 256, 0, stream>>>(
        static_cast<const float2*>(ct), static_cast<float2*>(ctw), N, nf, w0,
        w1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 block(32, WARPS);
    // pixel tiles on x: K (pixels) may exceed grid.y's 65,535 tiles
    const dim3 grid((K + TC - 1) / TC, (N + TB - 1) / TB);
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const float2*>(ctw), static_cast<const float*>(ps),
        static_cast<const float*>(tauT), static_cast<float*>(out), K, N, nf,
        npass, sp, sgn);
    return (int)cudaGetLastError();
}

template <bool PS_REAL>
int info(int* regs, int* smem, int* blocks_per_sm)
{
    auto kernel = rime_dtau_kernel<PS_REAL>;
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

// Launch on `stream`; returns the first CUDA error (0 on success). ctw
// is a scratch of R * N complex64 for w_r ct; the rows are npass passes
// of at most 32 channels (ops/rime_cuda.py::dtau_plan); w_r = w0 +
// (r mod nf) w1.
extern "C" int rime_dtau_launch(const void* ct, void* ctw, const void* ps,
                                const void* tauT, void* out, int R, int K,
                                int N, int nf, int npass, float a0, float b0,
                                float lo0, float a1, float b1, float lo1,
                                float w0, float w1, int conj, int ps_real,
                                void* stream)
{
    const Split sp{a0, b0, lo0, a1, b1, lo1};
    const float sgn = conj ? -1.f : 1.f;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return ps_real
        ? launch<true>(ct, ctw, ps, tauT, out, R, K, N, nf, npass, sp, sgn,
                       w0, w1, s)
        : launch<false>(ct, ctw, ps, tauT, out, R, K, N, nf, npass, sp, sgn,
                        w0, w1, s);
}

// The variant's registers per thread, shared memory per block (static +
// dynamic, bytes) and resident blocks per SM on the current device.
extern "C" int rime_dtau_info(int ps_real, int* regs, int* smem,
                              int* blocks_per_sm)
{
    return ps_real ? info<true>(regs, smem, blocks_per_sm)
                   : info<false>(regs, smem, blocks_per_sm);
}
