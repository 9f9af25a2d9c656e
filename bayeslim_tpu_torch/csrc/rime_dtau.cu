// Delay cotangent of the fused RIME reduction for NVIDIA Hopper (sm_90a).
//
//   dtauT[c, b] = sum_r w_r * Im(ct[r, b] * ps[r, c] * E[r, c, b])
//   E = exp(i * sgn * 2 pi * f_r * tauT[c, b]),   w_r = -sgn * 2 pi * f_r
//   f_r = f0 + (r mod nf) * df,   sgn = -1 if conj else +1
//
// Replaces the TPU kernel bayeslim_tpu/ops/rime_pallas.py::_dtau_kernel
// (launched by _dtau_pallas). The RIME backward calls it, pixel chunk by
// chunk, when antenna positions (blvecs) or pointing vectors (s_c) need
// a gradient: ct is the conjugate of the complex output's incoming
// gradient (R = Nstack * Nfreqs rows, N = Nbls), ps the forward's sky
// rows (K = Npix), tauT = s^T b^T / c (K x N). The caller contracts the
// (K, N) result with s_c and blvecs.
//
// ct is interleaved complex64 (R, N); ps is float32 (R, K) or
// interleaved complex64 (R, K); tauT and out are float32 (K, N). All
// row-major, contiguous.
//
// What bounds it on this card: FP32 instruction issue. Every (r, c, b)
// triple costs a phasor step and 2-4 FMAs against ~60 MB of operands at
// the hera-cal shapes (R = 1024, K = 6144, N = 630), so operations
// outweigh bytes by two orders of magnitude. The design:
//
// - One thread owns one output (c, b); b runs fastest across a warp, so
//   ct reads and out writes coalesce. Each block owns 16 pixels x 32
//   baselines and loops over the rows itself (the TPU grid's in-kernel
//   row loop); no atomics.
// - Rows are staged 32 at a time in shared memory: the ct rows of the
//   block's baselines with w_r folded in, and the ps rows of its pixels
//   (transposed, so that a warp, which shares one pixel, reads one
//   broadcast word per row).
// - Each thread walks the rows with the recurrence E <- E * D,
//   D = exp(i sgn 2 pi df tau): one complex multiply per row instead of
//   a sin/cos. It re-seeds in double from (f_r tau mod 1) at the first
//   row of every 32-row pass, so a float32 chain never runs more than 32
//   steps (over 1024 rows a float32 chain alone drifts towards 1e-4),
//   and resets to exp(i sgn 2 pi f0 tau) at every row where a stacked
//   block starts (r mod nf == 0), as the TPU kernel reseeds per pol block.
//   Rows are shared by the whole block, so these branches never diverge.
// - Phase accuracy: f tau reaches ~1e3 cycles, so the seeds f_r * tau,
//   f0 * tau and df * tau are formed in double and reduced mod 1 there;
//   only the reduced cycle reaches the float32 sincospif. No fast-math
//   intrinsics are used.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TB = 32;        // baselines per block (threads in x)
constexpr int TC = 16;        // pixels per block (threads in y)
constexpr int TR = 32;        // rows staged per pass; the reseed period
constexpr int NT = TB * TC;   // threads per block
constexpr double TWO_PI = 6.283185307179586;

template <bool PS_REAL>
__global__ void __launch_bounds__(NT)
rime_dtau_kernel(const float2* __restrict__ ct, const float* __restrict__ ps,
                 const float* __restrict__ tauT, float* __restrict__ out,
                 int R, int K, int N, int nf, double f0, double df, float sgn)
{
    __shared__ float2 ct_s[TR][TB];
    __shared__ float psr_s[TC][TR + 1];
    __shared__ float psi_s[PS_REAL ? 1 : TC][TR + 1];

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * TB + tx;
    const int b = blockIdx.y * TB + tx;
    const int c = blockIdx.x * TC + ty;
    const bool own = b < N && c < K;
    const double td = own ? (double)tauT[(size_t)c * N + b] : 0.0;

    // step phasor D and the stacked block's first-row phasor E0
    float sd, cd, sz, cz;
    double x = df * td;
    x -= floor(x);
    sincospif(2.f * (float)x, &sd, &cd);
    sd *= sgn;
    x = f0 * td;
    x -= floor(x);
    sincospif(2.f * (float)x, &sz, &cz);
    sz *= sgn;

    float acc = 0.f;
    for (int r0 = 0; r0 < R; r0 += TR) {
        for (int i = tid; i < TR * TB; i += NT) {
            const int rr = i / TB, bb = i % TB;
            const int r = r0 + rr, col = blockIdx.y * TB + bb;
            float2 v = make_float2(0.f, 0.f);
            if (r < R && col < N) {
                v = ct[(size_t)r * N + col];
                const float w = (float)(-(double)sgn * TWO_PI
                                        * (f0 + (double)(r % nf) * df));
                v.x *= w;
                v.y *= w;
            }
            ct_s[rr][bb] = v;
        }
        for (int i = tid; i < TR * TC; i += NT) {
            const int rr = i / TC, cc = i % TC;
            const int r = r0 + rr, col = blockIdx.x * TC + cc;
            float vr = 0.f, vi = 0.f;
            if (r < R && col < K) {
                const size_t idx = (size_t)r * K + col;
                if constexpr (PS_REAL) {
                    vr = ps[idx];
                } else {
                    const float2 v = reinterpret_cast<const float2*>(ps)[idx];
                    vr = v.x;
                    vi = v.y;
                }
            }
            psr_s[cc][rr] = vr;
            if constexpr (!PS_REAL) psi_s[cc][rr] = vi;
        }
        __syncthreads();

        // reseed at the pass's first row
        int k = r0 % nf;
        x = (f0 + (double)k * df) * td;
        x -= floor(x);
        float s, co;
        sincospif(2.f * (float)x, &s, &co);
        s *= sgn;
        const int rmax = min(TR, R - r0);
#pragma unroll 4
        for (int rr = 0; rr < rmax; ++rr) {
            if (k == 0) {
                co = cz;
                s = sz;
            }
            // Im((u + iv) p E) with E = co + i s
            const float2 u = ct_s[rr][tx];
            const float pr = psr_s[ty][rr];
            if constexpr (PS_REAL) {
                acc = fmaf(pr, fmaf(u.x, s, u.y * co), acc);
            } else {
                const float pm = psi_s[ty][rr];
                const float ur = fmaf(pr, u.x, -pm * u.y);
                const float ui = fmaf(pr, u.y, pm * u.x);
                acc = fmaf(ur, s, fmaf(ui, co, acc));
            }
            const float cn = fmaf(co, cd, -s * sd);
            s = fmaf(s, cd, co * sd);
            co = cn;
            if (++k == nf) k = 0;
        }
        __syncthreads();
    }
    if (own) out[(size_t)c * N + b] = acc;
}

template <bool PS_REAL>
void launch(const void* ct, const void* ps, const void* tauT, void* out,
            int R, int K, int N, int nf, double f0, double df, float sgn,
            cudaStream_t stream)
{
    const dim3 block(TB, TC);
    // pixel tiles on x: K (pixels) may exceed grid.y's 65,535 tiles
    const dim3 grid((K + TC - 1) / TC, (N + TB - 1) / TB);
    rime_dtau_kernel<PS_REAL><<<grid, block, 0, stream>>>(
        static_cast<const float2*>(ct), static_cast<const float*>(ps),
        static_cast<const float*>(tauT), static_cast<float*>(out), R, K, N,
        nf, f0, df, sgn);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rime_dtau_launch(const void* ct, const void* ps,
                                const void* tauT, void* out, int R, int K,
                                int N, int nf, double f0, double df,
                                int conj, int ps_real, void* stream)
{
    const float sgn = conj ? -1.f : 1.f;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ps_real)
        launch<true>(ct, ps, tauT, out, R, K, N, nf, f0, df, sgn, s);
    else
        launch<false>(ct, ps, tauT, out, R, K, N, nf, f0, df, sgn, s);
    return static_cast<int>(cudaGetLastError());
}
