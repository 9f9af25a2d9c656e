// Exact float phase arithmetic shared by the RIME kernels (rime_fwd.cu,
// rime_dtau.cu). No FP64: a product f t of a frequency f (~1e8 Hz) and a
// delay t (~1e-6 s) reaches ~1e3 cycles, so it is never formed in one
// float. f is split on the host (ops/phase.py::_split_f32, the TPU
// kernel's split) into float parts a + b + lo, each product is taken
// exactly as a float pair, and only remainders mod 1 are summed.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// f0 and df split on the host: f = a + b + lo (float32 values)
struct Split {
    float a0, b0, lo0, a1, b1, lo1;
};

// x mod 1 in [-1/2, 1/2], exact for every float x (x - floor(x) is not:
// 1 + x rounds for small negative x)
__device__ __forceinline__ float cfrac(float x) { return x - rintf(x); }

// f t mod 1 for f = a + b + lo, as an unevaluated pair hi + lo with hi
// in [-1/2, 1/2]: a t = x + xe and b t = y + ye exactly (fmaf gives a
// product's rounding error), cfrac(x) + cfrac(y) = s + e exactly
// (TwoSum), so only lo t and the sum of the small parts round (~1e-12).
// __fmul_rn keeps nvcc from contracting x into cfrac's subtraction,
// which would count part of xe twice.
__device__ __forceinline__ float2 cycles(float a, float b, float lo, float t)
{
    const float x = __fmul_rn(a, t), xe = fmaf(a, t, -x);
    const float y = __fmul_rn(b, t), ye = fmaf(b, t, -y);
    const float fx = cfrac(x), fy = cfrac(y);
    const float s = fx + fy, v = s - fx;
    const float e = (fx - (s - v)) + (fy - v);
    return make_float2(cfrac(s), e + xe + ye + lo * t);
}

// The seed of a run at its first channel k0 for one delay:
// exp(i sgn 2 pi (c0 + k0 c1)) with k0 c1h = p + pe exactly (fmaf);
// |c1l| < 3e-7, so k0 c1l rounds at ~1e-10 cycles for k0 < 4096. The
// phase is reduced to [-1/2, 1/2] cycles, so the SFU's __sincosf sees
// [-pi, pi], where its absolute error is at most 2^-21.41 (CUDA C++
// Programming Guide, intrinsic functions); nothing raises the seed to a
// power, so that error stays as it is
__device__ __forceinline__ void run_seed(float c0, float c1h, float c1l,
                                         float k0f, float sgn, float& c,
                                         float& s)
{
    const float p = __fmul_rn(k0f, c1h);
    const float ph = cfrac(cfrac(p) + (fmaf(k0f, c1h, -p) + k0f * c1l) + c0);
    __sincosf(6.283185307f * ph, &s, &c);
    s *= sgn;
}

// (c, s) times (dc, ds)
__device__ __forceinline__ void cmul(float c, float s, float dc, float ds,
                                     float& oc, float& os)
{
    oc = fmaf(c, dc, -s * ds);
    os = fmaf(s, dc, c * ds);
}
