"""
The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
(NVIDIA's data sheet, at 700 W) and the work each kernel call, and each
posterior evaluation, needs.

A call's least time is the larger of its FP32 operations at the FP32
rate and its bytes (each input read once, each output written once) at
the memory rate. Operations are those the algorithm needs for the
call's shapes, not those a kernel happens to run: the phasors of the
fringe are left out, so each share of a bound is a share of a lower
bound.
"""
from __future__ import annotations

PEAK_FP32 = 67e12      # FLOP/s, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12   # bytes/s, HBM3


def roofline_ms(flops, nbytes):
    """(least ms, 'operations' or 'bytes': which of the two bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def kernel_bound_ms(R, K, N, ps_real, out_imag):
    """One rime_fwd call, out[r, n] = sum_c ps[r, c] E[r, c, n]: a real
    (complex) ps costs 1 (2) FP32 multiply-adds per triple and plane of
    the output, 1 or 2 planes."""
    fma = (1 if ps_real else 2) * (2 if out_imag else 1)
    return roofline_ms(2.0 * fma * R * K * N,
                       4.0 * (R * K * (1 if ps_real else 2) + K * N
                              + R * N * (2 if out_imag else 1)))[0]


def dtau_bound_ms(R, K, N, ps_real):
    """One rime_dtau call: per (r, c, n) triple the contraction
    p Im(u E) costs 3 FP32 multiply-adds for a real ps and 6 for a complex
    one; bytes are ct (complex), ps, tauT and the real output once each."""
    fma = 3 if ps_real else 6
    return roofline_ms(2.0 * fma * R * K * N,
                       4.0 * (2 * R * N + R * K * (1 if ps_real else 2)
                              + 2 * K * N))[0]


def ylm_bound_ms(M, K, N):
    """One Ylm product of an a_lm sky with real_output: M channels, K
    modes, N pixels. The real map Re(a Y), and a's gradient of a real
    cotangent, each need 2 real multiply-adds per (channel, mode, pixel);
    a and Y complex are read once, the real map (or cotangent) once."""
    return roofline_ms(4.0 * M * K * N, 8.0 * (M * K + K * N) + 4.0 * M * N)[0]


def eval_flops(cfg, npix_fov):
    """FP32 operations one posterior evaluation (loss and gradient) needs
    at a configuration's sizes, whatever calls the program makes: per
    time the RIME contraction over the FOV pixels (real psky, complex
    visibilities: 2 multiply-adds a triple), its psky cotangent where the
    sky or beam trains (complex cotangent, real output: 2), the delay
    cotangent where antennas train (3); for an a_lm sky the map and its
    gradient over the whole sphere (2 each a channel, mode and pixel)."""
    R, K = cfg["nfreq"], npix_fov
    triple = 2.0 * R * K * _groups(cfg["hex"])
    trained = set(cfg["trained"])
    per_time = 2 * triple
    if trained & {"sky", "beam"}:
        per_time += 2 * triple
    if "antvecs" in trained:
        per_time += 3 * triple
    flops = cfg["ntime"] * per_time
    if "lmax" in cfg:
        ncoeff = (cfg["lmax"] + 1) * (cfg["lmax"] + 2) // 2
        flops += 2 * 4.0 * R * ncoeff * 12 * cfg["nside"] ** 2
    return flops


def _groups(n):
    """Redundant cross-baseline groups of a hexagon of n a side: the
    distinct nonzero differences of its lattice points, halved."""
    pts = {(i, j) for i in range(-(n - 1), n) for j in range(-(n - 1), n)
           if abs(i + j) <= n - 1}
    diffs = {(a[0] - b[0], a[1] - b[1]) for a in pts for b in pts} - {(0, 0)}
    return len(diffs) // 2
