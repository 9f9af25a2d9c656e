"""The arithmetic and the launch plan of the rime_fwd CUDA kernel
(bayeslim_tpu_torch/csrc/rime_fwd.cu, with its phase helpers in
csrc/phasor.cuh), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py). Here:

- a numpy float32 model of its phase arithmetic, step by step, against
  float64 phases over the 100-200 MHz grid at nf = 1024, for delays from
  0 to 3e-6 s;
- the port's copy of the f32 split against the JAX package's;
- the split of K over grid.z (ops/rime_cuda.py::fwd_plan).
"""
import numpy as np
import pytest

from bayeslim_tpu.ops import rime_pallas
from bayeslim_tpu_torch.ops import phase, rime_cuda

f32 = np.float32
F0, NF = 100e6, 1024
DF = 100e6 / (NF - 1)
RT = rime_cuda.FWD_RUN


def _fma(a, b, c):
    """fmaf on float32 values: a * b is exact in float64 (48 bits), so
    where c = -fl(a * b) the result, the product's rounding error, is
    exact as on the card."""
    return f32(np.float64(a) * np.float64(b) + np.float64(c))


def _cfrac(x):
    """phasor.cuh `cfrac` (:19): x mod 1 in [-1/2, 1/2], exact."""
    return f32(x - np.rint(x))


def _sincospi(x):
    """sincospif: sin and cos of pi x, correctly rounded to float32."""
    x = np.float64(x)
    return f32(np.sin(np.pi * x)), f32(np.cos(np.pi * x))


# the SFU's __sincosf on [-pi, pi]: at most 2^-21.41 absolute error
SFU_ERR = 2.0 ** -21.41


def _sincos_sfu(x):
    """__sincosf(x) for |x| <= pi, modelled as the correctly rounded
    values each moved away from zero by the error bound."""
    x = np.float64(x)
    s, c = np.sin(x), np.cos(x)
    return f32(s + np.sign(s) * SFU_ERR), f32(c + np.sign(c) * SFU_ERR)


def _cycles(split, t):
    """phasor.cuh `cycles` (:27): f t mod 1 as hi + lo for f = a + b +
    lo, split products and TwoSum."""
    a, b, lo = (f32(v) for v in split)
    x = f32(a * t)
    xe = _fma(a, t, -x)
    y = f32(b * t)
    ye = _fma(b, t, -y)
    fx, fy = _cfrac(x), _cfrac(y)
    s = f32(fx + fy)
    v = f32(s - fx)
    e = f32(f32(fx - f32(s - v)) + f32(fy - v))
    return _cfrac(s), f32(f32(f32(e + xe) + ye) + f32(lo * t))


def _cmul(c, s, dc, ds):
    """phasor.cuh `cmul` (:55)."""
    return _fma(c, dc, -f32(s * ds)), _fma(s, dc, f32(c * ds))


def _run_seed(c0, c1h, c1l, k0, sgn):
    """phasor.cuh `run_seed` (:44-52): (c0 + k0 c1) mod 1 in [-1/2, 1/2],
    k0 c1h = p + pe exactly; sin/cos from the SFU. Returns (cos, sgn sin)."""
    k0f = f32(k0)
    p = f32(k0f * c1h)
    pe = _fma(k0f, c1h, -p)
    ph = _cfrac(f32(f32(_cfrac(p) + f32(pe + f32(k0f * c1l))) + c0))
    assert np.all(np.abs(ph) <= 0.5)
    s, c = _sincos_sfu(f32(6.283185307) * ph)
    return c, f32(sgn) * s


def model_phasors(tau, f0, df, nf, sgn=1.0):
    """The kernel's phasors exp(i sgn 2 pi (f0 + k df) tau), (nf,) + tau's
    shape, computed as rime_fwd.cu does, in float32."""
    t = f32(tau)
    sg_ = f32(sgn)
    # the tile's phase table (rime_fwd.cu :211-228): c0, c1 = c1h + c1l,
    # D and D^4 by sincospif
    c0h, c0l = _cycles(phase._split_f32(f0), t)
    c1h, c1l = _cycles(phase._split_f32(df), t)
    c0 = f32(c0h + c0l)
    sd, cd = _sincospi(f32(2) * f32(c1h + c1l))
    sd = sg_ * sd
    s4, c4 = _sincospi(f32(2) * f32(_cfrac(f32(4) * c1h) + f32(4) * c1l))
    s4 = sg_ * s4
    two_c4 = f32(2) * c4
    d2c, d2s = _cmul(cd, sd, cd, sd)
    out = np.zeros((nf,) + t.shape, dtype=np.complex128)
    for k0 in range(0, nf, RT):
        e = [_run_seed(c0, c1h, c1l, k0, sg_)]
        # rows 1 .. 7, three products deep: D, D^2, D^4 (rime_fwd.cu :240-252)
        e.append(_cmul(*e[0], cd, sd))
        e.append(_cmul(*e[0], d2c, d2s))
        e.append(_cmul(*e[1], d2c, d2s))
        e += [_cmul(*e[g], c4, s4) for g in range(4)]
        # 4 chains, two-term recurrence over rows g + 4 j (:254-272)
        while len(e) < RT:
            j = len(e)
            e += [(_fma(two_c4, e[j - 4 + g][0], -e[j - 8 + g][0]),
                   _fma(two_c4, e[j - 4 + g][1], -e[j - 8 + g][1]))
                  for g in range(4)]
        for i, (c, s) in enumerate(e[:min(RT, nf - k0)]):
            out[k0 + i] = np.float64(c) + 1j * np.float64(s)
    return out


@pytest.mark.parametrize("tau_max", [0.0, 1e-10, 1e-8, 1e-6, 3e-6])
def test_model_phasors_vs_float64(tau_max):
    rng = np.random.default_rng(7)
    tau = f32(np.concatenate([[tau_max, -tau_max],
                              tau_max * rng.uniform(-1, 1, 200)]))
    freqs = F0 + np.arange(NF) * DF
    for sgn in (1.0, -1.0):
        got = model_phasors(tau, F0, DF, NF, sgn)
        ref = np.exp(1j * sgn * 2 * np.pi
                     * np.mod(freqs[:, None] * np.float64(tau)[None], 1.0))
        assert np.abs(got - ref).max() <= 1e-5
    if tau_max == 0.0:
        # D = D^4 = 1 exactly, so only the seed's SFU error is left
        assert np.abs(got - 1.0).max() <= 2 * SFU_ERR


@pytest.mark.parametrize("f", [F0, DF, 200e6, 1e6 / 3, 0.0, 123.456])
def test_split_f32_matches_the_jax_package(f):
    assert phase._split_f32(f) == rime_pallas._split_f32(f)
    a, b, lo = phase._split_f32(f)
    assert a % 4096 == 0 and np.float64(a) + b == np.float64(f32(f))


def _runs(R, nf):
    """The rows of each run of the kernel's layout (rime_fwd.cu: each
    stacked block of nf rows cut into runs of RT channels)."""
    rps = -(-nf // RT)
    return [[(q // rps) * nf + (q % rps) * RT + i
             for i in range(min(RT, nf - (q % rps) * RT))]
            for q in range((R // nf) * rps)]


@pytest.mark.parametrize("nf", [5, 24, 1000, 1024])
@pytest.mark.parametrize("nstack", [1, 2, 3, 4])
def test_plan_runs_cover_rows_inside_their_block(nf, nstack):
    R = nstack * nf
    runs = _runs(R, nf)
    rows = [r for run in runs for r in run]
    assert sorted(rows) == list(range(R))
    for run in runs:
        assert len({r // nf for r in run}) == 1
        assert run == list(range(run[0], run[0] + len(run)))
    S, cslice = rime_cuda.fwd_plan(R, 300, 70, nf, 132, 2)
    assert S >= 1 and cslice % rime_cuda.FWD_TILE_K == 0


@pytest.mark.parametrize("R,K,N,nf", [(1024, 6144, 630, 1024),
                                      (1024, 630, 6144, 1024),
                                      (3 * 1000, 777, 45, 1000),
                                      (10, 1, 1, 5), (72, 20, 45, 24),
                                      (1024, 40, 630, 1024)])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_plan_slices_cover_k_once(R, K, N, nf, per_sm):
    S, cslice = rime_cuda.fwd_plan(R, K, N, nf, 132, per_sm)
    assert 1 <= S <= rime_cuda.FWD_MAX_SLICES
    cover = [c for z in range(S) for c in range(z * cslice,
                                                min(K, (z + 1) * cslice))]
    assert cover == list(range(K))
    assert (S - 1) * cslice < K                  # no empty slice


def test_plan_at_the_hera_stat_shapes():
    sms, per_sm = 132, 2
    # the backward shape (K = 630 groups, N = 6144 pixels): no split
    assert rime_cuda.fwd_plan(1024, 630, 6144, 1024, sms, per_sm)[0] == 1
    # the forward shape has 80 blocks of 256 threads: split until the
    # card holds at least one full wave of blocks
    S, _ = rime_cuda.fwd_plan(1024, 6144, 630, 1024, sms, per_sm)
    blocks = -(-630 // rime_cuda.FWD_COLS_PER_BLOCK) * (
        1024 // rime_cuda.FWD_RUN // rime_cuda.FWD_RUNS_PER_BLOCK)
    assert blocks == 80
    assert S * blocks >= sms * per_sm
    # K smaller than one tile: one slice
    assert rime_cuda.fwd_plan(1024, 1, 1, 1024, sms, per_sm) == (
        1, rime_cuda.FWD_TILE_K)


def test_plan_raises_past_the_nf_limit():
    nf = rime_cuda.FWD_MAX_NF
    assert rime_cuda.fwd_plan(nf, 10, 10, nf, 132, 2)[0] >= 1
    with pytest.raises(ValueError, match="2\\^24"):
        rime_cuda.fwd_plan(nf + 1, 10, 10, nf + 1, 132, 2)
    with pytest.raises(ValueError):
        rime_cuda.fwd_plan(10, 10, 10, 3, 132, 2)
