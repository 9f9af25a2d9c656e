"""The port's in-memory data layer against the JAX package: TensorData's
arithmetic and copies, VisData's selections, calibration, chi-square,
baseline and time averages (with and without icov, flags, wgts and a
propagated cov), reduce_by_redundancy (and its identity against the
full per-baseline likelihood, value and gradients), LST rephasing,
nearest-neighbour time interpolation and redundant inflation; MapData's
and CalData's selections and CalData's operations; the concatenations
(lazy too), average_data, average_TensorData, caldata_from_visdata, the
chain blocks Difference, RedVisAvg and RedVisInflate, Dataset,
JonesModel.to_CalData round trips at 1, 2 and 4 pols, and vis_wedge.
Inputs come from numpy seeds on hex-2 and hex-3 arrays; everything
compares at float64 (1e-9 relative). ROADMAP queue C items 6 and 7
(VisData.apply_cal and CalData.set of the JAX package) are shown, not
pinned."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.data import containers as jc
from bayeslim_tpu.data import dataset as jds
from bayeslim_tpu.models import calibration as jcal
from bayeslim_tpu.models import fft as jfft
from bayeslim_tpu_torch.data import containers as tc
from bayeslim_tpu_torch.data import dataset as tds
from bayeslim_tpu_torch.models import calibration as tcal
from bayeslim_tpu_torch.models import fft as tfft
from bayeslim_tpu_torch.utils import make_hex

from _torch_graft import LOC

JD0 = 2458168.3
NF = 6
FREQS = np.linspace(100e6, 120e6, NF)
TIMES = JD0 + np.arange(4) * 5e-4
T64 = dict(device="cpu", dtype=torch.float64)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return None if x is None else np.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _all_bls(ants, autos=True):
    return [(a, b) for i, a in enumerate(ants)
            for b in ants[i if autos else i + 1:]]


def _meta(pkg, hexN):
    ants, antvecs = make_hex(hexN, D=15.0)
    mod = bl if pkg == "jax" else bt
    return mod.TelescopeModel(LOC), mod.utils.AntposDict(ants, antvecs), ants


def _vis(hexN=2, npol=1, icov=False, cov=False, flags=False, seed=0,
         ntime=4, bls=None):
    """(JAX VisData, port VisData) of the same random cube; every
    baseline of the array (autos too) unless bls given."""
    rng = np.random.default_rng(seed)
    ants = make_hex(hexN)[0]
    bls = _all_bls(ants) if bls is None else bls
    shape = (npol, npol, len(bls), ntime, NF)
    arrs = dict(
        data=rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
        icov=rng.uniform(1, 2, shape) if icov else None,
        cov=rng.uniform(0.5, 1.5, shape) if cov else None)
    fl = rng.random(shape) < 0.3 if flags else None
    pol = "ee" if npol == 1 else None
    out = []
    for pkg, conv in (("jax", _j), ("torch", _t)):
        T, ap, _ = _meta(pkg, hexN)
        vd = (jc if pkg == "jax" else tc).VisData()
        vd.setup_meta(T, ap)
        vd.setup_data(bls, TIMES[:ntime], FREQS, pol=pol,
                      flags=None if fl is None else fl.copy(),
                      **{k: conv(v) for k, v in arrs.items()})
        out.append(vd)
    return out


def _same(tv, jv, tol=1e-9, fields=("data", "icov", "cov")):
    for f in fields:
        a, b = getattr(tv, f, None), getattr(jv, f, None)
        assert (a is None) == (b is None), f
        if a is not None:
            assert _relerr(_np(a), b) <= tol, f
    if getattr(jv, "flags", None) is not None:
        np.testing.assert_array_equal(np.asarray(tv.flags),
                                      np.asarray(jv.flags))
    else:
        assert tv.flags is None
    for meta in ("blnums", "times", "freqs", "ants"):
        if hasattr(jv, meta) and getattr(jv, meta) is not None:
            np.testing.assert_array_equal(np.asarray(getattr(tv, meta)),
                                          np.asarray(getattr(jv, meta)))


# (icov, cov, wgts) of each weighting
MODES = {"none": (False, False, False), "icov": (True, False, False),
         "cov": (False, True, False), "cov+icov": (True, True, False),
         "wgts": (False, False, True), "wgts+icov": (True, False, True)}


def _wgts(jv, seed=5):
    return np.random.default_rng(seed).uniform(0.5, 2, jv.data.shape)


# --- VisData averages --------------------------------------------------------

@pytest.mark.parametrize("hexN,npol", [(2, 1), (3, 1), (2, 2)])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("flags", [False, True])
def test_bl_average_vs_jax(hexN, npol, mode, flags):
    icov, cov, wg = MODES[mode]
    jv, tv = _vis(hexN, npol, icov=icov, cov=cov, flags=flags)
    w = _wgts(jv) if wg else None
    ja = jv.bl_average(wgts=None if w is None else jnp.asarray(w))
    ta = tv.bl_average(wgts=w)
    _same(ta, ja)
    assert ta.Nbls == len(bl.models.telescope.build_reds(
        jv.antpos, bls=jv.bls)[0])
    # given groups (a subset, tuples and blnums) and redtol
    reds = [r for r in bl.models.telescope.build_reds(
        jv.antpos, bls=jv.bls, redtol=0.5)[0] if len(r) > 1]
    _same(tv.bl_average(reds=reds), jv.bl_average(reds=reds))
    nreds = [list(bt.utils.ants2blnum(r)) for r in reds]
    _same(tv.bl_average(reds=nreds), jv.bl_average(reds=nreds))
    # in place
    t2 = tv.copy()
    assert t2.bl_average(inplace=True) is t2


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("rephase", [False, True])
@pytest.mark.parametrize("flags", [False, True])
def test_time_average_vs_jax(mode, rephase, flags):
    icov, cov, wg = MODES[mode]
    jv, tv = _vis(2, 1, icov=icov, cov=cov, flags=flags, seed=1)
    w = _wgts(jv) if wg else None
    for tinds in (None, [[0, 1], [2, 3]], [[0, 2, 3], [1]],
                  [slice(0, 3), range(3, 4)]):
        ja = jv.time_average(time_inds=tinds, rephase=rephase,
                             wgts=None if w is None else jnp.asarray(w))
        ta = tv.time_average(time_inds=tinds, rephase=rephase, wgts=w)
        _same(ta, ja)


def test_averages_are_differentiable():
    """Gradients through bl_average and time_average (segment sums and
    the rephasing) against JAX's."""
    jv, tv = _vis(2, 1, icov=True, seed=2)
    x = np.array(jv.data)

    def jloss(d):
        v = jv.copy()
        v.data = d
        a = v.time_average([[0, 1], [2, 3]], rephase=True).bl_average()
        return jnp.sum(jnp.abs(a.data) ** 2 * a.icov)

    xt = torch.as_tensor(x).requires_grad_(True)
    v = tv.copy()
    v.data = xt
    a = v.time_average([[0, 1], [2, 3]], rephase=True).bl_average()
    loss = torch.sum(torch.abs(a.data) ** 2 * a.icov)
    assert abs(float(loss) - float(jloss(jnp.asarray(x)))) <= \
        1e-9 * float(loss)
    (g,) = torch.autograd.grad(loss, xt)
    jg = jax.grad(jloss)(jnp.asarray(x))
    assert _relerr(g.numpy(), np.conj(np.asarray(jg))) <= 1e-9


def test_segment_sums_fixed_order():
    """_Segments sums each segment over its rows, whatever their order
    and lengths (empty ones too), as index_add_ does."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((2, 11, 3)))
    segs = [[4, 1], [], [0, 2, 3, 5], [10], [6, 9], [7, 8, 1]]
    s = tc._Segments(segs)
    got = s.sum(s.gather(x, 1), 1)
    want = torch.zeros(2, len(segs), 3, dtype=x.dtype)
    for i, ix in enumerate(segs):
        for r in ix:
            want[:, i] += x[:, r]
    assert torch.allclose(got, want, rtol=0, atol=1e-14)
    assert s.counts(1, 3, x.dtype, x.device).reshape(-1).tolist() == \
        [2, 0, 4, 1, 2, 3]


@pytest.mark.parametrize("hexN", [2, 3])
@pytest.mark.parametrize("icov", [False, True])
def test_reduce_by_redundancy_vs_jax(hexN, icov):
    jv, tv = _vis(hexN, 1, icov=icov, seed=4)
    ja, jconst = jv.reduce_by_redundancy()
    ta, tconst = tv.reduce_by_redundancy()
    _same(ta, ja)
    assert isinstance(tconst, float)
    assert abs(tconst - jconst) <= 1e-9 * abs(jconst)


def _stat_pair(icov):
    """A hex-2 RIME over its cross-baseline groups; per-baseline data
    (the model plus noise, and icov if asked) on every cross baseline;
    the full per-baseline LogProb (RIME -> RedVisInflate) and the
    sufficient-statistics one (RIME against the reduced data)."""
    from _torch_graft import build_torch
    prob0 = build_torch(hexN=2, **T64)
    rime = prob0.model
    arr = rime.array
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    rime.setup_sim_bls([r[0] for r in reds])
    bls = [b for r in reds for b in r]
    bl2red = {b: i for i, r in enumerate(reds) for b in r}
    with torch.no_grad():
        groups = rime()
    full = groups.inflate_by_redundancy(bls=bls, bl2red=bl2red)
    rng = np.random.default_rng(6)
    shape = full.data.shape
    vd = bt.VisData()
    vd.setup_meta(rime.telescope, arr.to_antpos())
    vd.setup_data(bls, rime.sim_times, rime.freqs, pol="ee",
                  data=full.data + torch.as_tensor(
                      rng.standard_normal(shape)
                      + 1j * rng.standard_normal(shape)),
                  icov=torch.as_tensor(rng.uniform(0.5, 2, shape))
                  if icov else None)
    avg, const = vd.reduce_by_redundancy(reds=reds)
    seq = bt.Sequential({"rime": rime,
                         "inflate": tc.RedVisInflate(bls, bl2red=bl2red)})
    return bt.LogProb(seq, vd), bt.LogProb(rime, avg), const


@pytest.mark.parametrize("icov", [False, True])
def test_reduce_by_redundancy_identity(icov):
    """chi^2 of the full per-baseline likelihood = chi^2 against the
    statistics + const; equal gradients."""
    pf, ps, const = _stat_pair(icov)
    cf = pf.forward_chisq()[0]
    cs = ps.forward_chisq()[0]
    assert abs(float(cs) + const - float(cf)) <= 1e-9 * float(cf)
    gf = torch.autograd.grad(cf, list(pf.model.parameters()))
    gs = torch.autograd.grad(cs, list(ps.model.parameters()))
    for a, b in zip(gf, gs):
        assert _relerr(b.numpy(), a.numpy()) <= 1e-9


# --- rephasing, interpolation, inflation --------------------------------------

@pytest.mark.parametrize("hexN", [2, 3])
def test_lst_rephase_vs_jax(hexN):
    jv, tv = _vis(hexN, 1, seed=7)
    for kw in (dict(dtime=3e-4), dict(dLST=np.linspace(-0.01, 0.02, 4)),
               dict(dLST=0.005)):
        _same(tv.lst_rephase(**kw), jv.lst_rephase(**kw))


def test_time_nn_interp_vs_jax():
    jv, tv = _vis(2, 1, icov=True, flags=True, seed=8)
    lsts = bl.models.telescope.JD2LST(TIMES, LOC[0])
    targets = lsts[[0, 2]] + np.array([1e-4, -2e-4])
    _same(tv.time_nn_interp(lsts=targets, inplace=False),
          jv.time_nn_interp(lsts=targets, inplace=False))
    jt = TIMES[[1, 3]] + np.array([1e-5, -3e-5])
    _same(tv.time_nn_interp(times=jt, inplace=False),
          jv.time_nn_interp(times=jt, inplace=False))
    _same(tv.time_nn_interp(times=jt, rephase=False, inplace=False),
          jv.time_nn_interp(times=jt, rephase=False, inplace=False))


@pytest.mark.parametrize("hexN", [2, 3])
def test_inflate_by_redundancy_vs_jax(hexN):
    jv, tv = _vis(hexN, 1, icov=True, flags=True, seed=9)
    jg, tg = jv.bl_average(), tv.bl_average()
    _same(tg.inflate_by_redundancy(), jg.inflate_by_redundancy())
    sub = jv.bls[::3]
    _same(tg.inflate_by_redundancy(bls=sub), jg.inflate_by_redundancy(
        bls=sub))
    _, _, bl2red = bl.models.telescope.build_reds(jv.antpos, red_bls=jg.bls)[:3]
    _same(tg.inflate_by_redundancy(bl2red=bl2red),
          jg.inflate_by_redundancy(bl2red=bl2red))
    reps = jg.bls
    _same(tg.inflate_by_redundancy(bls=reps[::-1], red_bls=reps),
          jg.inflate_by_redundancy(bls=reps[::-1], red_bls=reps))
    blk = tc.RedVisInflate(sub)
    _same(blk(tg), jc.RedVisInflate(sub)(jg))


@pytest.mark.parametrize("kw", [
    {}, dict(uniq_bls=True), dict(keep_autos=False, min_len=20.0),
    dict(max_len=40.0, min_EW=5.0), dict(max_EW=20.0, min_NS=1.0),
    dict(max_NS=20.0, min_deg=30.0, max_deg=150.0),
    dict(uniq_bls=True, keep_autos=False, max_deg=90.0)])
def test_get_bls_vs_jax(kw):
    jv, tv = _vis(3, 1, seed=10)
    assert tv.get_bls(**kw) == jv.get_bls(**kw)


@pytest.mark.parametrize("axis", [None, 3])
def test_chisq_vs_jax(axis):
    jv, tv = _vis(2, 1, icov=True, seed=11)
    jo, to = _vis(2, 1, seed=12)
    for kw in (dict(other_vis=None), dict(other_vis="o"),
               dict(other_vis="o", dof=7.0)):
        jkw = {**kw, "other_vis": jo if kw["other_vis"] else None}
        tkw = {**kw, "other_vis": to if kw["other_vis"] else None}
        assert _relerr(tv.chisq(axis=axis, **tkw).numpy(),
                       jv.chisq(axis=axis, **jkw)) <= 1e-9
    ic = np.full(jv.data.shape, 3.0)
    assert _relerr(tv.chisq(icov=torch.as_tensor(ic)).numpy(),
                   jv.chisq(icov=jnp.asarray(ic))) <= 1e-9


# --- TensorData / VisData basics ------------------------------------------------

def test_tensordata_arithmetic_and_copies():
    jv, tv = _vis(2, 1, icov=True, flags=True, seed=13)
    jw, tw = _vis(2, 1, flags=True, seed=14)
    for op in ("__add__", "__sub__", "__mul__", "__truediv__"):
        _same(getattr(tv, op)(tw), getattr(jv, op)(jw))
        _same(getattr(tv, op)(2.5), getattr(jv, op)(2.5))
    c = tv.copy(copydata=True, copymeta=True)
    assert c.data is not tv.data and torch.equal(c.data, tv.data)
    assert c.times is not tv.times and c.flags is not tv.flags
    x = tv.data.clone().requires_grad_(True)
    v = tv.copy()
    v.data = x * 2
    assert v.copy().data.requires_grad
    assert not v.copy(detach=True).data.requires_grad
    assert tv.device == torch.device("cpu") and jv.device is not None
    assert tv.push("cpu", return_obj=True) is tv
    assert np.array_equal(tv.get_flags(squeeze=False), tv.flags)
    assert tv.get_cov() is None
    _same(tv.select(bl=[(0, 1), (1, 2)], inplace=False),
          jv.select(bl=[(0, 1), (1, 2)], inplace=False))


def test_visdata_selections_and_set_vs_jax():
    jv, tv = _vis(2, 2, icov=True, cov=True, flags=True, seed=15)
    for kw in (dict(bl=(0, 1)), dict(bl=[(0, 1), (2, 3)], pol="en"),
               dict(times=TIMES[1:3], freqs=FREQS[::2]),
               dict(bl_inds=[3, 1], time_inds=[2], freq_inds=[0, 4]),
               dict(bl=(1, 4), squeeze=False)):
        for get in ("get_data", "get_flags", "get_cov", "get_icov"):
            a, b = getattr(tv, get)(**kw), getattr(jv, get)(**kw)
            assert tuple(a.shape) == tuple(b.shape), (get, kw)
            assert _relerr(_np(a).astype(complex),
                           np.asarray(b).astype(complex)) <= 1e-12
    assert _relerr(tv[(0, 1)].numpy(), jv[(0, 1)]) == 0.0
    tv.check()
    jv.check()
    bad = tv.copy()
    bad.flags = np.zeros(3, dtype=bool)
    with pytest.raises(ValueError, match="flags"):
        bad.check()
    val = np.arange(2 * 2 * 1 * 4 * NF).reshape(2, 2, 1, 4, NF) * (1 + 1j)
    tv.set((0, 2), torch.as_tensor(val))
    jv.set((0, 2), jnp.asarray(val))
    tv.set((1, 3), torch.zeros(2, 2, 1, 4, NF), arr="icov")
    jv.set((1, 3), jnp.zeros((2, 2, 1, 4, NF)), arr="icov")
    _same(tv, jv)
    # a tensor in a graph is cloned, and the assignment enters the graph
    x = tv.data.clone().requires_grad_(True)
    v = tv.copy()
    v.data = x * 1.0
    v.set((0, 1), torch.zeros(2, 2, 1, 4, NF, dtype=x.dtype))
    v.data.real.sum().backward()
    assert float(x.grad.real.sum()) == (tv.Nbls - 1) * 2 * 2 * 4 * NF


# --- calibration ----------------------------------------------------------------

def _gains(npol, nant, ntime, seed):
    rng = np.random.default_rng(seed)
    g = 1 + 0.1 * (rng.standard_normal((npol, npol, nant, ntime, NF))
                   + 1j * rng.standard_normal((npol, npol, nant, ntime, NF)))
    if npol == 2:
        g[0, 1] *= 0.1
        g[1, 0] *= 0.1
    return g


def _caldata(pkg, g, ants, pol, ap=None):
    cd = (jc if pkg == "jax" else tc).CalData()
    cd.setup_meta(antpos=ap)
    cd.setup_data(ants, TIMES[:g.shape[3]], FREQS, pol=pol,
                  data=(jnp.asarray if pkg == "jax" else torch.as_tensor)(g))
    return cd


@pytest.mark.parametrize("npol,cal_2pol", [(1, False), (2, True), (2, False)])
@pytest.mark.parametrize("undo", [False, True])
@pytest.mark.parametrize("ntime", [1, 4])
def test_apply_cal_vs_jax_function(npol, cal_2pol, undo, ntime):
    """VisData.apply_cal against JAX's models.calibration.apply_cal with
    the same arguments (ROADMAP queue C item 6)."""
    jv, tv = _vis(2, npol, seed=16)
    ants = make_hex(2)[0]
    g = _gains(npol, len(ants), ntime, 17)
    cd = _caldata("torch", g, ants, "ee" if npol == 1 else None)
    got = tv.apply_cal(cd, undo=undo, cal_2pol=cal_2pol)
    want, _ = jcal.apply_cal(jv.data, jv.bls, jnp.asarray(g), ants,
                             undo=undo, cal_2pol=cal_2pol)
    assert _relerr(got.data.numpy(), want) <= 1e-9
    assert got is not tv and tv.apply_cal(cd, inplace=True) is tv


def test_queue_c6_jax_apply_cal_method_raises():
    """ROADMAP queue C item 6: the JAX VisData.apply_cal calls
    models.calibration.apply_cal without the baselines and the antennas,
    so it raises; the port's method is held to the JAX function above."""
    jv, tv = _vis(2, 1, seed=18)
    ants = make_hex(2)[0]
    g = _gains(1, len(ants), 1, 19)
    with pytest.raises(TypeError):
        jv.apply_cal(_caldata("jax", g, ants, "ee"))
    out = tv.apply_cal(_caldata("torch", g, ants, "ee"))
    assert torch.isfinite(out.data).all()


@pytest.mark.parametrize("polmode", ["1pol", "2pol", "4pol"])
def test_to_CalData_apply_cal_round_trip(polmode):
    """JonesModel.to_CalData (detached, on the gains' device) applied by
    VisData.apply_cal equals the JonesModel's own forward, and undo
    inverts it; against the JAX to_CalData."""
    npol = 1 if polmode == "1pol" else 2
    ants = make_hex(2)[0]
    g = _gains(npol, len(ants), 1, 20)
    jJ = jcal.JonesModel(jnp.asarray(g), ants, polmode=polmode)
    tJ = tcal.JonesModel(g, ants, polmode=polmode, **T64)
    jcd = jJ.to_CalData(FREQS, TIMES[:1], pol="ee" if npol == 1 else None)
    tcd = tJ.to_CalData(FREQS, TIMES[:1], pol="ee" if npol == 1 else None)
    _same(tcd, jcd)
    assert not tcd.data.requires_grad and tJ.params.requires_grad
    assert tcd.device == tJ.params.device
    jv, tv = _vis(2, npol, seed=21)
    cal2 = polmode == "2pol"
    fwd = tv.apply_cal(tcd, cal_2pol=cal2)
    assert _relerr(fwd.data.numpy(),
                   tJ(tv).data.detach().numpy()) <= 1e-12
    want = jcal.apply_cal(jv.data, jv.bls, jcd.data, jcd.ants,
                          cal_2pol=cal2)[0]
    assert _relerr(fwd.data.numpy(), want) <= 1e-9
    back = fwd.apply_cal(tcd, undo=True, cal_2pol=cal2)
    assert _relerr(back.data.numpy(), tv.data.numpy()) <= 1e-12


def test_apply_cal_4pol_of_inflated_1pol_caldata():
    """apply_cal(undo=True) of a 4-pol CalData from inflate_to_4pol: the
    2x2 Jones inverse, against JAX's apply_cal and against the 1-pol
    gains applied to each pol product."""
    ants = make_hex(2)[0]
    g = _gains(1, len(ants), 4, 22)
    jcd = _caldata("jax", g, ants, "ee").inflate_to_4pol()
    tcd = _caldata("torch", g, ants, "ee").inflate_to_4pol()
    _same(tcd, jcd)
    assert tcd.pol is None and tcd.Npol == 2
    jv, tv = _vis(2, 2, seed=23)
    got = tv.apply_cal(tcd, undo=True)
    want = jcal.apply_cal(jv.data, jv.bls, jcd.data, ants, undo=True)[0]
    assert _relerr(got.data.numpy(), want) <= 1e-9
    G = tcd.get_data_for_bls(tv.bls)
    assert _relerr(got.data.numpy(), (tv.data / G[0, 0]).numpy()) <= 1e-12


# --- MapData and CalData ---------------------------------------------------------

def _maps(seed=24):
    rng = np.random.default_rng(seed)
    npix = 10
    shape = (2, 1, NF, npix)
    angs = np.stack([rng.uniform(0, 360, npix), rng.uniform(-90, 30, npix)])
    arrs = dict(data=rng.standard_normal(shape),
                cov=rng.uniform(0.5, 1, shape), icov=rng.uniform(1, 2, shape),
                norm=rng.uniform(1, 2, shape))
    fl = rng.random(shape) < 0.3
    out = []
    for mod, conv in ((jc, _j), (tc, _t)):
        md = mod.MapData()
        md.setup_meta(name="m")
        md.setup_data(FREQS, df=np.full(NF, 1e5), pols=["ee", "nn"],
                      angs=conv(angs), flags=fl.copy(),
                      **{k: conv(v) for k, v in arrs.items()})
        out.append(md)
    return out


@pytest.mark.parametrize("kw", [
    {}, dict(freqs=FREQS[[1, 4]]), dict(pols="nn"), dict(pol_inds=[1, 0]),
    dict(ang_inds=[3, 0, 7]), dict(freq_inds=[5, 2], ang_inds=[1])])
def test_mapdata_selections_vs_jax(kw):
    jm, tm = _maps()
    for a, b in zip(tm.get_inds(**kw), jm.get_inds(**kw)):
        assert (isinstance(a, slice) and a == b) or np.array_equal(a, b)
    assert _relerr(tm.get_data(**kw).numpy(), jm.get_data(**kw)) == 0.0
    ts, js = tm.select(inplace=False, **kw), jm.select(inplace=False, **kw)
    _same(ts, js, fields=("data", "cov", "icov", "norm", "angs"))
    np.testing.assert_array_equal(ts.df, js.df)
    assert list(ts.pols) == list(js.pols) and ts.Npix == js.Npix
    assert ts.Nfreqs == js.Nfreqs


def test_mapdata_angs_select_vs_jax():
    jm, tm = _maps(25)
    angs = np.asarray(jm.angs)[:, [2, 5]] + 0.01
    _same(tm.select(angs=angs, inplace=False),
          jm.select(angs=angs, inplace=False),
          fields=("data", "cov", "icov", "norm", "angs"))


def test_caldata_ops_vs_jax():
    ants, antvecs = make_hex(2, D=15.0)
    g = _gains(1, len(ants), 4, 26)
    jcd = _caldata("jax", g, ants, "ee",
                   bl.utils.AntposDict(ants, antvecs))
    tcd = _caldata("torch", g, ants, "ee",
                   bt.utils.AntposDict(ants, antvecs))
    assert (tcd.Nants, tcd.Ntimes, tcd.Nfreqs, tcd.Npol) == \
        (jcd.Nants, jcd.Ntimes, jcd.Nfreqs, jcd.Npol)
    for kw in (dict(ant=3), dict(ant=[4, 0], times=TIMES[1:3]),
               dict(freqs=FREQS[[0, 5]]), dict(ant=2, squeeze=False)):
        assert _relerr(tcd.get_data(**kw).numpy(), jcd.get_data(**kw)) == 0.0
    for kw in (dict(ants=[5, 1]), dict(times=TIMES[::2], freqs=FREQS[:3])):
        _same(tcd.select(inplace=False, **kw), jcd.select(inplace=False,
                                                          **kw))
    bls = _all_bls(ants, autos=False)
    assert _relerr(tcd.get_data_for_bls(bls).numpy(),
                   jcd.get_data_for_bls(bls)) <= 1e-12
    for a, b in zip(tcd.redcal_degens(), jcd.redcal_degens()):
        assert _relerr(a.numpy(), b) <= 1e-9
    assert _relerr(tcd.redcal_degen_gains().numpy(),
                   jcd.redcal_degen_gains()) <= 1e-9
    w = np.linspace(0.5, 1.5, len(ants))
    for a, b in zip(tcd.redcal_degens(wgts=w), jcd.redcal_degens(
            wgts=jnp.asarray(w))):
        assert _relerr(a.numpy(), b) <= 1e-9
    _same(tcd.rephase_to_refant(3), jcd.rephase_to_refant(3))
    assert float(tcd.rephase_to_refant(3).get_data(ant=3).imag.abs().max()) \
        <= 1e-15


def test_queue_c7_jax_caldata_set_indexes_the_pol_axis():
    """ROADMAP queue C item 7: the JAX CalData.set hands its (antenna,
    time, freq) indices to _set_at as the first three axes, so on a
    device array it writes nothing of the antenna (the out-of-range
    writes are dropped) and on a numpy array it raises. The port sets
    the antenna's gains."""
    ants = make_hex(2)[0]
    g = _gains(1, len(ants), 2, 27)
    jcd = _caldata("jax", g, ants, "ee")
    jcd.set(2, 5.0)
    assert not np.any(np.asarray(jcd.data)[0, 0, 2] == 5.0)
    tcd = _caldata("torch", g, ants, "ee")
    tcd.set(2, 5.0)
    tcd.set([0, 4], torch.zeros(1, 1, 2, 2, NF, dtype=torch.complex128))
    want = g.copy()
    want[:, :, 2] = 5.0
    want[:, :, [0, 4]] = 0.0
    np.testing.assert_array_equal(tcd.data.numpy(), want)


# --- concatenation, averaging, blocks, Dataset ------------------------------------

@pytest.mark.parametrize("axis", ["bl", "time", "freq"])
def test_concat_visdata_lazy_vs_jax(axis):
    parts = [_vis(2, 1, icov=True, flags=True, seed=s) for s in (30, 31)]
    jp, tp = [p[0] for p in parts], [p[1] for p in parts]
    if axis == "time":
        for i, (a, b) in enumerate(parts):
            a.times = b.times = TIMES + i
    j = jc.concat_VisData(jp, axis, lazy=True)
    t = tc.concat_VisData(tp, axis, lazy=True)
    assert isinstance(t.data, tc.CatTensor) and t.data.shape == j.data.shape
    assert t.data.numel() == j.data.numel() and t.data.ndim == 5
    assert t.data.size(2) == j.data.size(2)
    assert _relerr(t.data.load().numpy(), j.data.load()) == 0.0
    assert _relerr(t.data[0, 0, 1].numpy(), j.data[0, 0, 1]) == 0.0
    np.testing.assert_array_equal(t.flags.load(), np.asarray(j.flags.load()))
    assert _relerr(t.icov.load().numpy(), j.icov.load()) == 0.0
    meta = {"bl": "blnums", "time": "times", "freq": "freqs"}[axis]
    np.testing.assert_array_equal(getattr(t, meta), getattr(j, meta))
    # get_data on the lazy cube loads it
    assert _relerr(t.get_data().numpy(), j.get_data()) == 0.0
    with pytest.raises(ValueError, match="interleave"):
        tc.concat_VisData(tp, axis, lazy=True, interleave=True)


@pytest.mark.parametrize("interleave", [False, True])
def test_concat_mapdata_caldata_vs_jax(interleave):
    (jm1, tm1), (jm2, tm2) = _maps(40), _maps(41)
    for axis in ("freq", "pix"):
        _same(tc.concat_MapData([tm1, tm2], axis, interleave=interleave),
              jc.concat_MapData([jm1, jm2], axis, interleave=interleave),
              fields=("data", "icov", "angs"))
    ants = make_hex(2)[0]
    c1, c2 = _gains(1, 7, 2, 42), _gains(1, 7, 2, 43)
    j = [_caldata("jax", c, ants, "ee") for c in (c1, c2)]
    t = [_caldata("torch", c, ants, "ee") for c in (c1, c2)]
    for axis in ("ant", "time", "freq"):
        _same(tc.concat_CalData(t, axis, interleave=interleave),
              jc.concat_CalData(j, axis, interleave=interleave))


@pytest.mark.parametrize("kw", [
    {}, dict(wgts="w"), dict(cov="c"), dict(truncate=True),
    dict(wgts="w", truncate=True)])
@pytest.mark.parametrize("dim", [-1, 1])
def test_average_data_vs_jax(kw, dim):
    rng = np.random.default_rng(50)
    x = rng.standard_normal((3, 7, 7)) + 1j * rng.standard_normal((3, 7, 7))
    w = rng.uniform(0.5, 2, x.shape)
    index = np.array([0, 2, 1, 2, 0, 3, 3])
    jkw = {k: {"w": w, "c": 1 / w}.get(v, v) for k, v in kw.items()}
    want = jc.average_data(jnp.asarray(x), dim, index, 4,
                           **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                              else v for k, v in jkw.items()})
    got = tc.average_data(torch.as_tensor(x), dim, index, 4,
                          **{k: torch.as_tensor(v)
                             if isinstance(v, np.ndarray) else v
                             for k, v in jkw.items()})
    for a, b in zip(got, want):
        assert _relerr(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("truncate", [False, True])
def test_average_data_empty_bins_vs_jax(truncate):
    """Bins that no element falls in (1 and 4 of 5), the index given as
    a tensor: zero sums, as JAX's scatter-add leaves them."""
    rng = np.random.default_rng(51)
    x = rng.standard_normal((2, 7)) + 1j * rng.standard_normal((2, 7))
    w = rng.uniform(0.5, 2, x.shape)
    index = np.array([0, 2, 2, 0, 3, 3, 0])
    want = jc.average_data(jnp.asarray(x), -1, index, 5, wgts=jnp.asarray(w),
                           truncate=truncate)
    got = tc.average_data(torch.as_tensor(x), -1, torch.as_tensor(index), 5,
                          wgts=torch.as_tensor(w), truncate=truncate)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _relerr(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("icov", [False, True])
def test_average_tensordata_and_caldata_from_visdata_vs_jax(icov):
    jp, tp = zip(*[_vis(2, 1, icov=icov, seed=s) for s in (60, 61, 62)])
    _same(tc.average_TensorData(tp), jc.average_TensorData(jp))
    w = [np.full(jp[0].data.shape, v) for v in (1.0, 2.0, 3.0)]
    _same(tc.average_TensorData(tp, wgts=[torch.as_tensor(x) for x in w]),
          jc.average_TensorData(jp, wgts=[jnp.asarray(x) for x in w]))
    jcd, tcd = jc.caldata_from_visdata(jp[0]), tc.caldata_from_visdata(tp[0])
    assert tcd.ants == jcd.ants and tcd.pol == jcd.pol
    np.testing.assert_array_equal(tcd.times, jcd.times)
    assert tc.pass_data(tp[0]) is tp[0]
    assert tc.pass_data(tp[0], copy=True) is not tp[0]


def test_difference_blocks_and_dataset_vs_jax(tmp_path):
    jv, tv = _vis(2, 1, icov=True, flags=True, seed=70)
    i1, i2 = dict(time_inds=[0, 1]), dict(time_inds=[2, 3])
    _same(tc.Difference(i1, i2)(tv), jc.Difference(i1, i2)(jv))
    x = np.arange(10.0)
    assert torch.equal(tc.Difference(slice(0, 5), slice(5, 10))(
        torch.as_tensor(x)), torch.full((5,), -5.0, dtype=torch.float64))
    _same(tc.RedVisAvg()(tv), jc.RedVisAvg()(jv))
    w = _wgts(jv)
    _same(tc.RedVisAvg(wgts=w, redtol=0.5)(tv),
          jc.RedVisAvg(wgts=jnp.asarray(w), redtol=0.5)(jv))
    parts = [tv.select(time_inds=[i], inplace=False) for i in range(2)]
    ds = tds.Dataset(parts)
    jd = jds.Dataset([jv.select(time_inds=[i], inplace=False)
                      for i in range(2)])
    assert len(ds) == ds.Nbatch == len(jd) == 2
    for a, b in zip(ds, jd):
        _same(a, b)
    assert tds.Dataset(tv)[0] is tv
    assert tds.Dataset(["f"], read_fn=lambda f: tv)[0] is tv
    # a path without a read_fn is read by load_data (the file layer)
    fname = str(tmp_path / "vis.h5")
    tv.write_hdf5(fname)
    _same(tds.Dataset([fname], device="cpu")[0], jv)


def test_logprob_takes_a_dataset_of_batches():
    """A Dataset of one-time targets is a batched LogProb's target list:
    the same value and gradients as the list."""
    from _torch_graft import build_torch
    prob = build_torch(Ntimes=2, **T64)
    rime = prob.model
    tgt = prob.target[0]
    rime.setup_sim_times([tgt.times[:1], tgt.times[1:]])
    parts = [tgt.select(time_inds=[i], inplace=False) for i in range(2)]
    rng = np.random.default_rng(71)
    for p in parts:
        p.data = p.data + torch.as_tensor(rng.standard_normal(p.data.shape))
    a = bt.LogProb(rime, tds.Dataset(parts))
    b = bt.LogProb(rime, parts)
    va, ga = a.value_and_grad()
    vb, gb = b.value_and_grad()
    assert float(va) == float(vb) and a.Nbatch == 2
    for k in ga:
        assert torch.equal(ga[k], gb[k])


def test_vis_wedge_vs_jax():
    """vis_wedge: the redundant average (groups from antpos) delay-
    transformed, against JAX's, with and without FFT options."""
    jv, tv = _vis(3, 1, icov=True, seed=80)
    for kw in ({}, dict(window="bh"), dict(window="tukey", alpha=0.3,
                                           ravg_kwgs=dict(redtol=0.5))):
        jw, jft = jfft.vis_wedge(jv, **kw)
        tw, tft = tfft.vis_wedge(tv, **kw)
        assert _relerr(tw.data.numpy(), jw.data) <= 1e-9
        np.testing.assert_array_equal(tw.blnums, jw.blnums)
        np.testing.assert_allclose(tft.freqs, jft.freqs, rtol=1e-12)
