"""The port's imaging (models/imaging.py: VisMapper, make_map,
compute_P, deconvolve_map, compute_Am, compute_Pm, VisData2MapData,
get_visdata), ops/phase.py's fringe_phasor, models/beam.py's rotation
helpers and the VisData selections it calls, against the JAX package at
float64 on the CPU (1e-9 relative).

Every VisMapper case runs on both of the port's routes: the plain
version (A built per time in pixel chunks, use_kernel=False) and the
kernel route (use_kernel=True: rime_fwd's plain version on the CPU, the
delays factored as blvecs @ s / c, 'diag' and the normalisations in
closed form), which must agree with each other as well. Cases:
tests/test_analysis.py's point source, tests/test_api_longtail.py's
set_*_inds setters, tests/test_config5.py's image, filter and image
again, each normalisation method with each contract ('diag', 'rowsum',
None), weights, beams, several pixel chunks. Data come from numpy
seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import imaging as jim
from bayeslim_tpu.models import beam as jbeam
from bayeslim_tpu.ops import phase as jphase
from bayeslim_tpu_torch.models import imaging as tim
from bayeslim_tpu_torch.models import beam as tbeam
from bayeslim_tpu_torch.ops import phase as tphase, rime_kernel

TOL = 1e-9
T64 = dict(device="cpu", dtype=torch.float64)
LOC = (21.428305555, -30.72152777, 1073.0)
JD0 = 2458168.3
# (use_kernel, pix_chunk): the plain route, the kernel route whole and in
# chunks of 16 pixels
ROUTES = [(False, None), (True, None), (True, 16)]


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _vd_pair(data, bls, times, freqs, hexN=2, icov=None, flags=None):
    """The same VisData (telescope, antpos, data) in both packages."""
    ants, antvecs = bt.utils.make_hex(hexN, D=15.0)
    jvd = bl.data.containers.VisData()
    jvd.setup_meta(bl.TelescopeModel(LOC), bl.utils.AntposDict(ants,
                                                               antvecs))
    jvd.setup_data(bls, times, freqs, pol="ee", data=jnp.asarray(data),
                   icov=None if icov is None else jnp.asarray(icov),
                   flags=None if flags is None else jnp.asarray(flags))
    tvd = bt.VisData()
    tvd.setup_meta(bt.TelescopeModel(LOC), bt.utils.AntposDict(ants,
                                                               antvecs))
    tvd.setup_data(bls, times, freqs, pol="ee", data=torch.tensor(data),
                   icov=None if icov is None else torch.as_tensor(icov),
                   flags=None if flags is None else torch.as_tensor(flags))
    return jvd, tvd


def _random_case(seed=0, nfreq=6, ntime=2, hexN=2, weights=False):
    rng = np.random.default_rng(seed)
    ants, _ = bt.utils.make_hex(hexN, D=15.0)
    bls = [(a, b) for i, a in enumerate(ants) for b in ants[i + 1:]]
    freqs = np.linspace(120e6, 140e6, nfreq)
    times = JD0 + np.arange(ntime) * 2e-3
    shp = (1, 1, len(bls), ntime, nfreq)
    data = rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
    icov = rng.uniform(0.5, 2.0, shp) if weights else None
    return _vd_pair(data, bls, times, freqs, hexN, icov=icov)


def _grid(n=9, width=12.0):
    """RA / Dec [deg] of a grid around the zenith at JD0."""
    ra0 = bt.TelescopeModel(LOC).JD2RA(JD0)
    g = np.linspace(-width, width, n)
    rr, dd = np.meshgrid(ra0 + g, LOC[1] + g)
    return rr.ravel(), dd.ravel()


def _beams(freqs, kind):
    if kind is None:
        return None, None
    params = np.ones((1, 1, 1, 1, 2)) * 14.0
    power = kind == "power"
    jb = bl.PixelBeam(jnp.asarray(params), freqs,
                      R=bl.beam_model.AiryResponse(powerbeam=power),
                      pol="e", powerbeam=power, fov=180.0)
    tb = bt.PixelBeam(params, freqs, R=bt.AiryResponse(powerbeam=power),
                      pol="e", powerbeam=power, fov=180.0, **T64)
    return jb, tb


def _mappers(jvd, tvd, ra, dec, route, beam=None, fov=180.0):
    jb, tb = _beams(jvd.freqs, beam)
    use_kernel, chunk = route
    jm = jim.VisMapper(jvd, ra, dec, beam=jb, fov=fov)
    tm = tim.VisMapper(tvd, ra, dec, beam=tb, fov=fov,
                       use_kernel=use_kernel, pix_chunk=chunk)
    assert tm._kernel_route() == bool(use_kernel)
    return jm, tm


# ------------------------------------------------------------------- maps
@pytest.mark.parametrize("route", ROUTES)
def test_point_source_images_to_its_location_vs_jax(route):
    """tests/test_analysis.py's case: one point source (a JAX RIME's
    visibilities, fed to both mappers) images back to its pixel."""
    from tests.test_rime import (setup_Array, setup_Telescope,
                                 setup_UniformBeam)
    from bayeslim_tpu.models.sky import PointSky, PointSkyResponse
    T = setup_Telescope()
    freqs = np.linspace(130e6, 150e6, 8)
    arr = setup_Array(N=3, freqs=freqs)
    ra0 = bt.TelescopeModel(T.location).JD2RA(JD0)
    sky = PointSky(jnp.asarray(np.ones((1, 1, 8, 1)) * 5.0),
                   jnp.asarray([[ra0], [-30.72]]),
                   R=PointSkyResponse(freqs, freq_mode="channel"))
    bls = arr.get_bls(keep_autos=False)
    rime = bl.RIME(sky, T, setup_UniformBeam(freqs), arr, bls,
                   np.asarray([JD0]), freqs)
    vd = rime.forward()
    jvd, tvd = _vd_pair(np.asarray(vd.data), bls, [JD0], freqs, hexN=3)
    dgrid = np.linspace(-5, 5, 21)
    rr, dd = np.meshgrid(ra0 + dgrid, -30.72 + dgrid)
    jm, tm = _mappers(jvd, tvd, rr.ravel(), dd.ravel(), route)
    jmaps, jP = jm.make_map(return_P=True)
    maps, P = tm.make_map(return_P=True)
    assert _relerr(_np(maps), np.asarray(jmaps)) <= TOL
    assert _relerr(_np(P), np.asarray(jP)) <= TOL
    assert _relerr(_np(tm.D), np.asarray(jm.D)) <= TOL
    m = _np(maps).mean(0).reshape(21, 21)
    assert np.unravel_index(np.argmax(m), m.shape) == (10, 10)
    assert _np(P).min() >= 0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("method", ["w", "Aw", "A2w"])
@pytest.mark.parametrize("contract", ["diag", "rowsum", None])
def test_make_map_methods_and_contracts_vs_jax(route, method, contract):
    """Every normalisation with every PSF contraction, weighted data and
    an Airy power beam; the maps, P and D against the JAX mapper."""
    jvd, tvd = _random_case(seed=1, weights=True)
    ra, dec = _grid(7, 30.0)
    jm, tm = _mappers(jvd, tvd, ra, dec, route, beam="power")
    for m in (jm, tm):
        m.set_normalization(method)
    jmaps, jP = jm.make_map(return_P=True, contract=contract)
    maps, P = tm.make_map(return_P=True, contract=contract)
    assert maps.shape == (6, 49)
    assert _relerr(_np(maps), np.asarray(jmaps)) <= TOL
    assert _relerr(_np(P), np.asarray(jP)) <= TOL
    assert _relerr(_np(tm.D), np.asarray(jm.D)) <= TOL
    # the mapper's compute_P is make_map's P
    assert _relerr(_np(tm.compute_P(contract=contract)), _np(P)) <= TOL
    assert _relerr(_np(tm.compute_P(contract=contract)),
                   np.asarray(jm.compute_P(contract=contract))) <= TOL


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("beam", [None, "field"])
def test_make_map_beams_and_icov_vs_jax(route, beam):
    """No beam, and a field (non-power) beam squared; set_normalization
    with an explicit icov; a list of VisData imaged as a leading axis;
    no P."""
    jvd, tvd = _random_case(seed=2)
    ra, dec = _grid(6, 20.0)
    jm, tm = _mappers(jvd, tvd, ra, dec, route, beam=beam)
    icov = np.random.default_rng(3).uniform(0.5, 2, tvd.data.shape)
    jm.set_normalization("A2w", icov=jnp.asarray(icov))
    tm.set_normalization("A2w", icov=torch.as_tensor(icov))
    jmaps, jP = jm.make_map(return_P=False)
    maps, P = tm.make_map(return_P=False)
    assert P is None
    assert _relerr(_np(maps), np.asarray(jmaps)) <= TOL
    j2, _ = jm.make_map(vd=[jvd, jvd], return_P=False)
    m2, _ = tm.make_map(vd=[tvd, tvd], return_P=False)
    assert m2.shape == (2, 6, 36)
    assert _relerr(_np(m2), np.asarray(j2)) <= TOL


def test_kernel_route_equals_plain_route():
    """fused_map == plain_map: the kernel route (rime_fwd's plain
    version on the CPU, use_kernel=True) against the plain A-building
    route, maps and every P."""
    jvd, tvd = _random_case(seed=4, weights=True)
    ra, dec = _grid(8, 25.0)
    tb = _beams(tvd.freqs, "power")[1]
    plain = tim.VisMapper(tvd, ra, dec, beam=tb, use_kernel=False)
    fused = tim.VisMapper(tvd, ra, dec, beam=tb, use_kernel=True,
                          pix_chunk=20)
    for contract in ("diag", "rowsum"):
        a, Pa = plain.make_map(contract=contract)
        b, Pb = fused.make_map(contract=contract)
        assert _relerr(_np(b), _np(a)) <= 1e-12
        assert _relerr(_np(Pb), _np(Pa)) <= 1e-12
    maps = _np(a)
    assert _relerr(_np(fused.compute_Am(torch.as_tensor(maps))),
                   _np(plain.compute_Am(torch.as_tensor(maps)))) <= 1e-12
    assert _relerr(_np(fused.compute_Pm(torch.as_tensor(maps))),
                   _np(plain.compute_Pm(torch.as_tensor(maps)))) <= 1e-12


def test_kernel_route_eligibility(monkeypatch):
    """The kernel route's rules: taken with use_kernel=True on the CPU;
    not with use_kernel 'auto' on the CPU, an irregular channel
    selection, a complex beam, or inside force_chunked (each an explicit
    rule: the maps then come from the plain route, equal to 1e-9)."""
    calls = []
    real = tim.rime_fwd

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tim, "rime_fwd", counting)
    _, tvd = _random_case(seed=5, nfreq=6)
    ra, dec = _grid(5, 20.0)
    m = tim.VisMapper(tvd, ra, dec, use_kernel=True)
    ref, _ = m.make_map()
    assert len(calls) == 2                          # 2 times x 1 chunk
    assert not tim.VisMapper(tvd, ra, dec)._kernel_route()
    with rime_kernel.force_chunked():
        assert not m._kernel_route()
        forced, _ = m.make_map()
    assert len(calls) == 2
    assert _relerr(_np(forced), _np(ref)) <= TOL
    m.set_freq_inds([0, 1, 3])
    assert not m._kernel_route()
    m.set_freq_inds([1, 3, 5])
    assert m._kernel_route()
    params = np.ones((1, 2, 1, 1, 2)) * 14.0 + 0.1j
    cb = bt.PixelBeam(params, tvd.freqs, R=bt.GaussResponse(powerbeam=False),
                      pol="e", powerbeam=False, fov=180.0, **T64)
    assert not tim.VisMapper(tvd, ra, dec, beam=cb,
                             use_kernel=True)._kernel_route()


@pytest.mark.parametrize("route", ROUTES)
def test_ind_setters_vs_jax(route):
    """tests/test_api_longtail.py's set_*_inds case: frequencies (a
    same-shape selection twice), times and baselines, an irregular
    selection, and back to all."""
    jvd, tvd = _random_case(seed=6, nfreq=4, ntime=3)
    ra, dec = _grid(5, 3.0)
    jm, tm = _mappers(jvd, tvd, ra, dec, route)
    m_all, _ = tm.make_map(return_P=False)
    steps = [("set_freq_inds", [0, 2]), ("set_freq_inds", [1, 3]),
             ("set_freq_inds", [0, 1, 3]), ("set_time_inds", [0]),
             ("set_bl_inds", [0, 1]), ("set_freq_inds", None),
             ("set_time_inds", None), ("set_bl_inds", None)]
    for name, arg in steps:
        getattr(jm, name)(arg)
        getattr(tm, name)(arg)
        assert tm.Nbls == jm.Nbls and len(tm.times) == len(jm.times)
        a, Pa = tm.make_map(return_P=True)
        b, Pb = jm.make_map(return_P=True)
        assert a.shape == b.shape
        assert _relerr(_np(a), np.asarray(b)) <= TOL
        assert _relerr(_np(Pa), np.asarray(Pb)) <= TOL
    assert _relerr(_np(a), _np(m_all)) <= 1e-12
    tm.set_freq_inds([1, 3])
    m13, _ = tm.make_map(return_P=False)
    assert _relerr(_np(m13), _np(m_all)[[1, 3]]) <= 1e-12
    tm.set_bl_inds(blnums=tvd.blnums[:3])
    assert tm.Nbls == 3


@pytest.mark.parametrize("route", ROUTES)
def test_compute_Am_Pm_vs_jax(route):
    """compute_Am (a map, a stack of maps, a MapData) and compute_Pm
    (its normalisation, and a D given) against the JAX mapper."""
    jvd, tvd = _random_case(seed=7, weights=True)
    ra, dec = _grid(6, 25.0)
    jm, tm = _mappers(jvd, tvd, ra, dec, route, beam="power")
    rng = np.random.default_rng(8)
    m2 = rng.standard_normal((6, 36))
    m3 = rng.standard_normal((2, 6, 36))
    for m in (m2, m3):
        a = tm.compute_Am(torch.as_tensor(m))
        b = jm.compute_Am(jnp.asarray(m))
        assert a.shape == b.shape
        assert _relerr(_np(a), np.asarray(b)) <= TOL
        a = tm.compute_Pm(torch.as_tensor(m))
        b = jm.compute_Pm(jnp.asarray(m))
        assert _relerr(_np(a), np.asarray(b)) <= TOL
    D = rng.uniform(0.5, 1.5, (6, 36))
    assert _relerr(_np(tm.compute_Pm(torch.as_tensor(m2),
                                     D=torch.as_tensor(D))),
                   np.asarray(jm.compute_Pm(jnp.asarray(m2),
                                            D=jnp.asarray(D)))) <= TOL
    assert _relerr(_np(tm.compute_P(D=torch.as_tensor(D), contract=None)),
                   np.asarray(jm.compute_P(D=jnp.asarray(D),
                                           contract=None))) <= TOL
    maps, _ = tm.make_map()
    md = tm.to_MapData(maps)
    assert _relerr(_np(tm.compute_Am(md)),
                   np.asarray(jm.compute_Am(jm.to_MapData(
                       jm.make_map()[0])))) <= TOL
    assert _relerr(_np(tm.compute_Am([maps, maps])[1]),
                   _np(tm.compute_Am(maps))) <= 1e-12


@pytest.mark.parametrize("route", ROUTES)
def test_config5_image_filter_image_vs_jax(route):
    """tests/test_config5.py's steps 3-4: image the visibilities, delay
    filter them (a GPFilter(residual=True) of a wide sinc covariance,
    one per package, each on the same JAX-simulated data), image the
    filtered data: the maps against the JAX ones, and the filtered map
    suppressed below half the unfiltered one."""
    from tests.test_config5 import _build
    rime, T, arr, bls, times, freqs, angs = _build(ntime=2)
    vd = rime.forward()
    data = np.asarray(vd.data)
    jvd, tvd = _vd_pair(data, bls, times, freqs, hexN=3)
    x = (freqs - freqs[0]) / (freqs[-1] - freqs[0])
    jf = bl.filt.GPFilter(bl.filt.sinc_cov(x, ls=0.5),
                          jnp.eye(len(freqs)) * 1e-2, dim=-1, residual=True)
    tf = bt.GPFilter(bt.models.filt.sinc_cov(x, ls=0.5, device="cpu"),
                     torch.eye(len(freqs), dtype=torch.float64) * 1e-2,
                     dim=-1, residual=True, device="cpu")
    jfilt, tfilt = jf.forward(jvd), tf.forward(tvd)
    assert _relerr(_np(tfilt.data), np.asarray(jfilt.data)) <= TOL
    sums = []
    for j, t in ((jvd, tvd), (jfilt, tfilt)):
        jm = jim.VisMapper(j, angs[0], angs[1])
        tm = tim.VisMapper(t, angs[0], angs[1], use_kernel=route[0],
                           pix_chunk=route[1] and 200)
        jmaps, jP = jm.make_map(return_P=True)
        maps, P = tm.make_map(return_P=True)
        assert maps.shape == (len(freqs), angs.shape[1])
        assert np.isfinite(_np(maps)).all()
        assert _relerr(_np(maps), np.asarray(jmaps)) <= TOL
        assert _relerr(_np(P), np.asarray(jP)) <= TOL
        sums.append(float(maps.abs().sum()))
    assert sums[1] < 0.5 * sums[0]


# --------------------------------------------------------- the functions
def test_module_functions_vs_jax():
    """make_map, compute_P (each contract, with D), compute_Am,
    compute_Pm and deconvolve_map (pinv, its diagonal, a diagonal P)."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((5, 3, 4)) + 1j * rng.standard_normal((5, 3, 4))
    v = rng.standard_normal((2, 5, 3)) + 1j * rng.standard_normal((2, 5, 3))
    w = rng.uniform(0.5, 2, (5, 3))
    m = rng.standard_normal((3, 4))
    D = rng.uniform(0.5, 2, (3, 4))
    tA, tw, tm, tD = (torch.as_tensor(x) for x in (A, w, m, D))
    jA, jw, jm_, jD = (jnp.asarray(x) for x in (A, w, m, D))
    assert _relerr(_np(tim.make_map(torch.as_tensor(v), tw, tA)),
                   np.asarray(jim.make_map(jnp.asarray(v), jw, jA))) <= TOL
    for contract in ("diag", "rowsum", None):
        for d in (None, True):
            a = tim.compute_P(tA, tw, D=tD if d else None, contract=contract)
            b = jim.compute_P(jA, jw, D=jD if d else None, contract=contract)
            assert _relerr(_np(a), np.asarray(b)) <= TOL
    assert _relerr(_np(tim.compute_Am(tA, tm.to(tA.dtype))),
                   np.asarray(jim.compute_Am(jA, jm_))) <= TOL
    assert _relerr(_np(tim.compute_Pm(tA, tw, tm, D=tD)),
                   np.asarray(jim.compute_Pm(jA, jw, jm_, D=jD))) <= TOL
    B = rng.standard_normal((3, 6, 6))
    P = B @ np.transpose(B, (0, 2, 1)) + 4 * np.eye(6)
    mm = rng.standard_normal((3, 6))
    for pinv in (True, False):
        assert _relerr(_np(tim.deconvolve_map(torch.as_tensor(mm),
                                              torch.as_tensor(P), pinv=pinv)),
                       np.asarray(jim.deconvolve_map(
                           jnp.asarray(mm), jnp.asarray(P),
                           pinv=pinv))) <= TOL
    Pd = rng.uniform(0.5, 2, (3, 6))
    assert _relerr(_np(tim.deconvolve_map(torch.as_tensor(mm),
                                          torch.as_tensor(Pd))),
                   np.asarray(jim.deconvolve_map(jnp.asarray(mm),
                                                 jnp.asarray(Pd)))) <= TOL


def test_visdata2mapdata_and_get_visdata_vs_jax():
    rng = np.random.default_rng(10)
    flags = rng.uniform(size=(1, 1, 21, 2, 6)) < 0.05
    flags[..., 2] = True
    jvd, tvd = _random_case(seed=11)
    jvd.flags, tvd.flags = jnp.asarray(flags), torch.as_tensor(flags)
    ra, dec = _grid(4, 10.0)
    tm = tim.VisMapper(tvd, ra, dec, use_kernel=False)
    jm = jim.VisMapper(jvd, ra, dec)
    maps, _ = tm.make_map()
    jmaps, _ = jm.make_map()
    a, b = tm.to_MapData(maps), jm.to_MapData(jmaps)
    assert a.pols == b.pols == ["ee"]
    assert np.array_equal(np.asarray(a.angs), np.asarray(b.angs))
    assert np.array_equal(_np(a.flags), np.asarray(b.flags))
    assert _relerr(_np(a.data), np.asarray(b.data)) <= TOL
    assert _relerr(_np(a.norm), np.asarray(b.norm)) <= TOL
    assert a.name == b.name == "dirty_map"
    md = tim.VisData2MapData(tvd, df=1e5, name="x")
    jmd = jim.VisData2MapData(jvd, df=1e5, name="x")
    assert md.df == jmd.df and md.pols == jmd.pols
    for kw in (dict(), dict(bl_inds=[0, 3], time_inds=[1],
                            freq_inds=[2, 4]), dict(squeeze=True,
                                                    time_inds=[0])):
        assert np.array_equal(_np(tim.get_visdata(tvd, **kw)),
                              np.asarray(jim.get_visdata(jvd, **kw)))
    assert np.array_equal(_np(tim.get_visdata([tvd, tvd], bl_inds=[1])),
                          np.asarray(jim.get_visdata([jvd, jvd],
                                                     bl_inds=[1])))


def test_visdata_selection_vs_jax():
    """VisData's get_inds / _index_arr / select (bl, times, freqs, pol,
    *_inds, inplace or not) against the JAX package's."""
    jvd, tvd = _random_case(seed=12, ntime=3, weights=True)
    sels = [dict(bl=[(0, 1), (2, 3)]), dict(times=tvd.times[[2, 0]]),
            dict(freqs=tvd.freqs[[1, 4]]), dict(pol="ee"),
            dict(bl_inds=[4, 1], time_inds=[1], freq_inds=[0, 5])]
    for sel in sels:
        ji = jvd.get_inds(**sel)
        ti = tvd.get_inds(**sel)
        for a, b in zip(ti, ji):
            if isinstance(a, slice):
                assert a == b
            else:
                assert np.array_equal(a, b)
        assert np.array_equal(_np(tvd._index_arr(tvd.data, ti)),
                              np.asarray(jvd._index_arr(jvd.data, ji)))
        a = tvd.select(inplace=False, **sel)
        b = jvd.select(inplace=False, **sel)
        assert np.array_equal(a.blnums, b.blnums)
        assert np.array_equal(a.times, b.times)
        assert np.array_equal(a.freqs, b.freqs)
        assert np.array_equal(_np(a.data), np.asarray(b.data))
        assert np.array_equal(_np(a.icov), np.asarray(b.icov))
    n = tvd.Nbls
    tvd.select(bl_inds=[0, 1])
    assert tvd.Nbls == 2 and n == 21
    tvd._set_bls([(0, 1)])
    assert tvd.bls == [(0, 1)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("conj", [False, True])
def test_fringe_phasor_vs_jax(dtype, conj):
    rng = np.random.default_rng(13)
    tau = rng.uniform(-1e-6, 1e-6, (7, 5)).astype(dtype)
    for freqs, grid in ((np.linspace(100e6, 200e6, 33), {}),
                        (np.asarray([100e6, 130e6, 131e6]), {}),
                        (np.linspace(100e6, 200e6, 33),
                         dict(f0=100e6, df=100e6 / 32))):
        a = tphase.fringe_phasor(torch.as_tensor(tau), freqs, conj=conj,
                                 **grid)
        b = jphase.fringe_phasor(jnp.asarray(tau), freqs, conj=conj, **grid)
        assert a.shape == (7, 5, len(freqs))
        tol = TOL if dtype == np.float64 else 1e-5
        assert np.abs(_np(a) - np.asarray(b)).max() <= tol


def test_beam_rotation_helpers_vs_jax():
    """tests/test_reference_parity.py's rotation chain case."""
    rng = np.random.default_rng(43)
    alpha = rng.uniform(0, 2 * np.pi, 12)
    delta = rng.uniform(-np.pi / 2, np.pi / 2, 12)
    phi = rng.uniform(0, 2 * np.pi, 12)
    theta = rng.uniform(0, np.pi, 12)
    pairs = [(tbeam.R_eq_to_xyz(alpha, delta), jbeam.R_eq_to_xyz(alpha,
                                                                 delta)),
             (tbeam.R_beta(0.63), jbeam.R_beta(0.63)),
             (tbeam.rotation(0.4, "x"), jbeam.rotation(0.4, "x")),
             (tbeam.R_XYZ_to_top(phi, theta), jbeam.R_XYZ_to_top(phi,
                                                                 theta)),
             (tbeam.R_chi(alpha, delta, 0.63), jbeam.R_chi(alpha, delta,
                                                           0.63))]
    for a, b in pairs:
        assert a.shape == np.shape(b)
        assert np.array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        tbeam.rotation(0.1, "z")
