"""The port's host-side helpers (ROADMAP A2) against the JAX package at
float64 (1e-9 relative, or equal where the result is exact): the
utils/indexing.py helpers (AntposDict.select, split_into_groups,
tukey_taper, SimpleIndex, Jy_to_KStr, tensor2numpy, conjbl,
colat2lat, fit_zero / get_zeros, stripe_tukey_mask, half_gaussian_taper,
voigt_beam) and models/sky.py's (Jy2K, ang_index, eqarea_grid,
index_sky_pixels), white_noise by its moments and seeding (it draws from
another generator than JAX's), utils/dtypes.py::isreal_view, the
telescope's conversion cache (TelescopeModel.hash, clear_cache, eq2top /
top2eq with store= and key=), build_reds over each of its arguments
after skip_reds, ArrayModel's cache arguments, match_bl_len and
gen_fringe (through s= and zen / az, conj, a freqs override, and its
gradient in the antenna positions), and lbfgs_approx_cov on the graft
chain in both of its forms, with the rounding sensitivity of a second
probe (ROADMAP C11). lbfgs_approx_cov(as_dense=) is in
tests/test_torch_redcal.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.inference import bfgs as jbfgs
from bayeslim_tpu.models import sky as jsky
from bayeslim_tpu.models import telescope as jtel
from bayeslim_tpu.utils import dtypes as jdt
from bayeslim_tpu.utils import indexing as jix
from bayeslim_tpu_torch.models import sky as tsky
from bayeslim_tpu_torch.models import telescope as ttel
from bayeslim_tpu_torch.utils import dtypes as tdt
from bayeslim_tpu_torch.utils import indexing as tix

from _torch_graft import LOC, build_torch

T64 = dict(device="cpu", dtype=torch.float64)
JD0 = 2458168.3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _same(a, b):
    """Equal structure and values (1e-12 relative for floats)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape
        if a.dtype.kind in "fc":
            assert _relerr(a, b) <= 1e-12 or np.array_equal(a, b)
        else:
            assert np.array_equal(a, b)


# ------------------------------------------------------- utils/indexing
def test_antposdict_select_matches_jax():
    ants, antvecs = tix.make_hex(3)
    t = tix.AntposDict(ants, antvecs).select([5, 0, 7])
    j = jix.AntposDict(ants, antvecs).select([5, 0, 7])
    assert t.ants == j.ants == [5, 0, 7]
    _same(t.antvecs, j.antvecs)
    tt = tix.AntposDict(ants, torch.as_tensor(antvecs)).select([2, 3])
    assert isinstance(tt.antvecs, torch.Tensor)
    _same(tt.antvecs, antvecs[[2, 3]])


@pytest.mark.parametrize("kw", [dict(Nelem=3), dict(Ngroup=3),
                                dict(Nelem=3, interleave=True),
                                dict(Ngroup=4, interleave=True),
                                dict(Nelem=20)])
def test_split_into_groups_matches_jax(kw):
    items = list(range(10))
    assert tix.split_into_groups(items, **kw) == \
        jix.split_into_groups(items, **kw)


def test_tukey_taper_matches_jax():
    for n, a in ((16, 0.5), (7, 0.0), (33, 1.0)):
        t = tix.tukey_taper(n, a, **T64)
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        assert _relerr(t.numpy(), jix.tukey_taper(n, a)) <= 1e-12


def test_half_gaussian_taper_matches_jax():
    x = np.linspace(-3, 3, 41)
    for below in (True, False):
        t = tix.half_gaussian_taper(torch.as_tensor(x), 0.4, 0.7, below)
        assert _relerr(t.numpy(), jix.half_gaussian_taper(
            x, 0.4, 0.7, below)) <= 1e-12
    t = tix.half_gaussian_taper(x, 0.4, 0.7, device="cpu")
    assert t.dtype == torch.float64 and t.device.type == "cpu"


HOST_CASES = {
    "Jy_to_KStr": lambda m: m.Jy_to_KStr(np.linspace(1e8, 2e8, 5)),
    "conjbl tuple": lambda m: m.conjbl((1, 2)),
    "conjbl list": lambda m: m.conjbl([(1, 2), (3, 4)]),
    "conjbl blnum": lambda m: m.conjbl(101102),
    "conjbl blnums": lambda m: m.conjbl(np.asarray([101102, 103104])),
    "colat2lat deg": lambda m: m.colat2lat(np.asarray([0.0, 30.0, 120.0])),
    "colat2lat rad": lambda m: m.colat2lat(np.asarray([0.0, 1.0]),
                                           deg=False),
    "fit_zero": lambda m: m.fit_zero(np.asarray([0.9, 1.0, 1.2]),
                                     np.asarray([-0.2, 0.05, 0.4])),
    "get_zeros": lambda m: m.get_zeros(
        np.linspace(0, 10, 200), np.cos(np.linspace(0, 10, 200))),
    "stripe_tukey_mask": lambda m: m.stripe_tukey_mask(
        np.linspace(0, np.pi, 50), 0.5, 2.5, np.linspace(0, 2 * np.pi, 50),
        1.0, 5.0, theta_alpha=0.3, phi_alpha=0.6),
    "voigt_beam": lambda m: m.voigt_beam(4, 0.3, 0.1),
    "SimpleIndex": lambda m: [m.SimpleIndex(3)[k] for k in (0, "a", 9)],
    # models/sky.py's host helpers, through each package's sky module
    "Jy2K steradians": lambda m: _sky(m).Jy2K(
        np.linspace(1e8, 2e8, 5), steradians=3e-4),
    "Jy2K px_area": lambda m: _sky(m).Jy2K(np.asarray([1.5e8]),
                                           px_area=1e-3),
    "ang_index cuts": lambda m: _sky(m).ang_index(
        *_ANGS, theta_min=0.3, theta_max=2.5, phi_min=1.0, phi_max=5.0),
    "ang_index none": lambda m: _sky(m).ang_index(*_ANGS),
    "eqarea_grid": lambda m: _sky(m).eqarea_grid(7.0),
    "index_sky_pixels": lambda m: _sky(m).index_sky_pixels(
        _LARGE, _LARGE[:, [3, 17, 50, 199]] + np.asarray(
            [[0.01, -360.0, 360.02, 0.0], [0.02, -0.01, 0.0, 0.03]])),
}
_sky = {tix: tsky, jix: jsky}.get
_ANGS = (np.random.default_rng(4).uniform(0, np.pi, 300),
         np.random.default_rng(5).uniform(0, 2 * np.pi, 300))
_LARGE = np.stack([np.random.default_rng(6).uniform(0, 360, 200),
                   np.random.default_rng(7).uniform(-90, 90, 200)])


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_helper_matches_jax(name):
    t, j = HOST_CASES[name](tix), HOST_CASES[name](jix)
    _same(t, j)


def test_tensor2numpy():
    x = torch.arange(6.0).reshape(2, 3)
    a = tix.tensor2numpy(x)
    a[0, 0] = 9.0
    assert float(x[0, 0]) == 0.0 and isinstance(a, np.ndarray)
    y = np.arange(3.0)
    assert tix.tensor2numpy(y) is not y
    assert tix.tensor2numpy(y, clone=False) is y
    assert np.array_equal(tix.tensor2numpy(x.requires_grad_(True)),
                          jix.tensor2numpy(np.arange(6.0).reshape(2, 3)))


@pytest.mark.parametrize("cplx", [False, True])
def test_white_noise_moments_and_seeding(cplx):
    shape = (4, 50000)
    g = torch.Generator().manual_seed(3)
    x = tix.white_noise(shape, key=g, dtype=torch.float64, complex=cplx)
    assert tuple(x.shape) == shape and x.device.type == "cpu"
    assert x.dtype == (torch.complex128 if cplx else torch.float64)
    # unit variance in all (1/2 a part when complex), zero mean: 5 sigma
    n = x.numel()
    assert abs(float(x.mean().abs())) < 5 / np.sqrt(n)
    var = float(torch.mean(torch.abs(x) ** 2))
    assert abs(var - 1.0) < 5 * np.sqrt(2.0 / n)
    if cplx:
        assert abs(float(torch.var(x.real)) - 0.5) < 5 * np.sqrt(0.5 / n)
    # the same seed gives the same draws, another seed others
    y = tix.white_noise(shape, key=torch.Generator().manual_seed(3),
                        dtype=torch.float64, complex=cplx)
    z = tix.white_noise(shape, key=torch.Generator().manual_seed(4),
                        dtype=torch.float64, complex=cplx)
    assert torch.equal(x, y) and not torch.equal(x, z)
    # JAX's draws have the same shape and moments
    j = np.asarray(jix.white_noise(shape, key=jax.random.PRNGKey(3),
                                   complex=cplx))
    assert j.shape == shape
    assert abs(np.mean(np.abs(j) ** 2) - 1.0) < 5 * np.sqrt(2.0 / n)
    np.random.seed(0)
    assert tix.white_noise(7, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("x", [np.zeros((3, 2)), np.zeros((3, 3)),
                               np.zeros(2), np.zeros(()),
                               np.zeros((2, 2), complex)])
def test_isreal_view_matches_jax(x):
    assert tdt.isreal_view(x) == tdt.isreal_view(torch.as_tensor(x)) \
        == bool(jdt.isreal_view(x))
    assert bt.utils.isreal_view is tdt.isreal_view


# ----------------------------------------------------------- telescope
def test_telescope_conversion_cache_matches_jax():
    ra = np.linspace(0, 359, 50)
    dec = np.linspace(-80, 80, 50)
    t, j = bt.TelescopeModel(LOC), bl.TelescopeModel(LOC)
    assert t.hash(JD0, ra) == j.hash(JD0, ra)
    zt, at = t.eq2top(JD0, ra, dec, store=True)
    zj, aj = j.eq2top(JD0, ra, dec, store=True)
    assert _relerr(zt, zj) <= 1e-12 and _relerr(at, aj) <= 1e-12
    key = t.hash(JD0, ra)
    assert key in t.conv_cache and key in j.conv_cache.cache
    # a cached key answers from the cache whatever the angles
    assert t.eq2top(JD0, ra, dec + 1.0)[0] is zt
    t.clear_cache(key)
    j.clear_cache(key)
    assert key not in t.conv_cache
    assert _relerr(t.eq2top(JD0, ra, dec + 1.0)[0],
                   j.eq2top(JD0, ra, dec + 1.0)[0]) <= 1e-12
    rt, dt_ = t.top2eq(JD0, zt, at, store=True, key="k")
    rj, dj = j.top2eq(JD0, zj, aj, store=True, key="k")
    assert _relerr(rt, rj) <= 1e-12 and _relerr(dt_, dj) <= 1e-12
    assert t.top2eq(JD0, zt + 1, at, key="k")[0] is rt
    t.clear_cache()
    assert t.conv_cache == {}


BUILD_REDS = [dict(), dict(min_EW_len=20.0), dict(exclude_reds=[(0, 1)]),
              dict(exclude_reds=[(0, 1), (2, 0)], use_2d=True),
              dict(norm_vec=True), dict(use_blnums=True), dict(use_2d=True),
              dict(fcluster=True), dict(skip_reds=True, use_blnums=True),
              dict(min_len=1.0, max_len=40.0, min_EW_len=5.0,
                   red_bls=[(0, 2), (0, 1)]),
              dict(redtol=0.5, norm_vec=True, use_2d=True)]


@pytest.mark.parametrize("kw", BUILD_REDS, ids=[
    ",".join(sorted(k)) or "defaults" for k in BUILD_REDS])
def test_build_reds_arguments_match_jax(kw):
    ants, antvecs = tix.make_hex(3)
    antvecs = antvecs + np.random.default_rng(0).normal(
        0, 0.05, antvecs.shape) * [1, 1, 0]
    t = ttel.build_reds(tix.AntposDict(ants, antvecs), **kw)
    j = jtel.build_reds(jix.AntposDict(ants, antvecs), **kw)
    _same(list(t), list(j))
    # red_info is returned as it is
    assert ttel.build_reds(None, red_info=t) is t


def test_array_model_cache_args_and_freq_index_match_jax():
    ants, antvecs = tix.make_hex(2)
    freqs = np.linspace(1e8, 1.2e8, 6)
    kw = dict(cache_s=False, cache_depth=3, cache_f=True,
              cache_f_angs=np.zeros((2, 4)), interp_mode="nearest")
    t = bt.ArrayModel(tix.AntposDict(ants, antvecs), freqs=freqs,
                      **kw, **T64)
    j = bl.ArrayModel(jix.AntposDict(ants, antvecs), freqs=freqs, **kw)
    for k in kw:
        assert np.array_equal(getattr(t, k), getattr(j, k))
    for idx in ([0, 2, 4], [1, 3], None, [5]):
        t.set_freq_index(idx)
        j.set_freq_index(idx)
        assert np.array_equal(t.freqs, j.freqs)
    t.set_freq_index([1, 3])
    t.set_freqs(freqs[:3])
    assert np.array_equal(t.freqs, freqs[:3]) and t._freq_idx is None


def test_match_bl_len_matches_jax():
    ants, antvecs = tix.make_hex(3)
    t = bt.ArrayModel(tix.AntposDict(ants, antvecs), **T64)
    j = bl.ArrayModel(jix.AntposDict(ants, antvecs))
    bls = t.get_bls(keep_autos=False)
    for bl_ in bls[:12]:
        for cand in (bls[1:8], bls[20:40], [bl_], []):
            assert t.match_bl_len(bl_, cand) == j.match_bl_len(bl_, cand)


@pytest.mark.parametrize("route", ["s", "zen_az"])
@pytest.mark.parametrize("conj", [False, True])
def test_gen_fringe_matches_jax(route, conj):
    ants, antvecs = tix.make_hex(2)
    freqs = np.linspace(1e8, 2e8, 7)
    t = bt.ArrayModel(tix.AntposDict(ants, antvecs), freqs=freqs, **T64)
    j = bl.ArrayModel(jix.AntposDict(ants, antvecs), freqs=freqs)
    bls = t.get_bls(keep_autos=False)
    rng = np.random.default_rng(1)
    zen, az = rng.uniform(0, 80, 30), rng.uniform(0, 360, 30)
    kw = dict(s=t.s_vector(zen, az)) if route == "s" \
        else dict(zen=zen, az=az)
    w = rng.standard_normal((len(bls), len(freqs), 30))
    for f in (None, freqs[::2] + 3.0):
        bv = t.get_blvecs(bls).detach().requires_grad_(True)
        ft = t.gen_fringe(bv, conj=conj, freqs=f, **kw)
        fj = j.gen_fringe(j.get_blvecs(bls), conj=conj, freqs=f, **kw)
        assert tuple(ft.shape) == fj.shape == (
            len(bls), len(freqs if f is None else f), 30)
        assert _relerr(ft.detach().numpy(), fj) <= 1e-9
        # the gradient in the baseline vectors
        nf = ft.shape[1]
        (gt,) = torch.autograd.grad(torch.sum(
            ft.real * torch.as_tensor(w[:, :nf])), bv)
        gj = jax.grad(lambda b: jnp.sum(j.gen_fringe(
            b, conj=conj, freqs=f, **kw).real * w[:, :nf]))(
            jnp.asarray(bv.detach().numpy()))
        assert _relerr(gt.numpy(), gj) <= 1e-9


# ---------------------------------------------------- lbfgs_approx_cov
def _graft_pair(jax_chunk=512, torch_chunk=512):
    """__graft_entry__._build()'s chain in both packages (the port's
    through _torch_graft.build_torch), at the given pixel chunks, its
    params scaled by 1.01 so that the probes start off the target's
    truth."""
    import __graft_entry__ as ge
    jp, tp = ge._build(pix_chunk=jax_chunk), build_torch(pix_chunk=torch_chunk)
    start = {k: v.detach().numpy() * 1.01
             for k, v in tp.collect_main_params().items()}
    bt.load_numpy_pdict(tp.model, start)
    jp.update(bl.ParamDict({k: jnp.asarray(v) for k, v in start.items()}))
    return jp, tp


@pytest.mark.parametrize("form,H0", [("per-leaf", None),
                                     ("per-leaf", 1e-3), ("dense", None)],
                         ids=["per-leaf", "per-leaf-H0", "dense"])
def test_lbfgs_approx_cov_graft_chain_matches_jax(form, H0):
    """lbfgs_approx_cov on the graft chain from its scaled start: the
    per-leaf probe's DiagMat and the moved parameters, and the dense
    form of a 3-step L-BFGS, equal the JAX package's at 1e-8."""
    jp, tp = _graft_pair()
    if form == "per-leaf":
        tc = bt.lbfgs_approx_cov(tp, Nsteps=2, H0=H0)
        jc = jbfgs.lbfgs_approx_cov(jp, Nsteps=2, H0=H0)
        assert _relerr(tc.diag.numpy(), jc.diag) <= 1e-8
        for k, v in jp.collect_main_params().items():
            assert _relerr(tp.model[k].detach().numpy(), v) <= 1e-8, k
    else:
        to, jo = bt.LBFGS(tp), jbfgs.LBFGS(jp)
        np.testing.assert_allclose(to.minimize(3), jo.minimize(3), rtol=1e-8)
        tH, jH = bt.lbfgs_approx_cov(to), jbfgs.lbfgs_approx_cov(jo)
        assert tH.shape == jH.shape == (to.x.numel(),) * 2
        assert _relerr(tH.numpy(), jH) <= 1e-8


def test_lbfgs_probe_rounding_sensitivity_graft_chain():
    """ROADMAP C11: a second per-leaf probe with H0 = 1e-3, from where a
    first probe (no H0) left the graft chain, depends on float64
    rounding in both packages. Its first trial steps move the loss by
    ~1e-5 of itself, where the strong-Wolfe extrapolation's cubic
    discriminant d1^2 - g1 g2 is ~4e-8 of d1^2 and takes its sign from
    the loss's last digits: the midpoint of the step bounds or their
    upper end. Each package's own pixel chunking (the order of the
    pixel sums) moves that probe's diagonal by more than 1e-2, while the
    first probe agrees to 1e-8 throughout; and the port at one chunking
    reproduces the JAX package's default build at 1e-8."""
    first, second = {}, {}
    for jc, tc in ((512, 512), (64, 64)):
        jp, tp = _graft_pair(jc, tc)
        for key, prob, mod in (("jax", jp, jbfgs), ("port", tp, bt)):
            a = mod.lbfgs_approx_cov(prob, Nsteps=2)
            b = mod.lbfgs_approx_cov(prob, Nsteps=2, H0=1e-3)
            first[key, jc] = _np(a.diag)
            second[key, jc] = _np(b.diag)
    ref = first["jax", 512]
    for k, v in first.items():
        assert _relerr(v, ref) <= 1e-8, k
    for pkg in ("jax", "port"):
        assert _relerr(second[pkg, 64], second[pkg, 512]) > 1e-2, pkg
    assert min(_relerr(second["port", c], second["jax", 512])
               for c in (512, 64)) <= 1e-8
