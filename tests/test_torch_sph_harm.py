"""The port's spherical harmonics (ops/sph_harm.py) against the JAX
package's at float64 on the CPU.

- gen_lm; gen_sph2pix's integer full-sphere path (the port's Legendre
  recurrence) against the JAX fast path at lmax <= 85, where that path
  is finite, with real, separable, m_phasor and renorm; at lmax 191
  against the JAX special.Plm (scipy's hyp2f1 on ~300 sampled modes,
  mpmath's on 20) at nside 64's 255 rings, relative to each row's
  largest value; finite to lmax 383;
- compute_lm for a cap and a stripe, and the cut-sky Ylm and forward
  (tests/test_sph_harm.py's test_compute_lm_cap and
  test_cutsky_ylm_forward);
- AlmModel: forward (complex a_lm, real pairs, separable, real_output),
  least_squares, select, the multi-grid forward, the Ylm cache, and
  write_Ylm / load_Ylm read across the packages both ways;
- ROADMAP queue C item 4, three faults of the JAX reference, shown
  without pinning them: its fast Ylm path goes non-finite at lmax 90 on
  nside 64's rings, its Ylm cache, keyed by theta alone, returns the
  Ylm of another phi grid, and its multi-grid forward applies LM twice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.ops import sph_harm as jsh
from bayeslim_tpu.ops import special as jsp
from bayeslim_tpu_torch.ops import special as tsp
from bayeslim_tpu_torch.ops import sph_harm as tsh
from bayeslim_tpu_torch.utils import healpix as hp

T64 = dict(device="cpu", dtype=torch.float64)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _row_err(a, b):
    """Worst |a - b| over each row's largest |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b).max(1) / np.abs(b).max(1)).max())


def _np(Y):
    if isinstance(Y, (tuple, list)):
        return tuple(np.asarray(y) for y in Y)
    return np.asarray(Y)


def _hpx(nside):
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    return theta, phi


def _rings(nside):
    """nside's ring colatitudes."""
    return np.unique(_hpx(nside)[0])


def test_gen_lm_matches_jax():
    for lmax in (0, 3, 20):
        for rf in (True, False):
            np.testing.assert_array_equal(tsh.gen_lm(lmax, rf),
                                          jsh.gen_lm(lmax, rf))


@pytest.mark.parametrize("opts", [
    dict(), dict(real=True), dict(m_phasor=True), dict(renorm=True),
    dict(renorm=True, pxarea=0.01), dict(real=True, m_phasor=True)])
@pytest.mark.parametrize("real_field", [True, False])
def test_gen_sph2pix_matches_jax(opts, real_field):
    theta, phi = _hpx(8)
    l, m = jsh.gen_lm(12, real_field=real_field)
    kw = dict(method="sphere", high_prec=False, **opts)
    Yj, nj, aj = jsh.gen_sph2pix(theta, phi, l, m, **kw)
    Yt, nt, at = tsh.gen_sph2pix(theta, phi, l, m, **kw, **T64)
    assert Yt.dtype == (torch.float64 if opts.get("real")
                        else torch.complex128)
    assert Yt.shape == Yj.shape
    assert _relerr(Yt.numpy(), Yj) <= 1e-12
    assert _relerr(nt.numpy(), nj) <= 1e-12
    np.testing.assert_array_equal(at.numpy(), aj)


@pytest.mark.parametrize("real", [False, True])
def test_gen_sph2pix_separable_matches_jax(real):
    theta_g = np.linspace(0.2, 2.9, 12)
    phi_g = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    l, m = jsh.gen_lm(10)
    kw = dict(separable=True, method="sphere", high_prec=False, real=real)
    (Tj, Pj), _, aj = jsh.gen_sph2pix(theta_g, phi_g, l, m, **kw)
    (Tt, Pt), _, at = tsh.gen_sph2pix(theta_g, phi_g, l, m, **kw, **T64)
    assert _relerr(Tt.numpy(), Tj) <= 1e-12
    assert _relerr(Pt.numpy(), Pj) <= 1e-12
    np.testing.assert_array_equal(at.numpy(), aj)
    full = tsh.inflate_Ylm((Tt, Pt)).numpy()
    assert _relerr(full, jsh.inflate_Ylm((Tj, Pj))) <= 1e-12


def test_fast_path_matches_jax_at_lmax_85_on_nside_64_rings():
    """Where the JAX fast path is finite (lmax <= 85 at nside 64), the
    port's recurrence gives its values."""
    x = _rings(64)
    l, m = jsh.gen_lm(85)
    rng = np.random.default_rng(0)
    phi = rng.uniform(0, 2 * np.pi, len(x))
    Yj, _, _ = jsh.gen_sph2pix(x, phi, l, m, high_prec=False)
    Yt, _, _ = tsh.gen_sph2pix(x, phi, l, m, high_prec=False, **T64)
    assert np.isfinite(np.asarray(Yj)).all()
    assert _row_err(Yt.numpy(), Yj) <= 1e-9


def _sample_modes(lmax, n, seed):
    l, m = tsh.gen_lm(lmax)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(l), n, replace=False)
    must = [np.flatnonzero((l == a) & (m == b))[0]
            for a, b in ((lmax, lmax), (lmax, 0), (0, 0), (lmax, lmax - 1))]
    idx = np.unique(np.concatenate([idx, must]))
    return l[idx], m[idx]


def test_fast_path_matches_jax_Plm_at_lmax_191():
    """Config #2's lmax on nside 64's 255 rings: the port's Ylm rows at
    phi = 0 against the JAX special.Plm (scipy's hyp2f1), ~300 modes
    with l = m = 191, (191, 0) and (0, 0) among them."""
    x = _rings(64)
    l, m = _sample_modes(191, 300, 1)
    want = jsp.Plm(l, m, np.cos(x), high_prec=False, keepdims=True)
    Yt, _, _ = tsh.gen_sph2pix(x, np.zeros_like(x), l, m, high_prec=False,
                               **T64)
    assert np.isfinite(want).all() and np.isfinite(Yt.numpy()).all()
    assert np.abs(Yt.numpy().imag).max() == 0.0
    assert _row_err(Yt.numpy().real, want) <= 1e-9


def test_fast_path_matches_jax_mpmath_Plm_at_lmax_191():
    """The same against the JAX special.Plm's exact route (mpmath) on 20
    modes."""
    x = _rings(64)[::4]
    l, m = _sample_modes(191, 16, 2)
    want = jsp.Plm(l, m, np.cos(x), high_prec=True, keepdims=True)
    got = tsh._sphere_legendre(l, m, np.cos(x))
    assert _row_err(got, want) <= 1e-9


def test_fast_path_finite_to_lmax_383():
    """Twice config #2's lmax: every value finite, and the sampled rows
    against scipy's sph_harm_y."""
    from scipy.special import sph_harm_y
    x = _rings(64)
    l, m = tsh.gen_lm(383)
    H = tsh._sphere_legendre(l, m, np.cos(x))
    assert np.isfinite(H).all() and np.abs(H).max() < 10
    ls, ms = _sample_modes(383, 40, 3)
    rows = [np.flatnonzero((l == a) & (m == b))[0] for a, b in zip(ls, ms)]
    want = np.stack([sph_harm_y(a, b, x, 0.0).real for a, b in zip(ls, ms)])
    assert _row_err(H[rows], want) <= 1e-9


def test_compute_lm_cap_matches_jax():
    """tests/test_sph_harm.py::test_compute_lm_cap's modes (mpmath) and
    the boundary condition they meet."""
    theta_max = np.radians(40.0)
    lt, mt = tsh.compute_lm(2 * np.pi, 2, 0.0, theta_max, lmax=12, dl=0.2,
                            high_prec=True)
    lj, mj = jsh.compute_lm(2 * np.pi, 2, 0.0, theta_max, lmax=12, dl=0.2,
                            high_prec=True)
    np.testing.assert_allclose(lt, lj, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(mt, mj)
    assert len(lt) > 3
    x = np.cos(np.asarray([theta_max]))
    for li, mi in zip(lt, mt):
        if np.isclose(li, mi) or li < 1e-3:
            continue  # the sectoral modes and the monopole are added
        dP = float(tsp.Plm(li, mi, x, deriv=True, high_prec=True))
        P = float(tsp.Plm(li, mi, x, high_prec=True))
        assert abs(dP) < 1e-4 * max(abs(P), 1.0), (li, mi, dP)


def test_compute_lm_stripe_matches_jax():
    lt, mt = tsh.compute_lm(np.pi, 2, np.radians(25.0), np.radians(70.0),
                            lmax=10, dl=0.25, high_prec=False, bc_type=1)
    lj, mj = jsh.compute_lm(np.pi, 2, np.radians(25.0), np.radians(70.0),
                            lmax=10, dl=0.25, high_prec=False, bc_type=1)
    np.testing.assert_allclose(lt, lj, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(mt, mj)
    assert len(lt) > 3


@pytest.mark.parametrize("method", ["cap", "stripe"])
def test_cutsky_ylm_forward_matches_jax(method):
    """tests/test_sph_harm.py::test_cutsky_ylm_forward, and its stripe
    counterpart: the cut-sky Ylm (legendre_func, scipy route) and the
    AlmModel forward of random a_lm."""
    theta, phi = _hpx(16)
    if method == "cap":
        tmin, tmax = 0.0, np.radians(40.0)
        cut = theta < tmax
        crit = dict(theta_crit=tmax)
    else:
        tmin, tmax = np.radians(25.0), np.radians(70.0)
        cut = (theta > tmin) & (theta < tmax)
        crit = dict(theta_crit=tmin)
    l, m = jsh.compute_lm(2 * np.pi, 2, tmin, tmax, lmax=10, dl=0.25,
                          high_prec=False)
    kw = dict(method=method, high_prec=False, **crit)
    Yj, _, aj = jsh.gen_sph2pix(theta[cut], phi[cut], l, m, **kw)
    Yt, _, at = tsh.gen_sph2pix(theta[cut], phi[cut], l, m, **kw, **T64)
    assert np.isfinite(np.asarray(Yj)).all()
    assert _relerr(Yt.numpy(), Yj) <= 1e-9
    rng = np.random.default_rng(0)
    alm = rng.normal(size=len(l)) + 1j * rng.normal(size=len(l))
    mj = jsh.AlmModel(l, m, real_output=True)
    mj.setup_Ylm(Yj, alm_mult=aj)
    mt = tsh.AlmModel(l, m, real_output=True, **T64)
    mt.setup_Ylm(Yt, alm_mult=at)
    got = mt.forward_alm(torch.as_tensor(alm)).numpy()
    assert got.shape == (int(cut.sum()),)
    assert _relerr(got, mj.forward_alm(jnp.asarray(alm))) <= 1e-9


def _alm_pair(l, m, theta, phi, real_output=False, **kw):
    mj = jsh.AlmModel(l, m, real_output=real_output)
    mj.generate_Ylm(theta, phi, method="sphere", high_prec=False, **kw)
    mt = tsh.AlmModel(l, m, real_output=real_output, **T64)
    mt.generate_Ylm(theta, phi, method="sphere", high_prec=False, **kw)
    return mj, mt


@pytest.mark.parametrize("real_output", [False, True])
@pytest.mark.parametrize("pairs", [False, True])
def test_alm_forward_matches_jax(real_output, pairs):
    """(Nfreq, Ncoeff) complex a_lm or (Nfreq, Ncoeff, 2) real pairs
    through the full Ylm, value and (port) gradient."""
    theta, phi = _hpx(8)
    l, m = jsh.gen_lm(8)
    mj, mt = _alm_pair(l, m, theta, phi, real_output)
    rng = np.random.default_rng(2)
    p = rng.normal(size=(3, len(l), 2))
    pin = p if pairs else p[..., 0] + 1j * p[..., 1]
    want = mj.forward_alm(jnp.asarray(pin))
    pt = torch.as_tensor(pin).requires_grad_(True)
    got = mt.forward_alm(pt)
    assert got.shape == want.shape
    assert _relerr(got.detach().numpy(), want) <= 1e-12
    torch.sum(torch.abs(got) ** 2).backward()
    import jax
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(mj.forward_alm(q)) ** 2))(
        jnp.asarray(pin))
    # JAX's gradient for a complex leaf is the conjugate of torch's
    # (ROADMAP queue C item 1)
    assert _relerr(pt.grad.numpy(), np.conj(jg)) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_ylm_product_gradcheck(dtype):
    """The a_lm product's own backward (conj(conj(g) @ Y^T), no copy of
    the Ylm) against finite differences."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 3, 5, dtype=dtype, generator=g, requires_grad=True)
    Y = torch.randn(5, 7, dtype=dtype, generator=g)
    assert torch.autograd.gradcheck(lambda x: tsh._product(x, Y), (a,))
    Yr = torch.randn(5, 7, dtype=torch.float64, generator=g)
    assert torch.autograd.gradcheck(lambda x: tsh._product(x, Yr), (a,))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_ylm_product_gradcheck_Y(dtype):
    """The product's gradient in a Ylm that takes one (a^H g, summed
    over a's leading dimensions), with a's, against finite differences
    and against torch.matmul's own backward."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(2, 3, 5, dtype=dtype, generator=g, requires_grad=True)
    Y = torch.randn(5, 7, dtype=dtype, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(tsh._product, (a, Y))
    assert torch.autograd.gradcheck(lambda y: tsh._product(a.detach(), y),
                                    (Y,))
    w = torch.randn(2, 3, 7, dtype=dtype, generator=g)
    got = torch.autograd.grad(
        (tsh._product(a, Y) * w).real.sum(), (a, Y))
    want = torch.autograd.grad((torch.matmul(a, Y) * w).real.sum(), (a, Y))
    for x, y in zip(got, want):
        assert _relerr(x.resolve_conj().numpy(),
                       y.resolve_conj().numpy()) <= 1e-12


def test_ylm_product_backward_runs_without_tf32(monkeypatch):
    """Both gradients of the product (a's, and a Ylm's that takes one)
    run with TF32 matmuls off, whatever the global setting."""
    a = torch.ones(3, 4, dtype=torch.complex64, requires_grad=True)
    Y = torch.ones(4, 5, dtype=torch.complex64, requires_grad=True)
    seen = []
    real_matmul = torch.Tensor.__matmul__

    def spy(x, y):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_matmul(x, y)
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tsh._product(a, Y).real.sum().backward()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False, False, False]
    assert a.grad is not None and Y.grad is not None


def test_alm_separable_equals_full():
    """tests/test_sph_harm.py::test_alm_separable_equals_full in the
    port, and against the JAX separable forward."""
    rng = np.random.default_rng(1)
    theta_g = np.linspace(0.2, 1.2, 12)
    phi_g = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    l, m = jsh.gen_lm(3)
    th, ph = tsh.AlmModel.setup_angs(theta_g, phi_g, separable=True)
    full = tsh.AlmModel(l, m, **T64)
    full.generate_Ylm(th, ph, high_prec=False)
    sep = tsh.AlmModel(l, m, **T64)
    sep.generate_Ylm(theta_g, phi_g, separable=True, high_prec=False)
    assert sep.separable and isinstance(sep.Ylm, tuple)
    alm = rng.normal(size=len(l)) + 1j * rng.normal(size=len(l))
    f1 = full.forward_alm(torch.as_tensor(alm)).numpy()
    f2 = sep.forward_alm(torch.as_tensor(alm)).numpy()
    assert np.abs(f1 - f2).max() < 1e-10
    js = jsh.AlmModel(l, m)
    js.generate_Ylm(theta_g, phi_g, separable=True, high_prec=False)
    assert _relerr(f2, js.forward_alm(jnp.asarray(alm))) <= 1e-12


def test_alm_roundtrip_least_squares():
    """tests/test_sph_harm.py::test_alm_roundtrip in the port: a
    conjugate-symmetric a_lm gives a real map, least_squares recovers
    it, and the m >= 0 basis with alm_mult gives the same map; each
    against the JAX package."""
    rng = np.random.default_rng(0)
    theta, phi = _hpx(8)
    l, m = jsh.gen_lm(5, real_field=False)
    mj, mt = _alm_pair(l, m, theta, phi)
    alm = rng.normal(size=len(l)) + 1j * rng.normal(size=len(l))
    alm[m == 0] = alm[m == 0].real
    for i in range(len(l)):
        if m[i] > 0:
            j = np.where((l == l[i]) & (m == -m[i]))[0][0]
            alm[j] = (-1.0) ** m[i] * np.conj(alm[i])
    mp = mt.forward_alm(torch.as_tensor(alm))
    assert np.abs(mp.numpy().imag).max() < 1e-12
    assert _relerr(mp.numpy(), mj.forward_alm(jnp.asarray(alm))) <= 1e-12
    rec = mt.least_squares(mp)
    assert np.abs(rec.numpy() - alm).max() < 1e-8
    assert _relerr(rec.numpy(), mj.least_squares(jnp.asarray(mp.numpy()))) \
        <= 1e-9
    l2, m2 = jsh.gen_lm(5)
    half = tsh.AlmModel(l2, m2, real_output=True, **T64)
    half.generate_Ylm(theta, phi, high_prec=False)
    keep = [np.where((l == a) & (m == b))[0][0] for a, b in zip(l2, m2)]
    mp2 = half.forward_alm(torch.as_tensor(alm[keep]),
                           alm_mult=half.alm_mult)
    assert np.abs(mp2.numpy() - mp.numpy().real).max() < 1e-10


def test_alm_select_matches_jax():
    theta, phi = _hpx(4)
    l, m = jsh.gen_lm(6)
    mj, mt = _alm_pair(l, m, theta, phi)
    lm = (np.array([0, 3, 5]), np.array([0, 2, 1]))
    for kw in (dict(lmin=1, mmax=4), dict(lm=lm)):
        sj = mj.select(**kw)
        st = mt.select(**kw)
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(mt.l, mj.l)
        assert _relerr(mt.Ylm.numpy(), mj.Ylm) <= 1e-12
        np.testing.assert_array_equal(mt.alm_mult.numpy(), mj.alm_mult)


def test_alm_multigrid_and_cache_match_jax():
    """tests/test_sph_harm.py::test_setup_multigrid_forward in both
    packages: per-grid outputs concatenated and reindexed, the cache
    serving get_Ylm, clear_multigrid back to the single grid."""
    rng = np.random.default_rng(5)
    l, m = jsh.gen_lm(3, real_field=False)
    th1, ph1 = np.array([40.0, 60.0]), np.array([10.0, 100.0])
    th2, ph2 = np.array([80.0, 100.0, 120.0]), np.array([200.0, 300.0, 40.0])
    alm = rng.normal(size=len(l)) + 1j * rng.normal(size=len(l))
    idx = np.array([4, 3, 2, 1, 0])
    outs = []
    for pkg, am, arr in ((jsh, jsh.AlmModel(l, m), jnp.asarray),
                         (tsh, tsh.AlmModel(l, m, **T64), torch.as_tensor)):
        Ys = []
        for th, ph in ((th1, ph1), (th2, ph2)):
            am.generate_Ylm(np.radians(th), np.radians(ph), method="sphere",
                            high_prec=False)
            Ys.append((am.Ylm, am.alm_mult))
        a = arr(alm)
        sep = [np.asarray(am.forward_alm(a, Ylm=Y, alm_mult=w))
               for Y, w in Ys]
        am.setup_multigrid_forward([th1, th2], [ph1, ph2],
                                   [Y for Y, _ in Ys], [w for _, w in Ys],
                                   idx=idx)
        out = np.asarray(am.forward_alm(a))
        assert np.allclose(out, np.concatenate(sep, axis=-1)[..., idx])
        Yc, _ = am.get_Ylm(th1, ph1)
        assert Yc is Ys[0][0]
        am.clear_Ylm_cache()
        am.clear_multigrid()
        assert am.grids is None and am.grid_idx is None
        outs.append((out, np.asarray(am.forward_alm(a))))
    for got, want in zip(outs[1], outs[0]):
        assert _relerr(got, want) <= 1e-12


def test_alm_multigrid_applies_LM_once():
    """ROADMAP queue C item 4: a multi-grid AlmModel with an LM equals
    its single-grid forwards concatenated, LM applied once. The JAX
    multi-grid forward calls forward_alm per grid without ignoreLM, so
    it applies LM a second time: that is shown here, and is not the
    expected value."""
    rng = np.random.default_rng(6)
    l, m = jsh.gen_lm(3, real_field=False)
    grids = ((np.array([40.0, 60.0]), np.array([10.0, 100.0])),
             (np.array([80.0, 100.0, 120.0]), np.array([200.0, 300.0, 40.0])))
    A = rng.normal(size=(len(l), len(l))) / np.sqrt(len(l))
    alm = rng.normal(size=(2, len(l))) + 1j * rng.normal(size=(2, len(l)))
    At, Aj = torch.as_tensor(A.T), jnp.asarray(A.T)
    outs = {}
    for pkg, am, arr in (
            ("jax", jsh.AlmModel(l, m, LM=lambda p: p @ Aj), jnp.asarray),
            ("torch", tsh.AlmModel(l, m, LM=lambda p: p @ At.to(p.dtype),
                                   **T64), torch.as_tensor)):
        Ys = []
        for th, ph in grids:
            am.generate_Ylm(np.radians(th), np.radians(ph), method="sphere",
                            high_prec=False)
            Ys.append((am.Ylm, am.alm_mult))
        # a given Ylm skips the grids: LM once, in either package
        once = np.concatenate([np.asarray(am.forward_alm(arr(alm), Ylm=Y,
                                                         alm_mult=w))
                               for Y, w in Ys], axis=-1)
        twice = np.concatenate([np.asarray(am.forward_alm(
            arr(alm @ A.T), Ylm=Y, alm_mult=w)) for Y, w in Ys], axis=-1)
        am.setup_multigrid_forward([g[0] for g in grids],
                                   [g[1] for g in grids],
                                   [Y for Y, _ in Ys], [w for _, w in Ys])
        outs[pkg] = (np.asarray(am.forward_alm(arr(alm))), once, twice)
    got, once, _ = outs["torch"]
    assert _relerr(got, once) <= 1e-12
    assert _relerr(once, outs["jax"][1]) <= 1e-12
    jout, jonce, jtwice = outs["jax"]
    assert _relerr(jout, jtwice) <= 1e-12
    assert _relerr(jout, jonce) > 0.1


def test_alm_setup_Ylm_generates_through_the_cache():
    """setup_Ylm(theta, phi, generate=True) [deg] generates once and
    serves the second call from the cache."""
    theta, phi = np.degrees(_hpx(4)[0]), np.degrees(_hpx(4)[1])
    l, m = jsh.gen_lm(4)
    am = tsh.AlmModel(l, m, **T64)
    am.setup_Ylm(theta, phi, generate=True, high_prec=False)
    Y1 = am.Ylm
    am.setup_Ylm(theta, phi, generate=True, high_prec=False)
    assert am.Ylm is Y1
    jm = jsh.AlmModel(l, m)
    jm.setup_Ylm(theta, phi, generate=True, high_prec=False)
    assert _relerr(Y1.numpy(), jm.Ylm) <= 1e-12


def test_alm_taper_names_what_it_waits_for():
    """taper_alm (it raised before models/fft.py's gen_window was
    ported): the window's decaying half over l / l_max on complex a_lm,
    on real pairs (comp_params) and on real a_lm, for several windows,
    against the JAX AlmModel."""
    l, m = jsh.gen_lm(6)
    am, jm = tsh.AlmModel(l, m, **T64), jsh.AlmModel(l, m)
    rng = np.random.default_rng(12)
    a = rng.standard_normal((2, len(l))) + 1j * rng.standard_normal(
        (2, len(l)))
    pairs = np.stack([a.real, a.imag], -1)
    for taper, kw in (("tukey", dict(alpha=0.4)), ("bh", {}),
                      ("hann", {}), ("cs9", {})):
        for x, cp in ((a, False), (pairs, True), (a.real, False)):
            want = jm.taper_alm(jnp.asarray(x), taper, comp_params=cp, **kw)
            got = am.taper_alm(torch.as_tensor(x), taper, comp_params=cp,
                               **kw)
            assert got.dtype == torch.as_tensor(x).dtype
            assert _relerr(got.numpy(), want) <= 1e-12, (taper, cp)


def test_alm_make_closure_is_differentiable():
    theta, phi = _hpx(4)
    l, m = jsh.gen_lm(4)
    mj, mt = _alm_pair(l, m, theta, phi)
    rng = np.random.default_rng(3)
    alm = rng.normal(size=len(l)) + 1j * rng.normal(size=len(l))
    target = rng.normal(size=len(theta))

    def loss(a, b):
        return ((a - b) ** 2).sum()
    cj = mj.make_closure(jnp.asarray(alm), loss, jnp.asarray(target))
    p = torch.as_tensor(alm).requires_grad_(True)
    ct = mt.make_closure(p, loss, torch.as_tensor(target))
    v = ct()
    assert abs(float(v.detach()) - float(cj())) <= 1e-9 * abs(float(cj()))
    v.backward()
    assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0


@pytest.fixture()
def h5():
    return pytest.importorskip(
        "h5py", reason="write_Ylm / load_Ylm need h5py, not installed")


@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_write_load_Ylm_across_packages(h5, tmp_path, separable, writer):
    """A file written by one package and read by the other, with a mode
    cut and extras, gives the same Ylm, modes and alm_mult."""
    if separable:
        theta = np.linspace(0.2, 2.0, 6)
        phi = np.linspace(0.0, 6.0, 8)
    else:
        theta, phi = _hpx(4)
    l, m = jsh.gen_lm(5)
    kw = dict(separable=separable, method="sphere", high_prec=False)
    Yj, nj, aj = jsh.gen_sph2pix(theta, phi, l, m, **kw)
    Yt, nt, at = tsh.gen_sph2pix(theta, phi, l, m, **kw, **T64)
    fn = str(tmp_path / "ylm.h5")
    angs = np.stack([np.degrees(theta[:6]), np.degrees(phi[:6])])
    extra = dict(D=np.eye(len(l)), history="test", theta_min=0.1)
    if writer == "port":
        tsh.write_Ylm(fn, Yt, angs, l, m, norm=nt, alm_mult=at, **extra)
    else:
        jsh.write_Ylm(fn, Yj, angs, l, m, norm=nj, alm_mult=aj, **extra)
    cut = dict(lmin=1, discard_sectoral=True)
    got = tsh.load_Ylm(fn, device="cpu", **cut)
    want = jsh.load_Ylm(fn, **cut)
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_array_equal(got["l"], want["l"])
    for a, b in zip(_np(got["Ylm"]) if separable else [got["Ylm"].numpy()],
                    _np(want["Ylm"]) if separable else [want["Ylm"]]):
        assert _relerr(a, b) <= 1e-12
    assert _relerr(got["alm_mult"].numpy(), want["alm_mult"]) == 0.0
    assert _relerr(got["D"].numpy(), want["D"]) == 0.0
    assert got["info"]["history"] == "test"
    with pytest.raises(FileExistsError):
        tsh.write_Ylm(fn, Yt, angs, l, m)


def test_queue_c4_jax_fast_path_goes_non_finite_at_lmax_90():
    """ROADMAP queue C item 4: the JAX fast path (scipy's unnormalised
    lpmv times exp(log_legendre_norm)) overflows from m ~ 90 on nside
    64's rings; the port's recurrence is finite there and matches the
    JAX special.Plm, whose scipy route stays finite. The JAX values are
    not the expected ones anywhere."""
    x = _rings(64)
    l, m = jsh.gen_lm(90)
    Yj, _, _ = jsh.gen_sph2pix(x, np.zeros_like(x), l, m, high_prec=False)
    bad = ~np.isfinite(np.asarray(Yj)).all(1)
    assert bad.any() and m[bad].min() >= 80
    Yt, _, _ = tsh.gen_sph2pix(x, np.zeros_like(x), l, m, high_prec=False,
                               **T64)
    assert np.isfinite(Yt.numpy()).all()
    rows = np.unique(np.concatenate([
        np.flatnonzero(bad)[::4],
        np.random.default_rng(4).choice(len(l), 60, replace=False)]))
    want = jsp.Plm(l[rows], m[rows], np.cos(x), high_prec=False,
                   keepdims=True)
    assert np.isfinite(want).all()
    assert _row_err(Yt.numpy()[rows].real, want) <= 1e-9


def test_queue_c4_jax_cache_key_ignores_phi():
    """ROADMAP queue C item 4: the JAX AlmModel keys its Ylm cache by
    theta alone, so a grid with the same rings and rotated phi gets the
    first grid's Ylm; the port keys by theta and phi and generates the
    rotated grid's own Ylm."""
    theta, phi = np.degrees(_hpx(4)[0]), np.degrees(_hpx(4)[1])
    rot = (phi + 30.0) % 360.0
    l, m = jsh.gen_lm(4)
    truth = tsh.gen_sph2pix(np.radians(theta), np.radians(rot), l, m,
                            high_prec=False, **T64)[0].numpy()
    jm = jsh.AlmModel(l, m)
    jm.get_Ylm(theta, phi, high_prec=False)
    Yj, _ = jm.get_Ylm(theta, rot, high_prec=False)
    assert _relerr(np.asarray(Yj), truth) > 0.1
    tm = tsh.AlmModel(l, m, **T64)
    Y0, _ = tm.get_Ylm(theta, phi, high_prec=False)
    Yt, _ = tm.get_Ylm(theta, rot, high_prec=False)
    assert Yt is not Y0
    assert _relerr(Yt.numpy(), truth) == 0.0
    assert tm.get_Ylm(theta, rot)[0] is Yt


def test_forward_alm_runs_without_tf32(monkeypatch):
    """The a_lm product runs with TF32 matmuls off, whatever the global
    setting (under TF32 its error would be ~5e-4 relative)."""
    theta, phi = _hpx(4)
    l, m = jsh.gen_lm(4)
    am = tsh.AlmModel(l, m, device="cpu", dtype=torch.float32)
    am.generate_Ylm(theta, phi, high_prec=False)
    seen = []
    real_matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_matmul(a, b)
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        am.forward_alm(torch.ones(len(l), dtype=torch.complex64))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False]


def test_gen_sph2pix_defaults_to_cuda():
    """device=None means CUDA: without a GPU that raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsh.gen_sph2pix([0.5], [0.1], [1], [0], high_prec=False)
