"""The port's special functions (ops/special.py) against the JAX
package's at float64: pochln, hypF, Plm and Qlm (values, derivatives,
sq_norm) on both routes (mpmath when high_prec, scipy otherwise), the
spherical Bessel functions jl / yl, Bessel J1 (polynomial and integral,
with its torch derivative), softplus and Softplus with its inverse.
The cut-sky cases are those of tests/test_sph_harm.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslim_tpu.ops import special as jsp
from bayeslim_tpu_torch.ops import special as tsp


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def test_log_legendre_norm_and_pochln():
    l = np.arange(0, 40.0)
    m = np.minimum(l, 7.0)
    assert _relerr(tsp.log_legendre_norm(l, m),
                   jsp.log_legendre_norm(l, m)) == 0.0
    # negative integer a with 0 < n <= -a, with n < 0, and non-integers
    a = np.array([-5.0, -3.0, -2.5, -1.0, 0.5, 1.0, 3.2, -4.0, 2.0])
    n = np.array([2.0, -1.0, 3.0, 1.0, 2.0, 0.0, 1.5, 3.0, -1.0])
    for got, want in zip(tsp.pochln(a, n), jsp.pochln(a, n)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("high_prec", [False, True])
def test_hypF_matches_jax(high_prec):
    """Both c > 0 and the c <= 0 branch (DLMF 15.2.3_5)."""
    z = np.linspace(0.0, 0.95, 9)
    a = np.array([[2.5], [4.0], [1.2]])
    b = np.array([[-1.5], [-3.0], [-0.2]])
    c = np.array([[0.5], [-2.0], [1.5]])
    got = tsp.hypF(a, b, c, z, high_prec=high_prec)
    want = jsp.hypF(a, b, c, z, high_prec=high_prec)
    assert got.shape == want.shape == (3, 9)
    assert _relerr(got, want) <= 1e-12


@pytest.mark.parametrize("high_prec", [False, True])
@pytest.mark.parametrize("deriv", [False, True])
@pytest.mark.parametrize("sq_norm", [True, False])
def test_Plm_Qlm_match_jax(high_prec, deriv, sq_norm):
    """Non-integer degrees of a 40 deg cap and a stripe, as
    compute_lm finds them (tests/test_sph_harm.py), and integer ones."""
    l = np.array([0.0, 2.0, 3.7, 5.25, 8.9, 12.0])
    m = np.array([0.0, 1.0, 2.0, 2.0, 1.0, 4.0])
    x = np.cos(np.radians(np.linspace(5.0, 70.0, 11)))
    kw = dict(deriv=deriv, sq_norm=sq_norm, high_prec=high_prec)
    for fn in ("Plm", "Qlm"):
        got = getattr(tsp, fn)(l, m, x, **kw)
        want = getattr(jsp, fn)(l, m, x, **kw)
        assert np.isfinite(want).all()
        assert _relerr(got, want) <= 1e-9, fn


def test_Plm_dtheta_false_and_scalar():
    """dP/dx (dtheta=False) and the squeezed scalar of one mode at one
    point."""
    got = tsp.Plm(3.5, 1.0, 0.3, deriv=True, dtheta=False, high_prec=False)
    want = jsp.Plm(3.5, 1.0, 0.3, deriv=True, dtheta=False, high_prec=False)
    assert np.ndim(got) == 0 and abs(got - want) <= 1e-12 * abs(want)


def test_integer_Plm_routes_agree_with_scipy():
    """At integer degrees both routes are scipy's orthonormal Legendre
    functions (sph_harm_y at phi = 0)."""
    from scipy.special import sph_harm_y
    l = np.array([0, 1, 4, 7, 10])
    m = np.array([0, 1, 2, 5, 10])
    theta = np.linspace(0.1, 3.0, 7)
    want = np.stack([sph_harm_y(a, b, theta, 0.0).real for a, b in zip(l, m)])
    for hp in (False, True):
        got = tsp.Plm(l, m, np.cos(theta), high_prec=hp)
        assert _relerr(got, want) <= 1e-10, hp


@pytest.mark.parametrize("deriv", [False, True])
def test_spherical_bessel_match_jax(deriv):
    l = np.array([0.0, 1.0, 2.5, 7.0])
    z = np.array([0.0, 1e-3, 0.5, 3.0, 12.0, 40.0])
    got = tsp.jl(l, z, deriv=deriv)
    want = jsp.jl(l, z, deriv=deriv)
    assert _relerr(got, want) <= 1e-12
    z = z[1:]
    assert _relerr(tsp.yl(l, z, deriv=deriv), jsp.yl(l, z, deriv=deriv)) \
        <= 1e-12


@pytest.mark.parametrize("brute_force", [False, True])
def test_j1_matches_jax_with_a_derivative(brute_force):
    import jax
    x = np.linspace(-20.0, 20.0, 101)
    got = tsp.j1(torch.as_tensor(x), brute_force=brute_force, Ntau=200)
    want = jsp.j1(jnp.asarray(x), brute_force=brute_force, Ntau=200)
    assert _relerr(got.numpy(), want) <= 1e-12
    xt = torch.as_tensor(x, dtype=torch.float64).requires_grad_(True)
    tsp.j1(xt, brute_force=brute_force, Ntau=200).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jsp.j1(v, brute_force=brute_force,
                                           Ntau=200)))(jnp.asarray(x))
    assert _relerr(xt.grad.numpy(), jg) <= 1e-9


def test_j1_integral_is_bessel_j1():
    from scipy.special import j1 as sj1
    x = np.linspace(0.0, 10.0, 41)
    got = tsp.j1_integral(torch.as_tensor(x), Ntau=400).numpy()
    assert np.abs(got - sj1(x)).max() <= 1e-6


@pytest.mark.parametrize("beta, threshold", [(1.0, 20.0), (2.5, 5.0)])
def test_softplus_matches_jax(beta, threshold):
    x = np.linspace(-30.0, 30.0, 121)
    got = tsp.softplus(torch.as_tensor(x), beta, threshold).numpy()
    want = jsp.softplus(jnp.asarray(x), beta, threshold)
    assert _relerr(got, want) <= 1e-12
    for inverted in (False, True):
        y = np.abs(x) + 0.1 if inverted else x
        sp_t = tsp.Softplus(beta, threshold, inverted=inverted)
        sp_j = jsp.Softplus(beta, threshold, inverted=inverted)
        assert _relerr(sp_t(torch.as_tensor(y)).numpy(),
                       sp_j(jnp.asarray(y))) <= 1e-12
    # inverse(forward(x)) = x away from the threshold, where each side
    # switches to the identity at its own argument
    sp = tsp.Softplus(beta, threshold)
    xi = x[(x > -10) & (beta * x < threshold - 1)]
    y = sp(torch.as_tensor(xi))
    assert _relerr(sp.inverse(y).numpy(), xi) <= 1e-9


def test_high_prec_without_mpmath_raises(monkeypatch):
    """The exact route names mpmath when it is missing and never falls
    back to scipy."""
    import builtins
    real_import = builtins.__import__

    def no_mpmath(name, *args, **kwargs):
        if name.split(".")[0] == "mpmath":
            raise ImportError("No module named 'mpmath'")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_mpmath)
    with pytest.raises(ImportError, match="mpmath"):
        tsp.Plm(2.5, 1.0, 0.3, high_prec=True)
    # the fast route needs no mpmath
    assert np.isfinite(tsp.Plm(2.5, 1.0, 0.3, high_prec=False))
