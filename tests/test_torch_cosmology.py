"""The port's cosmology (models/cosmology.py) against the JAX package's
at float64 on the CPU: every Cosmology method over arrays of redshift,
frequency and distance, and gauss1d, cube2lcone and cube2map in each of
their modes. Both are host numpy, so the values are held exactly equal
(the bar of 1e-9 relative is met with nothing to spare)."""
import numpy as np
import pytest

from bayeslim_tpu.models import cosmology as jc
from bayeslim_tpu_torch.models import cosmology as tc

Z = np.linspace(0.0, 30.0, 41)
F = np.linspace(50e6, 250e6, 33)

METHODS = [("Efunc", Z), ("H", Z), ("comoving_distance", Z),
           ("comoving_transverse_distance", Z), ("f2z", F), ("z2f", Z),
           ("f2r", F), ("dRperp_dtheta", Z), ("dRpara_df", Z), ("X2Y", Z),
           ("bl_to_kperp", Z[1:]), ("tau_to_kpara", Z)]


@pytest.mark.parametrize("name,x", METHODS)
@pytest.mark.parametrize("kw", [dict(), dict(H0=70.0, Om0=0.3, m_nu_eV=0.0)])
def test_cosmology_methods_match_jax(name, x, kw):
    want = getattr(jc.Cosmology(**kw), name)(x)
    got = getattr(tc.Cosmology(**kw), name)(x)
    np.testing.assert_array_equal(got, want)


def test_cosmology_r2f_and_attributes_match_jax():
    j, t = jc.Cosmology(), tc.Cosmology()
    r = j.f2r(F)
    np.testing.assert_array_equal(t.r2f(r), j.r2f(r))
    np.testing.assert_allclose(t.r2f(r), F, rtol=1e-9)
    for a in ("H0", "Om0", "Ob0", "Tcmb0", "Neff", "Ogamma0", "Onu0_rel",
              "Onu0_mass", "Or0", "Ode0"):
        assert getattr(t, a) == getattr(j, a), a


@pytest.mark.parametrize("x,scale,loc", [
    (np.linspace(-3, 3, 41), 0.8, 0.4), (np.linspace(0, 10, 11), 2.0, 5.0),
    (np.asarray(0.3), 1.0, 0.0)])
def test_gauss1d_matches_jax(x, scale, loc):
    np.testing.assert_array_equal(tc.gauss1d(x, scale=scale, loc=loc),
                                  jc.gauss1d(x, scale=scale, loc=loc))


def _cube(seed=0, n=12):
    return np.random.default_rng(seed).standard_normal((n, n, n))


def _angs(seed=1, npix=50):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, np.pi, npix),
                     rng.uniform(0, 2 * np.pi, npix)])


@pytest.mark.parametrize("interp", ["nearest", "linear"])
@pytest.mark.parametrize("roll", [None, 3, (1, 2, 3)])
@pytest.mark.parametrize("angs", [True, False])
def test_cube2map_matches_jax(interp, roll, angs):
    a = _angs() if angs else None
    for dc in (37.0, 5.5):
        np.testing.assert_array_equal(
            tc.cube2map(_cube(), dc, 2.0, angs=a, roll=roll, interp=interp),
            jc.cube2map(_cube(), dc, 2.0, angs=a, roll=roll, interp=interp))


@pytest.mark.parametrize("rinterp", ["nearest", "linear", "quadratic"])
@pytest.mark.parametrize("interp", ["nearest", "linear"])
def test_cube2lcone_matches_jax(rinterp, interp):
    sims = np.stack([_cube(s) for s in range(3)])
    sim_r = np.asarray([20.0, 40.0, 60.0])
    r = np.linspace(25.0, 55.0, 4)
    np.testing.assert_array_equal(
        tc.cube2lcone(sims, sim_r, r, 2.0, angs=_angs(), rinterp=rinterp,
                      interp=interp),
        jc.cube2lcone(sims, sim_r, r, 2.0, angs=_angs(), rinterp=rinterp,
                      interp=interp))


def test_cube2lcone_reads_npy_and_one_cube(tmp_path):
    f = str(tmp_path / "cube.npy")
    np.save(f, _cube())
    np.testing.assert_array_equal(
        tc.cube2lcone(f, [30.0], [30.0, 31.0], 2.0),
        jc.cube2lcone(_cube(), [30.0], [30.0, 31.0], 2.0))
    with pytest.raises(ValueError):
        tc.cube2lcone(_cube(), [30.0, 40.0], [35.0], 2.0, rinterp="cubic")
