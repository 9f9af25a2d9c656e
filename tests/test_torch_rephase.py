"""The port's telescope pieces of the data layer against the JAX
package: JD2LST, JD2RA, top2eq (and the TelescopeModel methods), the
rotation matrices eq2top_m / top2eq_m, the drift-scan rephasing phasor
vis_rephase (float64 phase, cast to the data's type), match_red_blvec,
build_reds' red_bls ordering and ArrayModel.get_bls' cuts. Inputs come
from numpy seeds; everything compares at float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.models import telescope as jtel
from bayeslim_tpu.utils import indexing as jind
from bayeslim_tpu_torch.models import telescope as ttel
from bayeslim_tpu_torch.utils import indexing as tind
from bayeslim_tpu_torch.utils import make_hex

from _torch_graft import LOC

JDS = 2458168.3 + np.array([0.0, 1e-3, 0.37, 12.5])


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def test_sidereal_time_and_zenith_ra_vs_jax():
    np.testing.assert_array_equal(ttel.JD2LST(JDS, LOC[0]),
                                  jtel.JD2LST(JDS, LOC[0]))
    for jd in JDS:
        assert ttel.JD2RA(LOC, jd) == jtel.JD2RA(LOC, jd)
        assert bt.TelescopeModel(LOC).JD2RA(jd) == \
            bl.TelescopeModel(LOC).JD2RA(jd)
        assert bt.TelescopeModel(LOC).JD2LST(jd) == \
            bl.TelescopeModel(LOC).JD2LST(jd)


@pytest.mark.parametrize("apparent", [True, False])
def test_top2eq_vs_jax_and_inverts_eq2top(apparent):
    rng = np.random.default_rng(0)
    zen, az = rng.uniform(0, 80, 20), rng.uniform(0, 360, 20)
    for jd in JDS[:2]:
        ra, dec = ttel.top2eq(LOC, jd, zen, az, apparent=apparent)
        jra, jdec = jtel.top2eq(LOC, jd, zen, az, apparent=apparent)
        np.testing.assert_array_equal(ra, jra)
        np.testing.assert_array_equal(dec, jdec)
        z2, a2 = ttel.eq2top(LOC, jd, ra, dec, apparent=apparent)
        assert np.abs(z2 - zen).max() < 1e-6
        T = bt.TelescopeModel(LOC, apparent=apparent)
        np.testing.assert_array_equal(T.top2eq(jd, zen, az)[0], ra)


def test_rotation_matrices_vs_jax():
    ha = np.linspace(-np.pi, np.pi, 7)
    for dec in (-0.5, 0.3):
        for tf, jf in ((ttel.eq2top_m, jtel.eq2top_m),
                       (ttel.top2eq_m, jtel.top2eq_m)):
            got = tf(torch.as_tensor(ha), dec)
            assert got.dtype == torch.float64 and got.shape == (7, 3, 3)
            assert _relerr(got.numpy(), jf(jnp.asarray(ha), dec)) <= 1e-14
        # inverses of each other
        eye = ttel.eq2top_m(ha, dec) @ ttel.top2eq_m(ha, dec)
        assert torch.allclose(eye, torch.eye(3, dtype=torch.float64)
                              .expand(7, 3, 3), atol=1e-14)


@pytest.mark.parametrize("hexN", [2, 3])
def test_vis_rephase_vs_jax(hexN):
    ants, antvecs = make_hex(hexN, D=15.0)
    bls = [(0, a) for a in ants[1:]]
    blvecs = np.stack([antvecs[b] - antvecs[a] for a, b in bls])
    freqs = np.linspace(100e6, 200e6, 9)
    dlst = np.array([-0.02, 0.0, 1e-4, 0.015])
    want = np.asarray(jtel.vis_rephase(jnp.asarray(dlst), LOC[1],
                                       jnp.asarray(blvecs),
                                       jnp.asarray(freqs)))
    got = ttel.vis_rephase(dlst, LOC[1], blvecs, freqs)
    assert got.dtype == torch.complex128 and got.shape == want.shape
    assert _relerr(got.numpy(), want) <= 1e-12
    assert np.all(got[:, 1].numpy() == 1.0)
    # blvecs as a tensor: the device taken from it; a complex64 phasor
    # is the float64 one rounded
    g32 = ttel.vis_rephase(torch.as_tensor(dlst), LOC[1],
                           torch.as_tensor(blvecs, dtype=torch.float32),
                           freqs, dtype=torch.complex64)
    assert g32.dtype == torch.complex64
    assert _relerr(g32.numpy(), want) <= 2e-6
    one = ttel.vis_rephase(0.01, LOC[1], blvecs, freqs)
    assert one.shape == (len(bls), 1, 9)


def test_match_red_blvec_vs_jax():
    ants, antvecs = make_hex(3, D=15.0)
    reds, rvecs = bl.models.telescope.build_reds(
        bl.utils.AntposDict(ants, antvecs))[:2]
    rng = np.random.default_rng(1)
    for i in rng.choice(len(reds), 6, replace=False):
        for v in (rvecs[i], rvecs[i] + 0.3, -rvecs[i], rvecs[i] + 50.0):
            for rc in (False, True):
                assert ttel.match_red_blvec(rvecs, v, return_conj=rc) == \
                    jtel.match_red_blvec(rvecs, v, return_conj=rc)


@pytest.mark.parametrize("hexN", [2, 3])
def test_build_reds_red_bls_vs_jax(hexN):
    """With red_bls the groups come in the order of the groups holding
    those baselines, either orientation; inflate_bls on the result."""
    ants, antvecs = make_hex(hexN, D=15.0)
    jap = bl.utils.AntposDict(ants, antvecs)
    tap = bt.utils.AntposDict(ants, antvecs)
    reds = jtel.build_reds(jap)[0]
    rng = np.random.default_rng(2)
    pick = rng.choice(len(reds), min(8, len(reds)), replace=False)
    red_bls = [reds[i][-1] if k % 2 else reds[i][0][::-1]
               for k, i in enumerate(pick)]
    want = jtel.build_reds(jap, red_bls=red_bls)
    got = ttel.build_reds(tap, red_bls=red_bls)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    assert got[4] == want[4] and got[5] == want[5] and got[6] == want[6]
    bls = jtel.build_reds(jap)[3]
    assert tind.inflate_bls(red_bls[:3], got[2]) == \
        jind.inflate_bls(red_bls[:3], want[2])
    assert tind.inflate_bls(red_bls, got[2], bls[::2]) == \
        jind.inflate_bls(red_bls, want[2], bls[::2])


@pytest.mark.parametrize("kw", [
    {}, dict(uniq_bls=True), dict(keep_autos=False, xants=[1, 5]),
    dict(min_len=20.0, max_len=50.0), dict(min_EW=5.0, max_EW=35.0),
    dict(min_NS=10.0, max_NS=30.0), dict(min_deg=45.0, max_deg=135.0),
    dict(uniq_bls=True, keep_autos=False, max_deg=60.0, min_NS=1.0)])
def test_array_get_bls_vs_jax(kw):
    ants, antvecs = make_hex(3, D=15.0)
    jarr = bl.ArrayModel(bl.utils.AntposDict(ants, antvecs))
    tarr = bt.ArrayModel(bt.utils.AntposDict(ants, antvecs), device="cpu")
    assert tarr.get_bls(**kw) == jarr.get_bls(**kw)
