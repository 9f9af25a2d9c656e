"""The plain reference against the port's float64 CPU path at a tiny
size: the loss at the start and at the truth and both leaves' gradients
at the start; and the sky geometry, groups and Ylm against the port's
own. The port's Bessel J1 is the A&S 9.4.4 / 9.4.6 polynomial (error up
to 1.3e-8, the beam ~5e-8 off the exact J1 the reference takes), which
sets the tolerances: the loss to 1e-6, gradients to 1e-5 of their
largest (at the truth they are the noise's, and the beam's error is a
larger share of them)."""
import numpy as np
import pytest
import torch

import bayeslim_tpu_torch as bt
from bench_port import harness
from bench_port.reference import alm64, astro
from conftest import CELLS


def _program64(c, inp, target):
    """The configuration's posterior built in float64 on the CPU."""
    def target64(bls):
        d, w = target(bls)
        return d.to(torch.complex128), w.to(torch.float64)
    return c.maker.build(bt, c.cfg, inp, target64, torch.device("cpu"),
                           torch.float64)


@pytest.mark.parametrize("name, traffic", CELLS)
def test_reference_matches_port_float64(tiny_root, name, traffic):
    cpu = torch.device("cpu")
    c = harness.cell(tiny_root, f"tiny{name}.{traffic}")
    inp = c.maker.inputs(c.cfg, 2 ** 31 + 3, cpu)
    target, data = harness.make_target(c, inp, cpu)
    prob, keys = _program64(c, inp, target)
    ref = c.reference.Model(c.cfg, inp, cpu)
    ref.data = data.to(torch.complex128)
    for at in ("start", "truth"):
        x = inp["start"] if at == "start" else inp["truth"]
        x = {k: x[k] for k in keys}
        pd = bt.ParamDict({keys[k]: v.to(torch.float64) for k, v in x.items()})
        loss, grads = prob.value_and_grad(pd)
        rloss, rgrads = ref.value_and_grad(x)
        assert float(loss) == pytest.approx(rloss, rel=1e-6)
        if at == "truth":
            continue
        for k in keys:
            g, r = grads[keys[k]].double(), rgrads[k]
            scale = float(r.abs().max())
            assert float((g - r).abs().max()) <= 1e-5 * scale, (at, k)


def test_pixel_centres_match_port():
    from bayeslim_tpu_torch.utils import healpix
    theta, phi = astro.healpix_centres(16)
    t2, p2 = healpix.pix2ang(16, np.arange(12 * 16 ** 2))
    assert np.allclose(theta, t2, atol=1e-13)
    assert np.allclose(phi, p2, atol=1e-13)


def test_reds_match_port():
    from bayeslim_tpu_torch.models.telescope import build_reds
    from bayeslim_tpu_torch.utils import AntposDict
    pos = astro.make_hex(3, 15.0)
    a1, a2, group, r1, r2 = astro.redundant_groups(pos)
    reds = build_reds(AntposDict(list(range(len(pos))), pos), redtol=0.5)[0]
    reds = [r for r in reds if r[0][0] != r[0][1]]
    assert sorted(zip(r1.tolist(), r2.tolist())) == sorted(r[0] for r in reds)
    mine = {(i, j): g for i, j, g in zip(a1, a2, group)}
    for r in reds:
        assert len({mine[bl] for bl in r}) == 1


def test_ylm_matches_port():
    from bayeslim_tpu_torch.ops.sph_harm import gen_sph2pix
    theta, phi = astro.healpix_centres(8)
    l, m = alm64.gen_lm(23)
    P = alm64.legendre(23, np.cos(theta))
    ref = P * np.exp(1j * m[:, None] * phi[None, :])
    Y = gen_sph2pix(theta, phi, l, m, high_prec=False, device="cpu",
                    dtype=torch.float64)[0].numpy()
    assert np.abs(Y - ref).max() <= 1e-12


def test_eq2top_matches_port():
    from bayeslim_tpu_torch.models.telescope import eq2top
    theta, phi = astro.healpix_centres(8)
    ra, dec = np.degrees(phi), 90 - np.degrees(theta)
    zen, az = astro.eq2top(2458168.3, ra, dec)
    z2, a2 = eq2top(astro.LOCATION, 2458168.3, ra, dec)
    assert np.abs(zen - z2).max() < 1e-9
    assert np.abs(np.angle(np.exp(1j * np.radians(az - a2)))).max() < 1e-9
