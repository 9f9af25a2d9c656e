"""The port's UVH5 and calfits layer (data/uvdata_interface.py) against
the JAX package: read_uvh5 of the bundled demo_hex7_sim.uvh5 exactly;
write_uvh5 and write_uvh5_part across the packages (files readable by
either, the same header); read_calfits of the bundled
demo_hex7_gains.calfits and write_calfits across the packages (the same
bytes); the off-diagonal Jones refusal (ROADMAP queue C item 8, the JAX
writer drops those terms); setup_uvdata and the time / frequency
parsers; run_rime_sim from a UVH5 template at float64 within 1e-9; and
the pyuvdata-only calls raising ImportError as the JAX ones do (pyuvdata
is not installed here)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.data import containers as jc
from bayeslim_tpu.data import io as jio
from bayeslim_tpu.data import uvdata_interface as ju
from bayeslim_tpu_torch.data import CONFIG_PATH, DATA_PATH
from bayeslim_tpu_torch.data import containers as tc
from bayeslim_tpu_torch.data import io as tio
from bayeslim_tpu_torch.data import uvdata_interface as tu
from bayeslim_tpu_torch.utils import make_hex

from _torch_graft import LOC

UVH5 = os.path.join(DATA_PATH, "demo_hex7_sim.uvh5")
CALFITS = os.path.join(DATA_PATH, "demo_hex7_gains.calfits")
T64 = dict(device="cpu", dtype=torch.float64)
JD0 = 2458168.3
FREQS = np.linspace(100e6, 130e6, 4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return None if x is None else np.asarray(x)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _exact(t, j):
    """A port and a JAX container hold the same arrays and metadata."""
    for f in ("data", "flags"):
        a, b = _np(getattr(t, f)), _np(getattr(j, f))
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for m in ("blnums", "times", "freqs", "ants", "pol"):
        if getattr(j, m, None) is not None:
            assert np.array_equal(np.asarray(getattr(t, m)),
                                  np.asarray(getattr(j, m))), m
    if j.antpos is not None:
        assert list(t.antpos.ants) == list(j.antpos.ants)
        assert np.array_equal(t.antpos.asnumpy(),
                              np.asarray(j.antpos.antvecs))
    if j.telescope is not None:
        assert tuple(t.telescope.location) == tuple(
            float(x) for x in j.telescope.location)


def _read_uvh5(pkg, fname):
    return ju.read_uvh5(fname) if pkg == "jax" else \
        tu.read_uvh5(fname, **T64)


def _obs(pkg, npol=1, seed=0, ntime=3):
    """A VisData of a hex-2 observation with random data (complex64
    values, which UVH5 stores) and flags."""
    rng = np.random.default_rng(seed)
    ants, antvecs = make_hex(2, D=15.0)
    bls = [(a, b) for i, a in enumerate(ants) for b in ants[i:]]
    shape = (npol, npol, len(bls), ntime, len(FREQS))
    data = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64).astype(np.complex128)
    mod, cont, conv = (bl, jc, jnp.asarray) if pkg == "jax" else \
        (bt, tc, torch.as_tensor)
    vd = cont.VisData()
    vd.setup_meta(mod.TelescopeModel(LOC), mod.utils.AntposDict(ants,
                                                                antvecs))
    vd.setup_data(bls, JD0 + np.arange(ntime) * 10 / 86400, FREQS,
                  pol="ee" if npol == 1 else None, data=conv(data),
                  flags=rng.random(shape) < 0.2, history="obs")
    return vd


def test_read_uvh5_bundled_vs_jax():
    _exact(tu.read_uvh5(UVH5, **T64), ju.read_uvh5(UVH5))
    t = tu.PyVisData.read_uvdata(UVH5, device="cpu")
    assert isinstance(t, tu.PyVisData) and t.data.dtype == torch.complex64
    assert np.array_equal(_np(t.data), _np(ju.read_uvh5(UVH5).data)
                          .astype(np.complex64))
    assert isinstance(tu.uvd_to_visdata(UVH5, device="cpu"), tu.PyVisData)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("npol", [1, 2])
def test_write_uvh5_across_packages(tmp_path, writer, npol):
    """A file written by either package reads back exactly in both; the
    two packages' files hold the same datasets."""
    f = str(tmp_path / "w.uvh5")
    (ju if writer == "jax" else tu).write_uvh5(_obs(writer, npol), f)
    ref = _obs("jax", npol)
    for reader in ("jax", "torch"):
        got = _read_uvh5(reader, f)
        want = np.asarray(ref.data)
        assert np.array_equal(_np(got.data), want)
        assert np.array_equal(_np(got.flags), np.asarray(ref.flags))
        assert np.array_equal(got.times, ref.times)
        assert got.bls == [tuple(b) for b in ref.bls]
    with pytest.raises(FileExistsError):
        tu.write_uvh5(_obs("torch", npol), f)
    import h5py
    g = str(tmp_path / "other.uvh5")
    (tu if writer == "jax" else ju).write_uvh5(
        _obs("torch" if writer == "jax" else "jax", npol), g)
    with h5py.File(f, "r") as a, h5py.File(g, "r") as b:
        for grp in ("Header", "Data"):
            assert sorted(a[grp]) == sorted(b[grp])
            for k in a[grp]:
                if k != "history":
                    assert np.array_equal(a[grp][k][()], b[grp][k][()]), k


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_write_uvh5_part_across_packages(tmp_path, writer):
    """One package lays out a file of zeros, the other writes blocks of
    baselines, times and channels into it."""
    f = str(tmp_path / "p.uvh5")
    z = _obs(writer)
    z.data = z.data * 0
    (ju if writer == "jax" else tu).write_uvh5(z, f)
    other = tu if writer == "jax" else ju
    part_pkg = "torch" if writer == "jax" else "jax"
    full = _obs(part_pkg, seed=4)
    for sel in (dict(bl=full.bls[:5]), dict(bl=full.bls[5:], times=full.times[:2]),
                dict(bl=full.bls[5:], times=full.times[2:],
                     freqs=FREQS[1:3])):
        other.write_uvh5_part(f, full.select(inplace=False, **sel))
    got = _read_uvh5("torch", f)
    want = _np(full.data).copy()
    want[:, :, 5:, 2:, [0, 3]] = 0
    assert np.array_equal(_np(got.data), want)
    with pytest.raises(ValueError):
        tu.write_uvh5_part(f, _obs("torch", ntime=4).select(
            times=[JD0 + 3 * 10 / 86400], inplace=False))


def test_read_calfits_bundled_vs_jax():
    t, j = tu.read_calfits(CALFITS, device="cpu"), ju.read_calfits(CALFITS)
    _exact(t, j)
    assert t.data.dtype == torch.complex128


def _caldata(pkg, npol, seed=0, off=False):
    rng = np.random.default_rng(seed)
    ants, antvecs = make_hex(2, D=15.0)
    shape = (npol, npol, len(ants), 2, len(FREQS))
    g = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    flags = rng.random(shape) < 0.2
    if npol == 2 and not off:
        g[0, 1] = g[1, 0] = 0
        flags[0, 1] = flags[1, 0] = False
    mod, cont, conv = (bl, jc, jnp.asarray) if pkg == "jax" else \
        (bt, tc, torch.as_tensor)
    cd = cont.CalData()
    cd.setup_meta(mod.TelescopeModel(LOC), mod.utils.AntposDict(ants,
                                                                antvecs))
    cd.setup_data(ants, 2458101.0 + np.arange(2) * 10.7 / 86400, FREQS,
                  pol="ee" if npol == 1 else None, data=conv(g),
                  flags=flags)
    return cd


@pytest.mark.parametrize("npol", [1, 2])
def test_write_calfits_across_packages(tmp_path, npol):
    """The two packages write the same bytes; either reads either's file
    back exactly (float64 gains, flags, the time and frequency grids at
    JD magnitudes)."""
    fj, ft = str(tmp_path / "j.calfits"), str(tmp_path / "t.calfits")
    ju.write_calfits(_caldata("jax", npol), fj)
    tu.write_calfits(_caldata("torch", npol), ft)
    assert open(fj, "rb").read() == open(ft, "rb").read()
    for f in (fj, ft):
        t, j = tu.read_calfits(f, device="cpu"), ju.read_calfits(f)
        _exact(t, j)
        src = _caldata("jax", npol)
        assert np.array_equal(_np(t.data), np.asarray(src.data))
        assert np.array_equal(t.flags, np.asarray(src.flags))
    with pytest.raises(FileExistsError):
        tu.write_calfits(_caldata("torch", npol), ft)
    # an irregular grid is refused, as in the JAX package
    for pkg, mod in (("jax", ju), ("torch", tu)):
        cd = _caldata(pkg, 1)
        cd.freqs = np.asarray([100e6, 110e6, 125e6, 130e6])
        with pytest.raises(ValueError, match="uniformly"):
            mod.write_calfits(cd, str(tmp_path / f"bad_{pkg}.calfits"))


def test_queue_c8_write_calfits_refuses_offdiagonal_terms(tmp_path):
    """ROADMAP queue C item 8: the JAX write_calfits writes only the
    diagonal of a 4-pol CalData, so its off-diagonal Jones terms are
    gone when the file is read back. The port's raises ValueError naming
    the term."""
    fj = str(tmp_path / "j.calfits")
    jcd = _caldata("jax", 2, off=True)
    ju.write_calfits(jcd, fj)
    back = np.asarray(ju.read_calfits(fj).data)
    src = np.asarray(jcd.data)
    assert np.array_equal(back[0, 0], src[0, 0])
    assert not np.any(back[0, 1]) and np.any(src[0, 1])
    with pytest.raises(ValueError, match=r"off-diagonal.*data\[0, 1\]"):
        tu.write_calfits(_caldata("torch", 2, off=True),
                         str(tmp_path / "t.calfits"))
    assert not os.path.exists(str(tmp_path / "t.calfits"))


def test_setup_uvdata_and_parsers_vs_jax():
    ants, antvecs = make_hex(2, D=15.0)
    cases = [dict(no_autos=True, Ntimes=4, start_time=JD0, time_cadence=10.0,
                  Nfreqs=8, start_freq=1e8, channel_width=1e5),
             dict(redundancy=1.0, no_autos=True, Nfreqs=3, bandwidth=3e6),
             dict(anchor_ant=0, time_array=JD0 + np.arange(2) * 1e-3,
                  freq_array=FREQS, pol_array=[-6]),
             dict(antenna_nums=[1, 2], bls=[(0, 1), (2, 1), (3, 4)]),
             dict(make_data=False, antnames=[f"a{a}" for a in ants])]
    for kw in cases:
        j = ju.setup_uvdata(antnums=ants, antpos=antvecs, **kw)
        t = tu.setup_uvdata(antnums=ants, antpos=antvecs, **kw, **T64)
        _exact(t, j)
        assert getattr(t, "antnames", None) == getattr(j, "antnames", None)
    with pytest.raises(ValueError):
        tu.setup_uvdata(antnums=ants, antpos=antvecs, anchor_ant=99, **T64)
    for p in (dict(Ntimes=3), dict(Ntimes=2, start_time=JD0,
                                   time_cadence=3.0),
              dict(time_array=JD0 + np.arange(3) * 1e-3)):
        a, b = tu.parse_time_params(p), ju.parse_time_params(p)
        assert a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)
    for p in (dict(Nfreqs=3), dict(Nfreqs=4, channel_width=1e5),
              dict(freq_array=FREQS)):
        a, b = tu.parse_freq_params(p), ju.parse_freq_params(p)
        assert a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)


def test_run_rime_sim_uvh5_template_vs_jax(tmp_path):
    """run_rime_sim from a UVH5 template (written by setup_uvdata and
    write_uvh5), a catalogue sky and a Gauss beam: the same visibilities
    at 1e-9; the output written whole and, into a laid-out file, by
    partial_write."""
    ants, antvecs = make_hex(2, D=15.0)
    template = str(tmp_path / "template.uvh5")
    ju.write_uvh5(ju.setup_uvdata(
        antnums=ants, antpos=antvecs, no_autos=True,
        telescope_location=LOC, time_array=JD0 + np.arange(2) * 5e-4,
        freq_array=FREQS), template)
    cat = os.path.join(CONFIG_PATH, "demo_channel_cat.yaml")
    beam = dict(kind="gauss", params=np.ones((1, 1, 1, 4, 2)) * 10.0,
                freqs=FREQS, pol="e")
    jsky = jio.build_sky(catfile=cat, freqs=FREQS)
    tsky = tio.build_sky(catfile=cat, freqs=FREQS, **T64)
    jout = ju.run_rime_sim(jsky, jio.build_beam(**beam), template)
    out = str(tmp_path / "out.uvh5")
    tout = tu.run_rime_sim(tsky, tio.build_beam(**beam, **T64), template,
                           outfname=out, **T64)
    assert _relerr(_np(tout.data), jout.data) <= 1e-9
    assert np.array_equal(tout.blnums, np.asarray(jout.blnums))
    back = _read_uvh5("jax", out)
    assert np.array_equal(np.asarray(back.data),
                          _np(tout.data).astype(np.complex64)
                          .astype(np.complex128))
    tu.run_rime_sim(tsky, tio.build_beam(**beam, **T64), template,
                    outfname=template, partial_write=True, **T64)
    assert np.array_equal(_np(_read_uvh5("torch", template).data), _np(
        tout.data).astype(np.complex64).astype(np.complex128))
    with pytest.raises(ValueError):
        tu.run_rime_sim(tsky, None, template, ant2beam={0: 0, 1: 1}, **T64)


def test_pyuvdata_only_calls_raise_importerror_as_jax(tmp_path):
    """Without pyuvdata: complete_uvdata, get_params_from_uvdata,
    CalData.read_uvcal and a non-path read_uvdata raise ImportError in
    both packages; read_uvdata of a path with selection kwargs raises
    TypeError in both; a VisData template is copied or selected."""
    assert ju.HAS_PYUVDATA is False and tu.has_pyuvdata() is False
    jv, tv = ju.setup_uvdata(antnums=[0, 1], antpos=np.eye(3)[:2] * 14), \
        tu.setup_uvdata(antnums=[0, 1], antpos=np.eye(3)[:2] * 14, **T64)
    calls = [(lambda m, v, kw: m.complete_uvdata(v), ImportError),
             (lambda m, v, kw: m.get_params_from_uvdata(object()),
              ImportError),
             (lambda m, v, kw: m.PyVisData.read_uvdata(object()),
              ImportError),
             (lambda m, v, kw: m.PyVisData.read_uvdata(UVH5, bls=[(0, 1)]),
              TypeError),
             (lambda m, v, kw: m.setup_uvdata(
                 antnums=[0, 1], antpos=np.eye(3)[:2], as_uvdata=True,
                 **kw), ImportError)]
    for call, err in calls:
        with pytest.raises(err):
            call(ju, jv, {})
        with pytest.raises(err, match="pyuvdata"):
            call(tu, tv, T64)
    for cont in (jc, tc):
        with pytest.raises(ImportError, match="pyuvdata"):
            cont.CalData.read_uvcal(CALFITS)
    assert tu.PyVisData.read_uvdata(tv) is not tv
    sel = tu.PyVisData.read_uvdata(tv, bl=[(0, 1)])
    assert sel.bls == [(0, 1)]
