"""The port's HDF5 file layer against the JAX package: VisData, MapData
and CalData files written by one package and read by the other, both
ways, bit for bit (with flags, diagonal and structured covariances and
the metadata); read_hdf5's selections; from_hdf5 over several files
along each axis, lazily and interleaved; HDF5Tensor,
SelectedHDF5Tensor and make_HDF5Tensor slices; load_data of lists with
concat_ax; a Dataset of paths. Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.data import containers as jc
from bayeslim_tpu.data import dataset as jds
from bayeslim_tpu_torch.data import containers as tc
from bayeslim_tpu_torch.data import dataset as tds
from bayeslim_tpu_torch.utils import make_hex

from _torch_graft import LOC

JD0 = 2458168.3
NF, NT = 6, 4
FREQS = np.linspace(100e6, 120e6, NF)
TIMES = JD0 + np.arange(NT) * 5e-4
CPU = dict(device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return None if x is None else np.asarray(x)


def _pkg(name):
    return (bl, jc, jnp.asarray) if name == "jax" else \
        (bt, tc, torch.as_tensor)


def _vis(pkg, seed=0, npol=1, cov_axis=None, flags=True, hexN=2):
    """A VisData of every cross baseline with random data, flags and a
    diagonal icov, or a structured cov along cov_axis."""
    mod, cont, conv = _pkg(pkg)
    rng = np.random.default_rng(seed)
    ants, antvecs = make_hex(hexN, D=15.0)
    bls = [(a, b) for i, a in enumerate(ants) for b in ants[i + 1:]]
    shape = (npol, npol, len(bls), NT, NF)
    data = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    vd = cont.VisData()
    vd.setup_meta(mod.TelescopeModel(LOC), mod.utils.AntposDict(ants,
                                                                antvecs))
    kw = dict(icov=conv(rng.uniform(1, 2, shape)))
    if cov_axis == "time":
        a = rng.standard_normal((npol, npol, len(bls), NF, NT, NT))
        kw = dict(cov=conv(a @ np.swapaxes(a, -1, -2)
                           + NT * np.eye(NT)), cov_axis="time")
    vd.setup_data(bls, TIMES, FREQS, pol="ee" if npol == 1 else None,
                  data=conv(data), history=f"seed {seed}",
                  flags=rng.random(shape) < 0.2 if flags else None, **kw)
    return vd


def _map(pkg, seed=0):
    mod, cont, conv = _pkg(pkg)
    rng = np.random.default_rng(seed)
    npix = 12
    md = cont.MapData()
    md.setup_meta(name="sky")
    shape = (2, 1, NF, npix)
    md.setup_data(FREQS, df=np.full(NF, 1e5), pols=["ee", "nn"],
                  data=conv(rng.standard_normal(shape)),
                  angs=rng.uniform(-30, 30, (2, npix)),
                  flags=rng.random(shape) < 0.2,
                  cov=conv(rng.uniform(1, 2, shape)),
                  icov=conv(rng.uniform(1, 2, shape)),
                  norm=conv(rng.uniform(1, 2, shape)), history="a map")
    return md


def _cal(pkg, seed=0, npol=1):
    mod, cont, conv = _pkg(pkg)
    rng = np.random.default_rng(seed)
    ants, antvecs = make_hex(2, D=15.0)
    shape = (npol, npol, len(ants), NT, NF)
    cd = cont.CalData()
    cd.setup_meta(mod.TelescopeModel(LOC), mod.utils.AntposDict(ants,
                                                                antvecs))
    cd.setup_data(ants, TIMES, FREQS, pol="e" if npol == 1 else None,
                  data=conv(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)),
                  flags=rng.random(shape) < 0.2,
                  cov=conv(rng.uniform(1, 2, shape)),
                  icov=conv(rng.uniform(1, 2, shape)), history="gains")
    return cd


def _exact(a, b, fields=("data", "flags", "cov", "icov")):
    """Two containers hold the same arrays, bit for bit, and the same
    metadata."""
    for f in fields:
        x, y = getattr(a, f, None), getattr(b, f, None)
        assert (x is None) == (y is None), f
        if x is not None:
            x, y = _np(x), _np(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for m in ("blnums", "times", "freqs", "ants", "pol", "pols",
              "cov_axis", "history", "name", "df", "norm"):
        if hasattr(b, m):
            x, y = getattr(a, m), getattr(b, m)
            if x is None or y is None:
                assert x is None and y is None, m
            else:
                assert np.array_equal(_np(x), _np(y)), m
    for m in ("cov_ndim", "cov_logdet"):
        if getattr(b, m, None) is not None:
            assert getattr(a, m) == pytest.approx(getattr(b, m), rel=1e-12)
    if getattr(b, "antpos", None) is not None:
        assert list(a.antpos.ants) == list(b.antpos.ants)
        assert np.array_equal(a.antpos.asnumpy() if hasattr(
            a.antpos, "asnumpy") else np.asarray(a.antpos.antvecs),
            np.asarray(b.antpos.antvecs))
    if getattr(b, "telescope", None) is not None:
        assert tuple(a.telescope.location) == tuple(
            float(x) for x in b.telescope.location)


DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


def _read(pkg, cls, fname, **kw):
    cont = _pkg(pkg)[1]
    return getattr(cont, cls).read_hdf5(fname, **(dict(kw, **CPU)
                                                 if pkg == "torch" else kw))


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("npol,cov_axis", [(1, None), (2, None),
                                           (1, "time")])
def test_visdata_files_across_packages(tmp_path, writer, reader, npol,
                                       cov_axis):
    fname = str(tmp_path / "vis.h5")
    _vis(writer, npol=npol, cov_axis=cov_axis).write_hdf5(fname)
    got = _read(reader, "VisData", fname)
    _exact(got, _vis(reader, npol=npol, cov_axis=cov_axis))
    with pytest.raises(FileExistsError):
        _vis(writer).write_hdf5(fname)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_mapdata_files_across_packages(tmp_path, writer, reader):
    fname = str(tmp_path / "map.h5")
    _map(writer).write_hdf5(fname)
    got = _read(reader, "MapData", fname)
    _exact(got, _map(reader))
    assert np.array_equal(_np(got.angs), _np(_map(reader).angs))


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("npol", [1, 2])
def test_caldata_files_across_packages(tmp_path, writer, reader, npol):
    fname = str(tmp_path / "cal.h5")
    _cal(writer, npol=npol).write_hdf5(fname)
    _exact(_read(reader, "CalData", fname), _cal(reader, npol=npol))


def test_read_hdf5_selections_vs_jax(tmp_path):
    """Selections by value and by index, read_data=False,
    suppress_nonessential, and the instance form (filled in place)."""
    fname = str(tmp_path / "vis.h5")
    _vis("jax", npol=2).write_hdf5(fname)
    bls = _vis("jax").bls
    cases = [dict(bl=bls[:3]), dict(times=TIMES[1:3]),
             dict(freqs=FREQS[::2]), dict(pol="ee"),
             dict(bl_inds=[4, 1], time_inds=[3], freq_inds=[0, 5]),
             dict(suppress_nonessential=True), dict(read_data=False)]
    for kw in cases:
        _exact(tc.VisData.read_hdf5(fname, **kw, **CPU),
               jc.VisData.read_hdf5(fname, **kw))
    vd = tc.VisData()
    assert vd.read_hdf5(fname, **CPU) is vd
    _exact(vd, jc.VisData.read_hdf5(fname))
    cfile = str(tmp_path / "cal.h5")
    _cal("jax", npol=2).write_hdf5(cfile)
    ants = _cal("jax").ants
    for kw in (dict(ants=ants[:2]), dict(times=TIMES[:1]), dict()):
        _exact(tc.CalData.read_hdf5(cfile, **kw, **CPU),
               jc.CalData.read_hdf5(cfile, **kw))


@pytest.mark.parametrize("axis", ["bl", "time", "freq"])
@pytest.mark.parametrize("mode", ["plain", "lazy", "interleave"])
def test_from_hdf5_several_files_vs_jax(tmp_path, axis, mode):
    """from_hdf5 of three files along an axis: the JAX package's element
    order, concatenated, round-robin (interleave) or as a lazy
    CatTensor of HDF5Tensors read on the host."""
    full = _vis("jax", seed=5)
    n = {"bl": full.Nbls, "time": NT, "freq": NF}[axis]
    step = n // 2
    files = []
    for i in range(2):
        sel = {"bl": dict(bl=full.bls[i * step:(i + 1) * step]),
               "time": dict(times=TIMES[i * step:(i + 1) * step]),
               "freq": dict(freqs=FREQS[i * step:(i + 1) * step])}[axis]
        f = str(tmp_path / f"part{i}.h5")
        full.select(inplace=False, **sel).write_hdf5(f)
        files.append(f)
    kw = dict(lazy_cat=mode == "lazy", interleave=mode == "interleave")
    jv = jc.VisData.from_hdf5(files, axis=axis, **kw)
    tv = tc.VisData.from_hdf5(files, axis=axis, **kw, **CPU)
    if mode == "lazy":
        assert isinstance(tv.data, tc.CatTensor)
        assert tv.data.shape == jv.data.shape
        assert np.array_equal(_np(tv.data.load()), _np(jv.data.load()))
        assert np.array_equal(_np(tv.data[:, :, 1]), _np(jv.data[:, :, 1]))
    else:
        _exact(tv, jv)
    # axis None: the list of VisData
    parts = tc.VisData.from_hdf5(files, **CPU)
    assert [p.Nbls for p in parts] == [
        p.Nbls for p in jc.VisData.from_hdf5(files)]


def test_hdf5tensor_slices_vs_jax(tmp_path):
    """HDF5Tensor, SelectedHDF5Tensor (slice, integer, index list and
    mask selections) and make_HDF5Tensor (sel and its alias idx):
    shapes and slices, read on the host and moved to the device."""
    import h5py
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((5, 6, 7)) + 1j * rng.standard_normal((5, 6, 7))
    fname = str(tmp_path / "t.h5")
    with h5py.File(fname, "w") as f:
        f.create_dataset("data", data=arr)
    jt = jc.make_HDF5Tensor(fname)
    tt = tc.make_HDF5Tensor(fname, **CPU)
    assert isinstance(tt, tc.HDF5Tensor)
    assert tt.shape == jt.shape and tt.ndim == 3 and len(tt) == 5
    assert tt.numel() == jt.numel() and tt.size(1) == jt.size(1)
    for idx in ((slice(1, 4), 2), (Ellipsis,), ([0, 2, 3],),
                (slice(None), slice(0, 6, 2), 0)):
        assert np.array_equal(_np(tt[idx]), _np(jt[idx]))
    assert tt[1:2].device.type == "cpu"
    assert tc.HDF5Tensor(fname, "data", dtype=torch.complex64,
                         **CPU)[0].dtype == torch.complex64
    sels = [(slice(1, 4),), (slice(None), [1, 3, 4]), (2,),
            (slice(None), slice(None), np.arange(7) % 2 == 0)]
    for sel in sels:
        for kw in (dict(sel=sel), dict(idx=sel)):
            js = jc.make_HDF5Tensor(fname, **kw)
            ts = tc.make_HDF5Tensor(fname, **kw, **CPU)
            assert isinstance(ts, tc.SelectedHDF5Tensor)
            assert ts.shape == js.shape
            for idx in ((Ellipsis,), (0,), (slice(None), [1, 0])):
                assert np.array_equal(_np(ts[idx]), _np(js[idx]))


def test_load_data_lists_and_dataset_vs_jax(tmp_path):
    """load_data of one file of each kind, of a list (concatenated along
    concat_ax, or a list), copy=; a Dataset of paths read when
    indexed."""
    files = {}
    for kind, obj in (("vis", _vis("jax")), ("map", _map("jax")),
                      ("cal", _cal("jax"))):
        files[kind] = str(tmp_path / f"{kind}.h5")
        obj.write_hdf5(files[kind])
    for kind, f in files.items():
        t, j = tc.load_data(f, **CPU), jc.load_data(f)
        assert type(t).__name__ == type(j).__name__
        _exact(t, j)
    vis = _vis("jax", seed=8)
    parts = []
    for i in range(2):
        f = str(tmp_path / f"t{i}.h5")
        vis.select(times=TIMES[2 * i:2 * i + 2], inplace=False).write_hdf5(f)
        parts.append(f)
    _exact(tc.load_data(parts, concat_ax="time", **CPU),
           jc.load_data(parts, concat_ax="time"))
    lst = tc.load_data(parts, copy=True, **CPU)
    assert isinstance(lst, list) and len(lst) == 2
    for a, b in zip(lst, jc.load_data(parts)):
        _exact(a, b)
    mem = tc.load_data(lst[0])
    assert mem is lst[0]
    ds, jd = tds.Dataset(parts, **CPU), jds.Dataset(parts)
    assert len(ds) == ds.Nbatch == 2
    for a, b in zip(ds, jd):
        _exact(a, b)
