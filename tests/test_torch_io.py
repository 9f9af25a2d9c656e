"""The port's builders and pickles (data/io.py) against the JAX package:
each build_* from the same kwargs in both packages (the telescope, the
array, a catalogue sky from the bundled YAML catalogues and its
multi-component form, set_param / unset_param, the Gauss, Airy and
uniform beams, the RIME with redundant expansion, baseline dicts and
time batches, indexed batching, the calibration blocks, Sequential
chains and LogProb from an HDF5 target, with and without
reduce_by_redundancy); outputs and gradients at float64 within 1e-9.
Also the port's own pickles, ParamDict pickles across the packages, the
catalogue files across the packages, Module.update / unset_param / push
/ copy / clone, LogProb(start_inp=) and model descriptions. Inputs come
from numpy seeds on hex-2 arrays."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslim_tpu as bl
import bayeslim_tpu_torch as bt
from bayeslim_tpu.data import io as jio
from bayeslim_tpu.models import sky as jsky
from bayeslim_tpu.utils import paramdict as jpd
from bayeslim_tpu_torch.data import CONFIG_PATH, io as tio
from bayeslim_tpu_torch.models import sky as tsky
from bayeslim_tpu_torch.utils import paramdict as tpd
from bayeslim_tpu_torch.utils import make_hex

from _torch_graft import LOC

JD0 = 2458168.3
TIMES = [JD0, JD0 + 5e-4]
FREQS = np.linspace(100e6, 130e6, 4)
T64 = dict(device="cpu", dtype=torch.float64)
CATS = {"channel": os.path.join(CONFIG_PATH, "demo_channel_cat.yaml"),
        "powerlaw": os.path.join(CONFIG_PATH, "demo_powerlaw_cat.yaml")}
TOL = 1e-9


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _beam(kind):
    """Beam build kwargs: the analytic responses, a pixel beam on an
    nside-8 HEALPix grid, a Ylm beam of lmax 3 on it."""
    rng = np.random.default_rng(12)
    rkw = {}
    if kind == "pixel":
        params = rng.uniform(0.5, 1.5, (1, 1, 1, 4, 768))
        rkw = dict(pixtype="healpix", nside=8, interp_mode="linear")
    elif kind == "ylm":
        from bayeslim_tpu.ops import sph_harm as jsh
        l, m = jsh.gen_lm(3)
        params = rng.standard_normal((1, 1, 1, 4, len(l))) / (l + 1.0)
        params[..., l == 0] += 2.0
        rkw = dict(l=l, m=m, nside=8,
                   Ylm_kwargs=dict(method="sphere", high_prec=False))
    else:
        params = {"gauss": np.ones((1, 1, 1, 4, 2)) * 10.0,
                  "airy": np.ones((1, 1, 1, 1, 2)) * 14.0,
                  "uniform": np.ones((1, 1, 1, 1, 1))}[kind]
    return dict(kind=kind, params=params, freqs=FREQS, pol="e",
                powerbeam=True, response_kwargs=rkw)


def _rime_dict(cat="channel", beam="gauss", sim_bls=None, **kw):
    ants, antvecs = make_hex(2)
    d = dict(sky=dict(catfile=CATS[cat], freqs=FREQS),
             telescope=dict(location=LOC), beam=_beam(beam),
             array=dict(ants=ants, antvecs=antvecs, freqs=FREQS),
             sim_bls=dict(keep_autos=False) if sim_bls is None else sim_bls,
             times=TIMES, freqs=FREQS)
    d.update(kw)
    return d


def _seq_dict(antpos_param=True, seed=0, **rkw):
    ants = make_hex(2)[0]
    rng = np.random.default_rng(seed)
    gains = np.zeros((1, 1, len(ants), 1, len(FREQS), 2))
    gains[..., 0] = 1 + 0.05 * rng.standard_normal(gains.shape[:-1])
    gains[..., 1] = 0.05 * rng.standard_normal(gains.shape[:-1])
    rd = _rime_dict(**rkw)
    rd["array"]["parameter"] = antpos_param
    return dict(order=["rime", "cal"], kind=["rime", "calibration"],
                mdict=dict(rime=rd, cal=dict(kind="jones", params=gains,
                                             ants=ants, refant=ants[0])))


def _build_both(builder, **kw):
    return getattr(jio, builder)(**kw), getattr(tio, builder)(**kw, **T64)


def _same_vis(jv, tv, tol=TOL):
    assert _relerr(_np(tv.data), jv.data) <= tol
    np.testing.assert_array_equal(tv.blnums, np.asarray(jv.blnums))
    np.testing.assert_array_equal(tv.times, np.asarray(jv.times))


def _grads_vs_jax(jp, tp, pdict=None, tol=TOL):
    """Loss and gradients of a JAX and a port LogProb, at pdict
    (numpy, by key) or at their own parameters."""
    jpdict = None if pdict is None else bl.ParamDict(
        {k: jnp.asarray(v) for k, v in pdict.items()})
    tpdict = None if pdict is None else bt.ParamDict(
        {k: torch.as_tensor(v) for k, v in pdict.items()})
    jl, jg = jp.value_and_grad(jpdict)
    tl, tg = tp.value_and_grad(tpdict)
    assert abs(float(tl) - float(jl)) <= tol * abs(float(jl)) + 1e-12
    assert sorted(jg.keys()) == sorted(tg.keys())
    for k in jg.keys():
        assert _relerr(_np(tg[k]), jg[k]) <= tol, k
    return float(tl), float(jl)


def _write_target(tmp_path, seq_dict, name="data.h5", seed=3):
    """Simulate the JAX chain, add noise, write it with the JAX writer."""
    jm = jio.build_sequential(**seq_dict)
    vd = jm(None)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(vd.data.shape) \
        + 1j * rng.standard_normal(vd.data.shape)
    vd.data = vd.data + jnp.asarray(noise)
    vd.setup_meta(bl.TelescopeModel(LOC),
                  bl.utils.AntposDict(*make_hex(2)))
    vd.icov = jnp.ones(vd.data.shape)
    fname = str(tmp_path / name)
    vd.write_hdf5(fname)
    return fname


# --------------------------------------------------------------- builders

def test_build_telescope_and_array_vs_jax():
    jt, tt = _build_both("build_telescope", location=LOC)
    assert tt.location == tuple(float(x) for x in jt.location)
    ants, antvecs = make_hex(2)
    for kw in (dict(ants=ants, antvecs=antvecs),
               dict(antpos={a: v for a, v in zip(ants, antvecs)})):
        ja, ta = _build_both("build_array", freqs=FREQS, **kw)
        assert ta.ants == list(ja.ants)
        assert _relerr(_np(ta.antvecs), ja.antvecs) == 0.0
        assert [list(r) for r in ta.reds] == [list(r) for r in ja.reds]
        assert ta.get_bls(keep_autos=False) == [
            tuple(b) for b in ja.get_bls(keep_autos=False)]


@pytest.mark.parametrize("cat", ["channel", "powerlaw"])
def test_build_sky_bundled_catalogue_vs_jax(cat):
    """catfile= on the bundled catalogues, read in place: the sky and
    the gradient of a function of it; set_param / unset_param."""
    js, ts = _build_both("build_sky", catfile=CATS[cat], freqs=FREQS)
    jd, td = js(None).data, ts().data
    assert _relerr(_np(td), jd) <= TOL
    assert np.array_equal(ts.angs_np, np.asarray(js.angs))
    w = np.random.default_rng(1).standard_normal(np.shape(jd))
    import jax
    jg = jax.grad(lambda p: jnp.sum(js(p).data * w))(js.params)
    (td * torch.as_tensor(w)).sum().backward()
    assert _relerr(_np(ts.params.grad), jg) <= TOL
    # toggling trainability after construction
    js, ts = _build_both("build_sky", catfile=CATS[cat], freqs=FREQS,
                         unset_param="params")
    assert "params" not in dict(ts.named_parameters())
    assert list(bl.utils.model2pdict(js).keys()) == []
    js, ts = _build_both("build_sky", catfile=CATS[cat], freqs=FREQS,
                         parameter=False, set_param="params")
    assert list(dict(ts.named_parameters())) == ["params"]
    assert list(bl.utils.model2pdict(js).keys()) == ["params"]
    # pdict= updates the catalogue's values
    new = np.asarray(js.params) * 1.5
    js, ts = _build_both("build_sky", catfile=CATS[cat], freqs=FREQS,
                         pdict={"params": new})
    assert _relerr(_np(ts().data), js(None).data) <= TOL
    assert np.array_equal(_np(ts.params), new)


def test_build_sky_multi_vs_jax():
    """multi= as a dict and as a list of (name, kwargs) pairs: the
    components' skies."""
    items = [(c, dict(catfile=CATS[c], freqs=FREQS)) for c in CATS]
    for multi, comp in ((dict(items), None),
                        (items, dict(sum_output=False))):
        js, ts = _build_both("build_sky", multi=multi, comp_kwargs=comp)
        jo, to = js(), ts()
        assert len(jo) == len(to) == 2
        for a, b in zip(jo, to):
            assert _relerr(_np(b.data), a.data) <= TOL


@pytest.mark.parametrize("beam", ["gauss", "airy", "uniform", "pixel",
                                  "ylm"])
def test_build_rime_beams_and_redundancy_vs_jax(beam):
    """build_rime with each beam kind, redundant expansion, a get_bls
    dict and a time batch of one: visibilities of every batch."""
    kw = _rime_dict(beam=beam, redundant=True, time_batch=1)
    jr, tr = _build_both("build_rime", **kw)
    assert tr.Nbatch == jr.Nbatch == 2
    jv, tv = jr.run_batches(), tr.run_batches()
    _same_vis(jv, tv)
    assert len(tr.sim_bls) < len(tr.data_bls)


def test_build_rime_indexed_batching_same_visibilities():
    """indexed_batching picks a compiled executable in JAX; the port
    accepts it and runs its ordinary batching: the same visibilities,
    equal to JAX's either way."""
    kw = _rime_dict(time_batch=1)
    a = tio.build_rime(indexed_batching=True, **kw, **T64).run_batches()
    b = tio.build_rime(indexed_batching=False, **kw, **T64).run_batches()
    assert torch.equal(a.data, b.data)
    _same_vis(jio.build_rime(indexed_batching=True, **kw).run_batches(), a)


def test_build_rime_from_pickled_blocks(tmp_path):
    """Blocks, times, freqs and baselines given as pickle paths, and a
    pdict pickle; the port reads its own pickles onto the device."""
    kw = _rime_dict()
    ref = tio.build_rime(**kw, **T64)
    paths = {}
    for key, obj in (("sky", ref.sky), ("beam", ref.beam),
                     ("telescope", ref.telescope), ("array", ref.array),
                     ("times", np.asarray(TIMES)), ("freqs", FREQS),
                     ("sim_bls", ref.sim_bls)):
        paths[key] = str(tmp_path / f"{key}.pkl")
        tio.write_pkl(paths[key], obj)
    pd = bt.ParamDict({"sky.params": ref.sky.params.detach() * 2})
    pfile = str(tmp_path / "pdict.pkl")
    pd.write_pkl(pfile)
    rime = tio.build_rime(pdict=pfile, **paths, **T64)
    two = ref.updated(pd)()
    assert torch.equal(rime().data, two.data)


@pytest.mark.parametrize("kind", ["jones", "vis", "redvis"])
def test_build_calibration_vs_jax(kind):
    """Each calibration kind applied to the same VisData."""
    ants = make_hex(2)[0]
    rng = np.random.default_rng(7)
    bls = [(a, b) for i, a in enumerate(ants) for b in ants[i + 1:]]
    vis = rng.standard_normal((1, 1, len(bls), 2, 4)) \
        + 1j * rng.standard_normal((1, 1, len(bls), 2, 4))
    if kind == "jones":
        kw = dict(params=1 + 0.1 * rng.standard_normal(
            (1, 1, len(ants), 1, 4, 2)), ants=ants)
    elif kind == "vis":
        kw = dict(params=0.1 * rng.standard_normal(
            (1, 1, len(bls), 2, 4, 2)))
    else:
        bl2red = {b: i % 3 for i, b in enumerate(bls)}
        kw = dict(params=0.1 * rng.standard_normal((1, 1, 3, 2, 4, 2)),
                  bl2red=bl2red)
    jm, tm = _build_both("build_calibration", kind=kind, **kw)
    outs = []
    for pkg, m, conv in (("jax", jm, jnp.asarray),
                         ("torch", tm, torch.as_tensor)):
        vd = (bl if pkg == "jax" else bt).VisData()
        vd.setup_data(bls, TIMES, FREQS, pol="ee", data=conv(vis))
        outs.append(m(vd).data)
    assert _relerr(_np(outs[1]), outs[0]) <= TOL


def test_build_prob_hdf5_target_vs_jax(tmp_path):
    """build_prob on an HDF5 target written by the JAX package: loss
    and gradients equal, at the start and at moved parameters; the
    chain's own simulation as the target gives a loss of ~0."""
    sd = _seq_dict()
    fname = _write_target(tmp_path, sd)
    jp = jio.build_prob(seq_dict=sd, data=fname)
    tp = tio.build_prob(seq_dict=sd, data=fname, **T64)
    assert isinstance(tp.target, bt.Dataset)
    _grads_vs_jax(jp, tp)
    rng = np.random.default_rng(11)
    moved = {k: _np(v) + 1e-3 * rng.standard_normal(v.shape)
             for k, v in tp.collect_main_params().items()}
    _grads_vs_jax(jp, tp, moved)
    # model == data: chi^2 ~ 0
    vd = tio.build_sequential(**sd, **T64)()
    vd.setup_meta(bt.TelescopeModel(LOC), bt.utils.AntposDict(*make_hex(2)))
    clean = str(tmp_path / "clean.h5")
    vd.data = vd.data.detach()
    vd.write_hdf5(clean)
    tp0 = tio.build_prob(seq_dict=sd, data=clean, compute="like", **T64)
    jp0 = jio.build_prob(seq_dict=sd, data=clean, compute="like")
    assert abs(float(tp0().detach())) < 1e-8 and abs(float(jp0(
        jp0.collect_main_params()))) < 1e-8


def test_build_prob_reduce_by_redundancy_vs_jax(tmp_path):
    """reduce_by_redundancy: the same chisq_const, loss and gradients
    against a RIME of the group representatives."""
    sd = _seq_dict(antpos_param=False)
    fname = _write_target(tmp_path, sd)
    red = _seq_dict(antpos_param=False,
                    sim_bls=dict(keep_autos=False, uniq_bls=True))
    del red["mdict"]["cal"]
    red["order"], red["kind"] = ["rime"], ["rime"]
    jp = jio.build_prob(seq_dict=red, data=fname, reduce_by_redundancy=True,
                        redtol=1.0)
    tp = tio.build_prob(seq_dict=red, data=fname, reduce_by_redundancy=True,
                        redtol=1.0, **T64)
    assert tp.chisq_const != 0.0
    assert abs(tp.chisq_const - jp.chisq_const) <= TOL * abs(jp.chisq_const)
    _grads_vs_jax(jp, tp)


def test_build_prob_from_yaml_config(tmp_path):
    """A YAML config (load_yaml) holding the whole seq_dict builds the
    same LogProb in both packages."""
    import yaml
    sd = _seq_dict()
    fname = _write_target(tmp_path, sd)

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, np.ndarray):
            return x.tolist()
        return x.item() if isinstance(x, np.generic) else x
    cfg = str(tmp_path / "cfg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(dict(seq_dict=plain(sd), data=fname), f)
    jc, tc = jio.load_yaml(cfg), tio.load_yaml(cfg)
    assert jc == tc
    _grads_vs_jax(jio.build_prob(**jc), tio.build_prob(**tc, **T64))


def test_chip_smoke_yaml_config_chain_matches_kwargs(tmp_path):
    """chip_smoke.io_yaml_chains at hex-2 on the CPU: hera-io's chain
    from a YAML config (the bundled powerlaw catalogue as a PointSky,
    the gains a pickle) gives the kwargs build's loss and gradients bit
    for bit, with sources in the field of view."""
    from chip_smoke import build_sky_beam, io_seq_dict, io_target, \
        io_yaml_chains
    dt = torch.float64
    _, _, sky, _, _ = build_sky_beam(bt, 2, 8, 16, 120e6, 0.5, True, "cpu",
                                     dt, np.random.default_rng(0), amp=1e4)
    sky_pkl = str(tmp_path / "sky.pkl")
    tio.write_pkl(sky_pkl, sky)
    sd = io_seq_dict(sky_pkl, hexN=2, nfreq=16, fmax=120e6, ntime=2,
                     pix_chunk=512)
    tgt = io_target(bt, torch, tio, sd, "cpu", dt)
    py, pk, cfg = io_yaml_chains(tio, sd, tgt, str(tmp_path), "cpu", dt)
    assert os.path.exists(cfg) and py.model.rime.Npix_cut > 0
    assert type(py.model.rime.sky).__name__ == "PointSky"
    ly, gy = py.value_and_grad()
    lk, gk = pk.value_and_grad()
    assert np.isfinite(float(ly)) and float(ly) == float(lk)
    assert sorted(gy.keys()) == sorted(gk.keys())
    for k in gk.keys():
        assert torch.equal(gy[k], gk[k]), k


# ---------------------------------------------------------------- pickles

def test_port_model_pickle_roundtrip(tmp_path):
    """write_pkl / read_pkl of a whole chain: the same loss; read_pkl
    with a pdict; build_* with modfile=; an existing file is kept."""
    sd = _seq_dict()
    fname = _write_target(tmp_path, sd)
    tp = tio.build_prob(seq_dict=sd, data=fname, **T64)
    f = str(tmp_path / "prob.pkl")
    tio.write_pkl(f, tp)
    tp2 = tio.read_pkl(f, device="cpu")
    l1, g1 = tp.value_and_grad()
    l2, g2 = tp2.value_and_grad()
    assert float(l1) == float(l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k])
    # an existing file is not overwritten
    tio.write_pkl(f, "other")
    assert isinstance(tio.read_pkl(f, device="cpu"), type(tp))
    # modfile= and pdict= through the builders
    sf = str(tmp_path / "seq.pkl")
    tio.write_pkl(sf, tp.model)
    pd = bt.ParamDict({k: v.detach() + 0.01
                       for k, v in tp.model.named_parameters()})
    pf = str(tmp_path / "pd.pkl")
    tpd.write_pdict(pf, pd)
    m = tio.read_pkl(sf, pdict=pf, device="cpu")
    for k, v in m.named_parameters():
        assert torch.equal(v.detach(), pd[k])
    assert isinstance(tio.build_sequential(modfile=sf, device="cpu"),
                      bt.Sequential)
    assert isinstance(tio.build_prob(modfile=f, device="cpu"), bt.LogProb)


def test_paramdict_pickles_across_packages(tmp_path):
    """A ParamDict pickled by either package reads back exactly in the
    other (a dict of numpy arrays); ParamDict.read_pkl(device=)."""
    rng = np.random.default_rng(2)
    arrs = {"a.params": rng.standard_normal((3, 4)),
            "b.params": rng.standard_normal(5) + 1j * rng.standard_normal(5)}
    fj, ft = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jpd.write_pdict(fj, bl.ParamDict({k: jnp.asarray(v)
                                      for k, v in arrs.items()}))
    bt.ParamDict({k: torch.as_tensor(v) for k, v in arrs.items()}
                 ).write_pkl(ft)
    with pytest.raises(FileExistsError):
        tpd.write_pdict(ft, bt.ParamDict({}))
    a = bt.ParamDict.read_pkl(fj, device="cpu")
    b = jpd.read_pdict(ft)
    c = tpd.read_pdict(ft, device="cpu")
    for k, v in arrs.items():
        assert np.array_equal(_np(a[k]), v)
        assert np.array_equal(np.asarray(b[k]), v)
        assert np.array_equal(_np(c[k]), v) and c[k].dtype == a[k].dtype


# ------------------------------------------------------ catalogue, module

def test_catalogue_files_across_packages(tmp_path):
    """Catalogues written by either package read back equal in the
    other, powerlaw and channel, and from a sky (sky= and the
    positional form)."""
    rng = np.random.default_rng(4)
    angs = np.stack([rng.uniform(0, 360, 5), rng.uniform(-60, 0, 5)])
    pl = np.stack([rng.uniform(1, 5, 5), rng.uniform(-3, -1, 5)])[None, None]
    ch = rng.uniform(1, 5, (1, 1, 3, 5))
    cfreqs = np.asarray([100e6, 110e6, 120e6])
    for mode, params, kw in (("powerlaw", pl, dict(f0=120e6)),
                             ("channel", ch, dict(freqs=cfreqs))):
        fj, ft = str(tmp_path / f"j_{mode}.yaml"), str(tmp_path / f"t_{mode}.yaml")
        jsky.write_catalogue(fj, params, angs, freq_mode=mode, **kw)
        tsky.write_catalogue(ft, torch.as_tensor(params), angs,
                             freq_mode=mode, **kw)
        with pytest.raises(FileExistsError):
            tsky.write_catalogue(ft, params, angs, freq_mode=mode, **kw)
        for f in (fj, ft):
            jp, ja, jm = jsky.read_catalogue(f)
            tp, ta, tm = tsky.read_catalogue(f, **T64)
            assert np.array_equal(_np(tp), np.asarray(jp))
            assert np.array_equal(ta, np.asarray(ja))
            assert jm["freq_mode"] == tm["freq_mode"] == mode
            jp, _, _ = jsky.read_catalogue(f, freqs=FREQS)
            tp, _, _ = tsky.read_catalogue(f, freqs=FREQS, **T64)
            assert _relerr(_np(tp), jp) <= TOL
    ts = tio.build_sky(catfile=str(tmp_path / "t_powerlaw.yaml"), freqs=FREQS,
                       **T64)
    for i, form in enumerate((dict(sky=ts), dict(params=ts))):
        f = str(tmp_path / f"sky{i}.yaml")
        if "sky" in form:
            tsky.write_catalogue(f, None, **form)
        else:
            tsky.write_catalogue(f, ts, [f"s{j}" for j in range(5)])
        jp, ja, jm = jsky.read_catalogue(f)
        assert np.array_equal(np.asarray(jp), pl)
        assert jm["f0"] == 120e6


def test_module_update_unset_push_copy_clone():
    """update writes into the leaves' own tensors (a Parameter stays the
    object an optimizer holds), clobber_param makes them buffers;
    unset_param; push moves every tensor of the tree (the meta device
    here); copy is shallow, clone deep."""
    seq = tio.build_sequential(**_seq_dict(), **T64)
    key = "models.cal.params"
    p = seq[key]
    opt = torch.optim.Adam([p], lr=0.1)
    new = torch.zeros_like(p) + 0.5
    seq.update(bt.ParamDict({key: new}))
    assert seq[key] is p and torch.equal(p.detach(), new)
    assert opt.param_groups[0]["params"][0] is p
    jseq = jio.build_sequential(**_seq_dict())
    jseq.update(bl.ParamDict({key: jnp.asarray(_np(new))}),
                clobber_param=True)
    seq.update({key: _np(new) * 2}, clobber_param=True)
    assert key not in dict(seq.named_parameters())
    assert sorted(dict(seq.named_parameters())) == sorted(
        bl.utils.model2pdict(jseq).keys())
    assert float(seq[key].flatten()[0]) == 1.0
    seq.models.rime.array.unset_param("antvecs")
    assert sorted(dict(seq.named_parameters())) == [
        "models.rime.beam.params", "models.rime.sky.params"]
    c = seq.copy()
    assert c.models is seq.models and c is not seq
    d = seq.clone()
    assert d.models.cal.params is not seq.models.cal.params
    assert torch.equal(d.models.cal.params, seq.models.cal.params)
    out = seq().data
    assert torch.equal(d().data, out)
    seq.push("meta")
    for mod in seq.modules():
        for t in list(mod.parameters(recurse=False)) + \
                list(mod.buffers(recurse=False)):
            assert t.device.type == "meta"
        for v in mod.__dict__.values():
            if isinstance(v, torch.Tensor):
                assert v.device.type == "meta"
    assert d.models.cal.params.device.type == "cpu"
    # a value of another shape replaces the leaf, keeping its kind
    m = bt.utils.Module()
    m.register_buffer("b", torch.zeros(2))
    m.register_parameter("p", torch.nn.Parameter(torch.zeros(2)))
    m.update({"b": np.ones(5), "p": np.ones(3)})
    assert m.b.shape == (5,) and "b" in dict(m.named_buffers())
    assert isinstance(m.p, torch.nn.Parameter) and m.p.shape == (3,)


def test_module_copy_then_update_leaves_original_vs_jax():
    """copy then update of a top-level leaf changes the copy alone, in
    both packages; a submodule stays shared, so an update through it
    reaches the original in both."""
    jseq = jio.build_sequential(**_seq_dict())
    tseq = tio.build_sequential(**_seq_dict(), **T64)
    jcal, tcal = jseq.models["cal"], tseq.models.cal
    rng = np.random.default_rng(4)
    before, new = (rng.standard_normal(tuple(tcal.params.shape))
                   for _ in range(2))
    jcal.update({"params": jnp.asarray(before)})
    tcal.update({"params": before})
    jc, tc = jcal.copy(), tcal.copy()
    jc.update({"params": jnp.asarray(new)})
    tc.update({"params": new})
    for got, want in ((np.asarray(jcal.params), before),
                      (_np(tcal.params), before),
                      (np.asarray(jc.params), new), (_np(tc.params), new)):
        assert np.array_equal(got, want)
    assert isinstance(tc.params, torch.nn.Parameter)
    assert tc.params is not tcal.params
    jsc, tsc = jseq.copy(), tseq.copy()
    jsc.update({"models.cal.params": jnp.asarray(new)})
    tsc.update({"models.cal.params": new})
    assert np.array_equal(np.asarray(jseq.models["cal"].params), new)
    assert np.array_equal(_np(tseq.models.cal.params), new)


def test_logprob_start_inp_vs_jax():
    """LogProb(start_inp=): each batch's input entry feeds the chain's
    first block (here gains applied to a given VisData)."""
    ants = make_hex(2)[0]
    bls = [(a, b) for i, a in enumerate(ants) for b in ants[i + 1:]]
    rng = np.random.default_rng(9)
    shape = (1, 1, len(bls), 2, 4)
    inp = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    data = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    g = 1 + 0.1 * rng.standard_normal((1, 1, len(ants), 1, 4, 2))
    probs = []
    for pkg, conv in ((bl, jnp.asarray), (bt, torch.as_tensor)):
        vi, vt = pkg.VisData(), pkg.VisData()
        vi.setup_data(bls, TIMES, FREQS, pol="ee", data=conv(inp))
        vt.setup_data(bls, TIMES, FREQS, pol="ee", data=conv(data))
        io = jio if pkg is bl else tio
        kw = {} if pkg is bl else T64
        cal = io.build_calibration(kind="jones", params=g, ants=ants, **kw)
        seq = pkg.utils.Sequential({"cal": cal})
        LP = bl.inference.LogProb if pkg is bl else bt.LogProb
        probs.append(LP(seq, vt, start_inp=[vi]))
    _grads_vs_jax(*probs)
    assert probs[1].get_batch_inp() is not None


def test_model_description_vs_jax():
    jm = jio.build_sequential(**_seq_dict())
    tm = tio.build_sequential(**_seq_dict(), **T64)
    jt, ja = jio.get_model_description(jm)
    tt, ta = tio.get_model_description(tm)
    assert tt == jt and ta == ja


def test_every_port_module_imports_without_h5py_yaml_pyuvdata():
    """In a fresh interpreter with h5py, yaml and pyuvdata blocked
    (sys.modules entries of None make their import raise), every module
    of the port imports, and a call that needs h5py raises ImportError
    naming it."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import sys
for m in ("h5py", "yaml", "pyuvdata"):
    sys.modules[m] = None
import importlib, pkgutil
import bayeslim_tpu_torch as bt
names = [m.name for m in pkgutil.walk_packages(bt.__path__, "bayeslim_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "bayeslim_tpu")]
try:
    bt.VisData().write_hdf5("x.h5")
except ImportError as e:
    assert "h5py" in str(e), e
else:
    raise AssertionError("no ImportError")
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50
