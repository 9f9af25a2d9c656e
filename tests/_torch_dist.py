"""Ranks of torch.distributed for the CPU tests of the sharded posterior
(bayeslim_tpu_torch/parallel/), and the small posteriors they share
with the JAX package's tests/test_parallel.py.

- run_ranks(world, names, workdir, timeout) starts `world` processes by
  multiprocessing's spawn (the pytest process has JAX and its thread
  pools loaded, which fork would copy). Each rank sets torch's threads
  to 1, joins gloo through a file:// store under workdir (no TCP port,
  so concurrent test workers never collide) with a collective timeout,
  runs the cases CASES[name] in order and pickles {name: result}. The
  parent joins every rank within timeout; on a failure or a timeout it
  kills the ranks and fails with their tracebacks.
- Rank code imports only torch, numpy and the port. The JAX side of
  the builders (JaxPkg) imports JAX inside its methods, and only the
  test files call it.
- build(pkg, name) builds the posterior of a case through either
  package (TorchPkg / JaxPkg) from the same numpy inputs: point sources
  under Gaussian beams on a hex-2 array (test_rime.py's setup_*),
  chains, structured covariances, priors, minibatches.
"""
import os
import pickle
import time
import traceback

import numpy as np
import torch

LOC = (21.428305555, -30.72152777, 1073.0)
JD0 = 2458168.3
TIMEOUT = 60.0        # a collective's limit inside the ranks [s]


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, names, workdir):
    try:
        torch.set_num_threads(1)
        from bayeslim_tpu_torch.parallel import multihost
        multihost.initialize(
            init_method="file://" + os.path.join(workdir, "store"),
            world_size=world, rank=rank, backend="gloo", timeout=TIMEOUT,
            device="cpu")
        out = {}
        for name in names:
            out[name] = CASES[name]()
        with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def start_ranks(world, names, workdir):
    """Start the ranks (the handle join_ranks takes)."""
    import multiprocessing as mp
    workdir = str(workdir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, list(names),
                                                  workdir), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, workdir, time.time()


def join_ranks(run, timeout=150.0):
    """[rank 0's results, rank 1's, ...], each {case name: result};
    the ranks killed and their tracebacks raised if any fails or is
    still running timeout seconds after the start."""
    procs, workdir, t0 = run
    for p in procs:
        p.join(max(t0 + timeout - time.time(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errs = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"err{r}.txt")
        if os.path.exists(path):
            errs.append(f"--- rank {r} ---\n" + open(path).read())
        elif p.exitcode not in (0, None):
            errs.append(f"--- rank {r} exit code {p.exitcode} ---")
    if hung:
        errs.insert(0, f"ranks {hung} still running {timeout} s after the "
                    f"start: killed")
    if errs:
        raise AssertionError("\n".join(errs))
    out = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_ranks(world, names, workdir, timeout=150.0):
    return join_ranks(start_ranks(world, names, workdir), timeout)


_MESHES = {}


def mesh(**axes):
    """The mesh of these axis sizes (one a shape, so its process groups
    are made once)."""
    from bayeslim_tpu_torch.parallel import make_mesh
    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes))
    return _MESHES[key]


def np_tree(x):
    """Tensors (and ParamDicts of them) as numpy, for pickling."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "items"):
        return {k: np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(np_tree(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# the two packages' constructors
# ---------------------------------------------------------------------------

class TorchPkg:
    """The port on the CPU in float64."""
    name = "torch"

    def __init__(self):
        import bayeslim_tpu_torch as bt
        from bayeslim_tpu_torch.utils import AntposDict, make_hex
        self.bt, self.AntposDict, self.make_hex = bt, AntposDict, make_hex
        self.kw = dict(device="cpu", dtype=torch.float64)

    def arr(self, freqs):
        ants, av = self.make_hex(2, D=15.0)
        return self.bt.ArrayModel(self.AntposDict(ants, av), freqs=freqs,
                                  **self.kw)

    def telescope(self):
        return self.bt.TelescopeModel(LOC)

    def point_sky(self, params, angs, freqs):
        bt = self.bt
        return bt.PointSky(params, angs, R=bt.PointSkyResponse(
            freqs, freq_mode="powerlaw", f0=freqs[0], **self.kw), **self.kw)

    def gauss_beam(self, params, freqs, pol="e", ant2beam=None,
                   powerbeam=True):
        return self.bt.PixelBeam(params, freqs, R=self.bt.GaussResponse(),
                                 pol=pol, ant2beam=ant2beam,
                                 powerbeam=powerbeam, fov=180.0, **self.kw)

    def rime(self, sky, T, beam, arr, bls, times, freqs, **kw):
        return self.bt.RIME(sky, T, beam, arr, bls, times, freqs, **kw)

    def jones(self, g, ants):
        return self.bt.JonesModel(g, ants, R=self.bt.JonesResponse(),
                                  **self.kw)

    def redvis(self, rv, bl2red):
        return self.bt.RedVisModel(rv, bl2red, **self.kw)

    def coupling(self, X, freqs, antpos, bls):
        return self.bt.VisCoupling(X, freqs, antpos, bls, **self.kw)

    def seq(self, blocks):
        return self.bt.Sequential(blocks)

    def wedge(self, x, ls, Cn, filt2bls):
        f = self.bt.models.filt
        return f.WedgeFilter([f.GPFilter(f.sinc_cov(x, l, **self.kw),
                                         torch.as_tensor(Cn), dim=-1,
                                         residual=True, **self.kw)
                              for l in ls], filt2bls)

    def prior(self, mean, var, **kw):
        return self.bt.LogGaussPrior(mean, var, **kw)

    def asarray(self, x):
        return torch.as_tensor(np.array(x))

    def forward(self, model):
        with torch.no_grad():
            return model()

    def visdata(self):
        return self.bt.VisData()

    def logprob(self, model, tgt):
        return self.bt.LogProb(model, tgt)


class JaxPkg(TorchPkg):
    """The JAX package (float64 under the tests' configuration)."""
    name = "jax"

    def __init__(self):
        import jax.numpy as jnp
        import bayeslim_tpu as bl
        from bayeslim_tpu.utils import AntposDict, make_hex
        self.bl, self.jnp = bl, jnp
        self.AntposDict, self.make_hex = AntposDict, make_hex

    def arr(self, freqs):
        ants, av = self.make_hex(2, D=15.0)
        return self.bl.ArrayModel(self.AntposDict(ants, av), freqs=freqs)

    def telescope(self):
        return self.bl.TelescopeModel(LOC)

    def point_sky(self, params, angs, freqs):
        from bayeslim_tpu.models.sky import PointSky, PointSkyResponse
        return PointSky(self.jnp.asarray(params), self.jnp.asarray(angs),
                        R=PointSkyResponse(freqs, freq_mode="powerlaw",
                                           f0=freqs[0]))

    def gauss_beam(self, params, freqs, pol="e", ant2beam=None,
                   powerbeam=True):
        return self.bl.PixelBeam(self.jnp.asarray(params), freqs,
                                 R=self.bl.beam_model.GaussResponse(),
                                 pol=pol, ant2beam=ant2beam,
                                 powerbeam=powerbeam, fov=180.0)

    def rime(self, sky, T, beam, arr, bls, times, freqs, **kw):
        kw.pop("pix_chunk", None)
        return self.bl.RIME(sky, T, beam, arr, bls, times, freqs,
                            time_mode="vmap", **kw)

    def jones(self, g, ants):
        from bayeslim_tpu.models.calibration import (JonesModel,
                                                     JonesResponse)
        return JonesModel(self.jnp.asarray(g), ants, R=JonesResponse())

    def redvis(self, rv, bl2red):
        from bayeslim_tpu.models.calibration import RedVisModel
        return RedVisModel(self.jnp.asarray(rv), bl2red)

    def coupling(self, X, freqs, antpos, bls):
        from bayeslim_tpu.models.coupling import VisCoupling
        return VisCoupling(self.jnp.asarray(X), freqs, antpos, bls)

    def seq(self, blocks):
        from bayeslim_tpu.utils import Sequential
        return Sequential(blocks)

    def wedge(self, x, ls, Cn, filt2bls):
        from bayeslim_tpu.models import filt as f
        return f.WedgeFilter([f.GPFilter(f.sinc_cov(x, l),
                                         self.jnp.asarray(Cn), dim=-1,
                                         residual=True) for l in ls],
                             filt2bls)

    def prior(self, mean, var, **kw):
        from bayeslim_tpu.inference import LogGaussPrior
        return LogGaussPrior(self.jnp.asarray(mean), self.jnp.asarray(var),
                             **kw)

    def asarray(self, x):
        return self.jnp.asarray(np.asarray(x))

    def forward(self, model):
        return model.forward()

    def visdata(self):
        return self.bl.VisData()

    def logprob(self, model, tgt):
        return self.bl.inference.LogProb(model, tgt)


# ---------------------------------------------------------------------------
# the posteriors (tests/test_parallel.py's, case by case)
# ---------------------------------------------------------------------------

def point_sky_params(Nsource=3, Nfreqs=4, seed=0):
    """test_rime.py's setup_PointSky draws."""
    from bayeslim_tpu_torch.models.telescope import TelescopeModel
    rng = np.random.default_rng(seed)
    freqs = np.linspace(100e6, 120e6, Nfreqs)
    ra0 = TelescopeModel(LOC).JD2RA(JD0)
    angs = np.stack([ra0 + rng.uniform(-20, 20, Nsource),
                     LOC[1] + rng.uniform(-20, 20, Nsource)])
    params = np.zeros((1, 1, 2, Nsource))
    params[0, 0, 0] = rng.uniform(1, 10, Nsource)
    params[0, 0, 1] = -2.2
    return params, angs, freqs


def red_subset(arr, nmdl, bls=None):
    """(sim_bls, data_bls): the first redundant groups whose count and
    data-baseline count divide nmdl (test_parallel.py's choice)."""
    bls = arr.get_bls(keep_autos=False) if bls is None else bls
    red_groups = [r for r in arr.reds if r[0][0] != r[0][1]]
    for k in range(nmdl, len(red_groups) + 1):
        gids = {arr.bl2red[r[0]] for r in red_groups[:k]}
        data = [b for b in bls if arr.bl2red[b] in gids]
        if k % nmdl == 0 and len(data) % nmdl == 0 and len(data) > k:
            return [r[0] for r in red_groups[:k]], data
    raise AssertionError(f"no divisible redundant subset for {nmdl}")


def _target(pk, model, T, arr, bls, times, freqs, offset, pol="ee", **kw):
    vd = pk.forward(model)
    tgt = pk.visdata()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol=pol, data=vd.data + offset, **kw)
    return tgt


def build(pk, name):
    """(LogProb, ShardedLogProb kwargs) of case `name` through package
    pk; the kwargs hold the mesh's axis sizes under 'mesh'."""
    spec = dict(SPECS[name])
    ntimes = spec.pop("ntimes", 4)
    nbls = spec.pop("nbls", 6)
    offset = spec.pop("offset", 0.02)
    chain = spec.pop("chain", ())
    seed = spec.pop("seed", 0)
    params, angs, freqs = point_sky_params(3, spec.pop("nfreqs", 4), seed)
    T = pk.telescope()
    arr = pk.arr(freqs)
    sky = pk.point_sky(params, angs, freqs)
    beam_kind = spec.pop("beam", "gauss")
    bls = arr.get_bls(keep_autos=False)
    if spec.pop("autos", False):
        ants = sorted(arr.ants)
        bls = [(a1, a2) for i, a1 in enumerate(ants) for a2 in ants[i:]]
    sim_bls, data_bls = bls[:nbls], None
    red = spec.pop("red", None)
    if red == "all":
        sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
        gids = {arr.bl2red[b] for b in sim_bls}
        data_bls = [b for b in bls if arr.bl2red[b] in gids]
    elif red is not None:
        sim_bls, data_bls = red_subset(arr, red)
    if beam_kind == "nmp":
        ants = sorted(set(a for b in sim_bls for a in b))
        bp = np.stack([np.ones((1, 1, len(freqs), 2)) * 0.5,
                       np.ones((1, 1, len(freqs), 2)) * 0.8], axis=2)
        beam = pk.gauss_beam(bp, freqs, ant2beam={
            a: (0 if i < len(ants) // 2 else 1) for i, a in enumerate(ants)})
    elif beam_kind == "pol2":
        beam = pk.gauss_beam(np.ones((2, 1, 1, len(freqs), 2)) * 0.5, freqs,
                             pol=None, powerbeam=False)
    else:
        beam = pk.gauss_beam(np.ones((1, 1, 1, len(freqs), 2)) * 0.5, freqs)
    tgroups = spec.pop("tgroups", None)
    times = JD0 + np.arange(ntimes) * 5e-4 if tgroups is None else \
        [JD0 + b * 0.01 + np.arange(tgroups) * 5e-4 for b in range(2)]
    prior = spec.pop("prior", None)
    if prior == "sky":
        sky.set_priors(pk.prior(np.zeros(1), np.ones(1) * 50.0))
    elif prior == "sky_out":
        sky.set_priors(priors_out_params=pk.prior(0.0, 4.0, diag_cov=True))
    rime = pk.rime(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=data_bls)
    out_bls = sim_bls if data_bls is None else data_bls
    ants = sorted(set(a for b in out_bls for a in b))
    rng = np.random.default_rng(21 + seed)
    blocks = {"rime": rime}
    for c in chain:
        if c in ("jones", "jones_t", "jones_pin"):
            nt = ntimes if c == "jones_t" else 1
            g = (rng.normal(1, 0.05, (1, 1, len(ants), nt, len(freqs)))
                 + 1j * rng.normal(0, 0.05, (1, 1, len(ants), nt,
                                             len(freqs))))
            J = pk.jones(g, ants)
            if c == "jones_pin":
                J = J.set_bls(out_bls)
            if prior == "jones":
                J.set_priors(pk.prior(np.zeros(1), np.ones(1)))
            blocks["cal"] = J
        elif c in ("rv", "rv_pin", "rv_nested"):
            bl2red = {b: arr.bl2red[b] for b in out_bls}
            ngrp = max(bl2red.values()) + 1
            rv = (rng.normal(size=(1, 1, ngrp, 1, len(freqs)))
                  + 1j * rng.normal(size=(1, 1, ngrp, 1, len(freqs)))) * 0.1
            m = pk.redvis(rv, bl2red)
            if c == "rv_pin":
                m = m.set_bls(out_bls)
            blocks["rv"] = m if c != "rv_nested" else pk.seq({"rv": m})
        elif c == "wedge":
            x = (freqs - freqs[0]) / (freqs[-1] - freqs[0])
            half = len(out_bls) // 2
            # two filters of different widths, so that a baseline
            # filtered by the other one shows
            blocks["filt"] = pk.wedge(x, (0.5, 0.15), np.eye(len(freqs))
                                      * 1e-2, {0: out_bls[:half],
                                               1: out_bls[half:]})
        elif c == "coupling":
            X = (rng.normal(size=(7, 7, 1, len(freqs)))
                 + 1j * rng.normal(size=(7, 7, 1, len(freqs)))) * 0.01
            blocks["coupling"] = pk.coupling(X[None, None], freqs,
                                             arr.to_antpos(), out_bls)
    model = rime if len(blocks) == 1 else pk.seq(blocks)
    cov = spec.pop("cov", None)
    tgts = []
    for i in range(rime.Nbatch):
        rime.batch_idx = i
        ti = times if tgroups is None else times[i]
        kw = {}
        nt = len(ti)
        if cov == "ones":
            kw = dict(icov=pk.asarray(np.ones((1, 1, len(out_bls), nt,
                                               len(freqs)))))
        elif cov == "freq":
            A = np.random.default_rng(2).normal(size=(len(freqs),) * 2)
            icf = np.eye(len(freqs)) * 2.0 + 0.1 * (A @ A.T)
            kw = dict(cov_axis="freq", icov=pk.asarray(np.broadcast_to(
                icf, (1, 1, len(out_bls), nt, len(freqs), len(freqs)))))
        elif cov in ("time", "bl"):
            A = np.random.default_rng(5).normal(
                size=(1, 1, len(out_bls), len(freqs), nt, nt)
                if cov == "time" else (1, 1, nt, len(freqs),
                                       len(out_bls), len(out_bls)))
            n = A.shape[-1]
            kw = dict(cov_axis=cov, icov=pk.asarray(
                A @ np.swapaxes(A, -1, -2) + 2 * np.eye(n)))
        tgts.append(_target(pk, model, T, arr, out_bls, ti, freqs, offset,
                            pol=None if beam_kind == "pol2" else "ee",
                            **kw))
    rime.batch_idx = 0
    prob = pk.logprob(model, tgts if len(tgts) > 1 else tgts[0])
    if spec.pop("main", False):
        prob.set_main_params({"sky.params": np.arange(3)})
    if spec.pop("like", False):
        prob.compute = "like"
    return prob, spec


# each case: test_parallel.py's posterior; 'mesh' the axis sizes, the
# other keys ShardedLogProb's (time_axis, bl_axis, param_shardings)
SPECS = {
    "time2": dict(ntimes=8, mesh=dict(data=2)),
    "time4": dict(ntimes=8, mesh=dict(data=4)),
    "mesh2d": dict(mesh=dict(data=2, model=2), bl_axis="model"),
    "unused": dict(mesh=dict(data=2, model=2)),
    "red_time": dict(red="all", ntimes=8, offset=0.05, cov="ones",
                     mesh=dict(data=4)),
    "red_bl": dict(red=2, offset=0.05, cov="ones",
                   mesh=dict(data=2, model=2), bl_axis="model"),
    "jones_time": dict(chain=("jones",), mesh=dict(data=4)),
    "jones_pin": dict(chain=("jones_pin",), nbls=8,
                      mesh=dict(data=2, model=2), bl_axis="model"),
    "jones_auto": dict(chain=("jones",), nbls=8,
                       mesh=dict(data=2, model=2), bl_axis="model"),
    "rv_pin": dict(chain=("rv_pin",), nbls=8, mesh=dict(data=2, model=2),
                   bl_axis="model"),
    "rv_nested": dict(chain=("rv_nested",), nbls=8,
                      mesh=dict(data=2, model=2), bl_axis="model"),
    "red_jones_bl": dict(red=2, chain=("jones_pin",),
                         mesh=dict(data=2, model=2), bl_axis="model"),
    "nmp_bl": dict(beam="nmp", nbls=8, offset=0.03,
                   mesh=dict(data=2, model=2), bl_axis="model"),
    "multipol": dict(beam="pol2", mesh=dict(data=2, model=2),
                     bl_axis="model"),
    "prior": dict(prior="sky", nbls=8, mesh=dict(data=2, model=2),
                  bl_axis="model"),
    "prior_out": dict(prior="sky_out", mesh=dict(data=4)),
    "gains_t": dict(chain=("jones_t",), ntimes=8, mesh=dict(data=4),
                    param_shardings={"models.cal.params":
                                     (None, None, None, "data", None)}),
    "gains_t_prior": dict(chain=("jones_t",), prior="jones", ntimes=8,
                          mesh=dict(data=4), param_shardings={
                              "models.cal.params":
                              (None, None, None, "data", None)}),
    "batch2": dict(prior="sky", tgroups=4, offset=0.05, mesh=dict(data=4)),
    "cov_freq": dict(cov="freq", offset=0.05, mesh=dict(data=2, model=2),
                     bl_axis="model"),
    "cov_time": dict(cov="time", ntimes=3, offset=0.05,
                     mesh=dict(data=2, model=2), time_axis=None,
                     bl_axis="model"),
    "main_like": dict(ntimes=8, main=True, like=True, mesh=dict(data=4)),
    "main_post": dict(ntimes=8, main=True, mesh=dict(data=4)),
    "coupling": dict(chain=("coupling",), nbls=None, autos=True,
                     offset=0.03, mesh=dict(data=4)),
    "wedge_time": dict(chain=("jones", "wedge"), nbls=8, offset=0.03,
                       mesh=dict(data=2)),
    "wedge_bl": dict(chain=("jones", "wedge"), nbls=8, offset=0.03,
                     mesh=dict(data=2, model=2), bl_axis="model"),
    "time2": dict(ntimes=8, mesh=dict(data=2)),
    "cov_time_m2": dict(cov="time", ntimes=3, offset=0.05,
                        mesh=dict(model=2), time_axis=None,
                        bl_axis="model"),
    "cov_bl": dict(cov="bl", offset=0.05, mesh=dict(data=2, model=2)),
    "pert": dict(ntimes=4, offset=0.5, mesh=dict(data=2)),
}


# ---------------------------------------------------------------------------
# the parent's references and checks (JAX imported inside)
# ---------------------------------------------------------------------------

def jax_sharded(name, prob=None, spec=None):
    """The JAX ShardedLogProb's (loss, gradients) of case name (or of
    prob under spec) on the 8-device CPU mesh."""
    from jax.sharding import PartitionSpec as P
    from bayeslim_tpu.parallel import ShardedLogProb, make_mesh
    if prob is None:
        prob, spec = build(JaxPkg(), name)
    pd = prob.collect_main_params()
    kw = shard_kwargs(spec)
    if "param_shardings" in kw:
        kw["param_shardings"] = {k: P(*v) for k, v in
                                 kw["param_shardings"].items()}
    sp = ShardedLogProb(prob, make_mesh(spec["mesh"]), **kw)
    v, g = sp.smap_value_and_grad(pd)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def torch_single(name, prob=None):
    """The single-process port's (loss, gradients) of case name (or of
    prob)."""
    if prob is None:
        prob = build(TorchPkg(), name)[0]
    v, g = prob.value_and_grad(prob.collect_main_params())
    return float(v), np_tree(g)


def assert_close(port, ref, conj=False, rtol=1e-9, gtol=1e-8):
    """port's (loss, grads) against ref's at the JAX bars; conj: ref is
    the JAX package's, whose complex leaves' gradients are the port's
    conjugates (ROADMAP queue C1)."""
    (v, g), (vr, gr) = port, ref
    assert abs(v - vr) <= rtol * abs(vr), (v, vr)
    assert_grads_close(g, gr, conj, gtol)


def assert_grads_close(g, gr, conj=False, gtol=1e-8):
    assert sorted(g) == sorted(gr)
    for k in gr:
        a = np.conj(gr[k]) if conj else gr[k]
        scale = np.abs(a).max()
        assert np.abs(g[k] - a).max() <= gtol * scale, \
            (k, np.abs(g[k] - a).max() / scale)


def assert_same_bits(results, name):
    v0, g0 = results[0][name]
    for r in results[1:]:
        v, g = r[name]
        assert v == v0
        for k in g0:
            np.testing.assert_array_equal(g[k], g0[k])



def shard_kwargs(spec):
    kw = {k: v for k, v in spec.items() if k != "mesh"}
    return kw


def evaluate(name):
    """Rank side of a case: the ShardedLogProb's (loss, gradients) at
    the unsharded prob's main params, on this rank."""
    from bayeslim_tpu_torch.parallel import ShardedLogProb
    prob, spec = build(TorchPkg(), name)
    pd = prob.collect_main_params()
    sprob = ShardedLogProb(prob, mesh(**spec["mesh"]), **shard_kwargs(spec))
    v, g = sprob.value_and_grad(pd)
    return float(v), np_tree(g)


CASES = {name: (lambda n=name: evaluate(n)) for name in SPECS}


def build_stats(pk, kind):
    """test_parallel.py's sufficient-statistics case: noisy per-baseline
    data of the first 4 redundant groups; kind 'full' the expansion
    solve against it, 'stat' the solve against its redundant-group
    reduction (sim baselines only, icov the group weights)."""
    params, angs, freqs = point_sky_params(3, 4, 0)
    T, arr = pk.telescope(), pk.arr(freqs)
    sky = pk.point_sky(params, angs, freqs)
    beam = pk.gauss_beam(np.ones((1, 1, 1, len(freqs), 2)) * 0.5, freqs)
    bls = arr.get_bls(keep_autos=False)
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    sim_bls = [r[0] for r in reds[:4]]
    gids = {arr.bl2red[b] for b in sim_bls}
    data_bls = [b for b in bls if arr.bl2red[b] in gids]
    times = JD0 + np.arange(4) * 5e-4
    vd = pk.forward(pk.rime(sky, T, beam, arr, data_bls, times, freqs))
    vd.setup_meta(T, arr.to_antpos())
    rng = np.random.default_rng(9)
    shape = tuple(vd.data.shape)
    noise = 0.05 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    vd.setup_data(data_bls, times, freqs, pol="ee",
                  data=vd.data + pk.asarray(noise),
                  icov=pk.asarray(np.ones(shape)), cov_axis=None)
    if kind == "full":
        return pk.logprob(pk.rime(sky, T, beam, arr, sim_bls, times, freqs,
                                  data_bls=data_bls), vd)
    red, _ = vd.reduce_by_redundancy(redtol=0.5)
    return pk.logprob(pk.rime(sky, T, beam, arr, sim_bls, times, freqs),
                      red)


STATS_MESH = dict(data=2, model=2)


def eval_stats():
    from bayeslim_tpu_torch.parallel import ShardedLogProb
    prob = build_stats(TorchPkg(), "stat")
    sprob = ShardedLogProb(prob, mesh(**STATS_MESH), bl_axis="model")
    v, g = sprob.value_and_grad(prob.collect_main_params())
    return float(v), np_tree(g)


def stats_refs():
    """(JAX sharded stat solve, port single-process stat solve, port
    single-process expansion solve) of the sufficient-statistics case."""
    from bayeslim_tpu.parallel import ShardedLogProb, make_mesh
    jp = build_stats(JaxPkg(), "stat")
    sp = ShardedLogProb(jp, make_mesh(STATS_MESH), bl_axis="model")
    v, g = sp.smap_value_and_grad(jp.collect_main_params())
    out = [(float(v), {k: np.asarray(x) for k, x in g.items()})]
    for kind in ("stat", "full"):
        p = build_stats(TorchPkg(), kind)
        v, g = p.value_and_grad(p.collect_main_params())
        out.append((float(v), np_tree(g)))
    return tuple(out)


CASES["sufficient_stats"] = eval_stats


# ---------------------------------------------------------------------------
# cases beyond one evaluation
# ---------------------------------------------------------------------------

def refusals():
    """What the port refuses, and why (each message, or None if nothing
    was raised)."""
    from bayeslim_tpu_torch.parallel import ShardedLogProb
    pk, out = TorchPkg(), {}

    def expect(key, fn):
        try:
            fn()
            out[key] = None
        except AssertionError as e:
            out[key] = str(e)

    m22 = mesh(data=2, model=2)
    prob, _ = build(pk, "cov_time")
    expect("cov_time_under_time", lambda: ShardedLogProb(prob, m22))
    prob, _ = build(pk, "cov_bl")
    expect("cov_bl_under_bl",
           lambda: ShardedLogProb(prob, m22, bl_axis="model"))
    prob, _ = build(pk, "wedge_bl")
    expect("wedge_under_bl",
           lambda: ShardedLogProb(prob, m22, bl_axis="model"))
    # pinned to the baselines in the wrong order
    prob, _ = build(pk, "jones_pin")
    prob.model.models.cal.set_bls(prob.model.rime.data_bls[::-1])
    expect("set_bls_mismatch",
           lambda: ShardedLogProb(prob, m22, bl_axis="model"))
    # 3 redundant groups over 2 baseline shards
    params, angs, freqs = point_sky_params(3, 4, 0)
    arr = pk.arr(freqs)
    reds = [r for r in arr.reds if r[0][0] != r[0][1]][:3]
    gids = {arr.bl2red[r[0]] for r in reds}
    data3 = [b for b in arr.get_bls(keep_autos=False)
             if arr.bl2red[b] in gids]
    rime = pk.rime(pk.point_sky(params, angs, freqs), pk.telescope(),
                   pk.gauss_beam(np.ones((1, 1, 1, 4, 2)) * 0.5, freqs), arr,
                   [r[0] for r in reds], JD0 + np.arange(4) * 5e-4, freqs,
                   data_bls=data3)
    tgt = _target(pk, rime, pk.telescope(), arr, data3,
                  JD0 + np.arange(4) * 5e-4, freqs, 0.0)
    expect("indivisible_expansion", lambda: ShardedLogProb(
        pk.logprob(rime, tgt), m22, bl_axis="model"))
    # a block that exposes set_bls but keeps the indices on the host

    class HostIdxBlock(pk.bt.Module):
        def set_bls(self, bls):
            self._host_bls = list(np.asarray(bls).ravel())
            return self

        def forward(self, vd, prior_cache=None, **kwargs):
            return vd
    prob, _ = build(pk, "time4")
    prob.model = pk.seq({"rime": prob.model, "host": HostIdxBlock()})
    expect("host_metadata_block",
           lambda: ShardedLogProb(prob, m22, bl_axis="model"))
    # module-attached priors under param_shardings
    prob, spec = build(pk, "gains_t_prior")
    sp = ShardedLogProb(prob, mesh(**spec["mesh"]), **shard_kwargs(spec))
    expect("param_shardings_fwd_priors",
           lambda: sp.value_and_grad(prob.collect_main_params()))
    # auto-pinning leaves the caller's chain as it was
    prob, _ = build(pk, "jones_auto")
    ShardedLogProb(prob, m22, bl_axis="model")
    out["auto_pin_nondestructive"] = prob.model.models.cal._g1_idx is None
    return out


CASES["refusals"] = refusals


PRODUCTION = {"time": dict(mesh=dict(data=4)),
              "bl": dict(mesh=dict(data=2, model=2), bl_axis="model")}


def production(kind):
    """__graft_entry__.dryrun_multichip's production stages through the
    port: the redundant 4-pol Jones chain, Nbatch = 2; 'time' on
    {'data': 4} at 4 times a batch, 'bl' baseline-sharded on {'data': 2,
    'model': 2} (build_production_torch(bl_axis_n=2), 2 times a
    batch)."""
    from _torch_graft import build_production_torch
    if kind == "time":
        prob = build_production_torch(Ntimes_per_batch=4, Nbatch=2)
    else:
        prob = build_production_torch(Ntimes_per_batch=2, Nbatch=2,
                                      bl_axis_n=2)
    return prob, PRODUCTION[kind]


def eval_production(kind):
    from bayeslim_tpu_torch.parallel import ShardedLogProb
    prob, spec = production(kind)
    sprob = ShardedLogProb(prob, mesh(**spec["mesh"]), **shard_kwargs(spec))
    v, g = sprob.value_and_grad(prob.collect_main_params())
    return float(v), np_tree(g)


def pixel_prob(pk):
    """dryrun_multichip's pixel stage: a hex-2 array, 8 channels over
    100-110 MHz, an nside-8 power-law pixel sky (_torch_graft's
    draws), the Airy power beam, 10 baselines, 2 times, one padded FOV
    block (pix_chunk 4096); the sky's parameters x 1.03 for a residual.
    Returns (LogProb, pdict)."""
    from _torch_graft import _sky_params
    freqs = np.linspace(1e8, 1.1e8, 8)
    T, arr = pk.telescope(), pk.arr(freqs)
    params, angs, px_area = _sky_params(8)
    if pk.name == "torch":
        bt, kw = pk.bt, pk.kw
        sky = bt.PixelSky(params, angs, px_area, R=bt.PixelSkyResponse(
            freqs, spatial_mode="pixel", freq_mode="powerlaw", f0=1e8,
            **kw), **kw)
        beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                            R=bt.AiryResponse(), pol="e", powerbeam=True,
                            fov=180.0, **kw)
    else:
        from bayeslim_tpu.models.sky import PixelSky, PixelSkyResponse
        sky = PixelSky(pk.jnp.asarray(params), pk.jnp.asarray(angs),
                       px_area, R=PixelSkyResponse(
                           freqs, spatial_mode="pixel", freq_mode="powerlaw",
                           f0=1e8))
        beam = pk.bl.PixelBeam(pk.jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                               R=pk.bl.beam_model.AiryResponse(), pol="e",
                               powerbeam=True, fov=180.0)
    bls = arr.get_bls(keep_autos=False)[:10]
    times = JD0 + np.arange(2) * 5e-4
    rime = (pk.bt.RIME if pk.name == "torch" else pk.bl.RIME)(
        sky, T, beam, arr, bls, times, freqs, pix_chunk=4096)
    prob = pk.logprob(rime, _target(pk, rime, T, arr, bls, times, freqs,
                                    0.0))
    pd = prob.collect_main_params()
    pd["sky.params"] = pd["sky.params"] * 1.03
    return prob, pd


def eval_pixels():
    """shard_pixels over {'model': 4}: the plain LogProb of the sharded
    RIME, at the whole parameters."""
    from bayeslim_tpu_torch.parallel import shard_pixels
    pk = TorchPkg()
    prob, pd = pixel_prob(pk)
    ncut = int(prob.model._pre[(0, 0)][0]["cut"].shape[0])
    ps = pk.logprob(shard_pixels(prob.model, mesh(model=4)), prob.target)
    local = int(ps.model._pre[(0, 0)][0]["cut"].shape[0])
    v, g = ps.value_and_grad(pd)
    return float(v), np_tree(g), (ncut, local)


def pert():
    """The 'pert' posterior (a residual of 0.5 a visibility)."""
    return build(TorchPkg(), "pert")[0]


def _sharded_pert():
    """pert's ShardedLogProb over {'data': 2}."""
    from bayeslim_tpu_torch.parallel import ShardedLogProb
    return ShardedLogProb(pert(), mesh(data=2))


def opt_trainer(prob=None, steps=3):
    """3 Adam steps by a Trainer over the sharded posterior (prob: the
    single-process one instead): (losses, final parameters)."""
    import functools
    from bayeslim_tpu_torch.inference import Trainer
    target = prob if prob is not None else _sharded_pert()
    tr = Trainer(target, optimizer=functools.partial(torch.optim.Adam,
                                                     lr=1e-2),
                 verbose=False)
    tr.train(steps)
    return tr.loss_history, np_tree(tr.pdict)


def opt_lbfgs(prob=None, steps=3):
    """3 L-BFGS steps (strong Wolfe): (losses, final parameters)."""
    from bayeslim_tpu_torch.inference import LBFGS
    target = prob if prob is not None else _sharded_pert()
    opt = LBFGS(target)
    losses = [float(opt.step()) for _ in range(steps)]
    return losses, np_tree(opt.pdict)


def hmc_traj(prob=None, nstep=5, eps=1e-3):
    """One HMC trajectory from the main params with fixed momenta (a
    seeded normal draw): (end position, end momentum, dH, accepted)."""
    from bayeslim_tpu_torch.inference import HMC, Potential
    from bayeslim_tpu_torch.utils.paramdict import ParamDict
    target = prob if prob is not None else _sharded_pert()
    x0 = ParamDict({k: v.detach().clone()
                    for k, v in target.collect_main_params().items()})
    rng = np.random.default_rng(7)
    hmc = HMC(Potential(target), x0, eps=eps, Nstep=nstep, seed=0)
    hmc.p = ParamDict({k: torch.as_tensor(rng.standard_normal(v.shape))
                       for k, v in x0.items()})
    hmc.step(sample_p=False)
    q1, p1, U0, U1 = hmc.last_proposal
    return np_tree(q1), np_tree(p1), float(hmc.dHs[-1])


def hessian(prob=None):
    """compute_hessian of the sharded posterior (prob: of the single one)."""
    from bayeslim_tpu_torch.inference import compute_hessian
    target = prob if prob is not None else _sharded_pert()
    H, _ = compute_hessian(target)
    return H.numpy()


def vismapper_vd(pk):
    """test_parallel.py's imaging case: one 5 Jy channel-mode source at
    the phase centre, 8 channels over 130-150 MHz, a uniform beam, every
    cross baseline, one time; (VisData, ra grid, dec grid)."""
    freqs = np.linspace(130e6, 150e6, 8)
    T, arr = pk.telescope(), pk.arr(freqs)
    ra0 = T.JD2RA(JD0)
    angs = np.asarray([[ra0], [-30.72]])
    if pk.name == "torch":
        bt, kw = pk.bt, pk.kw
        sky = bt.PointSky(np.ones((1, 1, 8, 1)) * 5.0, angs,
                          R=bt.PointSkyResponse(freqs, freq_mode="channel",
                                                **kw), **kw)
        beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 1)), freqs,
                            R=bt.UniformResponse(), pol="e",
                            powerbeam=True, fov=180.0, **kw)
        RIME = bt.RIME
    else:
        from bayeslim_tpu.models.sky import PointSky, PointSkyResponse
        sky = PointSky(pk.jnp.ones((1, 1, 8, 1)) * 5.0, pk.jnp.asarray(angs),
                       R=PointSkyResponse(freqs, freq_mode="channel"))
        beam = pk.bl.PixelBeam(pk.jnp.ones((1, 1, 1, 1, 1)), freqs,
                               R=pk.bl.beam_model.UniformResponse(),
                               pol="e", powerbeam=True, fov=180.0)
        RIME = pk.bl.RIME
    bls = arr.get_bls(keep_autos=False)
    vd = pk.forward(RIME(sky, T, beam, arr, bls, np.asarray([JD0]), freqs))
    vd.setup_meta(T, arr.to_antpos())
    dgrid = np.linspace(-5, 5, 9)
    rr, dd = np.meshgrid(ra0 + dgrid, -30.72 + dgrid)
    return vd, rr.ravel(), dd.ravel()


def vismapper(world=None):
    """Dirty maps and P with the channels split over {'data': 2}: each
    rank images its channels, the maps gathered along the channel axis.
    world=False: the single-process maps."""
    from bayeslim_tpu_torch.models.imaging import VisMapper
    from bayeslim_tpu_torch.parallel import collectives as C
    from bayeslim_tpu_torch.parallel.multihost import local_block
    vd, ra, dec = vismapper_vd(TorchPkg())
    if world is False:
        m, P = VisMapper(vd, ra, dec, fov=180.0).make_map(return_P=True)
        return m.numpy(), P.numpy()
    mm = mesh(data=2)
    lo, hi = local_block(vd.Nfreqs, 2, mm.coord("data"))
    vdl = vd.select(freq_inds=np.arange(lo, hi), inplace=False)
    m, P = VisMapper(vdl, ra, dec, fov=180.0).make_map(return_P=True)
    g = mm.group("data")
    return (torch.cat(C.all_gather(m, g), dim=-2).numpy(),
            torch.cat(C.all_gather(P, g), dim=-2).numpy())


CASES.update({
    "prod_time": lambda: eval_production("time"),
    "prod_bl": lambda: eval_production("bl"),
    "pixels": eval_pixels,
    "trainer": opt_trainer,
    "lbfgs": opt_lbfgs,
    "hmc": hmc_traj,
    "hessian": hessian,
    "vismapper": vismapper,
})
