"""Small posteriors built the same way through both packages.

- build_torch: the port's counterpart of __graft_entry__._build() (hex
  array, power-law pixel sky, Airy power beam, RIME, LogProb), on the
  CPU in float64 unless told otherwise;
- build_production_torch: the port's counterpart of
  __graft_entry__._build_production() (redundant sim -> data expansion,
  a 4-pol coherency sky under a 2x2 Jones PixelResponse beam,
  Sequential(RIME -> 4-pol JonesModel with complex leaves), Nbatch time
  minibatches), line for line;
- build_cal_torch / build_cal_jax: a small hera-cal chain,
  Sequential(RIME -> JonesModel) with trainable antenna positions and
  per-antenna complex gains (real pairs, refant the first antenna), the
  redundant groups simulated and expanded to every cross baseline, icov
  ones; cal_truth and cal_target make its truth and noisy target; with
  sky_beam=True the sky and beam train and the antennas are fixed (the
  hera-hmc chain);
- build_redcal_torch / build_redcal_jax: a small hera-redcal chain,
  Sequential(RIME -> RedVisModel -> JonesModel) with the array, sky and
  beam fixed, a per-redundant-group visibility correction from
  vis2RedVisModel and per-antenna gains from vis2JonesModel (one time
  bin, real pairs, refant the first antenna, the redcal degeneracies
  projected out), each with a LogGaussPrior; redcal_truth and
  redcal_target make its truth and noisy target;
- build_alm_torch / build_alm_jax: a small hera-alm chain, config #2's
  diffuse sky (chip_smoke.build_alm: a_lm real pairs through an
  AlmModel's complex Ylm and PixelSkyResponse(spatial_mode='alm'), the
  Airy power beam, both trainable, the redundant groups of a hex array
  with icov = group counts) at hex-2, nside 8, lmax 23, 8 frequencies,
  2 times.
"""
import numpy as np
import torch

import bayeslim_tpu_torch as bt
from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex


LOC = (21.428305555, -30.72152777, 1073.0)
# the small hera-cal chain: hex-2, nside 8, 8 frequencies, 2 times
HEXN, NSIDE, NFREQ, NTIMES, FMAX, PIX_CHUNK = 2, 8, 8, 2, 120e6, 512


def _sky_params(nside):
    """Power-law sky parameters (amplitudes U(1, 10), seed 0; index
    -2.5), pixel angles [deg] and pixel area."""
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    rng = np.random.default_rng(0)
    params = np.zeros((1, 1, 2, npix))
    params[0, 0, 0] = rng.uniform(1, 10, npix)
    params[0, 0, 1] = -2.5
    return params, angs, hp.nside2pixarea(nside)


def build_torch(Ntimes=2, hexN=2, nfreq=8, nside=8, pix_chunk=512,
                device="cpu", dtype=torch.float64, use_kernel="auto",
                target=None):
    """target: data tensor of the VisData target; default the model's
    own forward, as _build() does."""
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, 120e6, nfreq)
    kw = dict(device=device, dtype=dtype)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, **kw)
    params, angs, px_area = _sky_params(NSIDE)
    R = bt.PixelSkyResponse(freqs, spatial_mode="pixel",
                            freq_mode="powerlaw", f0=float(freqs[0]), **kw)
    sky = bt.PixelSky(params, angs, px_area, R=R, **kw)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, **kw)
    bls = arr.get_bls(keep_autos=False)
    times = 2458168.3 + np.arange(Ntimes) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, bls, times, freqs,
                   pix_chunk=pix_chunk, use_kernel=use_kernel)
    if target is None:
        with torch.no_grad():
            target = rime().data
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=target)
    return bt.LogProb(rime, tgt)


def _cal_layout(arr):
    """Redundant-group representatives (sim) and every cross baseline
    (data)."""
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    return sim_bls, arr.get_bls(keep_autos=False)


def build_cal_torch(target=None, device="cpu", dtype=torch.float64,
                    sky_beam=False):
    """target: data of the VisData target (default: the chain's own
    forward at its starting parameters). sky_beam: the sky and the beam
    are trainable and the antennas fixed (the hera-hmc chain) instead of
    the reverse."""
    ants, antvecs = make_hex(HEXN, D=15.0)
    freqs = np.linspace(100e6, FMAX, NFREQ)
    kw = dict(device=device, dtype=dtype)
    T = bt.TelescopeModel(LOC)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=not sky_beam, **kw)
    params, angs, px_area = _sky_params(NSIDE)
    R = bt.PixelSkyResponse(freqs, spatial_mode="pixel",
                            freq_mode="powerlaw", f0=float(freqs[0]), **kw)
    sky = bt.PixelSky(params, angs, px_area, R=R, parameter=sky_beam, **kw)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, parameter=sky_beam, **kw)
    sim_bls, data_bls = _cal_layout(arr)
    times = 2458168.3 + np.arange(NTIMES) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=data_bls, pix_chunk=PIX_CHUNK)
    gains = np.zeros((1, 1, len(ants), 1, NFREQ, 2))
    gains[..., 0] = 1.0
    cal = bt.JonesModel(gains, ants, refant=ants[0],
                        R=bt.JonesResponse(param_type="com"), **kw)
    seq = bt.Sequential({"rime": rime, "cal": cal})
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    if target is None:
        with torch.no_grad():
            target = seq().data
    target = torch.as_tensor(target, dtype=cdt, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=target,
                   icov=torch.ones(target.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt)


def build_cal_jax(target, sky_beam=False):
    """The same chain through the JAX package (float64 under the test
    configuration), against a numpy target."""
    import jax.numpy as jnp
    import bayeslim_tpu as bl
    from bayeslim_tpu.models.calibration import JonesModel, JonesResponse
    from bayeslim_tpu.models.sky import PixelSky, PixelSkyResponse
    from bayeslim_tpu.utils import AntposDict as JAntposDict
    from bayeslim_tpu.utils import Sequential, make_hex as jmake_hex

    ants, antvecs = jmake_hex(HEXN, D=15.0)
    freqs = np.linspace(100e6, FMAX, NFREQ)
    T = bl.TelescopeModel(LOC)
    arr = bl.ArrayModel(JAntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=not sky_beam)
    params, angs, px_area = _sky_params(NSIDE)
    R = PixelSkyResponse(freqs, spatial_mode="pixel", freq_mode="powerlaw",
                         f0=float(freqs[0]))
    sky = PixelSky(jnp.asarray(params), angs, px_area, R=R,
                   parameter=sky_beam)
    beam = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bl.beam_model.AiryResponse(), pol="e",
                        powerbeam=True, fov=180.0, parameter=sky_beam)
    sim_bls, data_bls = _cal_layout(arr)
    times = 2458168.3 + np.arange(NTIMES) * 5e-4
    rime = bl.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=data_bls, pix_chunk=PIX_CHUNK)
    gains = np.zeros((1, 1, len(ants), 1, NFREQ, 2))
    gains[..., 0] = 1.0
    cal = JonesModel(jnp.asarray(gains), ants, refant=ants[0],
                     R=JonesResponse(param_type="com"))
    seq = Sequential({"rime": rime, "cal": cal})
    tgt = bl.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee",
                   data=jnp.asarray(target),
                   icov=jnp.ones(np.shape(target)))
    return bl.inference.LogProb(seq, tgt)


def cal_truth(antvecs, seed=1):
    """Truth parameters: antenna positions moved by N(0, 1 cm) in E and
    N, gains 1 + 0.05 (N + iN) as real pairs."""
    rng = np.random.default_rng(seed)
    antvecs = np.array(antvecs, dtype=np.float64)
    antvecs[:, :2] += 0.01 * rng.standard_normal((len(antvecs), 2))
    gains = np.zeros((1, 1, len(antvecs), 1, NFREQ, 2))
    gains[..., 0] = 1.0 + 0.05 * rng.standard_normal(gains.shape[:-1])
    gains[..., 1] = 0.05 * rng.standard_normal(gains.shape[:-1])
    return {"models.rime.array.antvecs": antvecs, "models.cal.params": gains}


def cal_target(prob, truth, noise=0.01, seed=2):
    """numpy target: the chain's forward at the truth parameters plus
    complex noise of the given fraction of the visibilities' rms."""
    pd = bt.ParamDict({k: torch.as_tensor(v, dtype=prob.model.models.cal
                                          .params.dtype)
                       for k, v in truth.items()})
    with torch.no_grad():
        vis = prob.model.updated(pd)().data.numpy()
    rng = np.random.default_rng(seed)
    rms = np.sqrt(np.mean(np.abs(vis) ** 2))
    return vis + noise * rms * (rng.standard_normal(vis.shape)
                                + 1j * rng.standard_normal(vis.shape))


def build_production_torch(Ntimes_per_batch=4, Nbatch=2, hexN=2, nfreq=4,
                           nside=4, fmax=120e6, device="cpu",
                           dtype=torch.float64, use_kernel="auto",
                           targets=None, pix_chunk=512, bl_axis_n=None):
    """__graft_entry__._build_production() through the port. targets:
    one data tensor per batch (default: the chain's own forward + 0.01,
    as the entry makes them). bl_axis_n: the redundant groups restricted
    to the first subset whose sim and data baseline counts both divide
    bl_axis_n (baseline shards are equal), and the Jones block's
    baseline indices pinned (set_bls), as the entry's variant does."""
    rng = np.random.default_rng(0)
    kw = dict(device=device, dtype=dtype)
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, fmax, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        **kw)
    bls = arr.get_bls(keep_autos=False)
    red_groups = [r for r in arr.reds if r[0][0] != r[0][1]]
    if bl_axis_n:
        chosen = None
        for k in range(bl_axis_n, len(red_groups) + 1):
            cand = red_groups[:k]
            gids_k = {arr.bl2red[r[0]] for r in cand}
            data_k = [b for b in bls if arr.bl2red[b] in gids_k]
            if k % bl_axis_n == 0 and len(data_k) % bl_axis_n == 0 \
                    and len(data_k) > k:
                chosen = (cand, data_k)
                break
        assert chosen is not None, \
            f"no divisible redundant subset for bl_axis_n={bl_axis_n}"
        red_groups, data_bls = chosen
        sim_bls = [r[0] for r in red_groups]
    else:
        sim_bls = [r[0] for r in red_groups]
        gids = {arr.bl2red[b] for b in sim_bls}
        data_bls = [b for b in bls if arr.bl2red[b] in gids]

    npix = hp.nside2npix(nside)
    th, ph = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([ph * 180 / np.pi, 90 - th * 180 / np.pi])

    S = np.zeros((4, 1, nfreq, npix))
    S[0, 0] = rng.uniform(1, 5, npix)
    S[1, 0] = 0.1 * S[0, 0]
    sky = bt.CoherencySky(S, angs, freqs, **kw)

    # 2x2 Jones beam (realbeam=False)
    jb = rng.normal(size=(2, 2, 1, nfreq, npix)) * 0.05 + np.tile(
        np.eye(2)[:, :, None, None, None], (1, 1, 1, nfreq, npix))
    R = bt.PixelResponse(freqs, "healpix", nside=nside, powerbeam=False,
                         realbeam=False)
    beam = bt.PixelBeam(jb, freqs, R=R, powerbeam=False, parameter=False,
                        fov=180.0, **kw)

    jd0 = 2458168.3
    tgroups = [jd0 + b * 0.01 + np.arange(Ntimes_per_batch) * 5e-4
               for b in range(Nbatch)]
    rime = bt.RIME(sky, T, beam, arr, sim_bls, tgroups, freqs,
                   data_bls=data_bls, pix_chunk=pix_chunk, time_mode="vmap",
                   use_kernel=use_kernel)

    gains = (rng.normal(size=(2, 2, len(ants), 1, nfreq)) * 0.02 +
             np.tile(np.eye(2)[:, :, None, None, None],
                     (1, 1, len(ants), 1, nfreq)))
    J = bt.JonesModel(gains + 0j, ants=list(ants),
                      R=bt.JonesResponse(param_type="com"), polmode="4pol",
                      parameter=True, **kw)
    if bl_axis_n:
        J = J.set_bls(data_bls)
    seq = bt.Sequential({"rime": rime, "cal": J})

    tgts = []
    for i in range(rime.Nbatch):
        rime.batch_idx = i
        if targets is None:
            with torch.no_grad():
                data = seq().data + 0.01
        else:
            data = torch.as_tensor(targets[i], device=device)
        tgt = bt.VisData()
        tgt.setup_meta(T, arr.to_antpos())
        tgt.setup_data(data_bls, tgroups[i], freqs, pol=None, data=data)
        tgts.append(tgt)
    rime.batch_idx = 0
    return bt.LogProb(seq, tgts)



# the small hera-redcal chain's keys, sky-model error and priors
REDVIS, RGAINS = "models.redvis.params", "models.cal.params"
REDCAL_ERR, REDCAL_GAIN_SIGMA = 0.05, 0.05


def one_time(vd):
    """The VisData's first time alone: the gains of the redcal chain are
    one bin in time, shared by every time of the data."""
    v = vd.copy()
    v.times = vd.times[:1]
    v.data = vd.data[:, :, :, :1]
    return v


def group_rms(vis, red_idx):
    """Per redundant group, the rms over times and channels of the
    first baseline of the group (numpy vis (1, 1, Nbls, Nt, Nf))."""
    red_idx = np.asarray(red_idx)
    first = np.zeros(red_idx.max() + 1, dtype=np.int64)
    first[red_idx[::-1]] = np.arange(len(red_idx))[::-1]
    return np.sqrt(np.mean(np.abs(np.asarray(vis)[0, 0, first]) ** 2,
                           axis=(-2, -1)))


def redcal_priors(pkg, rms):
    """(RedVisModel prior, gains prior): mean 0 and sigma 4 x the sky
    model's error scale (REDCAL_ERR x the group's rms) on each real part
    of the correction; mean (1, 0) and sigma 0.2 on the gain pairs."""
    sig = 4 * REDCAL_ERR * np.asarray(rms)[None, None, :, None, None, None]
    return (pkg.LogGaussPrior(0.0, sig ** 2),
            pkg.LogGaussPrior(np.array([1.0, 0.0]), 0.04))


def build_redcal_torch(target=None, device="cpu", dtype=torch.float64):
    """target: data of the VisData target (default: the chain's own
    forward at its starting parameters)."""
    ants, antvecs = make_hex(HEXN, D=15.0)
    freqs = np.linspace(100e6, FMAX, NFREQ)
    kw = dict(device=device, dtype=dtype)
    T = bt.TelescopeModel(LOC)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=False, **kw)
    params, angs, px_area = _sky_params(NSIDE)
    R = bt.PixelSkyResponse(freqs, spatial_mode="pixel",
                            freq_mode="powerlaw", f0=float(freqs[0]), **kw)
    sky = bt.PixelSky(params, angs, px_area, R=R, parameter=False, **kw)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, parameter=False, **kw)
    sim_bls, data_bls = _cal_layout(arr)
    times = 2458168.3 + np.arange(NTIMES) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=data_bls, pix_chunk=PIX_CHUNK)
    with torch.no_grad():
        vd = rime()
    redvis = bt.vis2RedVisModel(vd, redtol=0.5, **kw)
    cal = bt.vis2JonesModel(one_time(vd), refant=ants[0], **kw)
    cal.R.setup_projection(abs_amp_gain=True, phs_slope_gain=True)
    rms = group_rms(vd.data.numpy(), redvis.red_index(vd.blnums))
    pr, pg = redcal_priors(bt, rms)
    redvis.set_priors(priors_inp_params=pr)
    cal.set_priors(priors_inp_params=pg)
    seq = bt.Sequential({"rime": rime, "redvis": redvis, "cal": cal})
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    if target is None:
        with torch.no_grad():
            target = seq().data
    target = torch.as_tensor(target, dtype=cdt, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=target,
                   icov=torch.ones(target.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt)


def build_redcal_jax(target):
    """The same chain through the JAX package (float64 under the test
    configuration), against a numpy target."""
    import jax.numpy as jnp
    import bayeslim_tpu as bl
    from bayeslim_tpu.inference import prob as jprob
    from bayeslim_tpu.models.calibration import (vis2JonesModel,
                                                 vis2RedVisModel)
    from bayeslim_tpu.models.sky import PixelSky, PixelSkyResponse
    from bayeslim_tpu.utils import AntposDict as JAntposDict
    from bayeslim_tpu.utils import Sequential, make_hex as jmake_hex

    ants, antvecs = jmake_hex(HEXN, D=15.0)
    freqs = np.linspace(100e6, FMAX, NFREQ)
    T = bl.TelescopeModel(LOC)
    arr = bl.ArrayModel(JAntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=False)
    params, angs, px_area = _sky_params(NSIDE)
    R = PixelSkyResponse(freqs, spatial_mode="pixel", freq_mode="powerlaw",
                         f0=float(freqs[0]))
    sky = PixelSky(jnp.asarray(params), angs, px_area, R=R, parameter=False)
    beam = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bl.beam_model.AiryResponse(), pol="e",
                        powerbeam=True, fov=180.0, parameter=False)
    sim_bls, data_bls = _cal_layout(arr)
    times = 2458168.3 + np.arange(NTIMES) * 5e-4
    rime = bl.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=data_bls, pix_chunk=PIX_CHUNK)
    vd = rime()
    redvis = vis2RedVisModel(vd, redtol=0.5)
    cal = vis2JonesModel(one_time(vd), refant=ants[0])
    cal.R.setup_projection(abs_amp_gain=True, phs_slope_gain=True)
    rms = group_rms(np.asarray(vd.data), redvis.red_index(vd.blnums))
    pr, pg = redcal_priors(jprob, rms)
    redvis.set_priors(priors_inp_params=pr)
    cal.set_priors(priors_inp_params=pg)
    seq = Sequential({"rime": rime, "redvis": redvis, "cal": cal})
    tgt = bl.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee",
                   data=jnp.asarray(target),
                   icov=jnp.ones(np.shape(target)))
    return bl.inference.LogProb(seq, tgt)


def redcal_truth(prob, seed=0):
    """Truth of the small hera-redcal chain (numpy, real pairs): the
    sky-model error REDCAL_ERR x the group's rms x complex N(0, 1) of
    unit variance per (group, time, channel), and gains 1 +
    REDCAL_GAIN_SIGMA (N + iN) with the refant's phase zeroed."""
    seq = prob.model
    with torch.no_grad():
        vis = seq.rime().data.numpy()
    red_idx = seq.redvis.red_index(seq.rime.data_bls)
    rms = group_rms(vis, red_idx)
    rng = np.random.default_rng(seed)
    G, (Nt, Nf) = len(rms), vis.shape[-2:]
    z = (rng.standard_normal((G, Nt, Nf))
         + 1j * rng.standard_normal((G, Nt, Nf))) / np.sqrt(2)
    dv = REDCAL_ERR * rms[:, None, None] * z
    nants = seq.cal.Nants
    g = 1 + REDCAL_GAIN_SIGMA * (rng.standard_normal((nants, Nf))
                                 + 1j * rng.standard_normal((nants, Nf)))
    g = g * np.exp(-1j * np.angle(g[:1]))
    return {REDVIS: np.stack([dv.real, dv.imag], -1)[None, None],
            RGAINS: np.stack([g.real, g.imag], -1)[None, None, :, None]}


# the small hera-alm chain: hex-2, nside 8, lmax 23, 8 frequencies, 2 times
ALM_SMALL = dict(hexN=2, nside=8, lmax=23, nfreq=8, fmax=120e6, ntime=2,
                 pix_chunk=512)


def build_alm_torch(device="cpu", dtype=torch.float64):
    """chip_smoke.build_alm at ALM_SMALL: (prob, numpy truth, info)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import build_alm
    return build_alm(bt, device=device, dtype=dtype, **ALM_SMALL)


def build_alm_jax(target, start):
    """The same chain through the JAX package, its Ylm from its own fast
    path (finite at lmax 23), against the numpy target, started at the
    numpy a_lm real pairs start."""
    import jax.numpy as jnp
    import bayeslim_tpu as bl
    from bayeslim_tpu.models.sky import PixelSky, PixelSkyResponse
    from bayeslim_tpu.ops.sph_harm import AlmModel, gen_lm
    from bayeslim_tpu.utils import AntposDict as JAntposDict
    from bayeslim_tpu.utils import make_hex as jmake_hex

    k = ALM_SMALL
    ants, antvecs = jmake_hex(k["hexN"], D=15.0)
    freqs = np.linspace(100e6, k["fmax"], k["nfreq"])
    T = bl.TelescopeModel(LOC)
    arr = bl.ArrayModel(JAntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=False)
    npix = hp.nside2npix(k["nside"])
    theta, phi = hp.pix2ang(k["nside"], np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    l, m = gen_lm(k["lmax"])
    alm = AlmModel(l, m)
    alm.generate_Ylm(theta, phi, method="sphere", high_prec=False)
    R = PixelSkyResponse(freqs, comp_params=True, spatial_mode="alm",
                         freq_mode="channel", real_output=True, spat_LM=alm)
    sky = PixelSky(jnp.asarray(start), angs, hp.nside2pixarea(k["nside"]),
                   R=R)
    beam = bl.PixelBeam(jnp.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bl.beam_model.AiryResponse(), pol="e",
                        powerbeam=True, fov=180.0, parameter=True)
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    bls = [r[0] for r in reds]
    times = 2458168.3 + np.arange(k["ntime"]) * 5e-4
    rime = bl.RIME(sky, T, beam, arr, bls, times, freqs,
                   pix_chunk=k["pix_chunk"])
    counts = np.asarray([len(r) for r in reds], dtype=np.float64)
    tgt = bl.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=jnp.asarray(target),
                   icov=jnp.asarray(np.broadcast_to(
                       counts[None, None, :, None, None],
                       np.shape(target)).copy()))
    return bl.inference.LogProb(rime, tgt)
