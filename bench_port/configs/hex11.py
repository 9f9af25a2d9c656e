"""
hex11: calibration of HERA's scale (configs/hex11.json). A 331-antenna
hexagon of 15 m spacing (630 redundant groups, 54,615 cross baselines),
1024 channels over 100-200 MHz, 16 times, an nside-32 power-law pixel sky
through a 14 m Airy power beam (both fixed); the groups simulated,
expanded to every cross baseline and multiplied by per-antenna complex
gains. Antenna positions and gains (real pairs) are trained.

``inputs`` makes everything both sides take from the seed, on the device,
each value rounded to float32 (what the program holds); ``build`` makes
the program's posterior from them through its public API.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.astro import LOCATION, make_hex


def _f32(x):
    return x.to(torch.float32).to(torch.float64)


def inputs(cfg, seed, device):
    """The sky, the start and the truth (antenna positions and gains),
    all from the run's seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=torch.float64, device=device)
    pos = _f32(torch.as_tensor(make_hex(cfg["hex"], cfg["spacing_m"]),
                               device=device))
    na, nf = pos.shape[0], cfg["nfreq"]
    amp = _f32(cfg["sky_amp"] * (1 + 9 * torch.rand(12 * cfg["nside"] ** 2,
                                                    **kw)))
    pairs = lambda z: torch.stack([z.real, z.imag], -1)[None, None, :, None]
    moved = pos.clone()
    moved[:, :2] += cfg["ant_sigma_m"] * torch.randn(na, 2, **kw)
    g = 1 + cfg["gain_sigma"] * torch.complex(torch.randn(na, nf, **kw),
                                              torch.randn(na, nf, **kw))
    g = g * (g[:1].conj() / g[:1].abs())
    return dict(sky_amp=amp, generator=gen,
                truth=dict(antvecs=moved, gains=pairs(g)),
                start=dict(antvecs=pos, gains=pairs(torch.ones(
                    na, nf, dtype=torch.complex128, device=device))))


def build(bt, cfg, inp, target, device, dtype=torch.float32):
    """(LogProb, {reference leaf: program key}). target(bls) gives the
    data and inverse covariance, shaped (1, 1, len(bls), Ntimes, Nfreqs),
    in the order of the program's baselines bls. dtype: the program's
    working precision (float32 on the timed path)."""
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp
    f32 = dtype
    nside, nf = cfg["nside"], cfg["nfreq"]
    pos = inp["start"]["antvecs"].cpu().numpy()
    ants = list(range(len(pos)))
    freqs = np.linspace(cfg["fmin_hz"], cfg["fmax_hz"], nf)
    times = cfg["time0_jd"] + np.arange(cfg["ntime"]) * cfg["dtime_jd"]
    T = bt.TelescopeModel(LOCATION)
    arr = bt.ArrayModel(AntposDict(ants, pos), freqs=freqs,
                        redtol=cfg["redtol_m"], parameter=True, device=device,
                        dtype=f32)
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    params = torch.zeros((1, 1, 2, npix), dtype=f32, device=device)
    params[0, 0, 0] = inp["sky_amp"].to(f32)
    params[0, 0, 1] = cfg["sky_index"]
    R = bt.PixelSkyResponse(freqs, spatial_mode="pixel",
                            freq_mode="powerlaw", f0=float(freqs[0]),
                            device=device, dtype=f32)
    sky = bt.PixelSky(params, angs, hp.nside2pixarea(nside), R=R,
                      parameter=False, device=device, dtype=f32)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * cfg["beam_diameter_m"],
                        freqs, R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, parameter=False, device=device, dtype=f32)
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=arr.get_bls(keep_autos=False),
                   pix_chunk=cfg["pix_chunk"])
    cal = bt.JonesModel(inp["start"]["gains"].to(f32).cpu().numpy(), ants,
                        refant=ants[0], R=bt.JonesResponse(param_type="com"),
                        device=device, dtype=f32)
    seq = bt.Sequential({"rime": rime, "cal": cal})
    data, icov = target(rime.data_bls)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=data,
                   icov=icov)
    keys = {id(v): k for k, v in seq.named_parameters()}
    return bt.LogProb(seq, tgt), {"antvecs": keys[id(arr.antvecs)],
                                  "gains": keys[id(cal.params)]}
