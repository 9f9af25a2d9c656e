"""
alm64: config #2's diffuse sky (configs/alm64.json) over hex11's array.
An nside-64 map of AlmModel(gen_lm(191)) modes (18,528, m >= 0) per
channel, 128 channels over 100-200 MHz, 16 times, a 14 m Airy power beam,
simulated on the 630 redundant groups, each weighted by its size. The
a_lm (real pairs) and the beam's two diameters are trained.

``inputs`` makes everything both sides take from the seed, on the device,
each value rounded to float32; ``build`` makes the program's posterior
from them through its public API (the Ylm generated by the program).
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.alm64 import gen_lm
from bench_port.reference.astro import LOCATION, make_hex


def _f32(x):
    return x.to(torch.float32).to(torch.float64)


def inputs(cfg, seed, device):
    """The start and the truth (the start is the truth, perturbed)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=torch.float64, device=device)
    l, m = (torch.as_tensor(v, device=device) for v in gen_lm(cfg["lmax"]))
    freqs = torch.linspace(cfg["fmin_hz"], cfg["fmax_hz"], cfg["nfreq"],
                           dtype=torch.float64, device=device)
    spec = (freqs / cfg["alm_f0_hz"]) ** cfg["alm_index"]
    z = torch.complex(torch.randn(len(l), **kw), torch.randn(len(l), **kw))
    a = cfg["alm_sigma0"] / (l + 1.0) * z / np.sqrt(2)
    a = torch.where(m == 0, a.real.to(a.dtype), a)
    a[0] = cfg["alm_monopole"] * np.sqrt(4 * np.pi)
    a = spec[:, None] * a[None]
    truth = _f32(torch.stack([a.real, a.imag], -1)[None, None])
    start = _f32(truth * (1 + cfg["perturb"] * torch.randn(truth.shape, **kw)))
    beam = torch.full((1, 1, 1, 1, 2), cfg["beam_diameter_m"],
                      dtype=torch.float64, device=device)
    pos = _f32(torch.as_tensor(make_hex(cfg["hex"], cfg["spacing_m"]),
                               device=device))
    return dict(pos=pos, generator=gen, truth=dict(sky=truth, beam=beam),
                start=dict(sky=start, beam=beam.clone()))


def build(bt, cfg, inp, target, device, dtype=torch.float32):
    """(LogProb, {reference leaf: program key}). target(bls) gives the
    data and inverse covariance, shaped (1, 1, len(bls), Ntimes, Nfreqs),
    in the order of the program's baselines bls. dtype: the program's
    working precision (float32 on the timed path)."""
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp
    f32 = dtype
    nside, nf = cfg["nside"], cfg["nfreq"]
    pos = inp["pos"].cpu().numpy()
    ants = list(range(len(pos)))
    freqs = np.linspace(cfg["fmin_hz"], cfg["fmax_hz"], nf)
    times = cfg["time0_jd"] + np.arange(cfg["ntime"]) * cfg["dtime_jd"]
    T = bt.TelescopeModel(LOCATION)
    arr = bt.ArrayModel(AntposDict(ants, pos), freqs=freqs,
                        redtol=cfg["redtol_m"], parameter=False,
                        device=device, dtype=f32)
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    l, m = bt.gen_lm(cfg["lmax"])
    alm = bt.AlmModel(l, m, device=device, dtype=f32)
    alm.generate_Ylm(theta, phi, method="sphere", high_prec=False)
    R = bt.PixelSkyResponse(freqs, comp_params=True, spatial_mode="alm",
                            freq_mode="channel", real_output=True,
                            spat_LM=alm, device=device, dtype=f32)
    sky = bt.PixelSky(inp["start"]["sky"].to(f32), angs,
                      hp.nside2pixarea(nside), R=R, device=device, dtype=f32)
    beam = bt.PixelBeam(inp["start"]["beam"].to(f32).cpu().numpy(), freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, device=device, dtype=f32)
    bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    rime = bt.RIME(sky, T, beam, arr, bls, times, freqs,
                   pix_chunk=cfg["pix_chunk"])
    data, icov = target(bls)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=data, icov=icov)
    keys = {id(v): k for k, v in rime.named_parameters()}
    return bt.LogProb(rime, tgt), {"sky": keys[id(sky.params)],
                                   "beam": keys[id(beam.params)]}
