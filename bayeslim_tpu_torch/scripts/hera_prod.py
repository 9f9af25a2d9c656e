"""
hera-prod: the production chain at HERA scale on the card. The code
shape of __graft_entry__._build_production (a Stokes sky emitted as a
2x2 coherency, a fixed 2x2 Jones PixelResponse beam interpolated off a
HEALPix grid, redundant sim -> data expansion, Nbatch time minibatches
whose gradients accumulate, Sequential(RIME -> 4-pol JonesModel with
complex leaves)) at full width: make_hex(11) (331 antennas, 630
redundant groups at redtol 0.5 expanded to 54,615 cross baselines),
1024 frequencies over 100-200 MHz, an nside-32 sky of 4 Stokes planes
and a beam on the same grid, 2 batches of 2 times. Adam steps the sky
and the gains.

    python -m bayeslim_tpu_torch.scripts.hera_prod [--ntime N] [--steps S]
        [--breakdown]

prints one line, ``HERA-PROD {json}``: the card, the size, the build
seconds, each step's wall and loss, the rime_fwd / rime_dtau launches
and the peak device memory. chip_smoke.py drives the same run through
``run``. --breakdown then times one batch's stages on the card (CUDA
events) and prints them as a line ``BREAKDOWN {json}`` of ms by stage.
"""
import argparse
import json
import time

import numpy as np
import torch

LOC = (21.428305555, -30.72152777, 1073.0)
GAINS = "models.cal.params"
# the full width (the entry's 4 times a batch cut to 2: the 4-pol data
# cube is 3.6 GB a batch at 2 times)
SIZE = dict(hexN=11, nside=32, nfreq=1024, fmax=200e6, ntime=2, nbatch=2,
            pix_chunk=512)


def build(bt, hexN, nside, nfreq, fmax, ntime, nbatch, pix_chunk,
          device=None, dtype=torch.float32, seed=0):
    """The chain through the port's public API, as the entry builds it
    (its numpy draws from seed 0, in its order): sky S (4, 1, Nfreqs,
    Npix) with I ~ U(1, 5) and f_Q = 0.1, trainable; the beam 1 + 0.05
    N(0, 1) about the identity, fixed; time groups 0.01 d apart of times
    5e-4 d apart. The target of batch i is the chain at the entry's
    gains (identity + 0.02 N(0, 1)) plus complex noise of unit variance
    (E|n|^2 = 1, from a seeded torch.Generator); icov None. The gains
    start at the identity. Returns (LogProb, the entry's gains)."""
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
    device = bt.resolve_device(device)
    kw = dict(device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, fmax, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        **kw)
    bls = arr.get_bls(keep_autos=False)
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    gids = {arr.bl2red[b] for b in sim_bls}
    data_bls = [b for b in bls if arr.bl2red[b] in gids]

    npix = hp.nside2npix(nside)
    th, ph = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([ph * 180 / np.pi, 90 - th * 180 / np.pi])
    S = np.zeros((4, 1, nfreq, npix))
    S[0, 0] = rng.uniform(1, 5, npix)
    S[1, 0] = 0.1 * S[0, 0]
    sky = bt.CoherencySky(S, angs, freqs, **kw)
    eye = np.eye(2)[:, :, None, None, None]
    jb = rng.normal(size=(2, 2, 1, nfreq, npix)) * 0.05 + eye
    R = bt.PixelResponse(freqs, "healpix", nside=nside, powerbeam=False,
                         realbeam=False)
    beam = bt.PixelBeam(jb, freqs, R=R, powerbeam=False, parameter=False,
                        fov=180.0, **kw)
    jd0 = 2458168.3
    tgroups = [jd0 + b * 0.01 + np.arange(ntime) * 5e-4
               for b in range(nbatch)]
    rime = bt.RIME(sky, T, beam, arr, sim_bls, tgroups, freqs,
                   data_bls=data_bls, pix_chunk=pix_chunk, time_mode="vmap")
    truth = rng.normal(size=(2, 2, len(ants), 1, nfreq)) * 0.02 + eye + 0j
    J = bt.JonesModel(np.broadcast_to(eye, truth.shape) + 0j,
                      ants=list(ants), R=bt.JonesResponse(param_type="com"),
                      polmode="4pol", parameter=True, **kw)
    seq = bt.Sequential({"rime": rime, "cal": J})
    at_truth = seq.updated(bt.ParamDict({GAINS: torch.as_tensor(
        truth, dtype=J.params.dtype, device=device)}))
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    tgts = []
    for i in range(rime.Nbatch):
        rime.batch_idx = i
        with torch.no_grad():
            data = at_truth().data
            for part in (data.real, data.imag):
                part += np.sqrt(0.5) * torch.randn(
                    data.shape, generator=gen, dtype=dtype, device=device)
        tgt = bt.VisData()
        tgt.setup_meta(T, arr.to_antpos())
        tgt.setup_data(data_bls, tgroups[i], freqs, pol=None, data=data)
        tgts.append(tgt)
    rime.batch_idx = 0
    return bt.LogProb(seq, tgts), truth


def run(bt, rime_cuda, size=SIZE, steps=3, lr=1e-3):
    """Build hera-prod on the card and take Adam steps, each over every
    batch, the launch counts set to 0 just before the first. Returns a
    dict: prob, trainer, build_s, losses, step_s, fwd / dtau launches,
    peak_gib (since the first step)."""
    t0 = time.time()
    prob, _ = build(bt, **size)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    trainer = bt.Trainer(prob, lr=lr)
    torch.cuda.reset_peak_memory_stats()
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t1 = time.time()
        loss = trainer.step()
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
        losses.append(float(loss))
    return dict(prob=prob, trainer=trainer, build_s=build_s, losses=losses,
                step_s=step_s, fwd=rime_cuda.launches,
                dtau=rime_cuda.dtau_launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _cuda_ms(fn, reps=3):
    """(ms per call by CUDA events over reps calls after one warm-up,
    the last result)."""
    out = fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, out


def _sandwich(g1, v, g2):
    """out[a, d] = sum_bc g1[a, b] v[b, c] conj(g2[d, c]) over the
    leading 2 x 2 axes, written as products of slices (the candidate to
    the einsum that _apply_cal runs; not used by the port)."""
    t = [[g1[a, 0] * v[0, c] + g1[a, 1] * v[1, c] for c in range(2)]
         for a in range(2)]
    g2c = g2.conj()
    return torch.stack([torch.stack([t[a][0] * g2c[d, 0] + t[a][1]
                                     * g2c[d, 1] for d in range(2)])
                        for a in range(2)])


def breakdown(prob):
    """Device time of one batch's stages (batch 0, CUDA events): the RIME
    forward (sky, beam, psky, rime_fwd, the sim -> data gather), the
    4-pol Jones gains applied to it, the residual and chi^2, the whole
    forward, and the forward with its backward; beside them the Jones
    product written as 2 x 2 sums of slices (_sandwich) and its relative
    difference from the einsum's. {stage: ms or value}."""
    from bayeslim_tpu_torch.inference.prob import apply_icov
    seq, tgt = prob.model, prob.get_batch_data(0)
    rime, cal = seq.models.rime, seq.models.cal
    out = {}
    with torch.no_grad():
        out["rime forward"], vd = _cuda_ms(rime)
        out["4-pol Jones apply"], vout = _cuda_ms(lambda: cal(vd))
        g = cal.get_jones()
        g1, g2 = (g.index_select(2, i)
                  for i in cal._ant_idx(vd.blnums, g.device))
        out["4-pol Jones apply as 2x2 sums of slices"], alt = _cuda_ms(
            lambda: _sandwich(g1, vd.data, g2))
        out["2x2 sums vs einsum, relative"] = float(
            (alt - vout.data).abs().max() / vout.data.abs().max())
        del alt
        out["residual and chi^2"], _ = _cuda_ms(lambda: torch.sum(
            apply_icov(vout.data - tgt.data, None)).real)
        out["batch forward"], _ = _cuda_ms(lambda: prob(idx=0))
    leaves = prob.collect_main_params()

    def fwd_bwd():
        loss = prob(idx=0)
        return torch.autograd.grad(loss, list(leaves.values()))
    out["batch forward and backward"], _ = _cuda_ms(fwd_bwd)
    return out


def main():
    import subprocess
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.ops import rime_cuda
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ntime", type=int, default=SIZE["ntime"],
                    help="times a batch")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--breakdown", action="store_true",
                    help="time one batch's stages")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hera_prod: needs a CUDA device")
    rime_cuda.build()
    size = dict(SIZE, ntime=args.ntime)
    res = run(bt, rime_cuda, size, steps=args.steps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {k: v for k, v in res.items() if k not in ("prob", "trainer")}
    print("HERA-PROD " + json.dumps({"card": card, "size": size, **out}),
          flush=True)
    if args.breakdown:
        print("BREAKDOWN " + json.dumps({"card": card,
                                         **breakdown(res["prob"])}),
              flush=True)


if __name__ == "__main__":
    main()
