"""
Where hera-filt's float32 gradient loses its information (ROADMAP C10):
chip_smoke.build_filt's chain at full width on the card, its gradient
in float32 against the same chain in float64 (the plain chunked path),
at several filter suppressions, as built and with one stage at a time
moved to float64. From the repository root:

    python -m bayeslim_tpu_torch.scripts.c10_stages [--cpu] [--small]

Stages (each alone; the chain is Sequential(RIME -> JonesModel ->
WedgeFilter)):

- built: the chain as chip_smoke.build_filt makes it (the filter's
  products in float64, its output in the data's float32);
- filter: the filter's input cast to complex128, so its output, the
  residual and the cotangent its backward returns stay float64 (the
  cast rounds that cotangent to complex64 for the gains);
- jones: the Jones application (models/calibration.py::_apply_cal) in
  complex128, visibilities and gains cast up before the product and the
  baselines' gain gather, the result cast back to complex64;
- rime_out: the RIME's output cube (after its sim -> data expansion)
  cast to complex128 before the gains, so the gains' product and the
  filter run in float64;
- expansion: the RIME's simulated cube cast to complex128 before its
  sim -> data expansion (and so everything after it in float64);
- all: expansion and jones together.

For each suppression s (Cn = I / s) and stage: two evaluations at the
chain's start with PyTorch's default algorithms, their gradients'
difference per leaf as a share of the leaf's max ("spread"), the first
one's difference from the float64 chain's ("err", the same share), the
loss's relative error, and the ms of each evaluation (CUDA events on
the card). The float64 chain's target is the noisy unfiltered cube in
float64 through the same filter; the float32 chains' is that target
rounded to complex64. Prints one line ``C10 {json}`` a (suppression,
stage) and the card's name and power limit. --small runs hex-3 at 64
channels (a rehearsal); --cpu runs on the CPU, where the float32 RIME
goes through the kernels' plain versions (use_kernel=True), as
precise as the kernels.

The jones and expansion stages replace calibration._apply_cal and
RIME._sim_component for their evaluations; a stage whose replacement
was not called raises, so a change to either function shows here
rather than measuring the chain as built under the stage's name. Kept
to be rerun when ROADMAP C10 is taken up.
"""
import contextlib
import json
import os
import sys
import time

SUPPRESSIONS = (1e9, 1e8, 1e7, 1e6, 1e5, 1e4, 1e3, 1e2)
STAGES = ("built", "filter", "jones", "rime_out", "expansion", "all")
# the stages measured at every suppression (all of them at the first)
EVERY = ("built", "all")
SMALL = dict(hexN=3, nside=8, nfreq=64, fmax=200e6, ntime=2,
             pix_chunk=512)
# the float64 chain's pixel chunk on the card (its fringe chunk is
# groups x channels x chunk complex128)
F64_CHUNK = 256


def main(argv):
    import numpy as np
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.models import calibration, rime as rime_mod
    cpu = "--cpu" in argv
    size = dict(SMALL) if "--small" in argv else dict(cs.HERA)
    device = "cpu" if cpu else None
    if not cpu:
        from bayeslim_tpu_torch.ops import rime_cuda
        rime_cuda.build()
        print(cs.smi(), flush=True)
    c64, c128 = torch.complex64, torch.complex128

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    t0 = time.time()
    p32, _, info = cs.build_filt(bt, device=device, dtype=torch.float32,
                                 **size)
    if cpu:
        p32.model.rime.use_kernel = True
    p64, _, _ = cs.build_filt(bt, device=device, dtype=torch.float64,
                              **dict(size, pix_chunk=min(
                                  size["pix_chunk"], F64_CHUNK)))
    start = {k: v.detach().clone() for k, v in p32.model.named_parameters()}
    bt.load_numpy_pdict(p64.model, {k: v.double().cpu().numpy()
                                    for k, v in start.items()})
    vd64 = info["unfiltered"].copy()
    vd64.data = vd64.data.to(c128)
    rime32 = p32.model.rime
    freqs = np.asarray(rime32.freqs)
    sync()
    print(f"c10 build {time.time() - t0:.1f} s: {tuple(vd64.data.shape)} "
          f"cube, {sum(v.numel() for v in start.values())} parameters",
          flush=True)

    class Cast(bt.Module):
        """The data cast to complex128."""

        def forward(self, vd, **kwargs):
            out = vd.copy()
            out.data = vd.data.to(c128)
            return out

    apply_cal = calibration._apply_cal
    sim_component = rime_mod.RIME._sim_component

    calls = {"jones": 0, "expansion": 0}

    def apply_cal64(vis, gains, *args, cast_back=True, **kwargs):
        calls["jones"] += 1
        g = gains.to(c128) if gains.is_complex() else gains.double()
        out, cov = apply_cal(vis.to(c128), g, *args, **kwargs)
        return (out.to(vis.dtype) if cast_back else out), cov

    def sim_component64(self, *args, **kwargs):
        calls["expansion"] += 1
        return sim_component(self, *args, **kwargs).to(c128)

    @contextlib.contextmanager
    def stage(name, filt):
        m = p32.model
        chain = {"rime": m.rime, "cal": m.cal, "filt": filt}
        if name == "filter":
            chain = {"rime": m.rime, "cal": m.cal, "cast": Cast(),
                     "filt": filt}
        elif name == "rime_out":
            chain = {"rime": m.rime, "cast": Cast(), "cal": m.cal,
                     "filt": filt}
        if name == "jones":
            calibration._apply_cal = apply_cal64
        elif name == "all":
            calibration._apply_cal = lambda *a, **k: apply_cal64(
                *a, cast_back=False, **k)
        if name in ("expansion", "all"):
            rime_mod.RIME._sim_component = sim_component64
        for k in calls:
            calls[k] = 0
        try:
            yield bt.Sequential(chain)
        finally:
            calibration._apply_cal = apply_cal
            rime_mod.RIME._sim_component = sim_component
        patched = {"jones": ("jones", "all"), "expansion": ("expansion", "all")}
        for k, names in patched.items():
            if name in names and not calls[k]:
                raise RuntimeError(f"stage {name}: the float64 {k} "
                                   f"replacement was never called")

    def evaluate(prob):
        if cpu:
            t1 = time.time()
            out = prob.value_and_grad()
            return out, (time.time() - t1) * 1e3
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = prob.value_and_grad()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def share(x, ref):
        x, ref = x.double().cpu(), ref.double().cpu()
        return float(torch.max(torch.abs(x - ref))
                     / torch.max(torch.abs(ref)))

    for si, s in enumerate(SUPPRESSIONS):
        t1 = time.time()
        filt = cs.filt_wedge(bt, freqs, rime32.data_bls, info["antpos"],
                             p32.model.rime.array.antvecs.device,
                             noise=1.0 / s)[0]
        with torch.no_grad():
            tgt64 = filt(vd64).data
        p64.model.models["filt"] = filt
        p64.target[0].data = tgt64
        (v64, g64), ms64 = evaluate(p64)
        print(f"c10 suppression {s:g}: filter and float64 chain "
              f"{time.time() - t1:.1f} s (the float64 evaluation "
              f"{ms64:.1f} ms); float64 gradient max " + ", ".join(
                  f"{k} {float(torch.max(torch.abs(g))):.4e}"
                  for k, g in g64.items()), flush=True)
        for name in (STAGES if si == 0 else EVERY):
            with stage(name, filt) as seq:
                tgt = p32.target[0].copy()
                tgt.data = tgt64.to(c64)
                prob = bt.LogProb(seq, tgt)
                (v0, g0), ms0 = evaluate(prob)
                (v1, g1), ms1 = evaluate(prob)
            rec = dict(suppression=s, stage=name,
                       spread={k: share(g1[k], g0[k]) for k in g0},
                       err={k: share(g0[k], g64[k]) for k in g0},
                       loss_err=abs(float(v0) - float(v64)) / abs(float(v64)),
                       loss=float(v0), loss64=float(v64), ms=[ms0, ms1])
            print("C10 " + json.dumps(rec), flush=True)
            del g0, g1
        del filt, tgt64, g64
        if not cpu:
            torch.cuda.empty_cache()
    if not cpu:
        print(cs.smi(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
