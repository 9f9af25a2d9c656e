#!/usr/bin/env python3
"""
The readings that set a cell's upper limits: the plain reference put in
the program's place, computed in the precision below the one the
configuration states (float32 with every product's operands rounded to
TF32, the step that would tempt a later change), and the faults a
training cell can have, planted in the reference put in the program's
place (half of the baselines left out and the rest counted twice; steps
that return the state unchanged). Each is compared with the float64
reference exactly as a run's program is, at the cell's own size:

    python3 bench_port/control.py --workload hex11.cal-lbfgs --seeds 1 2 3

prints one JSON line a seed. The benchmark's runs do not run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root, workload, seed, device):
    """{'reference', 'control', 'half', 'unchanged'}: each one's readings
    and, but for the reference, its gaps from the reference."""
    import torch
    from bench_port import check, harness
    c = harness.cell(root, workload)
    inp = c.maker.inputs(c.cfg, seed, device)
    _, data = harness.make_target(c, inp, device)
    out = {}

    def run(name, dtype=torch.float64, tf32=False, at=(), **kw):
        t0 = time.time()
        ref = c.reference.Model(c.cfg, inp, device, dtype=dtype, tf32=tf32)
        ref.data = data.to(device, torch.complex128 if dtype == torch.float64
                           else torch.complex64)
        r = check.reference_readings(c.cfg, c.traffic, ref, inp["start"],
                                     weight=kw.get("weight")(ref)
                                     if "weight" in kw else None,
                                     broken=kw.get("broken"), at=at)
        out[name] = dict(readings=r, seconds=time.time() - t0)
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()

    kinds = ("control", "half", "unchanged")
    run("control", dtype=torch.float32, tf32=True)
    run("half", weight=lambda ref: 2.0 * (torch.arange(
        len(ref.bls), device=device) % 2 == 0))
    run("unchanged", broken="unchanged")
    # the float64 reference, judging each at its own point after step 1
    run("reference", at=[out[k]["readings"]["x1"] for k in kinds]
        if "x1" in out["control"]["readings"] else [])
    ref = out["reference"]["readings"]
    for i, k in enumerate(kinds):
        out[k]["gaps"] = check.gaps(
            out[k]["readings"], ref, c.traffic["compared"],
            ref_dir=ref["dir_at"][i] if ref.get("dir_at") else None)
    for k in out:
        out[k]["readings"] = check.printable(out[k]["readings"])
    out["reference"]["readings"].pop("dir_at", None)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = readings(ROOT, args.workload, seed, torch.device("cuda", 0))
        print(json.dumps(dict(workload=args.workload, seed=seed, **out)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
