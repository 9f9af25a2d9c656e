"""
Does torch.profiler keep every kernel of a profiled function on the
card, and after what does it drop some? chip_smoke.py's profiles have
missed the first kernels of a step (hera-alm's first 17 ms GEMM) late in
its run, never early.

    python -m bayeslim_tpu_torch.scripts.profiler_probe [--age-s 60]

The profiled function launches 8 small elementwise kernels, an 8192^3
float32 GEMM, 8 small kernels and a second GEMM. Each trial profiles it
once and counts the kernels the profiler kept. Modes:

- "plain": the function alone;
- "markers": a spin kernel as the profiler starts, GAP_S of host time,
  a second spin kernel, then the function;
- "sacrifice": a ~10 ms spin kernel, then as "markers";
- "warmup": a torch.profiler schedule of one warm-up step (a spin
  kernel and small kernels), then an active step of a spin kernel and
  the function;
- "absorb": ABSORB spin kernels, then the function (chip_smoke.profile).

Trials run fresh, after the process has idled --age-s seconds, after
30,000 small kernels run unprofiled, and after each of three profiled
sessions of 30,000 small kernels. One line per trial, ``PROBE {json}``:
the trial, the mode, the process's seconds since its first trial, and
the kept and expected counts of spin, GEMM and small kernels.
"""
import argparse
import json
import subprocess
import time

import torch

GAP_S = 0.25
HEAVY = 30000
ABSORB = 64


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def work(A, B, x):
    for _ in range(8):
        x = x + 1.0
    C = A @ B
    for _ in range(8):
        x = x * 1.0001
    D = B @ A
    return C, D, x


def kept(prof):
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return dict(
        spin=sum(e.count for e in rows if "spin_kernel" in e.key),
        gemm=sum(e.count for e in rows if "gemm" in e.key.lower()),
        small=sum(e.count for e in rows if "elementwise" in e.key),
        device_ms=round(sum(e.self_device_time_total for e in rows) / 1e3,
                        3))


def profiled(mode, fn):
    """Profile fn in a mode; returns (kept counts, expected counts)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if mode == "warmup":
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.cuda._sleep(1000)
            torch.zeros(16, device="cuda").add_(1.0)
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
            prof.step()
        return kept(prof), dict(spin=1, gemm=2, small=16)
    with profile(activities=acts) as prof:
        spins = 0
        if mode == "absorb":
            for _ in range(ABSORB):
                torch.cuda._sleep(100)
            spins += ABSORB
        if mode == "sacrifice":
            torch.cuda._sleep(20_000_000)
            spins += 1
        if mode in ("markers", "sacrifice"):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(GAP_S)
            torch.cuda._sleep(1000)
            spins += 2
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return kept(prof), dict(spin=spins, gemm=2, small=16)


def heavy(profiled_session):
    x = torch.zeros(16, device="cuda")

    def run():
        for _ in range(HEAVY):
            x.add_(1.0)
        torch.cuda.synchronize()
    if profiled_session:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        prof.key_averages()
    else:
        run()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--age-s", type=float, default=60.0)
    args = ap.parse_args()
    print(smi(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn(8192, 8192, device="cuda", generator=g)
    B = torch.randn(8192, 8192, device="cuda", generator=g)
    x = torch.zeros(1 << 20, device="cuda")

    def fn():
        return work(A, B, x)
    fn()
    t_start = time.time()

    def trial(name, mode):
        got, want = profiled(mode, fn)
        print("PROBE " + json.dumps(dict(
            trial=name, mode=mode, age_s=round(time.time() - t_start, 1),
            kept=got, expected=want)), flush=True)

    modes = ("markers", "plain", "warmup", "sacrifice", "absorb")
    for mode in modes:
        trial("fresh", mode)
    time.sleep(args.age_s)
    trial(f"after {args.age_s:g} s idle", "markers")
    heavy(False)
    for mode in ("markers", "absorb"):
        trial(f"after {HEAVY} kernels unprofiled", mode)
    for i in range(3):
        heavy(True)
        for mode in modes:
            trial(f"after {i + 1} profiled sessions of {HEAVY} kernels",
                  mode)
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
