#!/usr/bin/env python3
"""
Run one cell of the benchmark of bayeslim_tpu_torch on an NVIDIA GPU,
from the root of a checkout:

    python3 bench_port/run.py --workload hex11.cal-lbfgs --seed 12345 \
        --seconds 20 --trace 0

Prints the card's name and power limit first, then, as its last line,
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics; with --trace 1 its per-layer ones), device (with
--trace 1 also busy_s and window_s of the profiled steps), with --trace
1 breakdown, and last checks, each number compared beside its limit;
those numbers are also the last lines on standard error. Exits non-zero
without a result when there is no CUDA device, or when the process has
loaded JAX or the JAX package.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bench_port")
FORBIDDEN = {"jax", "jaxlib", "flax", "bayeslim_tpu"}


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches inside the checkout at fixed paths, so that only a checkout's
    # first run builds them: PyTorch's runtime-compiled kernels, and the
    # bytecode of every module imported (the installed packages'
    # directories hold none, and compiling it took ~10 s of every run)
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          os.path.join(CACHE, "torch_kernels"))
    # PyTorch does not make the directory it is given, and caches nothing
    # without it
    os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, ROOT)
    import torch
    # one process with one host thread of PyTorch's own, so that the
    # host's shared cores, not the run, decide less of its timing
    torch.set_num_threads(1)
    from bench_port import harness
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}",
          file=sys.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, prog, ref, values, limits = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, args.trace,
        torch.device("cuda", 0), T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"bench_port: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    return report(result, prog, ref, values, limits)


def report(result, prog, ref, values, limits):
    """Print the readings, then the numbers compared with their limits as
    the last lines on standard error and the result as the last line on
    standard output."""
    from bench_port import check
    print(f"program readings: {json.dumps(prog)}", file=sys.stderr)
    print(f"reference readings: {json.dumps(ref)}", file=sys.stderr)
    result["correct"] = bool(check.verdict(values, limits)
                             and result["failed"] == 0)
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in values.items()}
    for k, v in values.items():
        print(f"{k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks"]
    print(json.dumps({k: result[k] for k in order if k in result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
