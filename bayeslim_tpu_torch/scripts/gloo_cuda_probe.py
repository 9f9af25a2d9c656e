"""
Which collectives does gloo run on CUDA tensors?

Ranks that share one card cannot use NCCL (it refuses two ranks on one
GPU), so they use gloo, which moves some collectives on CUDA tensors and
not others. parallel/collectives.py builds every collective from
all_gather, which this probe found gloo runs on CUDA tensors (torch
2.11 on an H100).

    python -m bayeslim_tpu_torch.scripts.gloo_cuda_probe [--ranks 2]

Spawns the ranks on cuda:0 with gloo (a file:// store under build/),
tries each collective on a float32 and a complex64 CUDA tensor and
checks the result against the same collective on the host. One line a
rank and operation, ``GLOO {json}``: the operation, the dtype, ok or the
error's first line, and the ms of one call (CUDA tensors, warm).
"""
import argparse
import json
import os
import shutil
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _ops(rank, n):
    def all_gather(x):
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x)
        return torch.stack(out)

    def all_reduce(x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    def broadcast(x):
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    def reduce_scatter(x):
        y = torch.empty_like(x[:x.shape[0] // n])
        dist.reduce_scatter(y, list(x.chunk(n)))
        return y

    def all_to_all(x):
        out = [torch.empty_like(c) for c in x.chunk(n)]
        dist.all_to_all(out, list(x.chunk(n)))
        return torch.cat(out)
    return dict(all_gather=all_gather, all_reduce=all_reduce,
                broadcast=broadcast, reduce_scatter=reduce_scatter,
                all_to_all=all_to_all)


def _rank(rank, n, store):
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=n, rank=rank)
    torch.cuda.set_device(0)
    ops = _ops(rank, n)
    for dtype in (torch.float32, torch.complex64):
        for name, op in ops.items():
            g = torch.Generator().manual_seed(rank)
            host = torch.randn(4 * n, 1024, generator=g, dtype=dtype)
            rec = dict(rank=rank, op=name, dtype=str(dtype))
            try:
                want = op(host)
                x = host.cuda()
                got = op(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                op(x)
                torch.cuda.synchronize()
                rec["ms"] = 1e3 * (time.perf_counter() - t0)
                rec["ok"] = bool(got.is_cuda and torch.equal(got.cpu(),
                                                              want))
            except Exception as e:       # the probe reports each failure
                rec["ok"] = False
                rec["error"] = str(e).splitlines()[0][:200] if str(e) \
                    else type(e).__name__
            print("GLOO " + json.dumps(rec), flush=True)
            dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    work = os.path.join(ROOT, "build", "gloo_probe")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, a.ranks,
                                             os.path.join(work, "store")))
             for r in range(a.ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
    if bad:
        print(f"gloo_cuda_probe: ranks {bad} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
