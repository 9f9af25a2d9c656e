"""
Time hera-stat's Adam steps and hera-cal's function evaluations at full
width for one checkout of this repository on the card, so that two
commits can be compared in one call on one card:

    python3 bayeslim_tpu_torch/scripts/step_times.py TREE [STEPS]

TREE is the root of a checkout (this one, or an older commit unpacked
by ``git archive``); its own package and chip_smoke.py's builders
(``build_posterior``, ``build_cal``, ``HERA``) are imported. After one
warm-up each, STEPS (default 10) hera-stat steps and STEPS hera-cal
``value_and_grad`` calls are timed on the host clock, each ending in
``torch.cuda.synchronize()``. Prints one line, ``AB {json}``, with every
wall in ms and their medians. Run the trees in turns, e.g. parent,
change, change, parent, one process each.
"""
import json
import os
import sys
import time


def main(tree, steps=10):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.ops import rime_cuda
    rime_cuda.build()

    def walls(fn):
        out = []
        for _ in range(steps + 1):
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            out.append((time.time() - t0) * 1e3)
        return out[1:]
    prob, _ = cs.build_posterior(bt, stat=True, device=None,
                                 dtype=torch.float32, **cs.HERA)
    stat = walls(bt.Trainer(prob, lr=1e-3).step)
    del prob
    prob, _ = cs.build_cal(bt, device=None, dtype=torch.float32, **cs.HERA)
    cal = walls(prob.value_and_grad)
    print("AB " + json.dumps({
        "tree": tree, "card": cs.smi(), "hera_stat_step_ms": stat,
        "hera_stat_median_ms": float(np.median(stat)),
        "hera_cal_eval_ms": cal,
        "hera_cal_median_ms": float(np.median(cal))}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
