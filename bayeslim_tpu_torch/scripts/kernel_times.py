"""
Time every CUDA kernel of one checkout of this repository on the card,
so that two commits can be compared in one call on one card:

    python3 bayeslim_tpu_torch/scripts/kernel_times.py TREE

TREE is the root of a checkout (this one, or an older commit unpacked
by ``git archive``); its own package, chip_smoke.py and kernels are
imported and built. The seven spikes are timed by their ``main()`` (400
launches in one CUDA graph each), ``rime_fwd`` at hera-stat's forward
and backward shapes and ``rime_dtau`` at hera-cal's (real ps) by
chip_smoke.py's ``cuda_ms``. Prints one line, ``AB {json}``, of ms per
launch by kernel. Run the trees in turns, e.g. parent, change, change,
parent, one process each.
"""
import json
import os
import sys


def main(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    from bayeslim_tpu_torch.ops import rime_cuda
    from bayeslim_tpu_torch.scripts import mosaic_spike as spike
    rime_cuda.build()
    dev = torch.device("cuda")
    res = {k: v["ms"] for k, v in spike.main(device=dev).items()}
    rng = np.random.default_rng(0)
    f0, df, R, K, N = 100e6, 100e6 / 1023, 1024, 6144, 630
    for label, (Rr, Kk, Nn), ps_real, conj, out_imag in (
            ("rime_fwd forward", (R, K, N), True, False, True),
            ("rime_fwd backward", (R, N, K), False, True, False)):
        ps, tauT = cs.rand_case(rng, Rr, Kk, Nn, ps_real)
        ps32 = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                               else torch.complex64, device=dev)
        tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
        res[label] = cs.cuda_ms(torch, lambda: rime_cuda.rime_fwd(
            ps32, tau32, f0, df, R, conj, out_imag), 20)
    ps, tauT = cs.rand_case(rng, R, K, N, True)
    ct = rng.standard_normal((R, N)) + 1j * rng.standard_normal((R, N))
    ps32 = torch.as_tensor(ps, dtype=torch.float32, device=dev)
    tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
    ct32 = torch.as_tensor(ct, dtype=torch.complex64, device=dev)
    res["rime_dtau"] = cs.cuda_ms(torch, lambda: rime_cuda.rime_dtau(
        ct32, ps32, tau32, f0, df, R), 20)
    print("AB " + json.dumps({"tree": tree, "card": cs.smi(), **res}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
