"""CPU tests of the benchmark (bench_port/), run from the repository root:

    python -m pytest bench_port/tests -q

Tests marked cuda run the cells' own sizes and skip without a card."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# hex-2 (7 antennas, 9 groups), nside 8, 8 channels; alm64 at lmax 23
TINY = dict(hex=2, nside=8, nfreq=8)
# a tiny cell's limits: at this size the port's J1 polynomial (its beam
# ~5e-8 off the exact J1 the reference takes) is a larger share of the
# loss than at full width (alm64's loss 2.3e-7 off the reference on the
# CPU, gradients 5.8e-6, the change 1.6e-6); the faults and the control
# read 1e-4 or more on at least one number
TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "step_gap": 1e-3,
               "dir_gap": 1e-3}
CELLS = (("hex11", "cal-lbfgs"), ("alm64", "adam"))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def tiny_cfg(name):
    with open(os.path.join(ROOT, "bench_port", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    if "lmax" in cfg:
        cfg["lmax"] = 3 * cfg["nside"] - 1
    return cfg


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding BENCHMARK.json and bench_port/, with a tiny
    cell 'tiny<config>.<traffic>' for each cell added by new files and a
    new workload entry alone (listed by every metric that lists the cell
    it copies)."""
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, traffic in CELLS:
        base = tmp_path / "bench_port"
        with open(base / "configs" / f"tiny{name}.json", "w") as f:
            json.dump(tiny_cfg(name), f)
        shutil.copy(base / "configs" / f"{name}.py",
                    base / "configs" / f"tiny{name}.py")
        with open(base / "cells" / f"tiny{name}.{traffic}.json", "w") as f:
            json.dump({"limits": TINY_LIMITS}, f)
        bench["workloads"].append(dict(
            name=f"tiny{name}.{traffic}", config=f"tiny{name}",
            traffic=traffic, chips=1, why="tiny"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"{name}.{traffic}" in m.get("workloads", []):
                m["workloads"].append(f"tiny{name}.{traffic}")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(tmp_path)
