"""The control (the plain reference put in the program's place in
float32 with TF32 matrix products) and the faults a training cell can
have (half of the baselines left out and the rest counted twice; steps
that leave the state unchanged), planted in the reference put in the
program's place: each must fail at least one of the cell's numbers
under the cell's limits. On the CPU at a tiny size; on the card at the
cell's own size, three seeds (as bench_port/control.py does)."""
import json
import os

import pytest
import torch

from bench_port import check, control
from conftest import CELLS, ROOT, TINY_LIMITS

KINDS = ("control", "half", "unchanged")


def _limits(workload):
    with open(os.path.join(ROOT, "bench_port", "cells",
                           workload + ".json")) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("name, traffic", CELLS)
def test_control_and_faults_fail_tiny(tiny_root, name, traffic):
    out = control.readings(tiny_root, f"tiny{name}.{traffic}", 2 ** 31 + 7,
                           torch.device("cpu"))
    for kind in KINDS:
        assert not check.verdict(out[kind]["gaps"], TINY_LIMITS), kind


@pytest.mark.cuda
@pytest.mark.parametrize("name, traffic", CELLS)
def test_control_and_faults_fail_full(cuda_device, name, traffic):
    workload = f"{name}.{traffic}"
    limits = _limits(workload)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out = control.readings(ROOT, workload, seed, cuda_device)
        for kind in KINDS:
            assert not check.verdict(out[kind]["gaps"], limits), (seed, kind)
