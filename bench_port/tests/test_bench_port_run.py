"""Whole runs of tiny cells on the CPU (the harness's look for a chip
skipped): a cell added by files and an entry alone runs and proves
correct; the last line's shape; the faults a training cell can have,
planted in the program under the timed path, make `correct` false; and
the command exits without a result where there is no card or no
program."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from bench_port import harness, run
from conftest import CELLS, ROOT

SEED = 2 ** 31 + 11


def _run(root, workload, trace=0, seconds=0.5):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        res = harness.run_cell(root, workload, SEED, seconds, trace,
                               torch.device("cpu"), 0.0)
        rc = run.report(*res)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue().strip().splitlines()


@pytest.mark.parametrize("name, traffic", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs_correct(tiny_root, name, traffic, trace):
    line, err = _run(tiny_root, f"tiny{name}.{traffic}", trace)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = f"tiny{name}.{traffic}"
    kind = "end_to_end" if trace == 0 else "per_layer"
    listed = {m["name"] for m in bench[kind]
              if wl in m.get("workloads", [wl])}
    if trace == 0:
        assert set(line["metrics"]) == listed
    else:
        assert set(line["metrics"]) <= listed
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    checks = line["checks"]
    assert set(checks) == {"loss_gap", "grad_gap", "step_gap"} | (
        {"dir_gap"} if traffic == "cal-lbfgs" else set())
    # the last lines on standard error: each number beside its limit
    for text, (k, v) in zip(err[-len(checks):], checks.items()):
        assert text == f"{k} {v['value']!r} limit {v['limit']!r}"


def _unchanged(monkeypatch):
    """Steps that return the state unchanged: L-BFGS evaluates and does
    not move; Adam's update does nothing."""
    from bayeslim_tpu_torch.inference import bfgs
    monkeypatch.setattr(bfgs._QuasiNewtonBase, "step",
                        lambda self: self._fun(self.x)[0])
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half(monkeypatch):
    """Half of the baselines left out of the chi^2, the rest counted
    twice (the mean over the rest)."""
    from bayeslim_tpu_torch.inference import prob
    orig = prob.apply_icov

    def half(data, icov, cov_axis=None, mode="vis"):
        out = orig(data, icov, cov_axis, mode)
        keep = (torch.arange(out.shape[2], device=out.device) % 2 == 0)
        return out * (2.0 * keep.to(out.real.dtype))[:, None, None]
    monkeypatch.setattr(prob, "apply_icov", half)


@pytest.mark.parametrize("name, traffic", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half])
def test_faults_read_not_correct(tiny_root, monkeypatch, name, traffic,
                                 fault):
    fault(monkeypatch)
    line, _ = _run(tiny_root, f"tiny{name}.{traffic}")
    assert line["correct"] is False


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "bench_port",
                                                     "run.py"),
                        "--workload", "hex11.cal-lbfgs", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and bench_port/: the
    program is missing, so the run fails before any result."""
    import shutil
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "hex11.cal-lbfgs", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def _stale_pair(monkeypatch):
    """L-BFGS keeps no curvature pair: step 2 takes -H0 g."""
    from bayeslim_tpu_torch.inference import bfgs
    monkeypatch.setattr(bfgs.LBFGS, "_update_curvature",
                        lambda self, s, y, ys, t: None)


def _wrong_rho(monkeypatch):
    """L-BFGS stores 2 / y.s for each pair's rho."""
    from bayeslim_tpu_torch.inference import bfgs
    orig = bfgs.LBFGS._update_curvature

    def wrong(self, s, y, ys, t):
        orig(self, s, y, ys, t)
        self.rho_hist[-1] = 2.0 / ys
    monkeypatch.setattr(bfgs.LBFGS, "_update_curvature", wrong)


@pytest.mark.parametrize("fault", [_stale_pair, _wrong_rho])
def test_lbfgs_update_faults_read_not_correct(tiny_root, monkeypatch, fault):
    """A fault in the quasi-Newton update, which the loss and change after
    step 1 cannot see, fails the check by step 2's direction."""
    fault(monkeypatch)
    line, _ = _run(tiny_root, "tinyhex11.cal-lbfgs")
    assert line["correct"] is False
    assert line["checks"]["dir_gap"]["value"] > \
        line["checks"]["dir_gap"]["limit"]
    for k in ("loss_gap", "grad_gap", "step_gap"):
        assert line["checks"][k]["value"] <= line["checks"][k]["limit"]
