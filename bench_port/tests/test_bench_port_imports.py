"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by
their whole top-level name: bayeslim_tpu_torch is not bayeslim_tpu."""
import os
import subprocess
import sys

import pytest

from bench_port import run
from conftest import ROOT

HARNESS = ["bench_port.run", "bench_port.harness", "bench_port.fit",
           "bench_port.check", "bench_port.tracing", "bench_port.counting",
           "bench_port.control"]
REFERENCE = ["bench_port.reference.astro", "bench_port.reference.physics",
             "bench_port.reference.optim", "bench_port.reference.hex11",
             "bench_port.reference.alm64"]


def _loaded(mods):
    code = ("import sys; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import {m}\n" for m in mods)
            + "import bayeslim_tpu_torch\n" * ("bench_port.harness" in mods)
            + "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


def test_harness_and_program_load_no_jax():
    top = _loaded(HARNESS)
    assert not top & run.FORBIDDEN, top & run.FORBIDDEN
    assert "bayeslim_tpu_torch" in top


def test_reference_loads_nothing_of_the_program():
    top = _loaded(REFERENCE)
    assert not top & (run.FORBIDDEN | {"bayeslim_tpu_torch"})


@pytest.mark.parametrize("mods, bad", [
    (["bayeslim_tpu_torch", "bayeslim_tpu_torch.ops"], []),
    (["bayeslim_tpu", "numpy"], ["bayeslim_tpu"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
])
def test_forbidden_by_whole_top_level_name(monkeypatch, mods, bad):
    fake = {m: object() for m in mods}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.loaded_forbidden() == bad
