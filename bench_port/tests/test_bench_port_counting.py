"""The yardstick's counting rules at the full widths the chip_smoke.py
phases printed (rime_fwd at hera-stat's forward shape, rime_dtau at
hera-cal's, the Ylm products at hera-alm's) and the work a posterior
evaluation needs."""
import json
import os

import pytest

from bench_port import counting
from conftest import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "bench_port", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("ms, want, digits", [
    (lambda: counting.kernel_bound_ms(1024, 6144, 630, True, True), 0.2366, 4),
    (lambda: counting.dtau_bound_ms(1024, 6144, 630, True), 0.3550, 4),
    (lambda: counting.ylm_bound_ms(128, 18528, 49152), 6.959, 3),
])
def test_bounds_at_full_width(ms, want, digits):
    assert round(ms(), digits) == want


def test_groups_of_hex11():
    assert counting._groups(11) == 630
    assert counting._groups(2) == 9


@pytest.mark.parametrize("name, npix, want", [
    ("hex11", 6144, 6.342e11),   # 16 times x (forward 2 + delays 3) x 2 R K N
    ("alm64", 26624, 1.2074e12),  # the Ylm products 9.325e11, 16 times x
                                  # (forward 2 + psky cotangent 2) x 2 R K N
])
def test_eval_flops(name, npix, want):
    assert counting.eval_flops(_cfg(name), npix) == pytest.approx(want,
                                                                  rel=1e-3)


def test_roofline_names_its_bound():
    assert counting.roofline_ms(67e9, 1.0)[1] == "operations"
    assert counting.roofline_ms(1.0, 3.35e9)[1] == "bytes"
    assert counting.roofline_ms(67e9, 0.0)[0] == pytest.approx(1.0)
