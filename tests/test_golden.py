"""Golden-fixture regression gate.

The committed ``tests/golden/*.npz`` fixtures were generated by the
independent NumPy oracle (scripts/make_golden.py); the jitted pipeline
must reproduce the keypoint set within float tolerance and every
descriptor within a tight band (popsift_tpu/eval/golden.py, shared with
``chip_smoke.py``). Any semantic drift — thresholds, filters, refine
math, descriptor weights — fails here even when keypoint *counts*
happen to agree.
"""

import os

import numpy as np
import pytest

from popsift_tpu.api import PopSift
from popsift_tpu.eval.golden import flatten_host, golden_cases, golden_errors

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("case", sorted(golden_cases()))
def test_golden(case):
    path = os.path.join(GOLDEN_DIR, f"{case}.npz")
    assert os.path.exists(path), \
        "golden fixtures missing; run scripts/make_golden.py"
    want = np.load(path)
    img, cfg, _variant = golden_cases()[case]

    host = PopSift(cfg).enqueue(img).get()
    fails, _ = golden_errors(flatten_host(host), want)
    assert not fails, fails


def test_golden_errors_catch_drift():
    """The shared comparison flags a perturbed descriptor and a count
    mismatch, and passes an exact copy."""
    want = dict(np.load(os.path.join(GOLDEN_DIR, "scene64_default.npz")))
    assert golden_errors(want, want)[0] == []
    bad = dict(want, desc=want["desc"].copy())
    bad["desc"][3, 17] += 0.01
    assert any("desc" in f for f in golden_errors(bad, want)[0])
    short = {k: v[1:] if k in ("x", "y", "sigma", "num_ori") else v
             for k, v in want.items()}
    assert "count" in golden_errors(short, want)[0][0]
