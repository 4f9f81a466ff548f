"""The parts of ``chip_smoke.py`` that need no GPU: it refuses to run
without one, its result line, and the comparisons it gates on; plus the
compile-cache helper its entry points share."""

import copy
import json
import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from popsift_tpu.api import PopSift  # noqa: E402
from popsift_tpu.config import SiftConfig  # noqa: E402
from popsift_tpu.eval.golden import extraction_errors  # noqa: E402
from popsift_tpu.utils import device  # noqa: E402


def test_refuses_cpu_backend():
    with pytest.raises(AssertionError):
        chip_smoke.require_gpu("cpu")
    chip_smoke.require_gpu("gpu")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_on_cpu_fails_without_result(argv, capsys):
    with pytest.raises(AssertionError):
        chip_smoke.main(argv)
    assert '"ok"' not in capsys.readouterr().out


def test_refuses_four_with_fewer_devices():
    with pytest.raises(AssertionError):
        chip_smoke.require_devices(1, 4)
    chip_smoke.require_devices(4, 4)


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line("gpu", "x", 4))["device"][
        "count"] == 4


def test_shifted_moves_content():
    img = np.arange(30, dtype=np.uint8).reshape(5, 6)
    s = chip_smoke.shifted(img, 1, 2)
    assert s.shape == img.shape
    assert np.array_equal(s[1:, 2:], img[:-1, :-2])


def test_ratio_test_f64_matches_matcher(rng):
    from popsift_tpu.ops.matching import RATIO, match_descriptors
    a = rng.random((40, 128)).astype(np.float32)
    b = np.concatenate([a[:20] + 0.01 * rng.random((20, 128)),
                        rng.random((30, 128))]).astype(np.float32)
    va, vb = np.ones(40, bool), np.ones(50, bool)
    acc, best, _, _ = chip_smoke.ratio_test_f64(a, va, b, vb, RATIO)
    res = match_descriptors(a, va, b, vb)
    assert np.array_equal(acc, np.asarray(res.accept))
    assert np.array_equal(best[acc], np.asarray(res.best_idx)[acc])
    assert acc[:20].all()


@pytest.fixture(scope="module")
def host(small_image):
    return PopSift(SiftConfig(octaves=3)).enqueue(small_image).get()


def test_extraction_errors_accepts_identical(host):
    fails, st = extraction_errors(host, host)
    assert fails == [] and st["matched"] == 1.0 and st["desc_err"] == 0.0


def test_extraction_errors_catches_perturbed_descriptor(host):
    bad = copy.copy(host)
    bad.descriptors = host.descriptors.copy()
    bad.descriptors[0, 5] += 0.05
    fails, _ = extraction_errors(bad, host)
    assert any("descriptor" in f for f in fails)


def test_extraction_errors_catches_count_mismatch(host):
    bad = copy.copy(host)
    keep = np.arange(len(host.x)) != 0
    for k in ("x", "y", "sigma", "octave", "num_ori", "orientations",
              "ori_valid"):
        setattr(bad, k, getattr(host, k)[keep])
    rows = host.desc_to_kp != 0
    bad.descriptors = host.descriptors[rows]
    bad.desc_to_kp = host.desc_to_kp[rows] - 1
    fails, _ = extraction_errors(bad, host, count_tol=0.0)
    assert any("count" in f for f in fails)


def test_compile_cache_respects_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
