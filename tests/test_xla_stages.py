"""The XLA detection and orientation stages against the NumPy oracle on
awkward (non-aligned) octave shapes, across the sift modes: the 26-
neighbour candidate mask, the refinement window patches, sub-pixel
refinement, and the orientation histograms."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops.extrema import (MAX_ITERATIONS, OctaveExtrema,
                                     _candidate_mask, _first_threshold,
                                     collect_candidates, detect_extrema)
from popsift_tpu.ops.orientation import assign_orientations
from popsift_tpu.oracle import oracle_extrema, oracle_orientations
from popsift_tpu.oracle.sift_oracle import _is_extremum_26

SHAPES = [(67, 93), (64, 128), (35, 41)]
MODES = ["popsift", "vlfeat", "opencv"]


def _random_stack(H, W, D, seed, scale):
    """Smoothed noise: sparse-ish strict extrema at every scale."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(D, H, W)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (1, 2):
        base = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, base)
    return (base * scale).astype(np.float32)


def _oracle_mask(dog, cfg):
    Z = cfg.total_levels - 3
    _, H, W = dog.shape
    thr = _first_threshold(cfg)
    border = 5 if cfg.sift_mode == "opencv" else 1
    mask = np.zeros((Z, H, W), bool)
    for z in range(1, Z + 1):
        for y in range(border, H - border):
            for x in range(border, W - border):
                if abs(dog[z, y, x]) >= thr and _is_extremum_26(dog, x, y, z):
                    mask[z - 1, y, x] = True
    return mask


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hw", SHAPES)
def test_candidate_mask_matches_oracle(hw, mode):
    cfg = SiftConfig(sift_mode=mode)
    dog = _random_stack(*hw, cfg.total_levels - 1, seed=0, scale=60.0)
    got = np.asarray(jax.jit(lambda d: _candidate_mask(d, cfg))(dog))
    want = _oracle_mask(dog, cfg)
    assert want.sum() > 10
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hw", SHAPES)
def test_refinement_windows_are_edge_padded_slices(hw):
    cfg = SiftConfig()
    dog = _random_stack(*hw, cfg.total_levels - 1, seed=1, scale=60.0)
    cand = jax.jit(lambda d: collect_candidates(d, cfg, 256))(dog)
    R = MAX_ITERATIONS
    P = 2 * R + 1
    padded = np.pad(dog, ((0, 0), (R, R), (R, R)), mode="edge")
    n = int(cand.n_found)
    assert n > 10
    patches = np.asarray(cand.patches)
    for i in range(n):
        y, x = int(cand.y0[i]), int(cand.x0[i])
        assert np.array_equal(patches[i], padded[:, y:y + P, x:x + P]), i


def _sets_match(got, want, tol=1e-3):
    assert len(got) == len(want), (len(got), len(want))
    for g in got:
        d = [abs(g[0] - o[0]) + abs(g[1] - o[1]) + abs(g[2] - o[2])
             for o in want]
        assert min(d) < tol, g


@pytest.mark.parametrize("mode", ["popsift", "vlfeat"])
@pytest.mark.parametrize("hw", SHAPES)
def test_refinement_matches_oracle(hw, mode):
    cfg = SiftConfig(sift_mode=mode)
    H, W = hw
    dog = _random_stack(H, W, cfg.total_levels - 1, seed=2, scale=60.0)
    cap = 4096
    got = jax.jit(lambda d: detect_extrema(d, cfg, cap, W, H))(dog)
    assert int(got.n_candidates) < cap
    valid = np.asarray(got.valid)
    g = list(zip(np.asarray(got.x)[valid], np.asarray(got.y)[valid],
                 np.asarray(got.s)[valid]))
    want = [(e.x, e.y, e.s) for e in oracle_extrema(dog, cfg, 0)]
    assert len(want) > 3
    _sets_match(g, want)


def _angdiff(a, b):
    d = abs(a - b) % (2 * math.pi)
    return min(d, 2 * math.pi - d)


@pytest.mark.parametrize("hw", SHAPES)
def test_orientation_histograms_match_oracle(hw):
    """Keypoints anywhere in the octave, borders included: the histogram
    window is clipped to the image exactly as the oracle clips it."""
    from popsift_tpu.oracle.sift_oracle import OracleExtremum

    cfg = SiftConfig()
    H, W = hw
    L = cfg.total_levels
    blur = _random_stack(H, W, L, seed=3, scale=40.0) + 100.0
    rng = np.random.default_rng(4)
    K = 12
    xs = rng.uniform(0, W - 1, K).astype(np.float32)
    ys = rng.uniform(0, H - 1, K).astype(np.float32)
    ss = rng.uniform(0.0, 2.4, K).astype(np.float32)
    sig = (cfg.sigma * 2.0 ** (ss / cfg.levels)).astype(np.float32)
    lvl = np.round(ss).astype(np.int32)
    ext = OctaveExtrema(
        x=jnp.asarray(xs), y=jnp.asarray(ys), s=jnp.asarray(ss),
        level=jnp.asarray(lvl), sigma=jnp.asarray(sig),
        cell=jnp.zeros(K, jnp.int32), valid=jnp.ones(K, bool),
        count=jnp.int32(K), n_candidates=jnp.int32(K),
        n_dropped=jnp.int32(0))
    got = jax.jit(lambda b, e: assign_orientations(b, e, cfg))(blur, ext)
    checked = 0
    for i in range(K):
        e = OracleExtremum(octave=0, x=float(xs[i]), y=float(ys[i]),
                           s=float(ss[i]), level=int(lvl[i]),
                           sigma=float(sig[i]), cell=0)
        want = oracle_orientations(blur, e, cfg)
        n = int(got.num_ori[i])
        assert n == len(want), (i, n, len(want))
        for j in range(n):
            assert _angdiff(float(got.ori[i, j]), want[j]) < 2e-3, (i, j)
        checked += n
    assert checked >= K
