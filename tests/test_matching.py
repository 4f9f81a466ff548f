"""Descriptor matching tests: tiled matmul matcher vs brute-force, ratio
test semantics, and an end-to-end self-match."""

import jax
import jax.numpy as jnp
import numpy as np

from popsift_tpu.api import PopSift
from popsift_tpu.config import SiftConfig
from popsift_tpu.ops.matching import match_brute_small, match_descriptors


def _rand_desc(n, seed):
    r = np.random.default_rng(seed)
    d = np.abs(r.standard_normal((n, 128))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d


def test_tiled_matches_brute():
    dl = _rand_desc(97, 0)
    dr = _rand_desc(201, 1)
    vl = np.ones(97, bool)
    vl[90:] = False
    vr = np.ones(201, bool)
    vr[13] = False
    got = jax.jit(lambda a, b, c, d: match_descriptors(a, b, c, d, tile=64))(
        dl, vl, dr, vr)
    want = match_brute_small(jnp.asarray(dl), jnp.asarray(vl),
                             jnp.asarray(dr), jnp.asarray(vr))
    np.testing.assert_array_equal(np.asarray(got.best_idx)[vl],
                                  np.asarray(want.best_idx)[vl])
    np.testing.assert_allclose(np.asarray(got.best_dist)[vl],
                               np.asarray(want.best_dist)[vl], atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.second_dist)[vl],
                               np.asarray(want.second_dist)[vl], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.accept)[vl],
                                  np.asarray(want.accept)[vl])
    # invalid left rows are never accepted
    assert not np.asarray(got.accept)[~vl].any()


def test_ratio_test_semantics():
    """A planted pair with a clear margin must be accepted; an ambiguous
    one rejected (ratio 0.8 on squared L2, features.cu:223)."""
    base = _rand_desc(8, 2)
    dl = base.copy()
    dr = np.concatenate([base + 0.001, _rand_desc(32, 3)], axis=0)
    # make one left descriptor ambiguous: two equidistant rights
    # (ratio on *squared* L2 must be < 0.8 to accept, features.cu:223)
    dr[20] = dl[3] - 0.001
    got = match_descriptors(jnp.asarray(dl), jnp.ones(8, bool),
                            jnp.asarray(dr), jnp.ones(40, bool))
    acc = np.asarray(got.accept)
    bi = np.asarray(got.best_idx)
    for i in range(8):
        if i == 3:
            assert not acc[i], "ambiguous match must fail the ratio test"
        else:
            assert acc[i] and bi[i] == i


def test_extraction_self_match(small_image):
    """Matching an image against itself: every valid descriptor matches
    itself with distance ~0 (but fails ratio against its duplicate only
    if descriptors are distinctive; use accept on distinct image pair)."""
    ps = PopSift(SiftConfig(octaves=2), mode="matching")
    dev = ps.enqueue(small_image).getDev()
    res = jax.jit(lambda: dev.match(dev))()
    acc = np.asarray(res.accept)
    bd = np.asarray(res.best_dist)
    valid = np.asarray(dev.desc_valid)
    assert valid.sum() > 0
    # self-distance must be ~0
    assert bd[valid].max() < 1e-6
    rows = np.arange(len(valid))[valid]
    np.testing.assert_array_equal(np.asarray(res.best_idx)[valid], rows)


def test_shifted_image_matches(small_image):
    """A translated copy must produce many accepted ratio-test matches."""
    img2 = np.roll(small_image, (3, 5), axis=(0, 1))
    ps = PopSift(SiftConfig(octaves=2), mode="matching")
    da = ps.enqueue(small_image).getDev()
    db = ps.enqueue(img2).getDev()
    res = da.match(db)
    acc = int(np.asarray(res.accept).sum())
    n = da.getDescriptorCount()
    assert acc > 0.5 * n, f"only {acc}/{n} matches on a shifted copy"


def test_pruned_matcher_exact_when_shortlist_covers():
    """shortlist >= R makes the cascade exact: identical accept set,
    indices and distances to the exhaustive matcher."""
    from popsift_tpu.ops.matching import (match_descriptors,
                                          match_descriptors_pruned)
    rng = np.random.default_rng(4)
    L, R = 96, 80
    dl = rng.normal(size=(L, 128)).astype(np.float32)
    dr = rng.normal(size=(R, 128)).astype(np.float32)
    dl /= np.linalg.norm(dl, axis=1, keepdims=True)
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    vl = rng.random(L) < 0.9
    vr = rng.random(R) < 0.9
    want = match_descriptors(jnp.asarray(dl), jnp.asarray(vl),
                             jnp.asarray(dr), jnp.asarray(vr))
    got = match_descriptors_pruned(jnp.asarray(dl), jnp.asarray(vl),
                                   jnp.asarray(dr), jnp.asarray(vr),
                                   shortlist=R)
    np.testing.assert_array_equal(np.asarray(got.accept),
                                  np.asarray(want.accept))
    acc = np.asarray(want.accept)
    np.testing.assert_array_equal(np.asarray(got.best_idx)[acc],
                                  np.asarray(want.best_idx)[acc])
    np.testing.assert_allclose(np.asarray(got.best_dist)[acc],
                               np.asarray(want.best_dist)[acc], rtol=1e-5)


def test_pruned_matcher_recall_on_sift_like_sets():
    """Recall >= 0.99 vs exhaustive on SIFT-like descriptor clouds
    (correlated cluster structure — the regime PCA sketches exploit)."""
    from popsift_tpu.ops.matching import (match_descriptors,
                                          match_descriptors_pruned)
    rng = np.random.default_rng(9)
    L = R = 1024
    # descriptor cloud with cluster structure + matched pairs
    centers = rng.normal(size=(32, 128)).astype(np.float32)
    dl = (centers[rng.integers(0, 32, L)]
          + 0.35 * rng.normal(size=(L, 128))).astype(np.float32)
    dl = np.abs(dl)   # SIFT descriptors are non-negative
    dl /= np.linalg.norm(dl, axis=1, keepdims=True)
    perm = rng.permutation(L)
    dr = dl[perm] + 0.05 * rng.normal(size=(L, 128)).astype(np.float32)
    dr = np.abs(dr)
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    vl = np.ones(L, bool)
    vr = np.ones(R, bool)

    want = match_descriptors(jnp.asarray(dl), jnp.asarray(vl),
                             jnp.asarray(dr), jnp.asarray(vr))
    got = match_descriptors_pruned(jnp.asarray(dl), jnp.asarray(vl),
                                   jnp.asarray(dr), jnp.asarray(vr),
                                   sketch_dim=16, shortlist=64)
    wa = np.asarray(want.accept)
    ga = np.asarray(got.accept)
    agree = (np.asarray(got.best_idx)[wa] ==
             np.asarray(want.best_idx)[wa]) & ga[wa]
    recall = agree.mean()
    assert recall >= 0.99, f"recall {recall}"


def test_matcher_agrees_with_cv2_bfmatcher():
    """External validation of the matcher in isolation: on identical
    descriptor sets, the tiled matmul matcher must reproduce OpenCV's
    BFMatcher(L2) kNN best/second-best and the squared-L2 ratio-0.8
    accept rule (features.cu:223). Complements the end-to-end cv2
    pipeline gate (tests/test_cv2_parity.py)."""
    import pytest
    cv2 = pytest.importorskip("cv2")

    dl, dr = _rand_desc(150, 7), _rand_desc(220, 8)
    vl = np.ones(150, bool)
    vr = np.ones(220, bool)
    got = jax.jit(match_descriptors)(dl, vl, dr, vr)

    knn = cv2.BFMatcher(cv2.NORM_L2).knnMatch(dl, dr, k=2)
    best = np.array([m[0].trainIdx for m in knn])
    d1 = np.array([m[0].distance for m in knn], np.float64) ** 2
    d2 = np.array([m[1].distance for m in knn], np.float64) ** 2
    accept = d1 / np.maximum(d2, 1e-30) < 0.8

    np.testing.assert_array_equal(np.asarray(got.best_idx), best)
    np.testing.assert_allclose(np.asarray(got.best_dist), d1, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.accept), accept)


def test_q8_matcher_recall_vs_exact():
    """Int8-quantized matcher agrees with the exact f32 matcher on
    >= 99% of accepted matches (quantization only flips near-ties),
    and its int32 distance arithmetic is exact for the quantized
    values."""
    from popsift_tpu.ops.matching import match_descriptors_q8

    rng = np.random.default_rng(21)
    L = 512
    centers = rng.normal(size=(32, 128)).astype(np.float32)
    dl = (centers[rng.integers(0, 32, L)]
          + 0.35 * rng.normal(size=(L, 128))).astype(np.float32)
    dl = np.abs(dl)
    dl /= np.linalg.norm(dl, axis=1, keepdims=True)
    perm = rng.permutation(L)
    dr = dl[perm] + 0.05 * rng.normal(size=(L, 128)).astype(np.float32)
    dr = np.abs(dr).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    vl = np.ones(L, bool)
    vl[L - 10:] = False
    vr = np.ones(L, bool)
    exact = jax.jit(match_descriptors)(dl, vl, dr, vr)
    q8 = jax.jit(match_descriptors_q8)(dl, vl, dr, vr)

    acc_e = np.asarray(exact.accept)
    acc_q = np.asarray(q8.accept)
    assert not acc_q[~vl].any()
    same_best = (np.asarray(exact.best_idx) == np.asarray(q8.best_idx))
    agree = (same_best & acc_q)[acc_e].mean()
    assert agree >= 0.99, agree
    # dequantized distances track the exact ones
    b_e = np.asarray(exact.best_dist)[acc_e]
    b_q = np.asarray(q8.best_dist)[acc_e]
    np.testing.assert_allclose(b_q, b_e, atol=0.02)
