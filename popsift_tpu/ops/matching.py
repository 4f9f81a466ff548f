"""Brute-force descriptor matching as matmuls.

Redesign of the reference matcher (FeaturesDev::match,
/root/reference/src/popsift/features.cu:163-302): the CUDA version runs
one block per left descriptor looping over all right descriptors with
warp-shuffle L2 reductions — an O(L*R*128) scalar loop. Here the whole
distance field is a single f32 matmul,

    d2[i, j] = |l_i|^2 + |r_j|^2 - 2 l_i . r_j

tiled over the right set so the working set stays bounded, with a
running (best, second-best) reduction. Acceptance is Lowe's ratio test
on squared L2 at 0.8 (features.cu:223).

Precision policy (the one statement of it for the repo): a float32
contraction whose result is kept — a distance, a descriptor bin, a BA
normal equation — asks for ``Precision.HIGHEST``, because on a GPU the
default may run in TF32 (~3 decimal digits). Only a contraction whose
result merely shortlists candidates for an exact pass keeps the default
(the sketch prefilter in :func:`match_descriptors_pruned`). Integer
dots are exact at any setting. The global ``jax_default_matmul_precision``
is left alone.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

RATIO = 0.8  # features.cu:223


class MatchResult(NamedTuple):
    best_idx: jnp.ndarray      # i32[L] index into right set
    second_idx: jnp.ndarray    # i32[L]
    best_dist: jnp.ndarray     # f32[L] squared L2
    second_dist: jnp.ndarray   # f32[L]
    accept: jnp.ndarray        # bool[L] ratio test + validity


def match_descriptors(desc_l: jnp.ndarray, valid_l: jnp.ndarray,
                      desc_r: jnp.ndarray, valid_r: jnp.ndarray,
                      ratio: float = RATIO,
                      tile: int = 4096) -> MatchResult:
    """Mutual best/second-best search with ratio test.

    desc_l: f32[L, 128]; desc_r: f32[R, 128]; validity masks exclude
    capacity padding. Jit-compatible; R is processed in static tiles.
    """
    L = desc_l.shape[0]
    R = desc_r.shape[0]
    tile = min(tile, R)
    ntiles = -(-R // tile)
    pad = ntiles * tile - R

    dr = jnp.pad(desc_r, ((0, pad), (0, 0)))
    vr = jnp.pad(valid_r, (0, pad))
    dr = dr.reshape(ntiles, tile, 128)
    vr = vr.reshape(ntiles, tile)

    l_sq = jnp.sum(desc_l * desc_l, axis=1, keepdims=True)   # [L, 1]

    # derive the init carry from the inputs so its sharding "varying"
    # status matches the body outputs under shard_map
    never = valid_l & jnp.logical_not(valid_l)
    inf = jnp.where(never, 0.0, jnp.inf).astype(jnp.float32)
    zero_i = never.astype(jnp.int32)
    init = (inf, zero_i, inf, zero_i)

    def body(carry, xs):
        b_d, b_i, s_d, s_i = carry
        dtile, vtile, base = xs
        r_sq = jnp.sum(dtile * dtile, axis=1)                # [T]
        cross = jax.lax.dot_general(
            desc_l, dtile,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)             # [L, T]
        d2 = l_sq + r_sq[None, :] - 2.0 * cross
        d2 = jnp.where(vtile[None, :], d2, jnp.inf)

        # best + second within the tile (mask the argmin column with a
        # compare instead of an .at[].set scatter)
        t_best = jnp.min(d2, axis=1)
        t_bidx = jnp.argmin(d2, axis=1).astype(jnp.int32)
        cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        d2_wo = jnp.where(cols == t_bidx[:, None], jnp.inf, d2)
        t_sec = jnp.min(d2_wo, axis=1)
        t_sidx = jnp.argmin(d2_wo, axis=1).astype(jnp.int32)
        t_bidx = t_bidx + base
        t_sidx = t_sidx + base

        # merge four candidates into running (best, second)
        c_d = jnp.stack([b_d, s_d, t_best, t_sec], axis=1)    # [L, 4]
        c_i = jnp.stack([b_i, s_i, t_bidx, t_sidx], axis=1)
        order = jnp.argsort(c_d, axis=1)
        c_d = jnp.take_along_axis(c_d, order, axis=1)
        c_i = jnp.take_along_axis(c_i, order, axis=1)
        return (c_d[:, 0], c_i[:, 0], c_d[:, 1], c_i[:, 1]), None

    bases = jnp.arange(ntiles, dtype=jnp.int32) * tile
    (b_d, b_i, s_d, s_i), _ = jax.lax.scan(body, init, (dr, vr, bases))

    accept = (b_d / jnp.maximum(s_d, 1e-30) < np.float32(ratio)) \
        & valid_l & jnp.isfinite(b_d) & jnp.isfinite(s_d)
    return MatchResult(best_idx=b_i, second_idx=s_i,
                       best_dist=b_d, second_dist=s_d, accept=accept)


def match_brute_small(desc_l, valid_l, desc_r, valid_r, ratio=RATIO):
    """Reference-shaped O(L*R) loop for cross-checking the tiled matcher
    in tests (mirrors compute_distance, features.cu:184-226)."""
    d2 = jnp.sum((desc_l[:, None, :] - desc_r[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(valid_r[None, :], d2, jnp.inf)
    b_i = jnp.argmin(d2, axis=1).astype(jnp.int32)
    b_d = jnp.min(d2, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    d2w = jnp.where(cols == b_i[:, None], jnp.inf, d2)
    s_i = jnp.argmin(d2w, axis=1).astype(jnp.int32)
    s_d = jnp.min(d2w, axis=1)
    accept = (b_d / jnp.maximum(s_d, 1e-30) < ratio) & valid_l \
        & jnp.isfinite(b_d) & jnp.isfinite(s_d)
    return MatchResult(b_i, s_i, b_d, s_d, accept)


def match_descriptors_q8(desc_l: jnp.ndarray, valid_l: jnp.ndarray,
                         desc_r: jnp.ndarray, valid_r: jnp.ndarray,
                         ratio: float = RATIO,
                         tile: int = 4096) -> MatchResult:
    """Int8-quantized variant of :func:`match_descriptors`.

    Descriptors are scaled to [0, 127] and rounded; squared distances
    are computed EXACTLY in int32 arithmetic (|a|^2 + |b|^2 - 2ab with
    an int8 x int8 -> int32 ``dot_general``, which can use the integer
    tensor-core rate instead of the exact matcher's full-f32 HIGHEST
    matmul). The Lowe ratio test is
    scale-invariant, so acceptance semantics survive quantization up
    to rounding of near-ties (recall >= 0.99 vs exact on SIFT
    descriptors, tests/test_matching.py). Distances are returned
    dequantized. (replaces compute_distance, features.cu:184-226,
    at SfM matching scale)
    """
    L = desc_l.shape[0]
    R = desc_r.shape[0]
    tile = min(tile, R)
    ntiles = -(-R // tile)
    pad = ntiles * tile - R

    scale = jnp.maximum(
        jnp.max(jnp.where(valid_l[:, None], desc_l, 0.0)),
        jnp.max(jnp.where(valid_r[:, None], desc_r, 0.0)))
    scale = jnp.maximum(scale, 1e-12)
    ql = jnp.clip(jnp.round(desc_l / scale * 127.0), 0, 127) \
        .astype(jnp.int8)
    qr = jnp.clip(jnp.round(desc_r / scale * 127.0), 0, 127) \
        .astype(jnp.int8)

    qr = jnp.pad(qr, ((0, pad), (0, 0)))
    vr = jnp.pad(valid_r, (0, pad))
    qr = qr.reshape(ntiles, tile, 128)
    vr = vr.reshape(ntiles, tile)

    ql32 = ql.astype(jnp.int32)
    l_sq = jnp.sum(ql32 * ql32, axis=1, keepdims=True)       # [L, 1]
    BIG = jnp.int32(2 ** 31 - 1)

    never = valid_l & jnp.logical_not(valid_l)
    big = jnp.where(never, 0, BIG).astype(jnp.int32)
    zero_i = never.astype(jnp.int32)
    init = (big, zero_i, big, zero_i)

    def body(carry, xs):
        b_d, b_i, s_d, s_i = carry
        qtile, vtile, base = xs
        q32 = qtile.astype(jnp.int32)
        r_sq = jnp.sum(q32 * q32, axis=1)                    # [T]
        cross = jax.lax.dot_general(
            ql, qtile,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32)                # [L, T]
        d2 = l_sq + r_sq[None, :] - 2 * cross
        d2 = jnp.where(vtile[None, :], d2, BIG)

        t_best = jnp.min(d2, axis=1)
        t_bidx = jnp.argmin(d2, axis=1).astype(jnp.int32)
        cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        d2_wo = jnp.where(cols == t_bidx[:, None], BIG, d2)
        t_sec = jnp.min(d2_wo, axis=1)
        t_sidx = jnp.argmin(d2_wo, axis=1).astype(jnp.int32)
        t_bidx = t_bidx + base
        t_sidx = t_sidx + base

        c_d = jnp.stack([b_d, s_d, t_best, t_sec], axis=1)
        c_i = jnp.stack([b_i, s_i, t_bidx, t_sidx], axis=1)
        order = jnp.argsort(c_d, axis=1)
        c_d = jnp.take_along_axis(c_d, order, axis=1)
        c_i = jnp.take_along_axis(c_i, order, axis=1)
        return (c_d[:, 0], c_i[:, 0], c_d[:, 1], c_i[:, 1]), None

    bases = jnp.arange(ntiles, dtype=jnp.int32) * tile
    (b_d, b_i, s_d, s_i), _ = jax.lax.scan(body, init, (qr, vr, bases))

    ok = (b_d < BIG) & (s_d < BIG)
    accept = (b_d.astype(jnp.float32)
              / jnp.maximum(s_d.astype(jnp.float32), 1.0)
              < np.float32(ratio)) & valid_l & ok
    deq = (scale / 127.0) ** 2
    return MatchResult(best_idx=b_i, second_idx=s_i,
                       best_dist=b_d.astype(jnp.float32) * deq,
                       second_dist=s_d.astype(jnp.float32) * deq,
                       accept=accept)


# ---------------------------------------------------------------------------
# Cascade-style pruned matching (SfM-scale; SURVEY section 7 L4 option)
# ---------------------------------------------------------------------------

def sketch_basis(desc: jnp.ndarray, valid: jnp.ndarray, dim: int = 16):
    """PCA sketch basis for descriptor pruning.

    Returns (P f32[128, dim] orthonormal top-eigenvector basis,
    mu f32[128] mean). Computed on device from the (masked) descriptor
    set: one 128x128 covariance matmul + eigh — negligible next to the
    distance matrix it will shrink. Orthonormal projection makes the
    sketch distance a LOWER bound of the true squared L2.
    """
    w = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(desc * w[:, None], axis=0) / n
    X = (desc - mu) * w[:, None]
    cov = jax.lax.dot_general(
        X, X, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)                 # [128, 128]
    _, vecs = jnp.linalg.eigh(cov)                           # ascending
    return vecs[:, -dim:], mu


def match_descriptors_pruned(desc_l: jnp.ndarray, valid_l: jnp.ndarray,
                             desc_r: jnp.ndarray, valid_r: jnp.ndarray,
                             ratio: float = RATIO, sketch_dim: int = 16,
                             shortlist: int = 64) -> MatchResult:
    """Two-stage matcher: a ``sketch_dim``-d PCA sketch prefilter (one
    matmul) shortlists ``shortlist`` candidates per left descriptor; the
    exact 128-d squared-L2 top-2 + ratio test then runs only on the
    shortlist. The structural answer to O(N^2) SfM matching the
    reference's brute force (features.cu:197-219) cannot scale to —
    a cascade-hash-style cascade built from matmuls instead of hash
    tables (no buckets, no scatter).

    Exact when ``shortlist >= R``; otherwise approximate with measured
    recall >= 0.99 vs exhaustive on SIFT descriptors (the sketch
    distance lower-bounds the true distance, so near neighbors are
    rarely pruned). Jit-compatible.
    """
    R = desc_r.shape[0]
    C = min(shortlist, R)

    P, mu = sketch_basis(desc_r, valid_r, sketch_dim)
    sl = (desc_l - mu) @ P                                   # [L, S]
    sr = (desc_r - mu) @ P                                   # [R, S]
    ssl = jnp.sum(sl * sl, axis=1)
    ssr = jnp.sum(sr * sr, axis=1)
    # default precision on purpose: the sketch only shortlists, and the
    # exact f32 pass below decides (precision policy, module docstring)
    cross = jax.lax.dot_general(
        sl, sr, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)                  # [L, R]
    s2 = ssl[:, None] + ssr[None, :] - 2.0 * cross
    s2 = jnp.where(valid_r[None, :], s2, jnp.inf)
    _, cand = jax.lax.top_k(-s2, C)                          # [L, C]
    cand = cand.astype(jnp.int32)

    dr = desc_r[cand]                                        # [L, C, 128]
    vr = valid_r[cand]
    diff = desc_l[:, None, :] - dr
    d2 = jnp.sum(diff * diff, axis=-1)                       # exact f32
    d2 = jnp.where(vr, d2, jnp.inf)

    b_c = jnp.argmin(d2, axis=1).astype(jnp.int32)
    b_d = jnp.min(d2, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    d2w = jnp.where(cols == b_c[:, None], jnp.inf, d2)
    s_c = jnp.argmin(d2w, axis=1).astype(jnp.int32)
    s_d = jnp.min(d2w, axis=1)

    b_i = jnp.take_along_axis(cand, b_c[:, None], axis=1)[:, 0]
    s_i = jnp.take_along_axis(cand, s_c[:, None], axis=1)[:, 0]
    accept = (b_d / jnp.maximum(s_d, 1e-30) < np.float32(ratio)) \
        & valid_l & jnp.isfinite(b_d) & jnp.isfinite(s_d)
    return MatchResult(best_idx=b_i, second_idx=s_i,
                       best_dist=b_d, second_dist=s_d, accept=accept)
