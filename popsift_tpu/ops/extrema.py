"""DoG extrema detection and sub-pixel refinement in JAX.

Redesign of the reference extrema kernel
(/root/reference/src/popsift/s_extrema.cu):

* warp-ballot + atomicAdd compaction (s_extrema.cu:22-44) becomes a dense
  boolean mask + ``jnp.nonzero(size=cap)`` compaction into a
  fixed-capacity, validity-masked candidate buffer — the reference itself
  clamps to ``max_extrema`` (s_extrema.cu:551-561), we make the bound a
  static shape.
* the early-exit grouped 26-neighbor test (s_extrema.cu:56-120) becomes
  a fully dense vectorized strict min/max over shifted slices that XLA
  fuses into one elementwise loop.
* the per-thread refinement loop (s_extrema.cu:359-460) is a 5x unrolled
  masked update over the compacted candidate set, with clamped gathers
  standing in for texture reads.

The math is bit-for-bit the reference algorithm in float32: closed-form
symmetric 3x3 solve (s_solve.h:24-85), PopSift/VLFeat step policies
(s_extrema.cu:196-298), contrast/curvature/edge tests
(s_extrema.cu:470-493).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SiftConfig

MAX_ITERATIONS = 5  # s_extrema.cu:363


class OctaveExtrema(NamedTuple):
    """Capacity-padded initial extrema of one octave (octave coords)."""

    x: jnp.ndarray        # f32[K] refined x
    y: jnp.ndarray        # f32[K]
    s: jnp.ndarray        # f32[K] continuous level
    level: jnp.ndarray    # i32[K] round(s)
    sigma: jnp.ndarray    # f32[K] octave-relative scale
    cell: jnp.ndarray     # i32[K] grid-filter cell id
    valid: jnp.ndarray    # bool[K]
    count: jnp.ndarray    # i32[] number of valid entries
    n_candidates: jnp.ndarray  # i32[] pre-refinement candidates (for
    # capacity calibration; counts saturate at the octave capacity)
    n_dropped: jnp.ndarray     # i32[] candidates dropped by the per-block
    # density clamp in _compact_mask (0 in healthy calibrated runs)


def _neighbor_offsets():
    offs = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx or dy or dz:
                    offs.append((dz, dy, dx))
    return offs


def _first_threshold(cfg: SiftConfig) -> float:
    """First-contrast gate: popsift 1.6*thr (s_extrema.cu:253-256),
    vlfeat 0.8*2*thr == 1.6*thr (:201-204), opencv floor(thr)."""
    thr = cfg.peak_threshold
    if cfg.sift_mode in ("popsift", "vlfeat"):
        return 1.6 * thr
    return float(np.floor(thr))


def _candidate_mask(dog: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """Dense mask of pixels passing contrast + strict 26-neighbor test.

    Layers z = 1 .. total_levels-3 are searched (grid.z = levels-3 with
    level = block_z + 1, s_extrema.cu:329-334). Edge-replication padding
    reproduces the clamped-texture behavior that silently excludes the
    outermost pixels (val > val is false). The 26 shifted compares fuse
    into one elementwise loop.
    """
    D, H, W = dog.shape
    Z = cfg.total_levels - 3
    thr1 = np.float32(_first_threshold(cfg))
    c = dog[1:Z + 1]
    first = jnp.abs(c) >= thr1
    dogp = jnp.pad(dog, ((1, 1), (1, 1), (1, 1)), mode="edge")
    gt = jnp.ones_like(c, dtype=bool)
    lt = jnp.ones_like(c, dtype=bool)
    for dz, dy, dx in _neighbor_offsets():
        nb = jax.lax.dynamic_slice(
            dogp, (1 + 1 + dz, 1 + dy, 1 + dx), (Z, H, W))
        gt = gt & (c > nb)
        lt = lt & (c < nb)
    mask = first & (gt | lt)

    if cfg.sift_mode == "opencv":
        # OpenCV rejects a 5-pixel border outright (s_extrema.cu:336-340)
        ys = jnp.arange(H)
        xs = jnp.arange(W)
        border = ((xs < 5) | (xs >= W - 5))[None, None, :] | \
                 ((ys < 5) | (ys >= H - 5))[None, :, None]
        mask = mask & ~border
    return mask


def _solve3(a00, a01, a02, a11, a12, a22, b0, b1, b2):
    """Symmetric 3x3 solve via adjugate (s_solve.h:24-85).

    Returns (singular, x0, x1, x2); singular lanes get x == 0.
    """
    det0 = a11 * a22 - a12 * a12
    det1 = a12 * a02 - a01 * a22
    det2 = a01 * a12 - a11 * a02
    det3 = a00 * a22 - a02 * a02
    det4 = a01 * a02 - a00 * a12
    det5 = a00 * a11 - a01 * a01
    det = a00 * det0 + a01 * det1 + a02 * det2
    singular = det == 0.0
    rsd = jnp.where(singular, 1.0, 1.0 / jnp.where(singular, 1.0, det))
    x0 = (det0 * b0 + det1 * b1 + det2 * b2) * rsd
    x1 = (det1 * b0 + det3 * b1 + det4 * b2) * rsd
    x2 = (det2 * b0 + det4 * b1 + det5 * b2) * rsd
    z = jnp.zeros_like(x0)
    return singular, jnp.where(singular, z, x0), \
        jnp.where(singular, z, x1), jnp.where(singular, z, x2)


def first_set_indices(mask: jnp.ndarray, size: int,
                      fill: int = 0) -> jnp.ndarray:
    """Ascending indices of the first ``size`` set bits of a 1-D bool
    mask — ``jnp.nonzero(mask, size=size, fill_value=fill)`` semantics
    as ONE ``lax.sort`` (nonzero's cumsum+bincount lowering emits a
    scatter per call; ROADMAP queue 1 item 6 A/Bs the two on the GPU).
    """
    n = mask.shape[0]
    keys = jnp.where(mask, jax.lax.iota(jnp.int32, n), jnp.int32(n))
    skeys = jax.lax.sort(keys)[:size]
    return jnp.where(skeys >= n, jnp.int32(fill), skeys)


def _rank_compact_rows(m: jnp.ndarray, K: int):
    """Per-row rank compaction of a [nb, 128] boolean mask: returns
    (pos i32[nb, K] lane of the j-th set bit, full_cnt i32[nb]).

    One per-row ascending ``lax.sort`` of (set ? lane : B) puts the set
    lanes' positions first — the moral equivalent of the reference's
    warp-ballot compaction (s_extrema.cu:22-44) as a single fused HLO.
    Ranks past the row's count report position 0.
    """
    nb, B = m.shape
    iota = jax.lax.broadcasted_iota(jnp.int32, (nb, B), 1)
    keys = jnp.where(m, iota, jnp.int32(B))       # unset lanes sort last
    skeys = jax.lax.sort(keys, dimension=1)       # ascending
    pos = skeys[:, :K]
    pos = jnp.where(pos >= B, 0, pos)             # overflow ranks -> 0
    full_cnt = jnp.sum(m, axis=1, dtype=jnp.int32)
    return pos, full_cnt


def _compact_mask(flat: jnp.ndarray, capacity: int, block_k: int = 0):
    """Compact a sparse boolean mask into up to ``capacity`` flat indices,
    preserving ascending index order — ``jnp.nonzero`` semantics with a
    per-128-lane-block density clamp (below). A single ``jnp.nonzero``
    over a full-octave mask lowers to a global cumsum+gather; this
    scheme is two-level:

    1. ONE cheap dense pass computes per-128-lane-block counts (the
       only full-mask traffic: a bool read + i32 row reduce);
    2. the ids of the first up-to-``capacity`` NON-EMPTY blocks are
       compacted recursively (the level-2 mask is nb bits — trivial);
    3. only those blocks' mask rows are gathered, and the rank phase
       (:func:`_rank_compact_rows`: one per-row lane sort) runs on the
       [<=capacity, 128] gathered rows instead of the full mask, so
       the work is proportional to the candidate count;
    4. block write offsets come from one small cumsum over block
       counts, and the output is *gathered* (searchsorted over
       offsets) rather than scattered, so no second nonzero is needed.

    Ascending-order semantics survive the truncation to ``capacity``
    non-empty blocks: each non-empty block holds >= 1 candidate, so the
    first ``capacity`` candidates always live in the first ``capacity``
    non-empty blocks.

    Blocks denser than K candidates per 128 lanes drop the excess — a
    *spatially local* clamp the reference's global ``max_extrema`` clamp
    (s_extrema.cu:551-561) does not have, so the third return value
    reports how many candidates were dropped this way (calibration and
    the API warning path watch it). K auto-scales with the
    capacity/mask-size ratio; pass ``block_k`` to pin it.
    """
    N = flat.shape[0]
    B = 128
    if block_k > 0:
        K = min(block_k, B - 1)    # rank B would wrap the int8 compare
    else:
        # >= 4x the capacity-implied mean block density, floor 16 (the
        # densest block measured on a texture-saturated synthetic 1080p
        # frame is ~6 per 128 lanes at default thresholds)
        K = int(np.clip(4 * capacity * B // max(N, 1) + 1, 16, B - 1))
    nb = -(-N // B)
    pad = nb * B - N
    m = jnp.pad(flat, (0, pad)).reshape(nb, B)

    if nb <= max(2 * capacity, 512):
        # small masks: the dense single-level scheme is already cheap
        pos, full_cnt = _rank_compact_rows(m, K)
        cnt = jnp.minimum(full_cnt, K)
        dropped = jnp.sum(full_cnt - cnt)
        bids = jnp.arange(nb, dtype=jnp.int32)
        nsel = nb
    else:
        # level 1: per-block counts (the only full-mask pass)
        blk_cnt = jnp.sum(m, axis=1, dtype=jnp.int32)        # [nb]
        total_bits = jnp.sum(blk_cnt)
        # level 2: ids of the first <= capacity non-empty blocks.
        # block_k=127 (the int8 max): non-empty blocks DO cluster (a
        # textured image region fills consecutive blocks), so the
        # level-2 density clamp must never bind
        bids, _, _ = _compact_mask(blk_cnt > 0, capacity, block_k=127)
        nsel = capacity
        sel_rows = m[bids]                                   # [cap, 128]
        sel_valid = jnp.arange(capacity, dtype=jnp.int32) < \
            jnp.sum(blk_cnt > 0, dtype=jnp.int32)
        sel_rows = sel_rows & sel_valid[:, None]
        pos, full_cnt = _rank_compact_rows(sel_rows, K)
        cnt = jnp.minimum(full_cnt, K)
        # density-clamp drops + candidates in blocks beyond the
        # truncation (the latter only occur past saturation)
        dropped = total_bits - jnp.sum(cnt)

    off = jnp.cumsum(cnt) - cnt               # exclusive block offsets
    total = jnp.minimum(off[-1] + cnt[-1], capacity)
    s = jnp.arange(capacity, dtype=jnp.int32)
    # block lookup b[s] = searchsorted(off, s, "right") - 1 as a dense
    # compare-sum: jnp.searchsorted lowers to a log2(n)-iteration while
    # loop, this to one fused [capacity, nsel] reduction.
    b = jnp.clip(jnp.sum((off[None, :] <= s[:, None]), axis=1,
                         dtype=jnp.int32) - 1, 0, nsel - 1)
    j = jnp.clip(s - off[b], 0, K - 1)
    flat_idx = (bids[b] * B
                + pos.reshape(-1)[b * K + j].astype(jnp.int32))
    return flat_idx, total, dropped


class CandidateSet(NamedTuple):
    """Per-octave compacted candidates + refinement patches (the cheap,
    shape-dependent half of detection — see :func:`refine_candidates`)."""

    patches: jnp.ndarray   # f32[K, D, P, P] refinement windows
    x0: jnp.ndarray        # i32[K] start column
    y0: jnp.ndarray        # i32[K] start row (local)
    z0: jnp.ndarray        # i32[K] start dog layer
    valid: jnp.ndarray     # bool[K]
    n_found: jnp.ndarray   # i32[]
    n_dropped: jnp.ndarray  # i32[]


def collect_candidates(dog: jnp.ndarray, cfg: SiftConfig,
                       capacity: int,
                       row_window: tuple | None = None) -> CandidateSet:
    """Mask + compact + window-extract for one octave's DoG stack.

    This is the only part of detection whose array shapes depend on the
    octave; the refinement math (:func:`refine_candidates`) runs on the
    capacity-padded candidate list and batches across octaves, so the
    pipeline concatenates all octaves' CandidateSets and refines once.
    """
    D, H, W = dog.shape
    mask = _candidate_mask(dog, cfg)
    if row_window is not None:
        lo, hi = row_window
        rows = jnp.arange(H, dtype=jnp.int32)
        mask = mask & ((rows >= lo) & (rows < hi))[None, :, None]
    idx, n_found, n_dropped = _compact_mask(
        mask.reshape(-1), capacity, block_k=cfg.compact_block_k)
    cand_valid = jnp.arange(capacity, dtype=jnp.int32) < n_found

    z0 = (idx // (H * W)).astype(jnp.int32) + 1   # dog layer
    rem = idx % (H * W)
    y0 = (rem // W).astype(jnp.int32)
    x0 = (rem % W).astype(jnp.int32)

    # Per-candidate neighborhood patches instead of per-read gathers:
    # positions move at most MAX_ITERATIONS-1 cells from the start and
    # derivatives need a +-1 halo, so an 11x11 window (all D layers)
    # covers every read of the refinement loop. One batched
    # dynamic_slice pulls the patches; the 27-point neighborhood of the
    # *current* position is then read with three tiny separable one-hot
    # contractions.
    R = MAX_ITERATIONS                      # 4 moves + 1 derivative halo
    P = 2 * R + 1
    dogp = jnp.pad(dog, ((0, 0), (R, R), (R, R)), mode="edge")

    def one_patch(y, x):
        return jax.lax.dynamic_slice(dogp, (0, y, x), (D, P, P))

    patches = jax.vmap(one_patch)(y0, x0)  # [K, D, P, P]
    return CandidateSet(patches=patches, x0=x0, y0=y0, z0=z0,
                        valid=cand_valid, n_found=n_found,
                        n_dropped=n_dropped)


def finalize_refined(state: jnp.ndarray, cand_valid: jnp.ndarray,
                     cfg: SiftConfig, oct_w, oct_h, n_candidates,
                     n_dropped, y_offset=0) -> OctaveExtrema:
    """Final accept tests over refined candidates (the tail of the
    reference refinement, s_extrema.cu:455-493): excessive-movement,
    bounds, contrast, curvature-sign and edge-ratio tests, plus sigma
    and grid-cell assignment.  ``state`` columns are
    (nx, ny, nz, dx, dy, dz, v, Dx, Dy, Ds, DDx, DDy, DXy) as produced
    by the loop in :func:`refine_candidates`."""
    (nx, nyv, nzv, dx, dy, dz, v,
     Dx, Dy, Ds, DDx, DDy, DXy) = (state[:, i] for i in range(13))
    Wb = jnp.asarray(oct_w, jnp.int32)
    Hb = jnp.asarray(oct_h, jnp.int32)
    maxlevel = cfg.total_levels - 1
    thr = np.float32(cfg.peak_threshold)
    goff = jnp.asarray(y_offset, jnp.int32)

    # excessive movement: positive side only (s_extrema.cu:455-460)
    ok = cand_valid & ~((dx >= 1.5) | (dy >= 1.5) | (dz >= 1.5))

    xn = nx + dx
    yn = (nyv + goff.astype(jnp.float32)) + dy    # global row coordinate
    sn = nzv + dz

    # verify bounds (s_extrema.cu:286-297), rows against the full octave
    ok = ok & (xn >= 0.0) & (xn <= Wb.astype(jnp.float32) - 1.0) \
        & (yn >= 0.0) & (yn <= Hb.astype(jnp.float32) - 1.0) \
        & (sn >= 0.0) & (sn <= maxlevel)

    contr = v + 0.5 * (Dx * dx + Dy * dy + Ds * dz)
    tr = DDx + DDy
    det = DDx * DDy - DXy * DXy
    e = np.float32(cfg.edge_limit)
    ok = ok & (det > 0.0)
    ok = ok & (jnp.abs(contr) >= 2.0 * thr)
    ok = ok & (tr * tr / jnp.where(det > 0, det, 1.0)
               < (e + 1.0) * (e + 1.0) / e)

    sigma0 = np.float32(cfg.sigma)
    sigma = sigma0 * jnp.exp2(sn / np.float32(cfg.levels))

    w_div = Wb.astype(jnp.float32) / np.float32(cfg.filter_grid_size)
    h_div = Hb.astype(jnp.float32) / np.float32(cfg.filter_grid_size)
    cell = (jnp.floor(yn / h_div) * cfg.filter_grid_size
            + jnp.floor(xn / w_div)).astype(jnp.int32)

    return OctaveExtrema(
        x=jnp.where(ok, xn, 0.0),
        y=jnp.where(ok, yn, 0.0),
        s=jnp.where(ok, sn, 0.0),
        level=jnp.where(ok, jnp.round(sn).astype(jnp.int32), 0),
        sigma=jnp.where(ok, sigma, 0.0),
        cell=jnp.where(ok, cell, 0),
        valid=ok,
        count=jnp.sum(ok, dtype=jnp.int32),
        n_candidates=n_candidates,
        n_dropped=n_dropped,
    )


def refine_candidates(cand: CandidateSet, cfg: SiftConfig,
                      oct_w, oct_h, y_offset=0) -> OctaveExtrema:
    """5-iteration masked sub-pixel refinement + final tests over a
    capacity-padded candidate list (the batched half of detection).

    ``oct_w``/``oct_h``/``y_offset`` may be Python ints (single octave)
    or per-candidate i32 arrays (cross-octave batched lists, where each
    row carries its own octave's dimensions); all bound tests broadcast.
    ``y_offset`` is the global row of local row 0 for spatially-sharded
    bands; ``oct_h`` is always the FULL octave height.
    """
    patches = cand.patches
    K, D, P, _ = patches.shape
    R = (P - 1) // 2
    capacity = K
    Wb = jnp.asarray(oct_w, jnp.int32)           # bound arrays (broadcast)
    Hb = jnp.asarray(oct_h, jnp.int32)
    maxlevel = cfg.total_levels - 1
    vlfeat = cfg.sift_mode == "vlfeat"
    goff = jnp.asarray(y_offset, jnp.int32)
    x0, y0, z0, cand_valid = cand.x0, cand.y0, cand.z0, cand.valid

    def neighborhood(nz, oy, ox):
        """All 27 neighbor values at layer nz + offset (oy, ox) from the
        patch center: v[k, a, b, c] = dog[nz+a-1, ny+b-1, nx+c-1]."""
        ar3 = jnp.arange(3, dtype=jnp.int32)
        zi = jnp.clip(nz[:, None] + ar3[None, :] - 1, 0, D - 1)  # [K, 3]
        yi = R + oy[:, None] + ar3[None, :] - 1
        xi = R + ox[:, None] + ar3[None, :] - 1
        oz = (zi[:, :, None] == jnp.arange(D, dtype=jnp.int32)
              ).astype(jnp.float32)                              # [K, 3, D]
        oyh = (yi[:, :, None] == jnp.arange(P, dtype=jnp.int32)
               ).astype(jnp.float32)                             # [K, 3, P]
        oxh = (xi[:, :, None] == jnp.arange(P, dtype=jnp.int32)
               ).astype(jnp.float32)
        # explicit multiply+reduce (NOT einsum/dot): a default-precision
        # dot may round its operands and costs refine precision; a dot
        # may also make XLA re-lay-out the whole patch stack. This form
        # stays f32 and fuses.
        t = jnp.sum(oz[:, :, :, None]
                    * patches.reshape(K, 1, D, P * P), axis=2)   # [K,3,P*P]
        t = t.reshape(K, 3, P, P)
        t = jnp.sum(oyh[:, None, :, :, None] * t[:, :, None, :, :],
                    axis=3)                                      # [K,3,3,P]
        return jnp.sum(oxh[:, None, None, :, :] * t[:, :, :, None, :],
                       axis=4)                                   # [K,3,3,3]

    nx, ny, nz = x0, y0, z0
    ox_off = jnp.zeros(capacity, jnp.int32)
    oy_off = jnp.zeros(capacity, jnp.int32)
    v = jnp.zeros(capacity, jnp.float32)
    dx = dy = dz = jnp.zeros(capacity, jnp.float32)
    Dx = Dy = Ds = jnp.zeros(capacity, jnp.float32)
    DDx = DDy = DDs = jnp.zeros(capacity, jnp.float32)
    DXy = DXs = DYs = jnp.zeros(capacity, jnp.float32)
    done = jnp.zeros(capacity, bool)

    for it in range(1, MAX_ITERATIONS + 1):
        act = ~done
        nb = neighborhood(nz, oy_off, ox_off)
        c = nb[:, 1, 1, 1]
        if it == 1:
            # original center value (contrast base, s_extrema.cu:357)
            v = c
        p2, p0 = nb[:, 1, 1, 2], nb[:, 1, 1, 0]
        q2, q0 = nb[:, 1, 2, 1], nb[:, 1, 0, 1]
        r2, r0 = nb[:, 2, 1, 1], nb[:, 0, 1, 1]
        nDx = 0.5 * (p2 - p0)
        nDy = 0.5 * (q2 - q0)
        nDs = 0.5 * (r2 - r0)
        nDDx = p2 + p0 - 2.0 * c
        nDDy = q2 + q0 - 2.0 * c
        nDDs = r2 + r0 - 2.0 * c
        nDXy = 0.25 * (nb[:, 1, 2, 2] + nb[:, 1, 0, 0]
                       - nb[:, 1, 2, 0] - nb[:, 1, 0, 2])
        nDXs = 0.25 * (nb[:, 2, 1, 2] + nb[:, 0, 1, 0]
                       - nb[:, 2, 1, 0] - nb[:, 0, 1, 2])
        nDYs = 0.25 * (nb[:, 2, 2, 1] + nb[:, 0, 0, 1]
                       - nb[:, 0, 2, 1] - nb[:, 2, 0, 1])

        sing, sx, sy, ss = _solve3(nDDx, nDXy, nDXs, nDDy, nDYs, nDDs,
                                   -nDx, -nDy, -nDs)

        # commit derivative state for active lanes
        Dx = jnp.where(act, nDx, Dx)
        Dy = jnp.where(act, nDy, Dy)
        Ds = jnp.where(act, nDs, Ds)
        DDx = jnp.where(act, nDDx, DDx)
        DDy = jnp.where(act, nDDy, DDy)
        DDs = jnp.where(act, nDDs, DDs)
        DXy = jnp.where(act, nDXy, DXy)
        dx = jnp.where(act, sx, dx)
        dy = jnp.where(act, sy, dy)
        dz = jnp.where(act, ss, dz)

        last_it = it == MAX_ITERATIONS
        if not last_it:
            # step policy (popsift s_extrema.cu:258-284; vlfeat :207-232);
            # row bounds in global coordinates (ny + goff)
            tx = (jnp.where((sx >= 0.6) & (nx < Wb - 2), 1, 0)
                  + jnp.where((sx <= -0.6) & (nx > 1), -1, 0))
            ty = (jnp.where((sy >= 0.6) & (ny + goff < Hb - 2), 1, 0)
                  + jnp.where((sy <= -0.6) & (ny + goff > 1), -1, 0))
            if vlfeat:
                tz = jnp.zeros_like(tx)
            else:
                tz = (jnp.where((ss >= 0.6) & (nz < maxlevel - 1), 1, 0)
                      + jnp.where((ss <= -0.6) & (nz > 1), -1, 0))
            converged = (tx == 0) & (ty == 0) & (tz == 0)
            move = act & ~sing & ~converged
            nx = jnp.where(move, nx + tx, nx)
            ny = jnp.where(move, ny + ty, ny)
            nz = jnp.where(move, nz + tz, nz)
            ox_off = jnp.where(move, ox_off + tx, ox_off)
            oy_off = jnp.where(move, oy_off + ty, oy_off)
            done = done | (act & (sing | converged))
        else:
            done = done | act

    # final accept tests
    state = jnp.stack([
        nx.astype(jnp.float32), ny.astype(jnp.float32),
        nz.astype(jnp.float32), dx, dy, dz, v,
        Dx, Dy, Ds, DDx, DDy, DXy], axis=1)
    return finalize_refined(state, cand_valid, cfg, oct_w, oct_h,
                            cand.n_found, cand.n_dropped,
                            y_offset=y_offset)


def detect_extrema(dog: jnp.ndarray, cfg: SiftConfig, capacity: int,
                   oct_w: int, oct_h: int, row_window: tuple | None = None,
                   y_offset=0) -> OctaveExtrema:
    """Detect, compact and refine extrema in one octave's DoG stack
    (collect + refine in one call — the single-octave convenience form;
    the pipeline batches refinement across octaves itself).

    Spatial sharding (parallel/spatial.py) passes a *row band with halo*:
    ``row_window=(lo, hi)`` restricts candidate rows to the device's own
    band [lo, hi) of the local array, and ``y_offset`` (traced scalar ok)
    is the global row index of local row 0 — all bound tests and outputs
    then use global coordinates while patch reads stay local. ``oct_h``
    is always the FULL octave height.
    """
    cand = collect_candidates(dog, cfg, capacity, row_window=row_window)
    return refine_candidates(cand, cfg, oct_w, oct_h, y_offset=y_offset)
