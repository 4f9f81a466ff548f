"""Keypoint orientation assignment in JAX.

Redesign of the reference orientation kernel
(/root/reference/src/popsift/s_orientation.cu:60-242):

* one CUDA block per extremum with shared-memory atomics becomes a
  batched computation over the capacity-padded extrema buffer: every
  keypoint scans the same static (2*R_max+1)^2 window with validity
  masks (radius, image bounds), histogram built by 36 masked sums.
* the warp bitonic top-peak sort (s_orientation.cu:207-215) becomes
  ``lax.top_k`` over the 36 refined peak values.
* VLFeat smoothing (3 iterations of two circular box-3 passes,
  s_orientation.cu:142-156) is six rolls on the bin axis.

Semantics reproduced: gradient from the keypoint's blur level by
central differences with clamped reads (s_gradiant.h:55-69), Gaussian
weight exp(int(d^2) * -0.5/(1.5 sigma)^2) with the reference's integer
truncation of the squared distance (s_orientation.cu:123-125), bin index
round(36*(theta+pi)/2pi) mod 36 (s_orientation.cu:128-134), parabolic
peak refinement and the 0.8*max acceptance rule with at most 4
orientations ordered by peak value (s_orientation.cu:183-231).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ORI_NBINS, ORI_WINFACTOR, ORIENTATION_MAX_COUNT, SiftConfig
from .extrema import OctaveExtrema
from .patches import extract_patches, pad_for_patches


class OctaveOrientations(NamedTuple):
    ori: jnp.ndarray        # f32[K, 4] angles, descending peak order
    ori_valid: jnp.ndarray  # bool[K, 4]
    num_ori: jnp.ndarray    # i32[K]


def max_ori_radius(cfg: SiftConfig) -> int:
    """Static window radius bound: rad = round(3 * 1.5 * sigma_max), where
    sigma_max corresponds to the verify() bound sn <= maxlevel
    (s_extrema.cu:286-297)."""
    sigma_max = cfg.sigma * 2.0 ** ((cfg.total_levels - 1) / cfg.levels)
    return int(round(3.0 * ORI_WINFACTOR * sigma_max))


def _orientation_hist_xla(blur, ext, cfg, R, y_bounds=None):
    """Histogram via patch extraction + per-bin masked reductions (a
    one-hot einsum would materialize [K, P*P, 36], ~1 GB per image).

    ``y_bounds=(lo, hi)``: inclusive valid row range in *local*
    coordinates (spatial sharding passes the band's global-bound
    translation); defaults to the image interior (1, H-2)."""
    L, H, W = blur.shape
    if y_bounds is None:
        y_lo, y_hi = 1, H - 2
    else:
        y_lo, y_hi = y_bounds
    K = ext.x.shape[0]
    P = 2 * (R + 1) + 1          # +1 margin for the gradient stencil

    img = pad_for_patches(blur, P)

    xr = jnp.round(ext.x).astype(jnp.int32)   # window center (s_orientation.cu:96-99)
    yr = jnp.round(ext.y).astype(jnp.int32)
    patches, y0, x0 = extract_patches(img, ext.level, yr, xr, R + 1)

    sigw = np.float32(ORI_WINFACTOR) * ext.sigma
    rad = jnp.round(3.0 * sigw).astype(jnp.int32)
    factor = -0.5 / (sigw * sigw + 1e-30)
    sq_thres = (rad * rad).astype(jnp.float32)

    # true image coordinates of each patch cell
    ii = jnp.arange(P, dtype=jnp.int32)
    xx = x0[:, None, None] + ii[None, None, :]     # [K, P, P]
    yy = y0[:, None, None] + ii[None, :, None]

    # gradient by central differences inside the patch (cells on the
    # patch border are never inside the masked window)
    dxv = jnp.roll(patches, -1, axis=2) - jnp.roll(patches, 1, axis=2)
    dyv = jnp.roll(patches, -1, axis=1) - jnp.roll(patches, 1, axis=1)
    grad = jnp.sqrt(dxv * dxv + dyv * dyv)
    theta = jnp.arctan2(dyv, dxv)

    inb = ((jnp.abs(xx - xr[:, None, None]) <= rad[:, None, None])
           & (jnp.abs(yy - yr[:, None, None]) <= rad[:, None, None])
           & (xx >= 1) & (xx <= W - 2) & (yy >= y_lo) & (yy <= y_hi))

    fdx = xx.astype(jnp.float32) - ext.x[:, None, None]
    fdy = yy.astype(jnp.float32) - ext.y[:, None, None]
    sq = jnp.floor(fdx * fdx + fdy * fdy)   # int truncation, s_orientation.cu:123
    inb = inb & (sq <= sq_thres[:, None, None])

    weight = jnp.where(inb, grad * jnp.exp(sq * factor[:, None, None]), 0.0)

    bidx = jnp.round(np.float32(ORI_NBINS) * (theta + np.float32(math.pi))
                     / np.float32(2.0 * math.pi)).astype(jnp.int32)
    bidx = jnp.where(bidx == ORI_NBINS, 0, bidx)

    wflat = weight.reshape(K, P * P)
    bflat = bidx.reshape(K, P * P)
    return jnp.stack(
        [jnp.sum(jnp.where(bflat == b, wflat, 0.0), axis=1)
         for b in range(ORI_NBINS)], axis=1)


def orientation_histograms(blur: jnp.ndarray, ext: OctaveExtrema,
                           cfg: SiftConfig,
                           y_bounds=None) -> jnp.ndarray:
    """Raw 36-bin gradient histograms f32[K, 36] for one octave's
    (padded) extrema — the only orientation phase that reads the octave
    image; the peak-finding tail (:func:`orientations_from_histograms`)
    is image-free and batches across octaves in the pipeline.

    Gradient reads go through one contiguous window per keypoint instead
    of per-pixel gathers. ``y_bounds`` (see _orientation_hist_xla) is
    used by the sharded extraction, where ``blur`` is a halo'd row band.
    """
    return _orientation_hist_xla(blur, ext, cfg, max_ori_radius(cfg),
                                 y_bounds=y_bounds)


def smooth_histograms(hist: jnp.ndarray, smoothing: str = "vlfeat"
                      ) -> jnp.ndarray:
    """Circular smoothing of [K, 36] orientation histograms.

    "vlfeat" = 3 iterations of two circular box-3 passes — the
    reference's compile-time default (WITH_VLFEAT_SMOOTHING,
    s_orientation.cu:31-34,142-156); "opencv" = one circular binomial
    [1,4,6,4,1]/16 pass (the #else branch, s_orientation.cu:158-173).
    """
    if smoothing == "opencv":
        return (jnp.roll(hist, 2, axis=1) + jnp.roll(hist, -2, axis=1)
                + 4.0 * (jnp.roll(hist, 1, axis=1)
                         + jnp.roll(hist, -1, axis=1))
                + 6.0 * hist) / 16.0
    for _ in range(6):
        hist = (jnp.roll(hist, 1, axis=1) + hist
                + jnp.roll(hist, -1, axis=1)) / 3.0
    return hist


def orientations_from_histograms(hist: jnp.ndarray,
                                 valid: jnp.ndarray,
                                 smoothing: str = "vlfeat"
                                 ) -> OctaveOrientations:
    """Smoothing + peak refinement + 0.8-max acceptance over histograms
    (s_orientation.cu:142-241). Pure [K, 36] math — callers concatenate
    all octaves' histograms and run this once per frame.

    ``smoothing`` selects the reference's compile-time variant
    (WITH_VLFEAT_SMOOTHING, s_orientation.cu:31-34) — see
    :func:`smooth_histograms`. Exposed at runtime via
    ``SiftConfig.ori_smoothing``."""
    hist = smooth_histograms(hist, smoothing)

    prev = jnp.roll(hist, 1, axis=1)
    nxt = jnp.roll(hist, -1, axis=1)
    peak = hist > jnp.maximum(prev, nxt)
    num = 3.0 * prev - 4.0 * hist + nxt
    denB = jnp.where(peak, 2.0 * (prev - 2.0 * hist + nxt), 1.0)
    newbin = num / denB
    ok = peak & (newbin >= 0.0) & (newbin <= 2.0)
    bins = jnp.arange(ORI_NBINS, dtype=jnp.float32)
    refined = jnp.where(ok, jnp.mod(bins - 1.0, ORI_NBINS) + newbin, -1.0)
    yval = jnp.where(ok, -(num * num) / (4.0 * denB) + prev, -jnp.inf)

    top_val, top_idx = jax.lax.top_k(yval, ORIENTATION_MAX_COUNT)
    best = top_val[:, :1]
    accept = (top_val >= 0.8 * best) & jnp.isfinite(top_val) \
        & valid[:, None]

    chosen = jnp.take_along_axis(refined, top_idx, axis=1)
    chosen = jnp.where(chosen >= ORI_NBINS, chosen - ORI_NBINS, chosen)
    th = (np.float32(2.0 * math.pi) * chosen) / np.float32(ORI_NBINS) \
        - np.float32(math.pi)

    return OctaveOrientations(
        ori=jnp.where(accept, th, 0.0),
        ori_valid=accept,
        num_ori=jnp.sum(accept, axis=1, dtype=jnp.int32),
    )


def assign_orientations(blur: jnp.ndarray, ext: OctaveExtrema,
                        cfg: SiftConfig,
                        y_bounds=None) -> OctaveOrientations:
    """Compute up to 4 orientations for each (padded) extremum —
    histogram + peak tail in one call (single-octave convenience form;
    the pipeline batches the tail across octaves itself)."""
    hist = orientation_histograms(blur, ext, cfg, y_bounds=y_bounds)
    return orientations_from_histograms(hist, ext.valid,
                                        smoothing=cfg.ori_smoothing)
