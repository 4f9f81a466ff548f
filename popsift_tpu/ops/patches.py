"""Patch extraction: the XLA stand-in for texture fetches.

Per-pixel texture reads (readTex,
/root/reference/src/popsift/common/assist.h:66-81) become one
*contiguous* window of the keypoint's blur level per keypoint, pulled by
a batched dynamic_slice (rows are contiguous, so the lowered gather
moves whole rows), and all subsequent arithmetic is dense.

Edge semantics: the reference's clamped texture reads equal
edge-replication. Levels smaller than the patch are pre-padded with
``pad_for_patches``; window starts are clamped into the valid range and
every patch cell carries its true image coordinate, so border behavior
is identical to clamped reads for all *used* (masked) cells.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pad_for_patches(img: jnp.ndarray, patch: int) -> jnp.ndarray:
    """Edge-pad the trailing two dims of [L, H, W] to at least ``patch``."""
    H, W = img.shape[-2:]
    py = max(0, patch - H)
    px = max(0, patch - W)
    if py == 0 and px == 0:
        return img
    pad = [(0, 0)] * (img.ndim - 2) + [(0, py), (0, px)]
    return jnp.pad(img, pad, mode="edge")


def extract_patches(img: jnp.ndarray, level: jnp.ndarray,
                    cy: jnp.ndarray, cx: jnp.ndarray, radius: int):
    """Extract [K, P, P] patches (P = 2*radius+1) centered near
    (cy, cx) from img[level], plus the image coordinates of each patch's
    origin.

    img: f32[L, H, W] with H, W >= P. level/cy/cx: i32[K].
    Returns (patches f32[K, P, P], y0 i32[K], x0 i32[K]) where patch cell
    (i, j) holds img[level, y0 + i, x0 + j].
    """
    L, H, W = img.shape
    P = 2 * radius + 1
    y0 = jnp.clip(cy - radius, 0, H - P)
    x0 = jnp.clip(cx - radius, 0, W - P)
    lv = jnp.clip(level, 0, L - 1)

    def one(l, y, x):
        return jax.lax.dynamic_slice(img, (l, y, x), (1, P, P))[0]

    patches = jax.vmap(one)(lv, y0, x0)
    return patches, y0, x0
