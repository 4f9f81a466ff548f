"""Pallas kernel (Triton route): SIFT descriptors, loop variant, for
NVIDIA GPUs.

The reference computes its hottest stage with one CUDA block per
(keypoint, orientation) that scans the keypoint's data-dependent
bounding box and accumulates 128 bins (s_desc_loop.cu:19-161). This
kernel keeps that shape: one Triton program per descriptor job. The
program reads its own window of the blur level straight from device
memory, tile by tile (``_RS`` rows x ``_CS`` columns), and keeps the
whole per-pixel pipeline in registers — gradient by central
differences, rotated coordinates, Gaussian weight, tile triangles and
the angle-bin split. Each tile's contribution is one small contraction

    desc[(ty, tx), b] += sum_p  wy[p, ty] * wx[p, tx] * cb[p, b]
                        ([16, T] x [T, 16], bins padded 8 -> 16)

accumulated in f32 at IEEE precision. The window is sized per job from
its own sigma (the reference's data-dependent bbox), so low-level
keypoints — the bulk — scan a fraction of the static worst-case patch.

``ops.descriptors._descriptor_loop_chunk`` is the plain reference; the
two agree to float rounding (tests/test_desc_kernel.py, and
``chip_smoke.py`` for the compiled kernel).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import DESC_BINS, DESC_MAGNIFY

_RS = 8            # window rows per tile
_CS = 32           # window columns per tile (one warp-wide row segment)
_T = _RS * _CS     # pixels per tile
_NB = 16           # angle bins padded to Triton's minimum dot width


def support_radius(sigma: jnp.ndarray) -> jnp.ndarray:
    """Per-job scan radius: used pixels satisfy |n|_inf < 2.5 in
    descriptor units, so |p - kp| < 2.5*sqrt(2)*SBP (s_desc_loop.cu:58-91),
    plus the half-pixel rounding of the window centre and one guard."""
    sbp = jnp.abs(np.float32(DESC_MAGNIFY) * sigma)
    return (jnp.ceil(np.float32(2.5 * math.sqrt(2.0)) * sbp)
            .astype(jnp.int32) + 2)


def _kernel(fpar_ref, ipar_ref, img_ref, out_ref, *, W):
    x = fpar_ref[0]
    y = fpar_ref[1]
    crsbp = fpar_ref[2]
    srsbp = fpar_ref[3]
    ang = fpar_ref[4]
    r_lo = fpar_ref[5]
    c_lo = fpar_ref[6]
    base = ipar_ref[0]
    n_rows = ipar_ref[1]
    n_cols = ipar_ref[2]
    n_tx = ipar_ref[3]
    n_tiles = ipar_ref[4]

    q = jnp.arange(_T, dtype=jnp.int32)
    qr = q // _CS
    qc = q % _CS
    k = jnp.arange(16, dtype=jnp.int32)[None, :]
    cent_y = (k // 4).astype(jnp.float32) - np.float32(1.5)   # tile ty
    cent_x = (k % 4).astype(jnp.float32) - np.float32(1.5)    # tile tx
    two_pi = np.float32(2.0 * math.pi)

    def tri(n, c):
        a = jnp.abs(n - c)
        return jnp.where(a < 1.0, 1.0 - a, 0.0)

    def tile(t, acc):
        ty = t // n_tx
        tx = t - ty * n_tx
        r = ty * _RS + qr
        c = tx * _CS + qc
        m = (r < n_rows) & (c < n_cols)
        off = base + r * W + c
        ld = functools.partial(plgpu.load, mask=m, other=0.0)
        dx = ld(img_ref.at[off + 1]) - ld(img_ref.at[off - 1])
        dy = ld(img_ref.at[off + W]) - ld(img_ref.at[off - W])
        mod = jnp.sqrt(dx * dx + dy * dy)
        th = jnp.arctan2(dy, dx)

        fdx = (c_lo + c.astype(jnp.float32)) - x
        fdy = (r_lo + r.astype(jnp.float32)) - y
        nx = crsbp * fdx + srsbp * fdy          # global rotated coords
        ny = crsbp * fdy - srsbp * fdx

        tha = th - ang
        tha = jnp.where(tha < 0.0, tha + two_pi, tha)
        tha = jnp.where(tha >= two_pi, tha - two_pi, tha)
        tth = tha * np.float32(4.0 / math.pi)
        fo_f = jnp.floor(tth)
        frac = tth - fo_f
        fo = fo_f.astype(jnp.int32)             # in [0, 8]
        fo0 = jnp.where(fo >= DESC_BINS, fo - DESC_BINS, fo)
        fo1 = jnp.where(fo + 1 >= DESC_BINS, fo + 1 - DESC_BINS, fo + 1)

        ww = jnp.exp(np.float32(-0.125) * (nx * nx + ny * ny))
        wgt = jnp.where(m, ww * mod, 0.0)

        wyx = tri(ny[:, None], cent_y) * tri(nx[:, None], cent_x)  # [T, 16]
        cb = wgt[:, None] * (
            jnp.where(fo0[:, None] == k, (1.0 - frac)[:, None], 0.0)
            + jnp.where(fo1[:, None] == k, frac[:, None], 0.0))    # [T, 16]
        return acc + pl.dot(wyx, cb, trans_a=True,
                            precision=jax.lax.Precision.HIGHEST)

    acc = jax.lax.fori_loop(0, n_tiles, tile,
                            jnp.zeros((16, _NB), jnp.float32))
    out_ref[...] = acc


@functools.partial(jax.jit, static_argnames=("W", "interpret"))
def _call(fpar, ipar, img_flat, W, interpret=False):
    F = fpar.shape[0]
    return pl.pallas_call(
        functools.partial(_kernel, W=W),
        grid=(F,),
        in_specs=[
            pl.BlockSpec((None, 8), lambda i: (i, 0)),
            pl.BlockSpec((None, 8), lambda i: (i, 0)),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((None, 16, _NB), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((F, 16, _NB), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="sift_desc_loop",
    )(fpar, ipar, img_flat)


def descriptor_loop_triton(blur: jnp.ndarray, jobs, radius: int,
                           y_bounds=None,
                           interpret: bool = False) -> jnp.ndarray:
    """Unnormalized loop-variant descriptors f32[F, 128] for a job list.

    blur: f32[L, H, W] octave blur stack (unpadded: the kernel masks its
    reads). ``radius`` is the static window bound the plain reference
    uses (descriptors.loop_patch_radius); each job scans at most that.
    ``y_bounds=(lo, hi)``: inclusive valid row range in local
    coordinates, two scalars that may be traced (the sharded row-band
    path); default ``(1, H-2)``. Invalid jobs and sigma 0 give zero rows.
    """
    L, H, W = blur.shape
    F = jobs.x.shape[0]
    if F == 0:
        return jnp.zeros((0, 128), jnp.float32)
    if y_bounds is None:
        y_lo, y_hi = 1, H - 2
    else:
        y_lo, y_hi = y_bounds
    # gradient reads touch rows y-1 .. y+1: keep them inside the array
    y_lo = jnp.maximum(jnp.asarray(y_lo, jnp.int32), 1)
    y_hi = jnp.minimum(jnp.asarray(y_hi, jnp.int32), H - 2)

    sbp = jnp.abs(np.float32(DESC_MAGNIFY) * jobs.sigma)
    inv_sbp = jnp.where(sbp > 0, 1.0 / jnp.where(sbp > 0, sbp, 1.0), 0.0)
    rj = jnp.minimum(support_radius(jobs.sigma), radius)
    xr = jnp.round(jobs.x).astype(jnp.int32)
    yr = jnp.round(jobs.y).astype(jnp.int32)
    r_lo = jnp.maximum(yr - rj, y_lo)
    c_lo = jnp.maximum(xr - rj, 1)
    n_rows = jnp.maximum(jnp.minimum(yr + rj, y_hi) - r_lo + 1, 0)
    n_cols = jnp.maximum(jnp.minimum(xr + rj, W - 2) - c_lo + 1, 0)
    n_tx = (n_cols + _CS - 1) // _CS
    n_tiles = jnp.where(jobs.valid & (sbp > 0),
                        ((n_rows + _RS - 1) // _RS) * n_tx, 0)
    lvl = jnp.clip(jobs.level, 0, L - 1)
    base = (lvl * H + r_lo) * W + c_lo

    zf = jnp.zeros_like(jobs.x)
    fpar = jnp.stack([jobs.x, jobs.y, jnp.cos(jobs.ang) * inv_sbp,
                      jnp.sin(jobs.ang) * inv_sbp, jobs.ang,
                      r_lo.astype(jnp.float32), c_lo.astype(jnp.float32),
                      zf], axis=1)
    zi = jnp.zeros_like(base)
    ipar = jnp.stack([base, n_rows, n_cols, n_tx, n_tiles, zi, zi, zi],
                     axis=1).astype(jnp.int32)
    out = _call(fpar, ipar, blur.reshape(-1), W, interpret=interpret)
    return out[:, :, :DESC_BINS].reshape(F, 128)
