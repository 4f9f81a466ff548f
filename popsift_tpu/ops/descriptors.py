"""SIFT descriptor extraction in JAX.

Redesign of the reference descriptor kernels
(/root/reference/src/popsift/s_desc_*.cu). The reference ships five CUDA
variants; the static-shape formulation is the IGrid/NoTile one
(s_desc_igrid.cu:19-108, s_desc_notile.cu): a *fixed* 40x40 rotated
sampling grid per (keypoint, orientation) — static shapes, no
data-dependent bounding boxes — with

* gradients by rotated central differences through bilinear sampling
  (get_gradiant with cos/sin offsets, s_gradiant.h:71-87),
* the Gaussian envelope and tile weights from the reference's constant
  tables (desc_gauss/desc_tile, sift_constants.cu:34-47),
* histogram binning expressed as two small matmuls against static tile
  weight matrices — the scatter in dpt[fo] += w becomes an einsum.

The per-tile "loop" variant (s_desc_loop.cu) scans image pixels in a
data-dependent bbox; :func:`_descriptor_loop_chunk` is its fixed-window
masked scan in XLA (the plain reference), and ops/pallas/desc.py is the
GPU kernel with a per-job window.

Every f32 contraction here asks for ``Precision.HIGHEST`` (the policy is
stated once in ops/matching.py).

Jobs are a flat capacity-padded (keypoint, orientation) list — the
analog of the reference's feat_to_ext_map indirection
(s_orientation.cu:279-301).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DESC_BINS, DESC_MAGNIFY, ORIENTATION_MAX_COUNT, SiftConfig
from .extrema import OctaveExtrema
from .orientation import OctaveOrientations
from .patches import extract_patches, pad_for_patches


class DescriptorJobs(NamedTuple):
    x: jnp.ndarray        # f32[F]
    y: jnp.ndarray
    sigma: jnp.ndarray
    level: jnp.ndarray    # i32[F]
    ang: jnp.ndarray      # f32[F]
    kp_index: jnp.ndarray  # i32[F] index into the octave extrema arrays
    valid: jnp.ndarray    # bool[F]
    count: jnp.ndarray    # i32[]


def make_descriptor_jobs(ext: OctaveExtrema, oris: OctaveOrientations,
                         capacity: int) -> DescriptorJobs:
    """Flatten (extremum, orientation) pairs into a padded job list."""
    from .extrema import first_set_indices
    K = ext.x.shape[0]
    flat = oris.ori_valid.reshape(-1)
    n = jnp.minimum(jnp.sum(flat, dtype=jnp.int32), capacity)
    idx = first_set_indices(flat, capacity)
    valid = jnp.arange(capacity, dtype=jnp.int32) < n
    kp = (idx // ORIENTATION_MAX_COUNT).astype(jnp.int32)
    slot = (idx % ORIENTATION_MAX_COUNT).astype(jnp.int32)
    return DescriptorJobs(
        x=ext.x[kp], y=ext.y[kp], sigma=ext.sigma[kp], level=ext.level[kp],
        ang=oris.ori[kp, slot], kp_index=kp, valid=valid, count=n)


def make_descriptor_jobs_segmented(ext_x, ext_y, ext_sigma, ext_level,
                                   ori, ori_valid, segments):
    """One batched job build for MANY octave segments of the pipeline's
    concatenated keypoint arrays.

    Per-octave :func:`make_descriptor_jobs` calls cost one sort and ~6
    gathers each. This builds all segments' front-packed job lists with
    ONE padded-stack sort and ONE gather per field (the reference's
    analog is a single global prefix-sum over the flat orientation
    list, s_orientation.cu:274-299).

    ``segments``: static ``((start, K, jcap), ...)`` — each segment
    compacts rows ``[start, start+K)`` of the [N]-shaped keypoint arrays
    into ``jcap`` padded job rows. Returns ``(jobs, counts)`` where
    ``jobs`` concatenates the segments' padded rows (``kp_index`` LOCAL
    to its segment, ``count`` = total valid) and ``counts`` is i32[S].
    """
    O = ORIENTATION_MAX_COUNT
    maxflat = max(K * O for _, K, _ in segments)
    rows = []
    for (s, K, _) in segments:
        seg = jax.lax.slice_in_dim(ori_valid, s, s + K, axis=0)
        seg = seg.reshape(-1)
        if seg.shape[0] < maxflat:
            seg = jnp.pad(seg, (0, maxflat - seg.shape[0]))
        rows.append(seg)
    m = jnp.stack(rows)                                     # [S, maxflat]
    iota = jax.lax.broadcasted_iota(jnp.int32, m.shape, 1)
    sk = jax.lax.sort(jnp.where(m, iota, jnp.int32(maxflat)), dimension=1)
    ns = jnp.sum(m, axis=1, dtype=jnp.int32)

    kp_loc, kp_glob, slots, valids = [], [], [], []
    for i, (s, K, jcap) in enumerate(segments):
        idx = sk[i, :jcap]
        idx = jnp.where(idx >= maxflat, 0, idx)
        kp = (idx // O).astype(jnp.int32)
        kp_loc.append(kp)
        kp_glob.append(kp + s)
        slots.append((idx % O).astype(jnp.int32))
        valids.append(jnp.arange(jcap, dtype=jnp.int32)
                      < jnp.minimum(ns[i], jcap))
    kpl = jnp.concatenate(kp_loc)
    kpg = jnp.concatenate(kp_glob)
    slot = jnp.concatenate(slots)
    valid = jnp.concatenate(valids)
    counts = jnp.minimum(ns, jnp.asarray([jc for _, _, jc in segments],
                                         jnp.int32))
    jobs = DescriptorJobs(
        x=ext_x[kpg], y=ext_y[kpg], sigma=ext_sigma[kpg],
        level=ext_level[kpg],
        ang=ori[kpg, slot], kp_index=kpl, valid=valid,
        count=jnp.sum(counts))
    return jobs, counts


# --- static tables (sift_constants.cu:34-47) -------------------------------

def _grid_tables():
    step = 1.0 / 8.0
    base = 0.5 * step - 20.0 * step          # -2.4375
    pos = base + np.arange(40) * step        # 40 sample offsets in SBP units
    gx, gy = np.meshgrid(pos, pos)
    ww = np.exp(-0.125 * (gx * gx + gy * gy)).astype(np.float32)

    tile = 1.0 - np.abs(-1.0 + 1.0 / 16.0 + np.arange(16) / 8.0)
    Wt = np.zeros((40, 4), np.float32)       # sample -> tile weight matrix
    for t in range(4):
        for k in range(16):
            Wt[t * 8 + k, t] = tile[k]
    return pos.astype(np.float32), ww, Wt


_GRID_POS, _GRID_WW, _GRID_WT = _grid_tables()


def _bilinear(blur: jnp.ndarray, lvl: jnp.ndarray, xs: jnp.ndarray,
              ys: jnp.ndarray) -> jnp.ndarray:
    """Clamped bilinear sample from a layered image (linear-texture readTex
    semantics). lvl broadcasts against xs/ys."""
    L, H, W = blur.shape
    xs = jnp.clip(xs, 0.0, W - 1.0)
    ys = jnp.clip(ys, 0.0, H - 1.0)
    x0 = jnp.floor(xs).astype(jnp.int32)
    y0 = jnp.floor(ys).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    fx = xs - x0.astype(jnp.float32)
    fy = ys - y0.astype(jnp.float32)
    lvl = jnp.clip(lvl, 0, L - 1)
    v00 = blur[lvl, y0, x0]
    v01 = blur[lvl, y0, x1]
    v10 = blur[lvl, y1, x0]
    v11 = blur[lvl, y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _descriptor_grid_chunk(blur: jnp.ndarray, jobs: DescriptorJobs) -> jnp.ndarray:
    """Unnormalized descriptors for one chunk of jobs, f32[F, 128]."""
    F = jobs.x.shape[0]
    pos = jnp.asarray(_GRID_POS)            # [40]
    ww = jnp.asarray(_GRID_WW)              # [40, 40]
    Wt = jnp.asarray(_GRID_WT)              # [40, 4]

    sbp = jnp.abs(np.float32(DESC_MAGNIFY) * jobs.sigma)[:, None, None]
    cos_t = jnp.cos(jobs.ang)[:, None, None]
    sin_t = jnp.sin(jobs.ang)[:, None, None]
    sx = pos[None, None, :]                  # grid x offsets
    sy = pos[None, :, None]                  # grid y offsets

    px = jobs.x[:, None, None] + (cos_t * sx - sin_t * sy) * sbp
    py = jobs.y[:, None, None] + (cos_t * sy + sin_t * sx) * sbp
    lvl = jobs.level[:, None, None]

    dx = (_bilinear(blur, lvl, px + cos_t, py + sin_t)
          - _bilinear(blur, lvl, px - cos_t, py - sin_t))
    dy = (_bilinear(blur, lvl, px - sin_t, py + cos_t)
          - _bilinear(blur, lvl, px + sin_t, py - cos_t))
    mod = jnp.sqrt(dx * dx + dy * dy)
    th = jnp.arctan2(dy, dx)
    two_pi = np.float32(2.0 * math.pi)
    th = jnp.where(th < 0.0, th + two_pi, th)
    th = jnp.where(th >= two_pi, th - two_pi, th)

    tth = th * np.float32(4.0 / math.pi)
    fo = jnp.floor(tth).astype(jnp.int32)
    frac = tth - fo.astype(jnp.float32)
    fo0 = fo % DESC_BINS
    fo1 = (fo + 1) % DESC_BINS

    wgt = ww[None] * mod                     # [F, 40, 40]
    bins = jnp.arange(DESC_BINS, dtype=jnp.int32)
    contrib = (wgt * (1.0 - frac))[..., None] * (fo0[..., None] == bins) \
        + (wgt * frac)[..., None] * (fo1[..., None] == bins)  # [F,40,40,8]

    hi = jax.lax.Precision.HIGHEST
    t1 = jnp.einsum("fyxb,yi->fixb", contrib, Wt, precision=hi,
                    preferred_element_type=jnp.float32)
    desc = jnp.einsum("fixb,xj->fijb", t1, Wt, precision=hi,
                      preferred_element_type=jnp.float32)   # [F, iy, ix, b]
    desc = desc.reshape(F, 128)
    zero = (sbp[:, 0, 0] == 0.0) | ~jobs.valid
    return jnp.where(zero[:, None], 0.0, desc)


def _descriptor_tilegrid_chunk(blur: jnp.ndarray,
                               jobs: DescriptorJobs) -> jnp.ndarray:
    """True ``grid`` variant (s_desc_grid.cu:19-147): per 4x4 tile a
    16x16 rotated sampling grid whose absolute addresses are *rounded to
    integer pixels* (``pix = round(pt + pix) - pt``), gradients by plain
    axis-aligned central differences at those integer pixels (point
    texture), tile/envelope weights recomputed from the rounded
    position. Unlike igrid, each sample contributes only to its own
    tile. Rounding uses round-half-away-from-zero like CUDA ``round``.
    """
    F = jobs.x.shape[0]
    sbp = jnp.abs(np.float32(DESC_MAGNIFY) * jobs.sigma)    # [F]
    c = jnp.cos(jobs.ang)
    s = jnp.sin(jobs.ang)

    # tile centers in descriptor units: offset = (ix - 1.5, iy - 1.5)
    t_off = jnp.asarray(np.arange(4, dtype=np.float32) - 1.5)
    ox = t_off[None, None, :]                                # [1, 1, 4]
    oy = t_off[None, :, None]                                # [1, 4, 1]
    cB = c[:, None, None]
    sB = s[:, None, None]
    sbpB = sbp[:, None, None]
    # pt = keypoint + rotate(offset) * SBP (tile center, image coords)
    ptx = jobs.x[:, None, None] + (cB * ox - sB * oy) * sbpB  # [F, 4, 4]
    pty = jobs.y[:, None, None] + (cB * oy + sB * ox) * sbpB

    # per-tile sample offsets in rotated units (s_desc_grid.cu:62-72):
    # lft_dn + (xd+0.5)*rgt_stp + (yd+0.5)*up__stp
    half = (jnp.asarray(np.arange(16, dtype=np.float32)) + 0.5) / 8.0
    xd = half[None, :]                                       # [1, 16]
    yd = half[:, None]                                       # [16, 1]
    c5 = c[:, None, None, None, None]
    s5 = s[:, None, None, None, None]
    pixo_x = (-c5 + s5) + c5 * xd - s5 * yd                  # [F,1,1,16,16]
    pixo_y = (-c5 - s5) + s5 * xd + c5 * yd
    sbp5 = sbp[:, None, None, None, None]

    absx = ptx[..., None, None] + pixo_x * sbp5              # [F,4,4,16,16]
    absy = pty[..., None, None] + pixo_y * sbp5
    # CUDA round(): half away from zero
    rx = jnp.sign(absx) * jnp.floor(jnp.abs(absx) + 0.5)
    ry = jnp.sign(absy) * jnp.floor(jnp.abs(absy) + 0.5)

    lvl = jobs.level[:, None, None, None, None]
    # integer-pixel central differences (get_gradiant point overload,
    # s_gradiant.h:55-69; bilinear at integer coords == point read)
    dx = _bilinear(blur, lvl, rx + 1.0, ry) - _bilinear(blur, lvl, rx - 1.0, ry)
    dy = _bilinear(blur, lvl, rx, ry + 1.0) - _bilinear(blur, lvl, rx, ry - 1.0)
    mod = jnp.sqrt(dx * dx + dy * dy)
    th = jnp.arctan2(dy, dx)

    # re-derive descriptor-frame coords from the rounded position
    inv_sbp = jnp.where(sbp5 > 0, 1.0 / jnp.where(sbp5 > 0, sbp5, 1.0), 0.0)
    pxo = (rx - ptx[..., None, None]) * inv_sbp
    pyo = (ry - pty[..., None, None]) * inv_sbp
    nx = c5 * pxo + s5 * pyo                                 # inverse rot
    ny = c5 * pyo - s5 * pxo
    dnx = nx + ox[..., None, None]
    dny = ny + oy[..., None, None]
    ww = jnp.exp(np.float32(-0.125) * (dnx * dnx + dny * dny))
    wx = 1.0 - jnp.abs(nx)
    wy = 1.0 - jnp.abs(ny)
    keep = (wx >= 0.0) & (wy >= 0.0)                         # continue-skip
    wgt = jnp.where(keep, ww * wx * wy * mod, 0.0)

    two_pi = np.float32(2.0 * math.pi)
    tha = th - jobs.ang[:, None, None, None, None]
    tha = jnp.where(tha < 0.0, tha + two_pi, tha)
    tha = jnp.where(tha >= two_pi, tha - two_pi, tha)
    tth = tha * np.float32(4.0 / math.pi)
    fo = jnp.floor(tth).astype(jnp.int32)
    frac = tth - fo.astype(jnp.float32)
    fo0 = fo % DESC_BINS
    fo1 = (fo + 1) % DESC_BINS                # dpt[0] += dpt[8] fold

    cols = []
    for b in range(DESC_BINS):
        cb = wgt * (jnp.where(fo0 == b, 1.0 - frac, 0.0)
                    + jnp.where(fo1 == b, frac, 0.0))
        cols.append(jnp.sum(cb, axis=(-2, -1)))              # [F, 4, 4]
    desc = jnp.stack(cols, axis=-1).reshape(F, 128)          # iy*32+ix*8+b
    zero = (sbp == 0.0) | ~jobs.valid
    return jnp.where(zero[:, None], 0.0, desc)


def _descriptor_iloop_chunk(blur: jnp.ndarray,
                            jobs: DescriptorJobs) -> jnp.ndarray:
    """``iloop`` variant (s_desc_iloop.cu:19-153): per tile, a 32x32
    axis-aligned sample grid spanning the rotated tile's bounding box
    (half-width ``bsz = |cos|+|sin|`` in SBP units); samples whose
    inverse-rotated coords fall outside the tile are skipped; gradients
    by *rotated* central differences through the linear texture
    (get_gradiant cos/sin overload, s_gradiant.h:71-87), so theta is
    already in the rotated frame and ``th -= ang`` is not applied.
    """
    F = jobs.x.shape[0]
    sbp = jnp.abs(np.float32(DESC_MAGNIFY) * jobs.sigma)
    c = jnp.cos(jobs.ang)
    s = jnp.sin(jobs.ang)
    bsz = jnp.abs(c) + jnp.abs(s)                            # [F]

    t_off = jnp.asarray(np.arange(4, dtype=np.float32) - 1.5)
    ox = t_off[None, None, :]
    oy = t_off[None, :, None]
    cB = c[:, None, None]
    sB = s[:, None, None]
    sbpB = sbp[:, None, None]
    ptx = (cB * ox - sB * oy) * sbpB                         # [F, 4, 4]
    pty = (cB * oy + sB * ox) * sbpB

    idx = jnp.asarray(np.arange(32, dtype=np.float32))
    c5 = c[:, None, None, None, None]
    s5 = s[:, None, None, None, None]
    b5 = bsz[:, None, None, None, None]
    dx = -b5 + idx[None, None, None, None, :] * b5 / 16.0    # [F,1,1,1,32]
    dy = -b5 + idx[None, None, None, :, None] * b5 / 16.0    # [F,1,1,32,1]
    nx = c5 * dx + s5 * dy                                   # [F,1,1,32,32]
    ny = c5 * dy - s5 * dx
    keep = (jnp.abs(nx) < 1.0) & (jnp.abs(ny) < 1.0)

    sbp5 = sbp[:, None, None, None, None]
    px = jobs.x[:, None, None, None, None] + ptx[..., None, None] + dx * sbp5
    py = jobs.y[:, None, None, None, None] + pty[..., None, None] + dy * sbp5
    lvl = jobs.level[:, None, None, None, None]

    gdx = (_bilinear(blur, lvl, px + c5, py + s5)
           - _bilinear(blur, lvl, px - c5, py - s5))
    gdy = (_bilinear(blur, lvl, px - s5, py + c5)
           - _bilinear(blur, lvl, px + s5, py - c5))
    mod = jnp.sqrt(gdx * gdx + gdy * gdy)
    th = jnp.arctan2(gdy, gdx)
    two_pi = np.float32(2.0 * math.pi)
    th = jnp.where(th < 0.0, th + two_pi, th)
    th = jnp.where(th >= two_pi, th - two_pi, th)

    dnx = nx + ox[..., None, None]
    dny = ny + oy[..., None, None]
    ww = jnp.exp(np.float32(-0.125) * (dnx * dnx + dny * dny))
    wgt = jnp.where(keep, ww * (1.0 - jnp.abs(nx)) * (1.0 - jnp.abs(ny))
                    * mod, 0.0)

    tth = th * np.float32(4.0 / math.pi)
    fo = jnp.floor(tth).astype(jnp.int32)
    frac = tth - fo.astype(jnp.float32)
    fo0 = fo % DESC_BINS
    fo1 = (fo + 1) % DESC_BINS

    cols = []
    for b in range(DESC_BINS):
        cb = wgt * (jnp.where(fo0 == b, 1.0 - frac, 0.0)
                    + jnp.where(fo1 == b, frac, 0.0))
        cols.append(jnp.sum(cb, axis=(-2, -1)))              # [F, 4, 4]
    desc = jnp.stack(cols, axis=-1).reshape(F, 128)
    zero = (sbp == 0.0) | ~jobs.valid
    return jnp.where(zero[:, None], 0.0, desc)


def loop_patch_radius(cfg: SiftConfig) -> int:
    """Static window bound for the loop variant.

    Used pixels satisfy |n|_inf < 1 per tile, tiles offset up to 1.5, so
    |p - kp|_inf < 2.5*sqrt(2)*SBP (s_desc_loop.cu:58-91). sigma is
    bounded by the verify() step bound sn < maxlevel - 0.5
    (d.z < 1.5 and n.z <= maxlevel-2, s_extrema.cu:271-296).
    """
    sigma_max = cfg.sigma * 2.0 ** ((cfg.total_levels - 1.5) / cfg.levels)
    sbp_max = DESC_MAGNIFY * sigma_max
    return int(math.ceil(2.5 * math.sqrt(2.0) * sbp_max)) + 2


def _descriptor_loop_chunk(img: jnp.ndarray, orig_hw, jobs: DescriptorJobs,
                           radius: int, y_bounds=None) -> jnp.ndarray:
    """Dense pixel-scan (loop variant, s_desc_loop.cu:19-138) over one
    contiguous patch per job: gradient at integer pixels by central
    differences, global rotated coordinates, per-tile triangular weights
    folded into 8 per-bin [P^2,4]x[4] matmuls. No scalar gathers."""
    H, W = orig_hw
    F = jobs.x.shape[0]
    P = 2 * radius + 1

    xr = jnp.round(jobs.x).astype(jnp.int32)
    yr = jnp.round(jobs.y).astype(jnp.int32)
    patches, y0, x0 = extract_patches(img, jobs.level, yr, xr, radius)

    ii = jnp.arange(P, dtype=jnp.int32)
    px = x0[:, None, None] + ii[None, None, :]      # [F, P, P] image coords
    py = y0[:, None, None] + ii[None, :, None]

    # gradient at integer pixels (s_gradiant.h:55-69); border cells of the
    # patch are outside every valid window, so circular roll is safe
    dxv = jnp.roll(patches, -1, axis=2) - jnp.roll(patches, 1, axis=2)
    dyv = jnp.roll(patches, -1, axis=1) - jnp.roll(patches, 1, axis=1)
    mod = jnp.sqrt(dxv * dxv + dyv * dyv)
    th = jnp.arctan2(dyv, dxv)

    sbp = jnp.abs(np.float32(DESC_MAGNIFY) * jobs.sigma)
    inv_sbp = jnp.where(sbp > 0, 1.0 / jnp.where(sbp > 0, sbp, 1.0), 0.0)
    cos_t = jnp.cos(jobs.ang)
    sin_t = jnp.sin(jobs.ang)
    crsbp = (cos_t * inv_sbp)[:, None, None]
    srsbp = (sin_t * inv_sbp)[:, None, None]

    fdx = px.astype(jnp.float32) - jobs.x[:, None, None]
    fdy = py.astype(jnp.float32) - jobs.y[:, None, None]
    nxg = crsbp * fdx + srsbp * fdy                 # global rotated coords
    nyg = crsbp * fdy - srsbp * fdx

    # scan bounds (xmin/xmax clamp to [1, W-2], s_desc_loop.cu:68-71);
    # y_bounds carries the global-row translation for sharded row bands
    if y_bounds is None:
        y_lo, y_hi = 1, H - 2
    else:
        y_lo, y_hi = y_bounds
    inb = (px >= 1) & (px <= W - 2) & (py >= y_lo) & (py <= y_hi)

    two_pi = np.float32(2.0 * math.pi)
    tha = th - jobs.ang[:, None, None]
    tha = jnp.where(tha < 0.0, tha + two_pi, tha)
    tha = jnp.where(tha >= two_pi, tha - two_pi, tha)
    tth = tha * np.float32(4.0 / math.pi)
    fo = jnp.floor(tth).astype(jnp.int32)
    frac = tth - fo.astype(jnp.float32)
    fo0 = fo % DESC_BINS
    fo1 = (fo + 1) % DESC_BINS

    ww = jnp.exp(np.float32(-0.125) * (nxg * nxg + nyg * nyg))
    wgt = jnp.where(inb, ww * mod, 0.0)             # [F, P, P]

    # per-tile triangular weights from global rotated coords
    centers = jnp.asarray(np.arange(4, dtype=np.float32) - 1.5)
    ax = jnp.abs(nxg[..., None] - centers)          # [F, P, P, 4]
    ay = jnp.abs(nyg[..., None] - centers)
    wx = jnp.where(ax < 1.0, 1.0 - ax, 0.0).reshape(F, P * P, 4)
    wy = jnp.where(ay < 1.0, 1.0 - ay, 0.0).reshape(F, P * P, 4)

    wgt_f = wgt.reshape(F, P * P)
    fo0f = fo0.reshape(F, P * P)
    fo1f = fo1.reshape(F, P * P)
    fracf = frac.reshape(F, P * P)

    cols = []
    for b in range(DESC_BINS):
        cb = wgt_f * (jnp.where(fo0f == b, 1.0 - fracf, 0.0)
                      + jnp.where(fo1f == b, fracf, 0.0))   # [F, P^2]
        # desc_b[ty, tx] = sum_p wy[p,ty] * cb[p] * wx[p,tx]
        a = jnp.einsum("fpi,fpj->fij", wy * cb[..., None], wx,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)  # [F, 4, 4]
        cols.append(a)
    desc = jnp.stack(cols, axis=-1)                 # [F, ty, tx, 8]
    desc = desc.reshape(F, 128)
    zero = (sbp == 0.0) | ~jobs.valid
    return jnp.where(zero[:, None], 0.0, desc)


def _loop_descriptors(blur: jnp.ndarray, jobs: DescriptorJobs,
                      cfg: SiftConfig, chunk: int, y_bounds,
                      impl: str | None) -> jnp.ndarray:
    """The one place that picks how the loop variant runs.

    ``impl=None``: the Triton kernel (ops/pallas/desc.py) where the
    program is lowered for a CUDA GPU, the plain XLA reference
    (:func:`_descriptor_loop_chunk`) everywhere else. The choice is made
    per platform at lowering time, so one jitted function gives the
    kernel on the card and the reference on the host CPU. ``"kernel"``
    or ``"xla"`` forces one (A/B runs, interpret-mode tests). A kernel
    that fails to compile fails the run; nothing falls back.
    """
    from .pallas.desc import descriptor_loop_triton

    radius = loop_patch_radius(cfg)

    def kernel():
        return descriptor_loop_triton(blur, jobs, radius,
                                      y_bounds=y_bounds)

    def xla():
        img = pad_for_patches(blur, 2 * radius + 1)
        return _chunked(
            lambda j: _descriptor_loop_chunk(img, blur.shape[-2:], j,
                                             radius, y_bounds=y_bounds),
            jobs, min(chunk, 256))  # loop patches are ~P^2 * 6 floats each

    if impl == "kernel":
        return kernel()
    if impl == "xla":
        return xla()
    if impl is not None:
        raise ValueError(f"impl must be None, 'kernel' or 'xla': {impl!r}")
    return jax.lax.platform_dependent(cuda=kernel, default=xla)


def _chunked(body_fn, jobs: DescriptorJobs, chunk: int) -> jnp.ndarray:
    """Evaluate ``body_fn`` over the job list in chunks under lax.map."""
    F = jobs.x.shape[0]
    if F <= chunk:
        return body_fn(jobs)
    nchunk = -(-F // chunk)
    pad = nchunk * chunk - F

    def prep(a):
        return jnp.pad(a, [(0, pad)]).reshape(nchunk, chunk)

    fields = tuple(prep(v) for v in
                   (jobs.x, jobs.y, jobs.sigma, jobs.level, jobs.ang,
                    jobs.kp_index, jobs.valid))

    def body(f):
        x, y, sigma, level, ang, kp, valid = f
        j = DescriptorJobs(x=x, y=y, sigma=sigma, level=level, ang=ang,
                           kp_index=kp, valid=valid,
                           count=jnp.sum(valid, dtype=jnp.int32))
        return body_fn(j)

    out = jax.lax.map(body, fields)
    return out.reshape(nchunk * chunk, 128)[:F]


def compute_descriptors(blur: jnp.ndarray, jobs: DescriptorJobs,
                        cfg: SiftConfig, chunk: int = 1024,
                        y_bounds=None,
                        impl: str | None = None) -> jnp.ndarray:
    """Unnormalized descriptors f32[F, 128].

    Variant dispatch (DescMode, sift_conf.h:59-65), each name mapping to
    its reference-distinct semantics:

    * ``loop``  — dense integer-pixel scan (s_desc_loop.cu): the Triton
      kernel on a GPU, the XLA reference elsewhere
      (:func:`_loop_descriptors`, which ``impl`` is passed to);
    * ``iloop`` — per-tile bbox scan with rotated-offset bilinear
      gradients (s_desc_iloop.cu);
    * ``grid``  — per-tile 16x16 rotated grid at *rounded* pixel
      addresses (s_desc_grid.cu);
    * ``igrid``/``notile`` — fixed 40x40 rotated grid with bilinear
      rotated gradients; notile is igrid with the redundant fetches
      deduplicated — identical sample positions, tables and math
      (s_desc_igrid.cu:19-108 vs s_desc_notile.cu:31-95), hence one
      implementation here.

    ``y_bounds=(lo, hi)`` (loop variant only): inclusive valid row range
    of a sharded row band, in local coordinates.
    """
    if cfg.desc_mode == "loop":
        return _loop_descriptors(blur, jobs, cfg, chunk, y_bounds, impl)
    if cfg.desc_mode == "iloop":
        # 16 tiles x 32x32 samples per job
        return _chunked(lambda j: _descriptor_iloop_chunk(blur, j), jobs,
                        min(chunk, 64))
    if cfg.desc_mode == "grid":
        # 16 tiles x 16x16 samples per job
        return _chunked(lambda j: _descriptor_tilegrid_chunk(blur, j),
                        jobs, min(chunk, 128))
    return _chunked(lambda j: _descriptor_grid_chunk(blur, j), jobs, chunk)


def normalize_descriptors(desc: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """RootSift (s_desc_norm_rs.h:44-80) or classic L2 with 0.2 clamp
    (s_desc_norm_l2.h:85-131); both scaled by 2^norm_multiplier."""
    mult = np.float32(2.0 ** cfg.norm_multiplier)
    if cfg.norm_mode == "rootsift":
        s = jnp.sum(desc, axis=-1, keepdims=True)
        s = jnp.where(s == 0.0, 1.0, s)
        return jnp.sqrt(jnp.maximum(desc, 0.0) / s) * mult
    n = jnp.sqrt(jnp.sum(desc * desc, axis=-1, keepdims=True))
    clamped = jnp.minimum(desc, 0.2 * n)
    n2 = jnp.sum(clamped * clamped, axis=-1, keepdims=True)
    n2 = jnp.where(n2 == 0.0, 1.0, n2)
    return clamped * jax.lax.rsqrt(n2) * mult
