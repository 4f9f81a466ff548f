"""Gaussian scale-space pyramid construction in JAX.

Re-design of the reference pyramid builder
(/root/reference/src/popsift/s_pyramid_build*.cu). The CUDA version is a
texture/stream/surface machine; here each octave is a dense
``f32[L, H, W]`` array and the whole pyramid is one XLA program:

* textures + hardware bilinear   -> explicit resample (gather-free: the
  upscale is a separable lerp expressed with static slices)
* per-octave CUDA streams/events -> XLA program order; parallelism comes
  from batching images, not streams
* ``__constant__`` filter tables -> trace-time constants baked into HLO

Semantics reproduced exactly (given float32):

* octave-0 level-0 built straight from the input image with the dd[0]
  filter sampled in *source* space with the sub-pixel shift convention
  (gauss::normalizedSource::horiz, s_pyramid_build_ra.cu:18-55;
  shift = 0.5 * 2^upscale for PopSift/VLFeat, s_pyramid_build.cu:109-123),
  then a vertical pass with inc[0] (s_pyramid_build.cu:546-556).
* levels 1..L-1 by incremental separable blur with clamped (edge
  replicated) borders (gauss::absoluteSource::{horiz,vert},
  s_pyramid_build_aa.cu:17-92).
* octave o>0 level 0 decimated 2x from level L-3 of the previous octave
  (get_by_2_pick_every_second, s_pyramid_build.cu:49-71).
* DoG layers dog[l] = blur[l+1] - blur[l] (make_dog,
  s_pyramid_build.cu:74-92).
* the pyramid is stored in 0..255 scale (out*255,
  s_pyramid_build_ra.cu:54).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SiftConfig
from ..gauss import GaussTables, build_gauss_tables, full_kernel


@dataclass(frozen=True)
class PyramidPlan:
    """Static shape/filter data for one (config, input size) pair."""

    config: SiftConfig
    in_h: int
    in_w: int
    dims: tuple            # ((h, w), ...) per octave
    shift0: float          # sub-pixel shift for octave-0 sampling

    # numpy filter banks (trace-time constants)
    inc_kernels: tuple     # full symmetric kernels per level
    absN_kernels: tuple    # level0 -> levelN kernels (relative-all/fixed)
    dd_kernels: tuple      # direct-downscale kernels per octave
    lvl0_kernel_x: np.ndarray  # dd[0] full kernel (horizontal from input)
    lvl0_kernel_y: np.ndarray  # inc[0] full kernel (vertical from interm)
    abs0_kernels: tuple = ()   # input -> octave-0 levelN (fixed modes)


def build_pyramid_plan(config: SiftConfig, height: int, width: int,
                       tables: GaussTables | None = None) -> PyramidPlan:
    if tables is None:
        tables = build_gauss_tables(config)
    if (config.sift_mode in ("popsift", "vlfeat")
            or config.gauss_mode in ("fixed9", "fixed15")):
        # fixed modes always use tshift = 0.5 * 2^upscale
        # (s_pyramid_fixed.cu:236) regardless of the sift mode
        shift0 = 0.5 * (2.0 ** config.upscale_factor)
    else:
        shift0 = 0.5
    inc_kernels = tuple(
        full_kernel(tables.inc[l], int(tables.inc_span[l]))
        for l in range(config.total_levels))
    absN_kernels = tuple(
        full_kernel(tables.abs_oN[l], int(tables.abs_oN_span[l]))
        for l in range(config.total_levels))
    n_oct = config.num_octaves_for(width, height)
    dd_kernels = tuple(
        full_kernel(tables.dd[o], int(tables.dd_span[o]))
        for o in range(n_oct))
    return PyramidPlan(
        config=config,
        in_h=height,
        in_w=width,
        dims=tuple(config.octave_dims(width, height)),
        shift0=shift0,
        inc_kernels=inc_kernels,
        absN_kernels=absN_kernels,
        dd_kernels=dd_kernels,
        lvl0_kernel_x=full_kernel(tables.dd[0], int(tables.dd_span[0])),
        lvl0_kernel_y=full_kernel(tables.inc[0], int(tables.inc_span[0])),
        abs0_kernels=tuple(
            full_kernel(tables.abs_o0[l], int(tables.abs_o0_span[l]))
            for l in range(config.total_levels)),
    )


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _input_as_float(img: jnp.ndarray) -> jnp.ndarray:
    """Input normalization per image mode (popsift.cpp:143-148 dispatch):
    uint8 reads through a normalized-float texture (val/255,
    s_image.cu:140-169); float32 input (ImageFloat, s_image.cu:264-293)
    reads element values as-is — callers feed [0, 1] floats and the
    pyramid's out*255 scaling (s_pyramid_build_ra.cu:54) applies to both.
    """
    if img.dtype == jnp.uint8:
        return img.astype(jnp.float32) / 255.0
    return img.astype(jnp.float32)


def _lerp_rows(img: jnp.ndarray, pos: np.ndarray) -> jnp.ndarray:
    """Resample axis 0 of ``img`` at (static numpy) positions ``pos`` with
    clamp-to-edge. Positions are trace-time constants, so this lowers to
    two static gathers + one fma — no dynamic gather."""
    n = img.shape[0]
    p = np.clip(pos, 0.0, n - 1.0)
    i0 = np.floor(p).astype(np.int32)
    i1 = np.minimum(i0 + 1, n - 1)
    f = jnp.asarray((p - i0).astype(np.float32))
    shape = (-1,) + (1,) * (img.ndim - 1)
    return img[i0] * (1.0 - f.reshape(shape)) + img[i1] * f.reshape(shape)


def _conv1d_valid(x: jnp.ndarray, kernel: np.ndarray, axis: int) -> jnp.ndarray:
    """Valid-mode symmetric 1-D convolution along ``axis`` as an explicit
    shift-and-add stencil.

    Not lax.conv: a default-precision convolution may run with reduced
    precision multiplies, which costs ~3 decimal digits — fatal for DoG
    thresholding. The shift-add form stays in f32, fuses with its
    neighbours, and exploits kernel symmetry (half the multiplies),
    mirroring the reference's paired-tap loop
    (s_pyramid_build_aa.cu:35-49).

    Slices run along ``axis`` in place (no moveaxis), so no output
    materializes transposed."""
    klen = kernel.shape[0]
    span = (klen + 1) // 2           # center + one-sided taps
    n = x.shape[axis]
    nout = n - klen + 1
    center = span - 1

    def sl(s):
        return jax.lax.slice_in_dim(x, s, s + nout, axis=axis)

    out = sl(center) * float(kernel[center])
    for off in range(1, span):
        out = out + (sl(center - off) + sl(center + off)
                     ) * float(kernel[center + off])
    return out


def _sep_blur(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Separable blur with edge-replication borders (readTex clamp
    semantics, s_pyramid_build_aa.cu:31-48)."""
    pad = (kernel.shape[0] - 1) // 2
    x = jnp.pad(img, ((0, 0), (pad, pad)), mode="edge")
    x = _conv1d_valid(x, kernel, axis=1)
    x = jnp.pad(x, ((pad, pad), (0, 0)), mode="edge")
    x = _conv1d_valid(x, kernel, axis=0)
    return x


def _phase_kernels(kernel: np.ndarray):
    """Polyphase decomposition of (2x linear upsample -> conv ``kernel``)
    along one axis.

    With up[2q] = img[q], up[2q+1] = (img[q] + img[q+1])/2 and
    out[p] = sum_u up[p - S + u] * kernel[u], the output phases are
    direct convolutions of the *source*:
        out[2j + phi] = sum_d img[j + d] * K_phi[d].
    Returns ((K0, q0min), (K1, q1min)) as numpy arrays over d offsets.
    """
    S = (kernel.shape[0] - 1) // 2
    out = []
    for phi in (0, 1):
        taps = {}
        for u in range(kernel.shape[0]):
            t = phi - S + u
            if t % 2 == 0:
                taps[t // 2] = taps.get(t // 2, 0.0) + float(kernel[u])
            else:
                lo = (t - 1) // 2
                taps[lo] = taps.get(lo, 0.0) + 0.5 * float(kernel[u])
                taps[lo + 1] = taps.get(lo + 1, 0.0) + 0.5 * float(kernel[u])
        qmin, qmax = min(taps), max(taps)
        arr = np.zeros(qmax - qmin + 1, np.float64)
        for d, v in taps.items():
            arr[d - qmin] = v
        out.append((arr.astype(np.float32), qmin))
    return tuple(out)


def _conv1d_asym(x: jnp.ndarray, taps: np.ndarray, qmin: int, pad: int,
                 axis: int) -> jnp.ndarray:
    """out[j] = sum_d x_padded[j + pad + qmin + (d - qmin)] * taps[...] —
    valid conv with an asymmetric kernel on an already-padded input.
    ``pad`` is the padding that was applied on both sides of ``axis``.
    In-place slicing along ``axis`` (see _conv1d_valid's layout note)."""
    n = x.shape[axis] - 2 * pad
    out = None
    for i in range(taps.shape[0]):
        off = pad + qmin + i
        term = jax.lax.slice_in_dim(x, off, off + n, axis=axis) \
            * float(taps[i])
        out = term if out is None else out + term
    return out


def _upsample2_axis(img: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Exact 2x upsample along ``axis`` for the PopSift/VLFeat sampling
    grid: with shift = 2^upscale * 0.5 = 1.0 and ratio 1/2, destination
    position p maps to source (p + 1) * 0.5 - 0.5 = p/2 — even outputs
    are source pixels, odd outputs are midpoints. Pure slicing +
    interleave, no gather."""
    x = jnp.moveaxis(img, axis, 0)
    n = x.shape[0]
    nxt = jnp.concatenate([x[1:], x[-1:]], axis=0)   # clamp last
    mid = 0.5 * (x + nxt)
    out = jnp.stack([x, mid], axis=1).reshape((2 * n,) + x.shape[1:])
    return jnp.moveaxis(out, 0, axis)


def _row_interleave(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[H, W] x2 -> [2H, W] alternating rows. stack(axis=1) produces
    [H, 2, W], whose row-major layout equals [2H, W]: the reshape is
    free, so this costs one concat-like copy."""
    H, W = a.shape
    return jnp.stack([a, b], axis=1).reshape(2 * H, W)


def _interleave2x2(planes) -> jnp.ndarray:
    """planes[py][px] f32[H, W] -> f32[2H, 2W]. The minor-dim
    interleave is done as transpose -> row interleave -> transpose, so
    every reshape is layout-free."""
    (p00, p01), (p10, p11) = planes
    q0 = _row_interleave(p00, p10)          # [2H, W]
    q1 = _row_interleave(p01, p11)
    return _row_interleave(q0.T, q1.T).T    # [2H, 2W]


def _decimate2(x: jnp.ndarray) -> jnp.ndarray:
    """Pick every second pixel (get_by_2_pick_every_second,
    s_pyramid_build.cu:49-71), as two row-axis strided slices with a
    transpose between."""
    r = x[0::2, :]
    return r.T[0::2, :].T


def _decimate2_interpolate(x: jnp.ndarray, oh: int, ow: int) -> jnp.ndarray:
    """get_by_2_interpolate (s_pyramid_build.cu:33-49): the linear
    texture fetch at (2x+1, 2y+1) lands exactly on texel (2x+1, 2y+1)
    (readTex adds 0.5; frac == 0), so this is odd-pixel decimation with
    edge clamping for odd-sized sources."""
    r = x[1::2, :]
    if r.shape[0] < oh:
        r = jnp.concatenate([r, x[-1:, :]], axis=0)
    rt = r.T
    c = rt[1::2, :]
    if c.shape[0] < ow:
        c = jnp.concatenate([c, rt[-1:, :]], axis=0)
    return c.T


def _octave_lvl0_from_input(img_u8: jnp.ndarray, plan: PyramidPlan,
                            octv: int) -> jnp.ndarray:
    """Direct-scaling path (ScalingMode ScaleDirect): build octave
    ``octv`` level 0 straight from the input image with the per-octave
    dd filter (gauss::normalizedSource + dd table,
    s_pyramid_build.cu:126-160, gauss_filter.cu:227-237). Uses the
    generic resample (gathers) — direct mode trades speed for accuracy
    exactly as the reference documents."""
    oh, ow = plan.dims[octv]
    sh, sw = plan.in_h, plan.in_w
    img = _input_as_float(img_u8)
    kx = plan.dd_kernels[octv]
    pad = (kx.shape[0] - 1) // 2
    ry = sh / oh
    rx = sw / ow
    ys = (np.arange(oh, dtype=np.float64) + plan.shift0) * ry - 0.5
    xs = (np.arange(-pad, ow + pad, dtype=np.float64)
          + plan.shift0) * rx - 0.5
    r = _lerp_rows(img, ys)
    r = _lerp_rows(r.T, xs).T
    out = _conv1d_valid(r, kx, axis=1) * 255.0
    ky = plan.lvl0_kernel_y
    pady = (ky.shape[0] - 1) // 2
    out = jnp.pad(out, ((pady, pady), (0, 0)), mode="edge")
    return _conv1d_valid(out, ky, axis=0)


def _octave0_level0(img_u8: jnp.ndarray, plan: PyramidPlan,
                    kx: np.ndarray | None = None,
                    ky: np.ndarray | None = None) -> jnp.ndarray:
    """Build an octave-0 level directly from the input image.

    Horizontal: resample rows at source positions
    (x + shift) * (src/dst) - 0.5 for an extended x range, then valid-mode
    convolve with ``kx`` (default dd[0]) — exactly equivalent to the
    reference's normalized-coordinate taps spaced one destination pixel
    apart (s_pyramid_build_ra.cu:37-53), including source-space clamping.
    Vertical: ``ky`` (default inc[0]) with destination-space clamping
    (s_pyramid_build.cu:553-556 -> absoluteSource::vert).

    The fixed9/fixed15 path passes ``kx == ky == abs_o0[level]`` — the
    reference's relativeTexAddress::octave_fixed applies the same
    absolute filter in both axes (s_pyramid_fixed.cu:129-203).
    """
    oh, ow = plan.dims[0]
    sh, sw = plan.in_h, plan.in_w
    img = _input_as_float(img_u8)

    if kx is None:
        kx = plan.lvl0_kernel_x
    if ky is None:
        ky = plan.lvl0_kernel_y
    pad = (kx.shape[0] - 1) // 2

    if oh == 2 * sh and ow == 2 * sw and plan.shift0 == 1.0:
        # Default 2x upscale (PopSift/VLFeat shift convention): the
        # sample grid degenerates to pixels + midpoints, so the whole
        # (upsample -> dd0 horiz conv -> inc0 vert conv) chain is a
        # polyphase filter bank: four quarter-res planes computed by
        # small convs on the *source* image, assembled by one
        # interleave (rows first + transposes keeps every reshape
        # layout-free).

        kxp = _phase_kernels(kx * 255.0)
        kyp = _phase_kernels(ky)
        px_pad = max(max(abs(q), abs(q + t.shape[0] - 1))
                     for t, q in kxp)
        py_pad = max(max(abs(q), abs(q + t.shape[0] - 1))
                     for t, q in kyp)
        imgp = jnp.pad(img, ((py_pad, py_pad), (px_pad, px_pad)),
                       mode="edge")
        planes = []
        for ky_t, ky_q in kyp:
            row = []
            for kx_t, kx_q in kxp:
                p = _conv1d_asym(imgp, kx_t, kx_q, px_pad, axis=1)
                p = _conv1d_asym(p, ky_t, ky_q, py_pad, axis=0)
                row.append(p)
            planes.append(tuple(row))
        return _interleave2x2(tuple(planes))
    else:
        ry = sh / oh
        rx = sw / ow
        ys = (np.arange(oh, dtype=np.float64) + plan.shift0) * ry - 0.5
        xs = (np.arange(-pad, ow + pad, dtype=np.float64)
              + plan.shift0) * rx - 0.5
        r = _lerp_rows(img, ys)                    # [oh, sw]
        r = _lerp_rows(r.T, xs).T                  # [oh, ow + 2*pad]
    out = _conv1d_valid(r, kx, axis=1) * 255.0     # [oh, ow]

    pady = (ky.shape[0] - 1) // 2
    out = jnp.pad(out, ((pady, pady), (0, 0)), mode="edge")
    return _conv1d_valid(out, ky, axis=0)


def build_pyramid(img_u8: jnp.ndarray, plan: PyramidPlan):
    """Full pyramid. Returns (blurs, dogs): tuples over octaves of
    f32[L, H, W] and f32[L-1, H, W]."""
    cfg = plan.config
    total = cfg.total_levels
    # strategy branches mirroring build_pyramid's dispatch
    # (s_pyramid_build.cu:460-596): direct scaling builds every octave's
    # level 0 from the input; VLFeat_Relative_All blurs every level from
    # level 0 with the absolute filters; default is incremental.
    direct = cfg.scaling_mode == "direct"
    relative_all = cfg.gauss_mode == "vlfeat-relative-all"
    fixed = cfg.gauss_mode in ("fixed9", "fixed15")
    blurs, dogs = [], []
    prev_ds_level = None

    def downscale(prev, oh, ow):
        if cfg.downscale_mode == "interpolate":
            return _decimate2_interpolate(prev, oh, ow)
        return _decimate2(prev)[:oh, :ow]

    for octv, (oh, ow) in enumerate(plan.dims):
        if fixed and octv == 0:
            # Fixed9/Fixed15 fused-octave semantics
            # (s_pyramid_fixed.cu:202-288): octave 0 builds EVERY level
            # straight from the input with the absolute abs_o0 filters
            # (same fixed-span filter both axes); octaves >0 downscale
            # level 0 then build levels 1..5 from level 0 with abs_oN.
            levels = [
                _octave0_level0(img_u8, plan, kx=plan.abs0_kernels[l],
                                ky=plan.abs0_kernels[l])
                for l in range(total)]
        else:
            if octv == 0:
                lvl0 = _octave0_level0(img_u8, plan)
            elif direct:
                lvl0 = _octave_lvl0_from_input(img_u8, plan, octv)
            else:
                lvl0 = downscale(prev_ds_level, oh, ow)
            levels = [lvl0]
            for lvl in range(1, total):
                if fixed or relative_all:
                    levels.append(_sep_blur(lvl0, plan.absN_kernels[lvl]))
                else:
                    levels.append(_sep_blur(levels[-1],
                                            plan.inc_kernels[lvl]))
        # DoG layers from adjacent levels (make_dog, s_pyramid_build.cu:74-92)
        blur = jnp.stack(levels)
        blurs.append(blur)
        dogs.append(blur[1:] - blur[:-1])
        prev_ds_level = levels[total - 3]
    return tuple(blurs), tuple(dogs)
