"""Spatial (sequence-parallel analog) sharding: very large frames split
across devices by rows, with halo exchange between neighbours.

SURVEY.md section 2.7: the reference handles large inputs only by
downsampling (sift_conf.h:179-184); this framework shards the image
axis instead — the moral equivalent of ring attention for stencil ops.
Each device holds a contiguous row band; every separable blur exchanges
a halo of boundary rows with its mesh neighbors via ``lax.ppermute``
before convolving, so results are bit-identical to the single-device
pyramid (interior bands; the global top/bottom keep edge-replication).

Round 2 extends this front to the FULL pipeline
(:func:`make_sharded_extract_fn`): sharded upscale + pyramid + DoG +
candidate mask + refinement per row band (global row coordinates carried
through ``detect_extrema(row_window=...)``), per-band orientation and
descriptor stages on halo'd blur bands, and ``all_gather`` of the tiny
per-band feature arrays — so a frame whose pyramid exceeds one device's
HBM never materializes on any single device. Octaves too small to shard
profitably (band < the keypoint-stage halo) run replicated from an
``all_gather`` of the decimated seed level; they hold <~6% of the pixels.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SiftConfig
from ..gauss import full_kernel
from ..ops.pyramid import _conv1d_valid


def _exchange_halo(x: jnp.ndarray, halo: int, axis_name: str):
    """Append ``halo`` rows from each row-band neighbor (edge-replicate
    at the global top/bottom). x: [Hs, W] -> [Hs + 2*halo, W]."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    down = [(i, (i + 1) % n) for i in range(n)]   # send my rows downward
    up = [(i, (i - 1) % n) for i in range(n)]

    from_above = jax.lax.ppermute(x[-halo:], axis_name, down)
    from_below = jax.lax.ppermute(x[:halo], axis_name, up)
    # global borders: replicate own edge rows instead of wrapping
    top_edge = jnp.broadcast_to(x[:1], (halo,) + x.shape[1:])
    bot_edge = jnp.broadcast_to(x[-1:], (halo,) + x.shape[1:])
    top = jnp.where(idx == 0, top_edge, from_above)
    bot = jnp.where(idx == n - 1, bot_edge, from_below)
    return jnp.concatenate([top, x, bot], axis=0)


def _sharded_blur(x: jnp.ndarray, kernel: np.ndarray, axis_name: str):
    """Separable blur of a row-sharded image with halo exchange."""
    pad = (kernel.shape[0] - 1) // 2
    xh = jnp.pad(x, ((0, 0), (pad, pad)), mode="edge")
    xh = _conv1d_valid(xh, kernel, axis=1)       # horizontal: no halo
    xh = _exchange_halo(xh, pad, axis_name)      # vertical halo exchange
    return _conv1d_valid(xh, kernel, axis=0)


def make_sharded_pyramid_fn(cfg: SiftConfig, height: int, width: int,
                            mesh: Mesh, axis_name: str = "sp"):
    """Jitted fn: f32[H, W] (row-sharded) -> (blurs, dogs) of octave 0,
    all row-sharded over the mesh. H must divide by the mesh size.

    Octave 0 only — coarser octaves fit on one device and are built from
    the gathered level L-3 by the regular pipeline. The caller provides
    the already upscaled-and-prefiltered level-0 image (or the raw frame
    when no upscale is used)."""
    from ..gauss import build_gauss_tables

    tables = build_gauss_tables(cfg)
    kernels = tuple(
        full_kernel(tables.inc[l], int(tables.inc_span[l]))
        for l in range(cfg.total_levels))
    n = mesh.shape[axis_name]
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh {n}")
    max_halo = max((k.shape[0] - 1) // 2 for k in kernels[1:])
    if height // n < max_halo:
        raise ValueError(
            f"row band {height // n} smaller than the largest blur halo "
            f"{max_halo}; use fewer shards for this frame size")

    def local(lvl0):
        levels = [lvl0]
        dogs = []
        for lvl in range(1, cfg.total_levels):
            levels.append(_sharded_blur(levels[-1], kernels[lvl],
                                        axis_name))
            dogs.append(levels[-1] - levels[-2])
        return jnp.stack(levels), jnp.stack(dogs)

    spec = P(axis_name, None)
    mapped = shard_map(local, mesh=mesh, in_specs=(spec,),
                       out_specs=(P(None, axis_name, None),
                                  P(None, axis_name, None)))
    return jax.jit(mapped)


# ---------------------------------------------------------------------------
# Full spatially-sharded extraction
# ---------------------------------------------------------------------------

def _exchange_halo_rows(x: jnp.ndarray, halo: int, axis_name: str,
                        axis: int = 0) -> jnp.ndarray:
    """Halo exchange along ``axis`` (rows live on different devices)."""
    if axis == 0:
        return _exchange_halo(x, halo, axis_name)
    xm = jnp.moveaxis(x, axis, 0)
    xm = _exchange_halo(xm, halo, axis_name)
    return jnp.moveaxis(xm, 0, axis)


def shardable_octaves(plan, n: int, min_band: int) -> int:
    """Number of leading octaves whose row dimension divides the mesh and
    whose per-device band can host the keypoint-stage halos.

    A sharded octave that must seed the next octave additionally needs an
    even band height so per-band decimation picks exactly the global even
    rows."""
    dims = plan.pyramid.dims
    S = 0
    for o, (oh, ow) in enumerate(dims):
        if oh % n or (oh // n) < min_band:
            break
        if o < len(dims) - 1 and (oh // n) % 2:
            break      # cannot seed octave o+1 from an odd band
        S += 1
    return S


def make_sharded_extract_fn(cfg: SiftConfig, height: int, width: int,
                            mesh: Mesh, axis_name: str = "sp",
                            octave_caps: tuple | None = None,
                            desc_chunk: int = 1024,
                            _as_local: bool = False):
    """Jitted fn: uint8[H, W] (row-sharded over ``mesh``) -> SiftFeatures
    (replicated), numerically matching the single-device ``extract``.

    The whole pipeline runs inside one ``shard_map``:

    1. octave-0 level 0 from the device's input band (polyphase 2x
       upscale or identity grid) with input-row halo exchange;
    2. per-octave incremental blurs + DoG via halo-exchange stencils
       (bit-identical to the dense pyramid in band interiors, and at the
       global borders by edge-replication in `_exchange_halo`);
    3. per-band candidate mask + refinement with global row coordinates
       (``detect_extrema(row_window=...)``) — each device detects only
       rows it owns, reading the DoG halo for the stencil and the
       refinement window;
    4. global grid filter on the ``all_gather``-ed (tiny) extrema;
    5. orientation + descriptors per band on a fat-halo'd blur band
       (halo >= the widest keypoint window), then ``all_gather`` of the
       per-band feature/descriptor arrays;
    6. octaves whose band would be smaller than the keypoint halo run
       replicated from an all-gathered seed level (they hold <~6% of
       the pixels).

    Limitations (ValueError): indirect scaling, non-fixed gauss modes,
    upscale factor 0 or 1, H divisible by the mesh size.
    """
    from ..ops.descriptors import (
        compute_descriptors, loop_patch_radius, make_descriptor_jobs,
        normalize_descriptors)
    from ..ops.extrema import detect_extrema
    from ..ops.gridfilter import maybe_grid_filter
    from ..ops.orientation import assign_orientations, max_ori_radius
    from ..ops.pyramid import (
        _conv1d_asym, _decimate2, _input_as_float, _interleave2x2,
        _phase_kernels, _sep_blur)
    from ..pipeline import SiftFeatures, build_extract_plan

    plan = build_extract_plan(cfg, height, width, octave_caps=octave_caps)
    n = mesh.shape[axis_name]
    if cfg.scaling_mode != "indirect" or cfg.gauss_mode in ("fixed9",
                                                            "fixed15"):
        raise ValueError("sharded extract supports indirect scaling with "
                         "incremental/relative gauss modes")
    if height % n:
        raise ValueError(f"input height {height} not divisible by mesh {n}")

    oh0, ow0 = plan.pyramid.dims[0]
    upscale2 = (oh0 == 2 * height and ow0 == 2 * width
                and plan.pyramid.shift0 == 1.0)
    identity = (oh0 == height and ow0 == width)
    if not (upscale2 or identity):
        raise ValueError("sharded extract supports upscale factor 1 "
                         "(default 2x) or 0")

    # keypoint-stage halo: widest window any stage reads around a keypoint
    hk = max(max_ori_radius(cfg) + 2, loop_patch_radius(cfg) + 1)
    hd = 6          # refine window (5 = MAX_ITERATIONS) + mask stencil
    S = shardable_octaves(plan, n, min_band=max(hk, 2 * hd))
    if S == 0:
        raise ValueError(
            f"band {plan.pyramid.dims[0][0] // n} rows is smaller than "
            f"the keypoint halo {hk}; use fewer devices")

    total = cfg.total_levels
    relative_all = cfg.gauss_mode == "vlfeat-relative-all"

    # per-device capacities for sharded octaves
    caps_dev = [-(-plan.ext_caps[o] // n) for o in range(S)]
    jcaps_dev = [c + c // 4 for c in caps_dev]
    # effective per-octave capacities of the assembled output
    eff_ext_caps = tuple(
        caps_dev[o] * n if o < S else plan.ext_caps[o]
        for o in range(len(plan.pyramid.dims)))
    eff_job_caps = tuple(
        jcaps_dev[o] * n if o < S else plan.job_caps[o]
        for o in range(len(plan.pyramid.dims)))

    def _lvl0_band(img_band, axis_name):
        """Octave-0 level-0 row band from the input band (with halo)."""
        img = _input_as_float(img_band)
        kx = plan.pyramid.lvl0_kernel_x
        ky = plan.pyramid.lvl0_kernel_y
        if upscale2:
            kxp = _phase_kernels(kx * 255.0)
            kyp = _phase_kernels(ky)
            px_pad = max(max(abs(q), abs(q + t.shape[0] - 1))
                         for t, q in kxp)
            py_pad = max(max(abs(q), abs(q + t.shape[0] - 1))
                         for t, q in kyp)
            imgp = jnp.pad(img, ((0, 0), (px_pad, px_pad)), mode="edge")
            imgp = _exchange_halo(imgp, py_pad, axis_name)
            planes = []
            for ky_t, ky_q in kyp:
                row = []
                for kx_t, kx_q in kxp:
                    p = _conv1d_asym(imgp, kx_t, kx_q, px_pad, axis=1)
                    p = _conv1d_asym(p, ky_t, ky_q, py_pad, axis=0)
                    row.append(p)
                planes.append(tuple(row))
            return _interleave2x2(tuple(planes))
        # identity sampling grid: separable (dd0 horiz, inc0 vert) conv
        padx = (kx.shape[0] - 1) // 2
        x = jnp.pad(img, ((0, 0), (padx, padx)), mode="edge")
        x = _conv1d_valid(x, kx, axis=1) * 255.0
        pady = (ky.shape[0] - 1) // 2
        x = _exchange_halo(x, pady, axis_name)
        return _conv1d_valid(x, ky, axis=0)

    def local_fn(img_band):
        dev = jax.lax.axis_index(axis_name)
        gather = partial(jax.lax.all_gather, axis_name=axis_name)

        kp_fields = {k: [] for k in
                     ("x", "y", "sigma", "octave", "num_ori", "valid",
                      "ori", "ori_valid")}
        desc_fields = {k: [] for k in ("desc", "desc_kp", "desc_valid")}
        cand_counts = []
        drop_counts = []

        # ---- phase 1: sharded pyramid + detection ----
        band_blurs = []    # per sharded octave: [L, Hb, W] local bands
        exts_dev = []      # per sharded octave: per-device OctaveExtrema
        exts_glob = []     # per octave: gathered/global OctaveExtrema
        band = None
        for o in range(S):
            oh, ow = plan.pyramid.dims[o]
            if o == 0:
                lvl0 = _lvl0_band(img_band, axis_name)
            else:
                lvl0 = _decimate2(band[total - 3])[:oh // n, :ow]
            levels = [lvl0]
            for lvl in range(1, total):
                src = lvl0 if relative_all else levels[-1]
                k = plan.pyramid.absN_kernels[lvl] if relative_all \
                    else plan.pyramid.inc_kernels[lvl]
                levels.append(_sharded_blur(src, k, axis_name))
            band = jnp.stack(levels)                    # [L, Hb, W]
            dog_band = band[1:] - band[:-1]             # [L-1, Hb, W]
            band_blurs.append(band)

            Hb = oh // n
            r0 = dev * Hb                               # global first row
            dogh = _exchange_halo_rows(dog_band, hd, axis_name, axis=1)
            ext = detect_extrema(
                dogh, cfg, caps_dev[o], ow, oh,
                row_window=(hd, hd + Hb), y_offset=r0 - hd)
            exts_dev.append(ext)
            # gather the tiny per-band extrema into the global view
            glob = jax.tree.map(
                lambda a: gather(a, axis=0, tiled=True)
                if a.ndim else gather(a, axis=0, tiled=False), ext)
            exts_glob.append(glob._replace(
                count=jnp.sum(glob.valid, dtype=jnp.int32),
                n_candidates=jnp.sum(glob.n_candidates),
                n_dropped=jnp.sum(glob.n_dropped)))

        # seed for the replicated tail: decimate the band, gather rows
        rep_blurs = []
        rep_dogs = []
        if S < len(plan.pyramid.dims):
            oh, ow = plan.pyramid.dims[S]
            Hb_prev = plan.pyramid.dims[S - 1][0] // n
            # Hb_prev is even (shardable_octaves), so per-band decimation
            # picks exactly the global even rows of the previous octave
            seed_band = _decimate2(band[total - 3])[:Hb_prev // 2, :ow]
            lvl0 = gather(seed_band, axis=0, tiled=True)[:oh]
            for o in range(S, len(plan.pyramid.dims)):
                oh, ow = plan.pyramid.dims[o]
                if o > S:
                    lvl0 = _decimate2(rep_blurs[-1][total - 3])[:oh, :ow]
                levels = [lvl0]
                for lvl in range(1, total):
                    src = lvl0 if relative_all else levels[-1]
                    k = plan.pyramid.absN_kernels[lvl] if relative_all \
                        else plan.pyramid.inc_kernels[lvl]
                    levels.append(_sep_blur(src, k))
                blur = jnp.stack(levels)
                rep_blurs.append(blur)
                dog = blur[1:] - blur[:-1]
                rep_dogs.append(dog)
                ext = detect_extrema(dog, cfg, plan.ext_caps[o], ow, oh)
                exts_glob.append(ext)

        # ---- phase 2: global grid filter (replicated compute) ----
        if cfg.filter_max_extrema > 0:
            cells = jnp.concatenate([e.cell for e in exts_glob])
            sig_g = jnp.concatenate(
                [e.sigma * np.float32(2.0 ** (o - cfg.upscale_factor))
                 for o, e in enumerate(exts_glob)])
            val_g = jnp.concatenate([e.valid for e in exts_glob])
            new_valid = maybe_grid_filter(cells, sig_g, val_g, cfg)
            off = 0
            for o, e in enumerate(exts_glob):
                cap = eff_ext_caps[o]
                seg = new_valid[off:off + cap]
                exts_glob[o] = e._replace(
                    valid=seg, count=jnp.sum(seg, dtype=jnp.int32))
                off += cap

        # ---- phase 3: keypoint stages ----
        kp_offset = 0
        for o in range(len(plan.pyramid.dims)):
            oh, ow = plan.pyramid.dims[o]
            glob = exts_glob[o]
            scale = np.float32(2.0 ** (o - cfg.upscale_factor))
            if o < S:
                Hb = oh // n
                r0 = dev * Hb
                goffb = r0 - hk                # global row of local row 0
                cap_d = caps_dev[o]
                # post-filter validity slice for this device's extrema
                val_dev = jax.lax.dynamic_slice(
                    glob.valid, (dev * cap_d,), (cap_d,))
                ext = exts_dev[o]._replace(
                    valid=val_dev,
                    y=ext_local_y(exts_dev[o].y, goffb))
                blur_halo = _exchange_halo_rows(
                    band_blurs[o], hk, axis_name, axis=1)
                yb = (1 - goffb, oh - 2 - goffb)
                oris = assign_orientations(blur_halo, ext, cfg,
                                           y_bounds=yb)
                jobs = make_descriptor_jobs(ext, oris, jcaps_dev[o])
                raw = compute_descriptors(blur_halo, jobs, cfg,
                                          chunk=desc_chunk, y_bounds=yb)
                desc = normalize_descriptors(raw, cfg)
                desc = jnp.where(jobs.valid[:, None], desc, 0.0)

                # gather per-band results; global keypoint row =
                # octave base + dev * cap_d + local row
                kp_glob = jobs.kp_index + dev * cap_d + kp_offset
                kp_fields["x"].append(glob.x * scale)
                kp_fields["y"].append(glob.y * scale)
                kp_fields["sigma"].append(glob.sigma * scale)
                kp_fields["octave"].append(
                    jnp.full((cap_d * n,), o, jnp.int32))
                kp_fields["num_ori"].append(
                    gather(oris.num_ori, axis=0, tiled=True))
                kp_fields["valid"].append(glob.valid)
                kp_fields["ori"].append(
                    gather(oris.ori, axis=0, tiled=True))
                kp_fields["ori_valid"].append(
                    gather(oris.ori_valid, axis=0, tiled=True))
                desc_fields["desc"].append(
                    gather(desc, axis=0, tiled=True))
                desc_fields["desc_kp"].append(
                    gather(kp_glob, axis=0, tiled=True))
                desc_fields["desc_valid"].append(
                    gather(jobs.valid, axis=0, tiled=True))
            else:
                blur = rep_blurs[o - S]
                ext = glob
                oris = assign_orientations(blur, ext, cfg)
                jobs = make_descriptor_jobs(ext, oris, plan.job_caps[o])
                raw = compute_descriptors(blur, jobs, cfg,
                                          chunk=desc_chunk)
                desc = normalize_descriptors(raw, cfg)
                desc = jnp.where(jobs.valid[:, None], desc, 0.0)
                cap = plan.ext_caps[o]
                kp_fields["x"].append(ext.x * scale)
                kp_fields["y"].append(ext.y * scale)
                kp_fields["sigma"].append(ext.sigma * scale)
                kp_fields["octave"].append(jnp.full((cap,), o, jnp.int32))
                kp_fields["num_ori"].append(oris.num_ori)
                kp_fields["valid"].append(ext.valid)
                kp_fields["ori"].append(oris.ori)
                kp_fields["ori_valid"].append(oris.ori_valid)
                desc_fields["desc"].append(desc)
                desc_fields["desc_kp"].append(jobs.kp_index + kp_offset)
                desc_fields["desc_valid"].append(jobs.valid)
            cand_counts.append(exts_glob[o].n_candidates)
            drop_counts.append(exts_glob[o].n_dropped)
            kp_offset += eff_ext_caps[o]

        cat = lambda xs: jnp.concatenate(xs, axis=0)
        valid = cat(kp_fields["valid"])
        desc_valid = cat(desc_fields["desc_valid"])
        return SiftFeatures(
            x=cat(kp_fields["x"]),
            y=cat(kp_fields["y"]),
            sigma=cat(kp_fields["sigma"]),
            octave=cat(kp_fields["octave"]),
            num_ori=cat(kp_fields["num_ori"]),
            valid=valid,
            ori=cat(kp_fields["ori"]),
            ori_valid=cat(kp_fields["ori_valid"]),
            desc=cat(desc_fields["desc"]),
            desc_kp=cat(desc_fields["desc_kp"]),
            desc_valid=desc_valid,
            n_keypoints=jnp.sum(valid, dtype=jnp.int32),
            n_descriptors=jnp.sum(desc_valid, dtype=jnp.int32),
            octave_candidates=jnp.stack(cand_counts),
            octave_dropped=jnp.stack(drop_counts),
        )

    def ext_local_y(y_glob, goffb):
        """Translate detected global rows into the halo'd band frame."""
        return y_glob - goffb.astype(jnp.float32)

    if _as_local:
        # composition hook (make_batched_sharded_extract_fn): the
        # per-band local function, to be embedded in a larger shard_map
        # whose ``axis_name`` axis carries the row sharding
        return local_fn, eff_ext_caps

    mapped = shard_map(local_fn, mesh=mesh,
                       in_specs=(P(axis_name, None),),
                       out_specs=P(), check_vma=False)
    return jax.jit(mapped), eff_ext_caps


def make_batched_sharded_extract_fn(cfg: SiftConfig, height: int,
                                    width: int, mesh: Mesh,
                                    dp_axis: str = "dp",
                                    sp_axis: str = "sp",
                                    octave_caps: tuple | None = None,
                                    desc_chunk: int = 1024):
    """DP x SP composition: a batch of LARGE frames, each row-sharded.

    mesh must have axes (dp_axis, sp_axis); input uint8[B, H, W] is
    sharded P(dp, sp, None): each dp group holds B/dp frames whose rows
    span its sp sub-axis. Halo exchange and feature gathers ride the
    sp axis only; frames in a dp group run back-to-back via lax.scan
    (the same batching mode as make_batched_extract_fn). Returns
    (fn, eff_caps); outputs are SiftFeatures with a leading batch axis,
    sharded over dp and replicated over sp.
    """
    n_dp = mesh.shape[dp_axis]
    local_fn, eff_caps = make_sharded_extract_fn(
        cfg, height, width, mesh, axis_name=sp_axis,
        octave_caps=octave_caps, desc_chunk=desc_chunk, _as_local=True)

    def group_fn(imgs):                    # [B/dp, H/sp, W]
        def body(_, band):
            return 0, local_fn(band)
        _, feats = jax.lax.scan(body, 0, imgs)
        return feats

    mapped = shard_map(group_fn, mesh=mesh,
                       in_specs=(P(dp_axis, sp_axis, None),),
                       out_specs=P(dp_axis), check_vma=False)
    return jax.jit(mapped), eff_caps
