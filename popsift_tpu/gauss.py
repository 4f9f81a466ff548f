"""Gaussian filter bank construction (host-side, NumPy).

Semantic re-implementation of the reference's constant-memory Gauss tables
(/root/reference/src/popsift/gauss_filter.cu:127-257):

* ``inc``    — incremental level->level filters (sigma recursion
               sqrt(sigma_lvl^2 - sigma_prev^2), gauss_filter.cu:181-186).
* ``abs_o0`` — input -> any level of octave 0 (initial-blur subtracted,
               gauss_filter.cu:194-197).
* ``abs_oN`` — level0 -> levelN of any octave (gauss_filter.cu:208-213).
* ``dd``     — direct-downscale filters, one per octave
               (gauss_filter.cu:227-237).

Filters are half-sided (center + ``span-1`` taps), normalized so the full
symmetric kernel sums to 1 (gauss_filter.cu:348-369). Span rules per mode:
VLFeat ``ceil(4*sigma)+1``, OpenCV ``(round(8*sigma+1)|1)/2+1``, fixed 5/8
(gauss_filter.cu:301-328). We do not build the hardware-interpolation
(ratio, weight) variant — there are no texture reads here; the plain taps
feed a separable convolution instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .config import GAUSS_ALIGN, MAX_OCTAVES, SiftConfig


def gauss_span(sigma: float, mode: str) -> int:
    """Half-span (center included) of the filter for ``sigma`` under ``mode``."""
    if mode in ("vlfeat", "vlfeat-relative-all"):
        # gauss_filter.cu:302-308
        return min(int(math.ceil(4.0 * sigma) + 1), GAUSS_ALIGN - 1)
    if mode == "vlfeat-relative":
        # next odd span >= vlfeat span (gauss_filter.cu:311-319)
        spn = min(int(math.ceil(4.0 * sigma) + 1), GAUSS_ALIGN - 1)
        return spn + 1 if spn % 2 == 0 else spn
    if mode == "opencv":
        # gauss_filter.cu:322-328
        span = int(round(2.0 * 4.0 * sigma + 1.0)) | 1
        span = (span >> 1) + 1
        return min(span, GAUSS_ALIGN - 1)
    if mode == "fixed9":
        return 5
    if mode == "fixed15":
        return 8
    raise ValueError(f"bad gauss mode {mode!r}")


def gauss_filter(sigma: float, span: int) -> np.ndarray:
    """Half-sided normalized Gaussian, float32[GAUSS_ALIGN].

    Matches gauss_filter.cu:344-369: center weight 1, taps
    exp(-0.5*(x/sigma)^2) accumulated in double, normalized so
    center + 2*sum(taps) == 1.
    """
    out = np.zeros(GAUSS_ALIGN, dtype=np.float64)
    out[0] = 1.0
    s = 1.0
    for x in range(1, span):
        v = math.exp(-0.5 * (float(x) / sigma) ** 2)
        out[x] = v
        s += 2.0 * v
    out[:span] /= s
    return out.astype(np.float32)


def full_kernel(half: np.ndarray, span: int) -> np.ndarray:
    """Expand a half-sided filter into the symmetric (2*span-1)-tap kernel."""
    k = np.concatenate([half[span - 1:0:-1], half[:span]])
    return k.astype(np.float32)


@dataclass
class GaussTables:
    """All filter banks for one configuration. Mirrors ``GaussInfo``."""

    levels: int                      # total gauss levels (config.levels + 3)
    inc_sigma: np.ndarray = field(default=None)    # [levels]
    inc_span: np.ndarray = field(default=None)
    inc: list = field(default_factory=list)        # half filters
    abs_o0_sigma: np.ndarray = field(default=None)
    abs_o0_span: np.ndarray = field(default=None)
    abs_o0: list = field(default_factory=list)
    abs_oN_sigma: np.ndarray = field(default=None)
    abs_oN_span: np.ndarray = field(default=None)
    abs_oN: list = field(default_factory=list)
    dd_sigma: np.ndarray = field(default=None)     # [MAX_OCTAVES]
    dd_span: np.ndarray = field(default=None)
    dd: list = field(default_factory=list)


def build_gauss_tables(config: SiftConfig) -> GaussTables:
    """Build every filter bank (init_filter, gauss_filter.cu:127-257)."""
    sigma0 = config.sigma
    levels = config.levels            # DoG levels (denominator of 2^(l/levels))
    stages = config.total_levels      # levels + 3 filter stages
    mode = config.gauss_mode
    initial_blur = config.scaled_initial_blur

    t = GaussTables(levels=stages)

    # inc: incremental blur sigmas (gauss_filter.cu:177-186)
    inc_sigma = np.zeros(stages, dtype=np.float64)
    inc_sigma[0] = (math.sqrt(abs(sigma0 ** 2 - initial_blur ** 2))
                    if config.assume_initial_blur else sigma0)
    for lvl in range(1, stages):
        s_prev = sigma0 * 2.0 ** ((lvl - 1) / levels)
        s_next = sigma0 * 2.0 ** (lvl / levels)
        inc_sigma[lvl] = math.sqrt(s_next ** 2 - s_prev ** 2)
    t.inc_sigma = inc_sigma.astype(np.float32)
    t.inc_span = np.array([gauss_span(s, mode) for s in inc_sigma], np.int32)
    t.inc = [gauss_filter(s, sp) for s, sp in zip(inc_sigma, t.inc_span)]

    # abs_o0: input image -> any level of octave 0 (gauss_filter.cu:194-199)
    abs0_sigma = np.zeros(stages, dtype=np.float64)
    for lvl in range(stages):
        s_next = sigma0 * 2.0 ** (lvl / levels)
        abs0_sigma[lvl] = math.sqrt(abs(s_next ** 2 - initial_blur ** 2))
    t.abs_o0_sigma = abs0_sigma.astype(np.float32)
    t.abs_o0_span = np.array([gauss_span(s, mode) for s in abs0_sigma], np.int32)
    t.abs_o0 = [gauss_filter(s, sp) for s, sp in zip(abs0_sigma, t.abs_o0_span)]

    # abs_oN: level 0 -> level N within an octave (gauss_filter.cu:208-215)
    absN_sigma = np.zeros(stages, dtype=np.float64)
    absN_sigma[0] = 0.0
    for lvl in range(1, stages):
        s_next = sigma0 * 2.0 ** (lvl / levels)
        absN_sigma[lvl] = math.sqrt(s_next ** 2 - sigma0 ** 2)
    t.abs_oN_sigma = absN_sigma.astype(np.float32)
    t.abs_oN_span = np.array(
        [gauss_span(s, mode) if s > 0 else 1 for s in absN_sigma], np.int32)
    t.abs_oN = [gauss_filter(s, sp) if s > 0 else
                np.concatenate([[np.float32(1.0)],
                                np.zeros(GAUSS_ALIGN - 1, np.float32)])
                for s, sp in zip(absN_sigma, t.abs_oN_span)]

    # dd: direct-downscale level-0 filters per octave (gauss_filter.cu:227-237)
    dd_sigma = np.zeros(MAX_OCTAVES, dtype=np.float64)
    for octv in range(MAX_OCTAVES):
        oct_sigma = math.ldexp(sigma0, octv)
        b = math.sqrt(abs(oct_sigma ** 2 - initial_blur ** 2))
        dd_sigma[octv] = math.ldexp(b, -octv)
    t.dd_sigma = dd_sigma.astype(np.float32)
    t.dd_span = np.array([gauss_span(s, mode) for s in dd_sigma], np.int32)
    t.dd = [gauss_filter(s, sp) for s, sp in zip(dd_sigma, t.dd_span)]

    return t
