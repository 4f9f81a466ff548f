"""Grid-based extrema budget filter.

Redesign of the reference's Thrust filtering pipeline
(/root/reference/src/popsift/s_filtergrid.cu:109-322): when the number of
initial extrema exceeds ``filter_max_extrema`` by more than 10%
(s_orientation.cu:362-367), the image is split into
``filter_grid_size^2`` cells and each cell keeps only its best extrema,
ordered by scale (largest/smallest first) or pseudo-randomly
(GridFilterMode, sift_conf.h:77-81).

The Thrust sort / reduce_by_key / scan / copy_if chain becomes a single
composite-key ``argsort`` plus a segmented rank (cummax of segment
starts) over the fixed-capacity extrema buffer. The per-cell limit uses
the reference's budget *redistribution* (s_filtergrid.cu:245-260): cells
below the shared limit keep everything and their unused budget raises
the limit for the loaded cells — computed here fully on device from the
sorted per-cell histogram (the reference rounds counts through the host).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SiftConfig
from .extrema import OctaveExtrema


def _redistributed_limit(counts: jnp.ndarray, budget: int) -> jnp.ndarray:
    """Per-cell keep limit with unused-budget redistribution
    (s_filtergrid.cu:245-260).

    Sort cell counts ascending; find the ``ct`` largest cells for which
    clamping every larger cell to this cell's count still exceeds the
    budget (FunctionIsAbove) — those cells share the reduction:
    ``newlimit = ceil(mean(top ct counts) - (total - budget)/ct)``.
    Lightly loaded cells keep everything; the limit only binds the dense
    tail, so the kept total lands within ``n_cells`` of the budget.
    """
    n_cells = counts.shape[0]
    cs = jnp.sort(counts)                        # ascending
    prefix = jnp.cumsum(cs)
    total = prefix[-1]
    rev = jnp.arange(n_cells - 1, -1, -1, dtype=counts.dtype)
    sumup = prefix + cs * rev                    # total if clamped to cs[i]
    ct = jnp.sum(sumup > budget)
    ct_safe = jnp.maximum(ct, 1).astype(jnp.float32)
    in_tail = jnp.arange(n_cells) >= n_cells - ct
    tail_avg = jnp.sum(jnp.where(in_tail, cs, 0)).astype(jnp.float32) \
        / ct_safe
    excess = (total - budget).astype(jnp.float32)
    newlimit = jnp.ceil(tail_avg - excess / ct_safe).astype(jnp.int32)
    # under budget: no cell needs to lose anything
    return jnp.where(ct > 0, jnp.maximum(newlimit, 1), jnp.int32(2 ** 30))


def grid_filter_mask(cell: jnp.ndarray, sigma: jnp.ndarray,
                     valid: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """Return an updated validity mask keeping at most ``newlimit``
    extrema per grid cell, where ``newlimit`` redistributes budget unused
    by sparse cells to loaded ones (reference host loop,
    s_filtergrid.cu:245-281).

    Operates on the *global* (all octaves concatenated) arrays; ``sigma``
    must be in input-image units so cross-octave ordering is meaningful.
    """
    n = cell.shape[0]
    n_cells = cfg.filter_grid_size * cfg.filter_grid_size
    # per-cell histogram via a tiny one-hot contraction (n_cells is
    # small)
    onehot = cell[:, None] == jnp.arange(n_cells, dtype=cell.dtype)[None, :]
    counts = jnp.sum(jnp.where(valid[:, None] & onehot, 1, 0), axis=0)
    limit = _redistributed_limit(counts, cfg.filter_max_extrema)

    if cfg.grid_filter_mode == "largest":
        sec = -sigma            # biggest scale first (LargestScaleFirst)
    elif cfg.grid_filter_mode == "smallest":
        sec = sigma
    else:  # "random": deterministic pseudo-random order
        h = (jnp.arange(n, dtype=jnp.uint32) * np.uint32(2654435761)) \
            ^ np.uint32(0x9E3779B9)
        sec = h.astype(jnp.float32)

    # normalize secondary key into [0, 1) then build composite sort key;
    # invalid entries sort last
    smin = jnp.min(jnp.where(valid, sec, jnp.inf))
    smax = jnp.max(jnp.where(valid, sec, -jnp.inf))
    rng = jnp.maximum(smax - smin, 1e-20)
    frac = jnp.clip((sec - smin) / rng, 0.0, 1.0) * 0.999
    key = jnp.where(valid, cell.astype(jnp.float32) + frac,
                    np.float32(n_cells + 2))
    order = jnp.argsort(key)

    sc = cell[order]
    sv = valid[order]
    first = jnp.concatenate([jnp.ones(1, bool), sc[1:] != sc[:-1]])
    idx = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(first, idx, -1))
    rank = idx - seg_start
    keep_sorted = sv & (rank < limit)

    keep = jnp.zeros(n, bool).at[order].set(keep_sorted)
    return keep


def maybe_grid_filter(cell, sigma, valid, cfg: SiftConfig):
    """Apply the filter only when >10% over budget
    (s_orientation.cu:362-367). Trace-safe: both branches computed,
    selected by the predicate."""
    total = jnp.sum(valid, dtype=jnp.int32)
    over = total.astype(jnp.float32) > 1.1 * cfg.filter_max_extrema
    filtered = grid_filter_mask(cell, sigma, valid, cfg)
    return jnp.where(over, filtered, valid)


def apply_grid_filter(ext: OctaveExtrema, cfg: SiftConfig) -> OctaveExtrema:
    """Per-octave convenience wrapper (single-octave budget)."""
    new_valid = maybe_grid_filter(ext.cell, ext.sigma, ext.valid, cfg)
    return ext._replace(valid=new_valid,
                        count=jnp.sum(new_valid, dtype=jnp.int32))
