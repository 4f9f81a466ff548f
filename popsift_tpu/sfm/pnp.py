"""Absolute pose (PnP): batched DLT + RANSAC, refinement by Gauss-Newton.

Same batched hypothesize-and-verify structure as the two-view RANSAC
(twoview.py): S minimal 6-point DLT problems solved as one batched SVD,
every hypothesis scored against all correspondences in one pass.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .rotation import exp_so3, log_so3


def pnp_dlt(X, x):
    """Batched 6-point DLT for the projection matrix.

    X: [S, 6, 3] world points; x: [S, 6, 2] normalized camera coords.
    Returns (R [S,3,3], t [S,3]) with R projected onto SO(3).
    """
    S = X.shape[0]
    ones = jnp.ones(X.shape[:2], X.dtype)
    zeros4 = jnp.zeros(X.shape[:2] + (4,), X.dtype)
    Xh = jnp.concatenate([X, ones[..., None]], axis=-1)     # [S, 6, 4]
    u, v = x[..., 0], x[..., 1]
    r1 = jnp.concatenate([Xh, zeros4, -u[..., None] * Xh], axis=-1)
    r2 = jnp.concatenate([zeros4, Xh, -v[..., None] * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=1)                   # [S, 12, 12]
    _, _, vt = jnp.linalg.svd(A)
    P = vt[:, -1, :].reshape(S, 3, 4)

    # orthogonalize the rotation part, fix scale/sign by det and depth
    M = P[:, :, :3]
    uM, sM, vtM = jnp.linalg.svd(M)
    detM = jnp.linalg.det(uM @ vtM)
    R = uM @ (jnp.stack([jnp.ones_like(detM), jnp.ones_like(detM), detM],
                        -1)[..., None] * vtM)
    scale = jnp.mean(sM[:, :2], axis=1)
    scale = jnp.where(scale < 1e-12, 1e-12, scale)
    t = P[:, :, 3] / scale[:, None]
    # sign: majority of points must be in front
    Z = jnp.einsum("sij,snj->sni", R, X)[..., 2] + t[:, None, 2]
    flip = jnp.sum(jnp.sign(Z), axis=1) < 0
    R = jnp.where(flip[:, None, None], -R, R)
    # -R is not a rotation (det -1); re-orthogonalize via double flip of
    # two axes: instead just flip t and rotate by pi is wrong — use the
    # standard trick: P -> -P flips both R-part and t.
    t = jnp.where(flip[:, None], -t, t)
    uR, _, vtR = jnp.linalg.svd(R)
    dR = jnp.linalg.det(uR @ vtR)
    R = uR @ (jnp.stack([jnp.ones_like(dR), jnp.ones_like(dR), dR],
                        -1)[..., None] * vtR)
    return R, t


def reprojection_error2(R, t, X, x):
    """Squared reprojection error in normalized coords.
    R [S,3,3], t [S,3]; X [N,3]; x [N,2] -> [S,N]."""
    Xc = jnp.einsum("sij,nj->sni", R, X) + t[:, None, :]
    z = Xc[..., 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    proj = Xc[..., :2] / zsafe[..., None]
    err = jnp.sum((proj - x[None]) ** 2, axis=-1)
    return jnp.where(z > 0, err, jnp.inf)   # behind camera = outlier


class PnPResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("n_hyp", "refine_iters"))
def ransac_pnp(key, X, x, valid, thresh=1e-4, n_hyp=256, refine_iters=10):
    """PnP RANSAC. X [N,3] world points, x [N,2] normalized coords,
    valid bool[N] (padding mask). thresh: squared normalized-coord gate.
    """
    N = X.shape[0]
    nvalid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    idx = jax.random.randint(key, (n_hyp, 6), 0, nvalid)
    (rows,) = jnp.nonzero(valid, size=N, fill_value=0)
    samples = rows[idx]
    R, t = pnp_dlt(X[samples], x[samples])
    err = reprojection_error2(R, t, X, x)
    err = jnp.where(valid[None], err, jnp.inf)
    inl = err < thresh
    msac = jnp.sum(jnp.where(valid[None], jnp.minimum(err, thresh), 0.0),
                   axis=1)
    best = jnp.argmin(msac)
    Rb, tb, inlb = R[best], t[best], inl[best]

    # Gauss-Newton refinement on inliers (rotvec + t)
    w = (inlb & valid).astype(jnp.float32)

    def residual(params):
        Rr = exp_so3(params[:3])
        tr = params[3:]
        Xc = X @ Rr.T + tr
        z = jnp.where(jnp.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        proj = Xc[:, :2] / z[:, None]
        return ((proj - x) * w[:, None]).reshape(-1)

    p0 = jnp.concatenate([log_so3(Rb), tb])

    def gn_step(p, _):
        J = jax.jacfwd(residual)(p)
        r = residual(p)
        JtJ = J.T @ J + 1e-8 * jnp.eye(6, dtype=p.dtype)
        dp = jnp.linalg.solve(JtJ, -(J.T @ r))
        return p + dp, None

    p, _ = jax.lax.scan(gn_step, p0, None, length=refine_iters)
    Rf = exp_so3(p[:3])
    tf = p[3:]
    errf = reprojection_error2(Rf[None], tf[None], X, x)[0]
    inlf = (errf < thresh) & valid
    better = jnp.sum(inlf, dtype=jnp.int32) >= jnp.sum(inlb & valid,
                                                       dtype=jnp.int32)
    R_out = jnp.where(better, Rf, Rb)
    t_out = jnp.where(better, tf, tb)
    inl_out = jnp.where(better, inlf, inlb & valid)
    return PnPResult(R=R_out, t=t_out, inliers=inl_out,
                     n_inliers=jnp.sum(inl_out, dtype=jnp.int32))


@partial(jax.jit, static_argnames=("n_hyp", "refine_iters"))
def ransac_pnp_batch(key, X, x, valid, thresh=1e-4, n_hyp=256,
                     refine_iters=10):
    """PnP RANSAC for B candidate images in ONE device program.

    X [B,N,3], x [B,N,2], valid bool[B,N] (row padding). Returns a
    PnPResult with leading [B] axes. One dispatch replaces B serial
    :func:`ransac_pnp` calls (incremental reconstruction evaluates many
    failing frontier candidates per accepted image; see
    IncrementalSfM._register_pass)."""
    keys = jax.random.split(key, X.shape[0])
    return jax.vmap(
        lambda k, Xi, xi, vi: ransac_pnp(
            k, Xi, xi, vi, thresh=thresh, n_hyp=n_hyp,
            refine_iters=refine_iters))(keys, X, x, valid)
