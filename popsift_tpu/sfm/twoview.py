"""Two-view geometry: batched RANSAC for essential matrix / homography,
pose recovery, triangulation.

New capability relative to the reference (BASELINE.json north star). The
design is batched end to end: RANSAC is a *batched
hypothesize-and-verify* — S minimal problems solved at once (batched
small SVDs), every hypothesis scored against every correspondence with
one matmul-like [S, N] pass — instead of the sequential loop CPU RANSAC
uses.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# minimal solvers (batched)
# ---------------------------------------------------------------------------

def _normalize_points(pts, valid):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    w = valid.astype(pts.dtype)[:, None]
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w, axis=0) / n
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=1) + 1e-30)
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w[:, 0]) / n, 1e-12)
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                  pts.dtype)
    T = T.at[0, 0].set(scale).at[1, 1].set(scale)
    T = T.at[0, 2].set(-scale * mean[0]).at[1, 2].set(-scale * mean[1])
    return (pts - mean) * scale, T


def eight_point(x1, x2):
    """Batched 8-point fundamental/essential solver.

    x1, x2: [S, 8, 2] correspondences (normalized camera coords for E).
    Returns [S, 3, 3] rank-2-enforced matrices.
    """
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                   u1, v1, ones], axis=-1)           # [S, 8, 9]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    f = vt[..., -1, :]                                # [S, 9]
    F = f.reshape(-1, 3, 3)
    # rank-2 projection
    uF, sF, vtF = jnp.linalg.svd(F)
    sF = sF.at[..., 2].set(0.0)
    return uF @ (sF[..., None] * vtF)


def essential_project(E):
    """Project onto the essential manifold: equal singular values."""
    u, s, vt = jnp.linalg.svd(E)
    m = (s[..., 0] + s[..., 1]) * 0.5
    s2 = jnp.stack([m, m, jnp.zeros_like(m)], -1)
    return u @ (s2[..., None] * vt)


def homography_dlt(x1, x2):
    """Batched 4-point homography DLT. x1, x2: [S, 4, 2] -> [S, 3, 3]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    r1 = jnp.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], -1)
    r2 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    A = jnp.concatenate([r1, r2], axis=-2)           # [S, 8, 9]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[..., -1, :].reshape(-1, 3, 3)


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def sampson_error(E, x1, x2):
    """Squared Sampson distance. E: [S,3,3]; x1/x2: [N,2] -> [S,N]."""
    N = x1.shape[0]
    h1 = jnp.concatenate([x1, jnp.ones((N, 1), x1.dtype)], -1)  # [N, 3]
    h2 = jnp.concatenate([x2, jnp.ones((N, 1), x2.dtype)], -1)
    Ex1 = jnp.einsum("sij,nj->sni", E, h1)
    Etx2 = jnp.einsum("sji,nj->sni", E, h2)
    x2Ex1 = jnp.einsum("ni,sni->sn", h2, Ex1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
             + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return (x2Ex1 ** 2) / jnp.maximum(denom, 1e-12)


def homography_error(H, x1, x2):
    """Squared symmetric-free forward transfer error [S, N]."""
    N = x1.shape[0]
    h1 = jnp.concatenate([x1, jnp.ones((N, 1), x1.dtype)], -1)
    p = jnp.einsum("sij,nj->sni", H, h1)
    z = jnp.where(jnp.abs(p[..., 2:3]) < 1e-12, 1e-12, p[..., 2:3])
    proj = p[..., :2] / z
    return jnp.sum((proj - x2[None]) ** 2, axis=-1)


# ---------------------------------------------------------------------------
# batched RANSAC
# ---------------------------------------------------------------------------

class RansacResult(NamedTuple):
    model: jnp.ndarray        # [3, 3]
    inliers: jnp.ndarray      # bool[N]
    n_inliers: jnp.ndarray    # i32
    score: jnp.ndarray        # f32 (MSAC score, lower is better)


def _ransac(key, x1, x2, valid, solver, min_set, err_fn, thresh, n_hyp):
    N = x1.shape[0]
    idx = jax.random.randint(key, (n_hyp, min_set), 0, jnp.maximum(
        jnp.sum(valid.astype(jnp.int32)), 1))
    # map sampled ranks onto valid rows
    (rows,) = jnp.nonzero(valid, size=N, fill_value=0)
    samples = rows[idx]                               # [S, m]
    models = solver(x1[samples], x2[samples])         # [S, 3, 3]
    err = err_fn(models, x1, x2)                      # [S, N]
    err = jnp.where(valid[None, :], err, jnp.inf)
    inl = err < thresh
    msac = jnp.sum(jnp.where(valid[None, :], jnp.minimum(err, thresh), 0.0),
                   axis=1)
    best = jnp.argmin(msac)
    return RansacResult(model=models[best], inliers=inl[best],
                        n_inliers=jnp.sum(inl[best], dtype=jnp.int32),
                        score=msac[best])


@partial(jax.jit, static_argnames=("n_hyp",))
def ransac_essential(key, x1, x2, valid, thresh=1e-4, n_hyp=512):
    """Essential matrix RANSAC on normalized camera coordinates.

    x1, x2: [N, 2] (padded; ``valid`` masks real rows). ``thresh`` is the
    squared Sampson distance gate in normalized coords.
    """
    res = _ransac(key, x1, x2, valid,
                  lambda a, b: essential_project(eight_point(a, b)),
                  8, sampson_error, thresh, n_hyp)
    # final refit on inliers: weighted 8-point over all inlier rows
    E = _refit_essential(x1, x2, res.inliers)
    err = sampson_error(E[None], x1, x2)[0]
    inl = (err < thresh) & valid
    better = jnp.sum(inl, dtype=jnp.int32) >= res.n_inliers
    return RansacResult(
        model=jnp.where(better, E, res.model),
        inliers=jnp.where(better, inl, res.inliers),
        n_inliers=jnp.where(better, jnp.sum(inl, dtype=jnp.int32),
                            res.n_inliers),
        score=res.score)


def _refit_essential(x1, x2, w):
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                   u1, v1, ones], axis=-1)
    A = A * w.astype(A.dtype)[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[-1].reshape(3, 3)
    return essential_project(F[None])[0]


@partial(jax.jit, static_argnames=("n_hyp",))
def ransac_homography(key, x1, x2, valid, thresh=4.0, n_hyp=512):
    """Homography RANSAC in pixel coordinates; thresh = squared px."""
    return _ransac(key, x1, x2, valid, homography_dlt, 4,
                   homography_error, thresh, n_hyp)


# ---------------------------------------------------------------------------
# pose recovery + triangulation
# ---------------------------------------------------------------------------

def triangulate(R1, t1, R2, t2, x1, x2):
    """Batched midpoint-free DLT triangulation.

    (R, t) map world -> camera. x: [N, 2] normalized coords.
    Returns X [N, 3] world points.
    """
    P1 = jnp.concatenate([R1, t1[:, None]], axis=1)   # [3, 4]
    P2 = jnp.concatenate([R2, t2[:, None]], axis=1)

    def rows(P, x):
        return jnp.stack([x[:, 0:1] * P[2] - P[0][None],
                          x[:, 1:2] * P[2] - P[1][None]], axis=1)

    A = jnp.concatenate([rows(P1, x1), rows(P2, x2)], axis=1)  # [N, 4, 4]
    _, _, vt = jnp.linalg.svd(A)
    Xh = vt[:, -1, :]
    w = jnp.where(jnp.abs(Xh[:, 3:4]) < 1e-12, 1e-12, Xh[:, 3:4])
    return Xh[:, :3] / w


@jax.jit
def triangulate_rows(R1, t1, R2, t2, x1, x2):
    """DLT triangulation with PER-ROW camera poses.

    Same math as :func:`triangulate` but R1/t1/R2/t2 carry a leading
    [N] axis, so one device call triangulates N tracks each against its
    own (partner, new-image) camera pair — the batched form the
    incremental engine's registration step needs (the per-partner
    loop was O(registered images) device calls per registration).
    """
    P1 = jnp.concatenate([R1, t1[..., None]], axis=-1)   # [N, 3, 4]
    P2 = jnp.concatenate([R2, t2[..., None]], axis=-1)

    def rows(P, x):
        return jnp.stack([x[:, 0:1] * P[:, 2] - P[:, 0],
                          x[:, 1:2] * P[:, 2] - P[:, 1]], axis=1)

    A = jnp.concatenate([rows(P1, x1), rows(P2, x2)], axis=1)  # [N, 4, 4]
    _, _, vt = jnp.linalg.svd(A)
    Xh = vt[:, -1, :]
    w = jnp.where(jnp.abs(Xh[:, 3:4]) < 1e-12, 1e-12, Xh[:, 3:4])
    return Xh[:, :3] / w


def recover_pose(E, x1, x2, valid):
    """Choose the (R, t) decomposition of E with max cheirality support
    (points in front of both cameras). Returns (R, t, good_mask)."""
    u, _, vt = jnp.linalg.svd(E)
    d = jnp.linalg.det(u) * jnp.linalg.det(vt)
    u = u * jnp.sign(d)  # ensure proper rotations
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                  E.dtype)
    Ra = u @ W @ vt
    Rb = u @ W.T @ vt
    t = u[:, 2]
    eye = jnp.eye(3, dtype=E.dtype)
    zero = jnp.zeros(3, dtype=E.dtype)

    def support(R2, t2):
        X = triangulate(eye, zero, R2, t2, x1, x2)
        z1 = X[:, 2]
        Xc2 = X @ R2.T + t2
        z2 = Xc2[:, 2]
        ok = (z1 > 0) & (z2 > 0) & valid
        return jnp.sum(ok, dtype=jnp.int32), ok

    cands = [(Ra, t), (Ra, -t), (Rb, t), (Rb, -t)]
    counts = []
    masks = []
    for R2, t2 in cands:
        c, m = support(R2, t2)
        counts.append(c)
        masks.append(m)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    ms = jnp.stack(masks)
    return Rs[best], ts[best], ms[best]


@partial(jax.jit, static_argnames=("iters",))
def refine_pose(R, t, x1, x2, weights, iters=10):
    """Gauss-Newton refinement of a relative pose on the essential
    manifold (5 dof: so(3) x tangent of the unit translation sphere),
    minimizing the weighted signed Sampson residual over the inlier
    set.

    The linear 8-point estimate + closed-form decomposition is noisy in
    the translation direction (several degrees at 0.1% pixel noise);
    ~10 GN steps close the gap to OpenCV's 5-point solver — externally
    checked in tests/test_cv2_sfm_parity.py. Returns (R, t), |t| = 1.
    """
    from .rotation import exp_so3

    w = weights.astype(x1.dtype)
    N = x1.shape[0]
    h1 = jnp.concatenate([x1, jnp.ones((N, 1), x1.dtype)], -1)
    h2 = jnp.concatenate([x2, jnp.ones((N, 1), x2.dtype)], -1)

    def hat(v):
        return jnp.array([[0.0, -v[2], v[1]],
                          [v[2], 0.0, -v[0]],
                          [-v[1], v[0], 0.0]], v.dtype)

    def residual(p, R, t, u, v):
        Rp = exp_so3(p[:3]) @ R
        tp = t + p[3] * u + p[4] * v
        tp = tp / jnp.sqrt(jnp.sum(tp * tp) + 1e-20)
        E = hat(tp) @ Rp
        Ex1 = h1 @ E.T
        Etx2 = h2 @ E
        num = jnp.sum(h2 * Ex1, -1)
        den = (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
               + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)
        return w * num / jnp.sqrt(jnp.maximum(den, 1e-12))

    def step(carry, _):
        R, t = carry
        a = jnp.where(jnp.abs(t[0]) < 0.9,
                      jnp.array([1.0, 0.0, 0.0], t.dtype),
                      jnp.array([0.0, 1.0, 0.0], t.dtype))
        u = jnp.cross(t, a)
        u = u / jnp.sqrt(jnp.sum(u * u) + 1e-20)
        v = jnp.cross(t, u)
        z = jnp.zeros(5, x1.dtype)
        r0 = residual(z, R, t, u, v)
        J = jax.jacfwd(residual)(z, R, t, u, v)
        H = J.T @ J + 1e-9 * jnp.eye(5, dtype=x1.dtype)
        dp = -jnp.linalg.solve(H, J.T @ r0)
        Rn = exp_so3(dp[:3]) @ R
        tn = t + dp[3] * u + dp[4] * v
        tn = tn / jnp.sqrt(jnp.sum(tn * tn) + 1e-20)
        # accept only cost-decreasing steps (poor man's LM): the
        # Sampson objective is sign-agnostic in t, and an unguarded GN
        # step on poorly-conditioned geometry can wander — observed as
        # a cheirality flip that collapsed 200-camera registration
        rn = residual(z, Rn, tn, u, v)
        better = jnp.sum(rn * rn) < jnp.sum(r0 * r0)
        return (jnp.where(better, Rn, R), jnp.where(better, tn, t)), \
            jnp.float32(0)

    (R, t), _ = jax.lax.scan(step, (R, t), None, length=iters)
    return R, t


@partial(jax.jit, static_argnames=("n_hyp",))
def solve_pairs_batch(key, x1, x2, valid, thresh=1e-4, n_hyp=512):
    """Full two-view chain for B edges in ONE device program.

    Runs essential RANSAC -> pose recovery -> essential-manifold GN
    polish -> cheirality re-decomposition -> triangulation, vmapped
    over a leading batch axis: x1/x2 [B, N, 2], valid bool[B, N].
    Returns (R [B,3,3], t [B,3], good bool[B,N], X [B,N,3]).

    One dispatch replaces ~5 serial device calls PER EDGE in the
    view-graph construction of global SfM (global_sfm.py). Semantics match
    IncrementalSfM._solve_pair's device portion exactly.
    """
    from .rotation import hat

    def one(k, xa, xb, v):
        res = ransac_essential(k, xa, xb, v, thresh=thresh, n_hyp=n_hyp)
        w = v & res.inliers
        R2, t2, _ = recover_pose(res.model, xa, xb, w)
        R2, t2 = refine_pose(R2, t2, xa, xb, w)
        R2, t2, good = recover_pose(hat(t2) @ R2, xa, xb, w)
        X = triangulate(jnp.eye(3, dtype=xa.dtype), jnp.zeros(3, xa.dtype),
                        R2, t2, xa, xb)
        return R2, t2, good, X

    keys = jax.random.split(key, x1.shape[0])
    return jax.vmap(one)(keys, x1, x2, valid)
