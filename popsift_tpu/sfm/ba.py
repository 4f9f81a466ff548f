"""Bundle adjustment: Levenberg-Marquardt with Schur-complement CG.

New capability relative to the reference (BASELINE.json north star:
"distributed bundle adjustment with Schur-complement reduction over ICI
collectives"). Design:

* residuals/Jacobians are *batched over observations* — one vmapped
  pinhole projection, Jacobians by forward-mode autodiff. No sparse
  matrix is ever assembled.
* the reduced camera system  S = Hcc - Hcp Hpp^-1 Hpc  is applied
  *matrix-free* inside CG: each application is two segment-sums over
  observations plus batched 3x3 solves for the point blocks — exactly
  the structure that distributes: observations are sharded point-aligned
  across devices, point blocks stay local, and the camera-side
  reductions become ``psum`` over the mesh (see ``shard_ba_step``).
* block-Jacobi preconditioner from the Hcc diagonal blocks.

Camera model: world->camera rigid transform (rotvec[3], t[3]) with shared
fixed intrinsics (fx, fy, cx, cy). Camera parameter block size 6.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .rotation import exp_so3

CAM_DIM = 6


class BAProblem(NamedTuple):
    cams: jnp.ndarray       # f32[Nc, 6]  (rotvec, t)
    points: jnp.ndarray     # f32[Np, 3]
    intr: jnp.ndarray       # f32[4] fx fy cx cy
    obs_cam: jnp.ndarray    # i32[No]
    obs_pt: jnp.ndarray     # i32[No]
    obs_uv: jnp.ndarray     # f32[No, 2]
    obs_valid: jnp.ndarray  # bool[No]
    cam_fixed: jnp.ndarray  # bool[Nc] gauge fixing (e.g. first camera)


def project(cam, X, intr):
    """Pinhole projection of one point through one camera."""
    R = exp_so3(cam[:3])
    Xc = R @ X + cam[3:6]
    z = jnp.where(jnp.abs(Xc[2]) < 1e-9, 1e-9, Xc[2])
    return jnp.array([intr[0] * Xc[0] / z + intr[2],
                      intr[1] * Xc[1] / z + intr[3]])


def residuals(p: BAProblem):
    """r [No, 2] = predicted - observed, zeroed for invalid obs."""
    def one(ci, pi, uv):
        return project(p.cams[ci], p.points[pi], p.intr) - uv
    r = jax.vmap(one)(p.obs_cam, p.obs_pt, p.obs_uv)
    return jnp.where(p.obs_valid[:, None], r, 0.0)


def robust_cost(r, huber_delta=None):
    """Total cost of residuals [No, 2]: plain squared L2, or the Huber
    loss on the per-observation norm when ``huber_delta`` is set."""
    if huber_delta is None:
        return jnp.sum(r * r)
    n2 = jnp.sum(r * r, axis=1)
    n = jnp.sqrt(n2 + 1e-20)
    d = jnp.float32(huber_delta)
    return jnp.sum(jnp.where(n <= d, n2, 2.0 * d * n - d * d))


def _huber_sw(r, huber_delta):
    """sqrt IRLS weights [No, 1] for the Huber loss: w = min(1, d/|r|).
    Applied to both r and J, one observation's influence on the normal
    equations saturates at the inlier scale — a single gross outlier
    (e.g. a mismatched track) can no longer dominate the f32 system."""
    n = jnp.sqrt(jnp.sum(r * r, axis=1) + 1e-20)
    d = jnp.float32(huber_delta)
    return jnp.sqrt(jnp.minimum(1.0, d / n))[:, None]


def _jacobians(p: BAProblem):
    """Per-observation Jacobians Jc [No,2,6], Jp [No,2,3] (fwd autodiff)."""
    def one(ci, pi, uv):
        cam = p.cams[ci]
        X = p.points[pi]
        f = lambda c, x: project(c, x, p.intr) - uv
        Jc = jax.jacfwd(f, argnums=0)(cam, X)
        Jp = jax.jacfwd(f, argnums=1)(cam, X)
        return Jc, Jp
    Jc, Jp = jax.vmap(one)(p.obs_cam, p.obs_pt, p.obs_uv)
    m = p.obs_valid[:, None, None]
    # gauge: fixed cameras contribute no camera gradient
    free = ~p.cam_fixed[p.obs_cam]
    Jc = jnp.where(m & free[:, None, None], Jc, 0.0)
    Jp = jnp.where(m, Jp, 0.0)
    return Jc, Jp


def _seg_sum(values, idx, num):
    return jax.ops.segment_sum(values, idx, num_segments=num)


def _inv33(H):
    """Batched SPD 3x3 inverse via adjugate."""
    a00, a01, a02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    a11, a12, a22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    det0 = a11 * a22 - a12 * a12
    det1 = a12 * a02 - a01 * a22
    det2 = a01 * a12 - a11 * a02
    det3 = a00 * a22 - a02 * a02
    det4 = a01 * a02 - a00 * a12
    det5 = a00 * a11 - a01 * a01
    det = a00 * det0 + a01 * det1 + a02 * det2
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    return jnp.stack([
        jnp.stack([det0, det1, det2], -1),
        jnp.stack([det1, det3, det4], -1),
        jnp.stack([det2, det4, det5], -1)], -2) / det[..., None, None]


def _solve33(H, b):
    """Batched SPD 3x3 solve via adjugate (same shape as s_solve.h)."""
    a00, a01, a02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    a11, a12, a22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    det0 = a11 * a22 - a12 * a12
    det1 = a12 * a02 - a01 * a22
    det2 = a01 * a12 - a11 * a02
    det3 = a00 * a22 - a02 * a02
    det4 = a01 * a02 - a00 * a12
    det5 = a00 * a11 - a01 * a01
    det = a00 * det0 + a01 * det1 + a02 * det2
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    inv = jnp.stack([
        jnp.stack([det0, det1, det2], -1),
        jnp.stack([det1, det3, det4], -1),
        jnp.stack([det2, det4, det5], -1)], -2) / det[..., None, None]
    return jnp.einsum("...ij,...j->...i", inv, b)


class _SchurOps(NamedTuple):
    Jc: jnp.ndarray
    Jp: jnp.ndarray
    Hpp_inv_chol: jnp.ndarray   # damped Hpp (not factored; solved per use)
    obs_cam: jnp.ndarray
    obs_pt: jnp.ndarray
    Nc: int
    Np: int
    lam: jnp.ndarray
    Hcc_diag: jnp.ndarray       # [Nc, 6, 6] damped block diagonal


def _build_schur(p: BAProblem, lam, psum_axis=None, sw=None):
    Jc, Jp = _jacobians(p)
    if sw is not None:               # IRLS sqrt weights [No, 1]
        Jc = Jc * sw[:, :, None]
        Jp = Jp * sw[:, :, None]
    Nc = p.cams.shape[0]
    Np = p.points.shape[0]
    Hpp = _seg_sum(jnp.einsum("oki,okj->oij", Jp, Jp), p.obs_pt, Np)
    Hcc = _seg_sum(jnp.einsum("oki,okj->oij", Jc, Jc), p.obs_cam, Nc)
    if psum_axis is not None:
        Hcc = jax.lax.psum(Hcc, psum_axis)
    eye3 = jnp.eye(3, dtype=Jp.dtype)
    eye6 = jnp.eye(6, dtype=Jc.dtype)
    Hpp = Hpp + lam * eye3[None]
    Hcc = Hcc + lam * eye6[None]
    return _SchurOps(Jc=Jc, Jp=Jp, Hpp_inv_chol=Hpp,
                     obs_cam=p.obs_cam, obs_pt=p.obs_pt,
                     Nc=Nc, Np=Np, lam=lam, Hcc_diag=Hcc)


def _apply_S(ops: _SchurOps, v, psum_axis=None):
    """S v for the reduced camera system, matrix-free."""
    vc = v[ops.obs_cam]                                # [No, 6]
    Jv = jnp.einsum("oki,oi->ok", ops.Jc, vc)          # [No, 2]
    # Hcc v (local) — block diagonal, but computed via obs to keep the
    # sharded path identical: a = seg_cam(Jc^T Jv) (+psum)
    a = _seg_sum(jnp.einsum("oki,ok->oi", ops.Jc, Jv), ops.obs_cam, ops.Nc)
    b = _seg_sum(jnp.einsum("oki,ok->oi", ops.Jp, Jv), ops.obs_pt, ops.Np)
    c = _solve33(ops.Hpp_inv_chol, b)                  # Hpp^-1 Hpc v
    Jpc = jnp.einsum("oki,oi->ok", ops.Jp, c[ops.obs_pt])
    d = _seg_sum(jnp.einsum("oki,ok->oi", ops.Jc, Jpc), ops.obs_cam, ops.Nc)
    out = a - d
    if psum_axis is not None:
        out = jax.lax.psum(out, psum_axis)
    return out + ops.lam * v


def _precond(ops: _SchurOps, r):
    """Block-Jacobi: solve the damped 6x6 camera diagonal blocks."""
    eye = jnp.eye(CAM_DIM, dtype=r.dtype) * 1e-8
    return jnp.linalg.solve(ops.Hcc_diag + eye[None],
                            r[..., None])[..., 0]


def schur_dense_step(p: BAProblem, lam, psum_axis=None, huber_delta=None,
                     opt_intr: bool = False, intr_mask=None):
    """One damped Gauss-Newton step via an EXPLICIT dense reduced camera
    system — the matmul formulation of the Schur complement.

    The matrix-free CG step (:func:`schur_cg_step`) spends ~all its time
    in per-CG-iteration gathers/segment-sums over the observation list
    (3 segment sums + 2 row gathers per iteration).
    Here the per-observation work happens ONCE: the camera-point coupling
    blocks are aggregated into a dense U [Np, Nc, 6, 3] with a single
    combined-index segment sum, and the Schur correction

        B = U Hpp^-1 U^T            (a (6Nc, 3Np) x (3Np, 6Nc) matmul)

    is one matmul. The reduced system S = Hcc + lam I - B (6Nc x 6Nc)
    is then solved directly — symmetric Jacobi scaling followed by an LU
    solve (``jnp.linalg.solve``); exact, no CG tolerance. (LU rather
    than Cholesky: S is PSD only up to f32 roundoff, see below.)
    Feasible whenever the dense U fits (Np*Nc*72 bytes; ~288 MB for the
    100-cam/40k-point benchmark problem) — ``bundle_adjust`` picks this
    path automatically and falls back to CG otherwise.

    With ``psum_axis`` (observations point-sharded over a mesh), Hcc, S
    and the camera gradient are psum'd once per step — one [6Nc, 6Nc]
    collective instead of two [6Nc] psums per CG iteration.

    ``opt_intr``: JOINTLY solve for the shared intrinsics block by
    augmenting the reduced camera system to [6Nc+4, 6Nc+4] — the
    intrinsics behave as one extra camera-like block observed by every
    residual. This avoids the focal<->depth near-degeneracy that makes
    block-coordinate alternation (:func:`intr_step`) converge at a
    ~0.999 linear rate: cameras/points re-absorb a shared focal error
    every alternating step, while the joint Schur solve moves along the
    coupled direction exactly. Returns (dc, dp, di, cost); ``intr_mask``
    (f32[4], 1 = optimize) freezes components (e.g. [1,1,0,0] = focal
    only).
    """
    Nc = p.cams.shape[0]
    Np = p.points.shape[0]
    r = residuals(p)
    cost = robust_cost(r, huber_delta)
    if psum_axis is not None:
        cost = jax.lax.psum(cost, psum_axis)
    Jc, Jp = _jacobians(p)
    if huber_delta is not None:      # IRLS: scale r and J by sqrt(w)
        sw = _huber_sw(r, huber_delta)
        r = r * sw
        Jc = Jc * sw[:, :, None]
        Jp = Jp * sw[:, :, None]

    Hpp = _seg_sum(jnp.einsum("oki,okj->oij", Jp, Jp), p.obs_pt, Np)
    Hcc = _seg_sum(jnp.einsum("oki,okj->oij", Jc, Jc), p.obs_cam, Nc)
    if psum_axis is not None:
        Hcc = jax.lax.psum(Hcc, psum_axis)
    Hpp = Hpp + lam * jnp.eye(3, dtype=Jp.dtype)[None]
    Hpp_inv = _inv33(Hpp)                               # [Np, 3, 3]

    # dense camera-point coupling via ONE combined-index segment sum
    W = jnp.einsum("oki,okj->oij", Jc, Jp)              # [No, 6, 3]
    comb = p.obs_pt.astype(jnp.int32) * Nc + p.obs_cam.astype(jnp.int32)
    U = _seg_sum(W.reshape(-1, 18), comb, Np * Nc)
    U = U.reshape(Np, Nc, 6, 3)

    A = jnp.einsum("pcik,pkl->pcil", U, Hpp_inv)        # U Hpp^-1
    # B[(c,i),(d,j)] = sum_{p,k} A[p,c,i,k] U[p,d,j,k] as one matmul
    A2 = jnp.transpose(A, (1, 2, 0, 3)).reshape(Nc * 6, Np * 3)
    U2 = jnp.transpose(U, (1, 2, 0, 3)).reshape(Nc * 6, Np * 3)
    B = jax.lax.dot_general(
        A2, U2, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)            # [6Nc, 6Nc]

    g_c = _seg_sum(jnp.einsum("oki,ok->oi", Jc, r), p.obs_cam, Nc)
    if psum_axis is not None:
        g_c = jax.lax.psum(g_c, psum_axis)
    g_p = _seg_sum(jnp.einsum("oki,ok->oi", Jp, r), p.obs_pt, Np)
    corr = jnp.einsum("pcik,pk->ci", A, g_p)            # U Hpp^-1 g_p
    if psum_axis is not None:
        # one [6Nc, 6Nc] + one [Nc, 6] collective per GN step
        B = jax.lax.psum(B, psum_axis)
        corr = jax.lax.psum(corr, psum_axis)
    rhs = -(g_c - corr)                                 # [Nc, 6]

    S = -B
    eye = jnp.eye(Nc * 6, dtype=B.dtype)
    blockdiag = jnp.zeros((Nc, 6, Nc, 6), B.dtype)
    idx = jnp.arange(Nc)
    blockdiag = blockdiag.at[idx, :, idx, :].set(Hcc)
    S = S + blockdiag.reshape(Nc * 6, Nc * 6) + lam * eye

    if opt_intr:
        # augment the reduced system with the shared 4-dim intrinsics
        # block: S_aug = [[S, Sci], [Sci^T, Sii]] with the point
        # couplings eliminated through the same Hpp^-1
        mask4 = (jnp.ones(4, jnp.float32) if intr_mask is None
                 else jnp.asarray(intr_mask, jnp.float32))
        Ji = _intr_jacobian(p)
        if huber_delta is not None:
            Ji = Ji * sw[:, :, None]
        Ji = Ji * mask4[None, None, :]       # frozen comps: zero columns
        Hii = jnp.einsum("oki,okj->ij", Ji, Ji)
        Hci = _seg_sum(jnp.einsum("oki,okj->oij", Jc, Ji),
                       p.obs_cam, Nc)                   # [Nc, 6, 4]
        Vi = _seg_sum(jnp.einsum("oki,okj->oij", Ji, Jp),
                      p.obs_pt, Np)                     # [Np, 4, 3]
        g_i = jnp.einsum("oki,ok->i", Ji, r)
        Ai = jnp.einsum("pik,pkl->pil", Vi, Hpp_inv)    # Vi Hpp^-1
        B_ci = jnp.einsum("pcik,pjk->cij", A, Vi)       # [Nc, 6, 4]
        B_ii = jnp.einsum("pik,pjk->ij", Ai, Vi)
        corr_i = jnp.einsum("pik,pk->i", Ai, g_p)
        if psum_axis is not None:
            Hii = jax.lax.psum(Hii, psum_axis)
            Hci = jax.lax.psum(Hci, psum_axis)
            B_ci = jax.lax.psum(B_ci, psum_axis)
            B_ii = jax.lax.psum(B_ii, psum_axis)
            g_i = jax.lax.psum(g_i, psum_axis)
            corr_i = jax.lax.psum(corr_i, psum_axis)
        Sci = (Hci - B_ci).reshape(Nc * 6, 4)
        Sii = Hii - B_ii + lam * jnp.eye(4) + jnp.diag(1.0 - mask4)
        S = jnp.block([[S, Sci], [Sci.T, Sii]])
        rhs = jnp.concatenate([rhs.reshape(-1), -(g_i - corr_i)])

    # symmetric Jacobi scaling before the LU solve: S is PSD only up to
    # f32 roundoff (entries span ~1e7 : lam), and an unscaled
    # factorization can go singular
    d = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
    Ss = S * d[:, None] * d[None, :]
    y = jnp.linalg.solve(Ss, rhs.reshape(-1) * d)
    x = y * d
    dc = x[:Nc * 6].reshape(Nc, 6)
    dc = jnp.where(p.cam_fixed[:, None], 0.0, dc)

    # back-substitute point updates: dp = Hpp^-1 (-g_p - Hpc dc [- Hpi di])
    Jdc = jnp.einsum("oki,oi->ok", Jc, dc[p.obs_cam])
    if opt_intr:
        di = x[Nc * 6:] * mask4
        Jdc = Jdc + jnp.einsum("oki,i->ok", Ji, di)
    hpc = _seg_sum(jnp.einsum("oki,ok->oi", Jp, Jdc), p.obs_pt, Np)
    dp = _solve33(Hpp, -g_p - hpc)
    if opt_intr:
        return dc, dp, di, cost
    return dc, dp, cost


def schur_cg_step(p: BAProblem, lam, cg_iters: int = 25, psum_axis=None,
                  huber_delta=None):
    """One damped Gauss-Newton step. Returns (d_cams, d_points, cost)."""
    r = residuals(p)
    cost = robust_cost(r, huber_delta)
    if psum_axis is not None:
        cost = jax.lax.psum(cost, psum_axis)
    sw = None
    if huber_delta is not None:
        sw = _huber_sw(r, huber_delta)
        r = r * sw
    ops = _build_schur(p, lam, psum_axis=psum_axis, sw=sw)

    g_c = _seg_sum(jnp.einsum("oki,ok->oi", ops.Jc, r), p.obs_cam, ops.Nc)
    if psum_axis is not None:
        g_c = jax.lax.psum(g_c, psum_axis)
    g_p = _seg_sum(jnp.einsum("oki,ok->oi", ops.Jp, r), p.obs_pt, ops.Np)

    hp = _solve33(ops.Hpp_inv_chol, g_p)
    Jphp = jnp.einsum("oki,oi->ok", ops.Jp, hp[p.obs_pt])
    rhs_corr = _seg_sum(jnp.einsum("oki,ok->oi", ops.Jc, Jphp),
                        p.obs_cam, ops.Nc)
    if psum_axis is not None:
        rhs_corr = jax.lax.psum(rhs_corr, psum_axis)
    rhs = -(g_c - rhs_corr)                            # [Nc, 6]

    # preconditioned CG on S x = rhs
    x = jnp.zeros_like(rhs)
    res = rhs - _apply_S(ops, x, psum_axis)
    z = _precond(ops, res)
    d = z
    rz = jnp.sum(res * z)

    def body(_, state):
        x, res, d, rz = state
        Sd = _apply_S(ops, d, psum_axis)
        denom = jnp.sum(d * Sd)
        # f32 roundoff can make S indefinite near convergence: a
        # non-positive curvature direction would blow alpha up to inf
        # and poison the whole step with NaN — freeze instead
        live = denom > 1e-20
        alpha = jnp.where(live, rz / jnp.where(live, denom, 1.0), 0.0)
        x = x + alpha * d
        res = res - alpha * Sd
        z = _precond(ops, res)
        rz_new = jnp.sum(res * z)
        beta = jnp.where(live, rz_new / jnp.maximum(rz, 1e-20), 0.0)
        d = z + beta * d
        return x, res, d, jnp.where(live, rz_new, rz)

    x, res, d, rz = jax.lax.fori_loop(0, cg_iters, body, (x, res, d, rz))
    dc = jnp.where(p.cam_fixed[:, None], 0.0, x)

    # back-substitute point updates: dp = Hpp^-1 (-g_p - Hpc dc)
    Jdc = jnp.einsum("oki,oi->ok", ops.Jc, dc[p.obs_cam])
    hpc = _seg_sum(jnp.einsum("oki,ok->oi", ops.Jp, Jdc), p.obs_pt, ops.Np)
    dp = _solve33(ops.Hpp_inv_chol, -g_p - hpc)
    return dc, dp, cost


def _intr_jacobian(p: BAProblem):
    """Per-observation Jacobian wrt the shared intrinsics Ji [No,2,4]
    (forward autodiff through the pinhole projection), masked like the
    camera/point Jacobians."""
    def one(ci, pi, uv):
        f = lambda intr: project(p.cams[ci], p.points[pi], intr) - uv
        return jax.jacfwd(f)(p.intr)
    Ji = jax.vmap(one)(p.obs_cam, p.obs_pt, p.obs_uv)
    return jnp.where(p.obs_valid[:, None, None], Ji, 0.0)


def intr_step(p: BAProblem, lam, huber_delta=None, psum_axis=None,
              intr_mask=None):
    """One damped GN step on the SHARED intrinsics block (fx fy cx cy)
    with cameras/points held fixed — the intrinsics half of a
    block-coordinate LM iteration (``bundle_adjust(opt_intr=True)``).

    The block is 4-dimensional, so the normal equations are a single
    [4, 4] solve; distributed, that is one tiny psum of (H, g) per
    step — negligible next to the Schur reductions. ``intr_mask``
    (f32[4], 1 = optimize) freezes components, e.g. [1, 1, 0, 0] to
    refine focal only. (New capability: the reference ends at
    matching, features.cu, and has no notion of intrinsics at all.)
    """
    r = residuals(p)
    if huber_delta is not None:
        sw = _huber_sw(r, huber_delta)
        r = r * sw
    Ji = _intr_jacobian(p)
    if huber_delta is not None:
        Ji = Ji * sw[:, :, None]
    H = jnp.einsum("oki,okj->ij", Ji, Ji)
    g = jnp.einsum("oki,ok->i", Ji, r)
    if psum_axis is not None:
        H = jax.lax.psum(H, psum_axis)
        g = jax.lax.psum(g, psum_axis)
    mask = (jnp.ones(4, jnp.float32) if intr_mask is None
            else jnp.asarray(intr_mask, jnp.float32))
    # frozen components: zero rows/cols + unit diagonal
    H = H * mask[:, None] * mask[None, :]
    H = H + (lam + 1e-8) * jnp.eye(4) + jnp.diag(1.0 - mask)
    di = -jnp.linalg.solve(H, g * mask)
    return di * mask


def dense_schur_feasible(n_cams: int, n_points: int,
                         budget_bytes: int = 1 << 31) -> bool:
    """Whether the explicit dense-U Schur path fits the memory budget."""
    return n_cams * 6 <= 4096 and n_points * n_cams * 72 <= budget_bytes


@partial(jax.jit, static_argnames=("iters", "cg_iters", "dense",
                                   "huber_delta", "opt_intr"))
def bundle_adjust(p: BAProblem, iters: int = 10, cg_iters: int = 25,
                  lam0: float = 1e-3, dense: bool | None = None,
                  huber_delta: float | None = None,
                  opt_intr: bool = False, intr_mask=None):
    """Levenberg-Marquardt loop (jitted, fixed iteration count).

    Accept/reject with damping update: classic LM without host sync.
    ``dense`` selects the dense-Schur direct solve
    (:func:`schur_dense_step`) over matrix-free CG; by default it is on
    whenever the dense coupling matrix fits memory. ``huber_delta``
    switches the objective to the Huber loss on the per-observation
    residual norm (IRLS reweighting each GN step), capping any single
    observation's influence — use when the track set may contain
    mismatches. ``opt_intr`` alternates a shared-intrinsics GN step
    (:func:`intr_step`) with every camera/point step, each with its own
    accept/reject; ``intr_mask`` (f32[4], 1 = optimize) restricts the
    refined components (e.g. ``[1, 1, 0, 0]`` for focal only).
    """
    if dense is None:
        dense = dense_schur_feasible(int(p.cams.shape[0]),
                                     int(p.points.shape[0]))

    def body(state, _):
        prob, lam = state
        if dense and opt_intr:
            # joint augmented-Schur step: cams + points + intrinsics in
            # one solve (the alternating intr_step stalls on the
            # focal<->depth coupled direction)
            dc, dp, di, cost = schur_dense_step(
                prob, lam, huber_delta=huber_delta,
                opt_intr=True, intr_mask=intr_mask)
        elif dense:
            dc, dp, cost = schur_dense_step(prob, lam,
                                            huber_delta=huber_delta)
            di = None
        else:
            dc, dp, cost = schur_cg_step(prob, lam, cg_iters=cg_iters,
                                         huber_delta=huber_delta)
            di = None
        new = prob._replace(cams=prob.cams + dc, points=prob.points + dp)
        if di is not None:
            new = new._replace(intr=prob.intr + di)
        new_r = residuals(new)
        new_cost = robust_cost(new_r, huber_delta)
        ok = new_cost < cost           # NaN steps are rejected too
        # accept/reject the whole step
        cams = jnp.where(ok, new.cams, prob.cams)
        points = jnp.where(ok, new.points, prob.points)
        intr = jnp.where(ok, new.intr, prob.intr)
        prob = prob._replace(cams=cams, points=points, intr=intr)
        cost = jnp.where(ok, new_cost, cost)
        if opt_intr and not dense:
            # CG path: alternate a shared-intrinsics GN step (approximate
            # but memory-free; the dense path does the joint solve)
            di = intr_step(prob, lam, huber_delta=huber_delta,
                           intr_mask=intr_mask)
            cand = prob._replace(intr=prob.intr + di)
            c_cost = robust_cost(residuals(cand), huber_delta)
            ok_i = c_cost < cost
            prob = prob._replace(
                intr=jnp.where(ok_i, cand.intr, prob.intr))
            cost = jnp.where(ok_i, c_cost, cost)
        lam = jnp.where(ok, lam * 0.5, lam * 4.0)
        return (prob, lam), cost

    (prob, lam), costs = jax.lax.scan(
        body, (p, jnp.float32(lam0)), None, length=iters)
    return prob, costs
