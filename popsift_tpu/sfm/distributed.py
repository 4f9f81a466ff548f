"""Distributed bundle adjustment over a device mesh.

The BASELINE north star: "distributed bundle adjustment with
Schur-complement reduction over ICI collectives, keyframes/map blocks
sharded across a multi-host slice".

Sharding layout (landmark-parallel):

* observations are partitioned by *point*: every point's observations
  live on exactly one shard, so Hpp stays block-local (the 3x3 landmark
  blocks never cross devices).
* camera parameters are replicated; every camera-side reduction
  (Hcc v, g_c, the Schur correction sum over points) becomes a
  ``psum`` over the mesh axis — these are the Schur-complement
  reductions as collectives.
* the CG loop therefore runs identically on every device on the
  replicated [Nc, 6] camera system; point back-substitution is local.

``partition_by_point`` prepares a BAProblem for a mesh: points and their
observations are bucketed round-robin into equal-size shards (padded
with invalid observations).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .ba import BAProblem, residuals, schur_cg_step


def partition_by_point(p: BAProblem, n_shards: int) -> BAProblem:
    """Reorder/pad a BAProblem so points and observations split evenly
    into ``n_shards`` contiguous, point-aligned blocks. Host-side."""
    cams = np.asarray(p.cams)
    pts = np.asarray(p.points)
    oc = np.asarray(p.obs_cam)
    op = np.asarray(p.obs_pt)
    uv = np.asarray(p.obs_uv)
    ov = np.asarray(p.obs_valid)
    Np = pts.shape[0]

    # round-robin points over shards, padding EVERY shard to np_per
    # (with Np not divisible by n_shards, shards get floor or ceil
    # counts — each must be padded individually so the per-shard local
    # indices line up with the [n_shards, np_per] point layout)
    np_per = -(-Np // n_shards) if Np else 1
    pt_shard = np.arange(Np) % n_shards
    pts2 = np.zeros((n_shards, np_per, 3), pts.dtype)
    new_index = np.empty(Np, np.int64)
    for s in range(n_shards):
        ids = np.nonzero(pt_shard == s)[0]
        pts2[s, :len(ids)] = pts[ids]
        new_index[ids] = s * np_per + np.arange(len(ids))

    # group observations by point shard
    obs_shard = pt_shard[op]
    grouped = [np.nonzero((obs_shard == s) & ov)[0]
               for s in range(n_shards)]
    No_per = max(max(len(r) for r in grouped), 1)

    n_oc = np.zeros((n_shards, No_per), np.int32)
    n_op = np.zeros((n_shards, No_per), np.int32)
    n_uv = np.zeros((n_shards, No_per, 2), np.float32)
    n_ov = np.zeros((n_shards, No_per), bool)
    for s, rows in enumerate(grouped):
        k = len(rows)
        n_oc[s, :k] = oc[rows]
        # local point index within the shard
        n_op[s, :k] = new_index[op[rows]] - s * np_per
        n_uv[s, :k] = uv[rows]
        n_ov[s, :k] = True

    return BAProblem(
        cams=jnp.asarray(cams),
        points=jnp.asarray(pts2),
        intr=p.intr,
        obs_cam=jnp.asarray(n_oc),
        obs_pt=jnp.asarray(n_op),
        obs_uv=jnp.asarray(n_uv),
        obs_valid=jnp.asarray(n_ov),
        cam_fixed=p.cam_fixed,
    ), new_index


def make_distributed_ba_fn(mesh: Mesh, axis_name: str = "dp",
                           iters: int = 8, cg_iters: int = 20,
                           lam0: float = 1e-3, dense: bool = False,
                           opt_intr: bool = False, intr_mask=None):
    """Build a jitted distributed LM-BA over the given mesh.

    Takes the sharded BAProblem layout from ``partition_by_point``
    (leading shard axis on points/observations) and returns the
    optimized problem plus per-iteration costs. With ``dense`` the
    reduced camera system is built locally per shard and psum'd once per
    GN step ([6Nc, 6Nc]) instead of two [Nc, 6] psums per CG iteration —
    fewer, fatter collectives, and an exact solve
    (ba.py::schur_dense_step). ``opt_intr`` + ``dense`` jointly solves
    the [6Nc+4] augmented reduced system (one extra [6Nc, 4] + [4, 4]
    psum; ba.py::schur_dense_step(opt_intr=True)); on the CG path it
    falls back to alternating a shared-intrinsics GN step per LM
    iteration (one [4, 4] + [4] psum, ba.py::intr_step). The refined
    intrinsics are returned replicated.
    """
    from .ba import intr_step, schur_dense_step

    def local(cams, points, intr, oc, op, uv, ov, fixed):
        prob = BAProblem(cams=cams, points=points, intr=intr,
                         obs_cam=oc, obs_pt=op, obs_uv=uv,
                         obs_valid=ov, cam_fixed=fixed)

        def psum_cost(pr):
            r = residuals(pr)
            return jax.lax.psum(jnp.sum(r * r), axis_name)

        def body(state, _):
            prob, lam = state
            di = None
            if dense and opt_intr:
                dc, dp, di, cost = schur_dense_step(
                    prob, lam, psum_axis=axis_name,
                    opt_intr=True, intr_mask=intr_mask)
            elif dense:
                dc, dp, cost = schur_dense_step(prob, lam,
                                                psum_axis=axis_name)
            else:
                dc, dp, cost = schur_cg_step(prob, lam,
                                             cg_iters=cg_iters,
                                             psum_axis=axis_name)
            new = prob._replace(cams=prob.cams + dc,
                                points=prob.points + dp)
            if di is not None:
                new = new._replace(intr=prob.intr + di)
            new_cost = psum_cost(new)
            ok = new_cost < cost       # NaN steps are rejected too
            cams = jnp.where(ok, new.cams, prob.cams)
            points = jnp.where(ok, new.points, prob.points)
            intr = jnp.where(ok, new.intr, prob.intr)
            prob = prob._replace(cams=cams, points=points, intr=intr)
            cost = jnp.where(ok, new_cost, cost)
            if opt_intr and not dense:
                di = intr_step(prob, lam, psum_axis=axis_name,
                               intr_mask=intr_mask)
                cand = prob._replace(intr=prob.intr + di)
                c_cost = psum_cost(cand)
                ok_i = c_cost < cost
                prob = prob._replace(
                    intr=jnp.where(ok_i, cand.intr, prob.intr))
                cost = jnp.where(ok_i, c_cost, cost)
            lam = jnp.where(ok, lam * 0.5, lam * 4.0)
            return (prob, lam), cost

        (prob, _), costs = jax.lax.scan(
            body, (prob, jnp.float32(lam0)), None, length=iters)
        return prob.cams, prob.points, prob.intr, costs

    spec_sh = P(axis_name)       # sharded leading axis
    spec_rep = P()               # replicated
    mapped = shard_map(
        local, mesh=mesh,
        in_specs=(spec_rep, spec_sh, spec_rep, spec_sh, spec_sh,
                  spec_sh, spec_sh, spec_rep),
        out_specs=(spec_rep, spec_sh, spec_rep, spec_rep))

    @jax.jit
    def run(p: BAProblem):
        # strip the leading shard axis per-device inside shard_map
        def inner(cams, points, intr, oc, op, uv, ov, fixed):
            return mapped(cams, points, intr, oc, op, uv, ov, fixed)
        cams, points, intr, costs = inner(
            p.cams, p.points.reshape(-1, 3), p.intr,
            p.obs_cam.reshape(-1), p.obs_pt.reshape(-1),
            p.obs_uv.reshape(-1, 2), p.obs_valid.reshape(-1), p.cam_fixed)
        return p._replace(cams=cams, intr=intr,
                          points=points.reshape(p.points.shape)), costs

    return run
