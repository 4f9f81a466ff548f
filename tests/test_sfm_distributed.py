"""Distributed Schur-complement BA on the 8-device virtual mesh."""

import jax
import numpy as np
import pytest

from popsift_tpu.parallel.mesh import make_mesh
from popsift_tpu.sfm.ba import bundle_adjust, residuals
from popsift_tpu.sfm.distributed import make_distributed_ba_fn, partition_by_point
from popsift_tpu.sfm.evaluate import ate_rmse, camera_centers
from tests.test_sfm import _make_ba_problem

pytestmark = pytest.mark.distributed


def test_partition_preserves_problem():
    rng = np.random.default_rng(7)
    prob, _, _ = _make_ba_problem(rng, n_cams=3, n_pts=50)
    sharded, new_index = partition_by_point(prob, 8)
    assert sharded.points.shape[0] == 8
    # every original observation appears exactly once
    assert int(np.asarray(sharded.obs_valid).sum()) == prob.obs_cam.shape[0]
    # residuals identical (compare sums of squares)
    import jax.numpy as jnp
    flat = sharded._replace(
        points=sharded.points.reshape(-1, 3),
        obs_cam=sharded.obs_cam.reshape(-1),
        obs_pt=(sharded.obs_pt
                + (jnp.arange(8)[:, None] * sharded.points.shape[1])
                ).reshape(-1),
        obs_uv=sharded.obs_uv.reshape(-1, 2),
        obs_valid=sharded.obs_valid.reshape(-1))
    r_flat = np.asarray(residuals(flat))
    r_orig = np.asarray(residuals(prob))
    assert abs((r_flat ** 2).sum() - (r_orig ** 2).sum()) < 1e-3


def test_distributed_ba_matches_single_device():
    rng = np.random.default_rng(8)
    prob, cams_gt, _ = _make_ba_problem(rng, n_cams=5, n_pts=64,
                                        noise_px=0.3)
    # single-device result
    out_s, costs_s = bundle_adjust(prob, iters=8, cg_iters=20)
    ate_s = ate_rmse(camera_centers(np.asarray(out_s.cams)),
                     camera_centers(cams_gt))

    mesh = make_mesh(8)
    sharded, _ = partition_by_point(prob, 8)
    run = make_distributed_ba_fn(mesh, iters=8, cg_iters=20)
    out_d, costs_d = run(sharded)
    ate_d = ate_rmse(camera_centers(np.asarray(out_d.cams)),
                     camera_centers(cams_gt))

    assert ate_d < max(2 * ate_s, 5e-3), f"dist ATE {ate_d} vs single {ate_s}"
    # costs should track each other closely
    np.testing.assert_allclose(np.asarray(costs_d)[-1],
                               np.asarray(costs_s)[-1], rtol=0.2)


def test_dense_schur_matches_cg():
    """The dense-Schur direct step must agree with matrix-free CG at
    the LM level, and the distributed dense path (one psum'd [6Nc,6Nc]
    per step) must match the single-device dense path."""
    import jax.numpy as jnp
    from popsift_tpu.sfm.ba import BAProblem, bundle_adjust, project

    rng = np.random.default_rng(3)
    nc, npts = 8, 160
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (npts, 3)).astype(np.float32)
    intr = jnp.asarray([500.0, 500.0, 320.0, 240.0], jnp.float32)
    obs_c, obs_p, obs_uv, cams = [], [], [], []
    for i in range(nc):
        w = np.concatenate([rng.normal(0, 0.02, 3),
                            [0.3 * i, 0, 0]]).astype(np.float32)
        cams.append(w)
        for j in range(npts):
            if rng.random() < 0.6:
                uv = np.asarray(project(jnp.asarray(w), jnp.asarray(X[j]),
                                        intr))
                obs_c.append(i)
                obs_p.append(j)
                obs_uv.append(uv + rng.normal(0, 0.5, 2))
    prob = BAProblem(
        cams=jnp.asarray(np.stack(cams)),
        points=jnp.asarray(X + rng.normal(0, 0.05, X.shape)
                           .astype(np.float32)),
        intr=intr,
        obs_cam=jnp.asarray(np.array(obs_c, np.int32)),
        obs_pt=jnp.asarray(np.array(obs_p, np.int32)),
        obs_uv=jnp.asarray(np.stack(obs_uv).astype(np.float32)),
        obs_valid=jnp.ones(len(obs_c), bool),
        cam_fixed=jnp.asarray([True] + [False] * (nc - 1)))

    out_cg, costs_cg = bundle_adjust(prob, iters=6, cg_iters=60,
                                     dense=False)
    out_d, costs_d = bundle_adjust(prob, iters=6, dense=True)
    assert float(costs_d[-1]) <= float(costs_d[0])
    rel = abs(float(costs_d[-1]) - float(costs_cg[-1])) / \
        max(float(costs_cg[-1]), 1e-9)
    assert rel < 0.01, (float(costs_d[-1]), float(costs_cg[-1]))

    from popsift_tpu.parallel.mesh import make_mesh
    from popsift_tpu.sfm.distributed import (
        make_distributed_ba_fn, partition_by_point)
    mesh = make_mesh(8, axis_name="sp")
    sh, _ = partition_by_point(prob, 8)
    ba = make_distributed_ba_fn(mesh, axis_name="sp", iters=6, dense=True)
    _, costs_dist = ba(sh)
    np.testing.assert_allclose(float(costs_dist[-1]), float(costs_d[-1]),
                               rtol=1e-3)


def test_distributed_joint_intrinsics_matches_single_device():
    """The joint augmented-Schur intrinsics solve must produce the same
    refined focal distributed (point-sharded obs, one extra [6Nc,4] +
    [4,4] psum) as on a single device."""
    import jax.numpy as jnp
    from popsift_tpu.parallel.mesh import make_mesh
    from popsift_tpu.sfm.ba import BAProblem, project
    from popsift_tpu.sfm.distributed import (
        make_distributed_ba_fn, partition_by_point)
    from popsift_tpu.sfm.rotation import exp_so3

    rng = np.random.default_rng(13)
    f, cx, cy = 500.0, 320.0, 240.0
    nc, npts = 6, 64
    X = rng.uniform([-2, -2, -2], [2, 2, 2], (npts, 3)).astype(np.float32)
    cams = []
    for i in range(nc):
        ang = 2 * np.pi * i / nc * 0.3
        C = np.array([7 * np.sin(ang), 2.5 * np.sin(2 * ang + 1.0),
                      -7 * np.cos(ang)], np.float32)
        w = np.array([0.2 * np.sin(3 * i + 0.5), ang,
                      0.1 * np.cos(2 * i)], np.float32)
        R = np.asarray(exp_so3(jnp.asarray(w)))
        cams.append(np.concatenate([w, (-R @ C).astype(np.float32)]))
    cams = np.stack(cams)
    intr = jnp.asarray([f, f, cx, cy], jnp.float32)
    obs_c, obs_p, obs_uv = [], [], []
    for i in range(nc):
        for j in range(npts):
            uv = np.asarray(project(jnp.asarray(cams[i]),
                                    jnp.asarray(X[j]), intr))
            obs_c.append(i)
            obs_p.append(j)
            obs_uv.append(uv + rng.normal(0, 0.2, 2))
    prob = BAProblem(
        cams=jnp.asarray(cams + rng.normal(0, 0.005, cams.shape)
                         .astype(np.float32)),
        points=jnp.asarray(X + rng.normal(0, 0.03, X.shape)
                           .astype(np.float32)),
        intr=intr * jnp.asarray([1.05, 1.05, 1.0, 1.0]),
        obs_cam=jnp.asarray(np.array(obs_c, np.int32)),
        obs_pt=jnp.asarray(np.array(obs_p, np.int32)),
        obs_uv=jnp.asarray(np.stack(obs_uv).astype(np.float32)),
        obs_valid=jnp.ones(len(obs_c), bool),
        cam_fixed=jnp.asarray([True] + [False] * (nc - 1)))

    out_s, costs_s = bundle_adjust(prob, iters=10, dense=True,
                                   opt_intr=True,
                                   intr_mask=(1.0, 1.0, 0.0, 0.0))
    assert abs(float(out_s.intr[0]) - f) / f < 0.01

    mesh = make_mesh(8, axis_name="sp")
    sh, _ = partition_by_point(prob, 8)
    ba = make_distributed_ba_fn(mesh, axis_name="sp", iters=10,
                                dense=True, opt_intr=True,
                                intr_mask=(1.0, 1.0, 0.0, 0.0))
    out_d, costs_d = ba(sh)
    np.testing.assert_allclose(np.asarray(out_d.intr),
                               np.asarray(out_s.intr), rtol=1e-3)
    np.testing.assert_allclose(float(costs_d[-1]), float(costs_s[-1]),
                               rtol=1e-3)


def test_distributed_rotation_translation_averaging():
    """Edge-sharded global averaging on the 8-device mesh reproduces the
    single-device solution: each device assembles normal equations from
    its edge shard, one psum per round forms the global system."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from popsift_tpu.sfm.global_sfm import (rotation_averaging,
                                            translation_averaging)
    from popsift_tpu.sfm.rotation import exp_so3

    rng = np.random.default_rng(3)
    n = 24
    R_gt = np.asarray(exp_so3(jnp.asarray(
        rng.normal(0, 1, (n, 3)).astype(np.float32))))
    C_gt = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    ei = list(range(n - 1))
    ej = list(range(1, n))
    for _ in range(4 * n):
        i, j = rng.integers(0, n, 2)
        if i != j:
            ei.append(min(i, j))
            ej.append(max(i, j))
    ei = np.asarray(ei, np.int32)
    ej = np.asarray(ej, np.int32)
    E = len(ei)
    R_rel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei]) \
        .astype(np.float32)
    d = C_gt[ej] - C_gt[ei]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    # pad edges to a multiple of 8 with masked (0, 0) self-loops
    Ep = -(-E // 8) * 8
    pad = Ep - E
    eip = np.concatenate([ei, np.zeros(pad, np.int32)])
    ejp = np.concatenate([ej, np.zeros(pad, np.int32)])
    Rp = np.concatenate([R_rel, np.tile(np.eye(3, dtype=np.float32),
                                        (pad, 1, 1))])
    dp = np.concatenate([d, np.tile(np.float32([1, 0, 0]), (pad, 1))])
    vp = np.arange(Ep) < E

    mesh = make_mesh(8, axis_name="e")
    rot_sh = shard_map(
        lambda a, b, c, v: rotation_averaging(
            n, a, b, c, valid=v, psum_axis="e"),
        mesh=mesh, in_specs=(P("e"), P("e"), P("e"), P("e")),
        out_specs=(P(), P("e")))
    R_dist, _ = rot_sh(jnp.asarray(eip), jnp.asarray(ejp),
                       jnp.asarray(Rp), jnp.asarray(vp))
    R_ref, _ = rotation_averaging(n, jnp.asarray(eip), jnp.asarray(ejp),
                                  jnp.asarray(Rp),
                                  valid=jnp.asarray(vp))
    np.testing.assert_allclose(np.asarray(R_dist), np.asarray(R_ref),
                               atol=2e-4)

    tr_sh = shard_map(
        lambda a, b, c, v: translation_averaging(
            n, a, b, c, valid=v, psum_axis="e"),
        mesh=mesh, in_specs=(P("e"), P("e"), P("e"), P("e")),
        out_specs=(P(), P("e")))
    C_dist, _ = tr_sh(jnp.asarray(eip), jnp.asarray(ejp),
                      jnp.asarray(dp), jnp.asarray(vp))
    C_ref, _ = translation_averaging(n, jnp.asarray(eip),
                                     jnp.asarray(ejp), jnp.asarray(dp),
                                     valid=jnp.asarray(vp))
    np.testing.assert_allclose(np.asarray(C_dist), np.asarray(C_ref),
                               atol=2e-3)
    assert ate_rmse(np.asarray(C_dist), C_gt) < 0.05
