"""SfM at scale: end-to-end incremental reconstruction of a 40-camera
synthetic sequence with a distributed final BA on the 8-device mesh
(VERDICT round-2 item 8). Asserts the ATE bound from BASELINE.json and
cost parity between single-device and distributed BA.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from popsift_tpu.parallel.mesh import make_mesh
from popsift_tpu.sfm.evaluate import ate_rmse
from popsift_tpu.sfm.incremental import IncrementalSfM
from popsift_tpu.sfm.rotation import exp_so3
from popsift_tpu.sfm.tracks import Tracks

INTR = np.array([500.0, 500.0, 320.0, 240.0], np.float32)


def make_sequence(rng, n_pts=240, n_cams=40, noise=0.25,
                  window=8, span=None, vis_pts=None):
    """Forward-moving camera over a point cloud; each camera sees a
    sliding subset of points (video-like visibility, not all-see-all).

    ``span``: x-extent of the cloud. Defaults to the original fixed
    [-4, 12] box (stable test fixtures); long sequences MUST stretch it
    with the trajectory (cameras advance 0.25/frame) or late cameras
    see only a distant degenerate cloud. ``vis_pts``: fixed number of
    visible points per camera (overrides the fraction-of-n_pts
    ``window`` rule, which does not scale)."""
    x_hi = 12.0 if span is None else float(span)
    X = rng.uniform([-4, -3, 4], [x_hi, 3, 10],
                    size=(n_pts, 3)).astype(np.float32)
    order = np.argsort(X[:, 0])          # sort points along the path
    X = X[order]
    fx, fy, cx, cy = INTR
    cams, kps, vis = [], {}, {}
    for i in range(n_cams):
        w = np.array([0.02 * np.sin(i / 5), -0.015 * i / n_cams,
                      0.01 * np.cos(i / 7)], np.float32)
        R = np.asarray(exp_so3(jnp.asarray(w))).astype(np.float32)
        C = np.array([0.25 * i, 0.05 * np.sin(i / 3.0), -0.02 * i],
                     np.float32)
        t = (-R @ C).astype(np.float32)
        cams.append((R, t))
        # sliding visibility window over the path-sorted points
        lo = int(i / n_cams * n_pts * 0.6)
        hi = min(n_pts, lo + (int(vis_pts) if vis_pts
                              else int(n_pts * (window / 10))))
        ids = np.arange(lo, hi)
        Xc = X[ids] @ R.T + t
        ok = Xc[:, 2] > 0.5
        ids = ids[ok]
        Xc = Xc[ok]
        x = Xc[:, :2] / Xc[:, 2:3]
        uv = np.stack([fx * x[:, 0] + cx, fy * x[:, 1] + cy], -1)
        uv = uv + rng.normal(0, noise, uv.shape)
        kps[i] = uv.astype(np.float32)
        vis[i] = ids
    return X, cams, kps, vis


def tracks_from_vis(kps, vis):
    tid, iid, fid, uv = [], [], [], []
    for img in kps:
        for j, tr in enumerate(vis[img]):
            tid.append(int(tr))
            iid.append(img)
            fid.append(j)
            uv.append(kps[img][j])
    n_tracks = int(max(tid)) + 1
    return Tracks(track_id=np.asarray(tid), image_id=np.asarray(iid),
                  feature_id=np.asarray(fid),
                  uv=np.stack(uv).astype(np.float32), n_tracks=n_tracks)


@pytest.mark.slow
def test_sequence_reconstruction_scale():
    rng = np.random.default_rng(11)
    n_cams = 40
    X, cams, kps, vis = make_sequence(rng, n_cams=n_cams)
    tracks = tracks_from_vis(kps, vis)

    sfm = IncrementalSfM(tracks, INTR, ba_every=10)
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    n_reg = len(sfm.rec.registered)
    assert n_reg >= n_cams - 2, f"registered only {n_reg}/{n_cams}"
    costs = sfm.global_ba(iters=10)
    assert costs[-1] < costs[0]

    # ATE after similarity alignment (evaluate.py handles scale/rot)
    reg = sorted(sfm.rec.registered)
    C_est = np.stack([-(sfm.rec.cam_R[i].T @ sfm.rec.cam_t[i])
                      for i in reg])
    C_gt = np.stack([-(cams[i][0].T @ cams[i][1]) for i in reg])
    rmse = ate_rmse(C_est, C_gt)
    # BASELINE.json target: ATE within bound on benchmark sequences;
    # camera path spans ~10 units -> bound 1% of trajectory extent
    assert rmse < 0.1, f"ATE {rmse}"

    # distributed final BA on the 8-device mesh must agree with the
    # single-device result
    from popsift_tpu.sfm.ba import bundle_adjust
    from popsift_tpu.sfm.distributed import (
        make_distributed_ba_fn, partition_by_point)

    prob, cam_ids, track_ids = sfm.as_ba_problem()
    single_out, single_costs = bundle_adjust(prob, iters=3)

    mesh = make_mesh(8, axis_name="sp")
    sharded, _ = partition_by_point(prob, 8)
    ba = make_distributed_ba_fn(mesh, axis_name="sp", iters=3,
                                cg_iters=20)
    dist_out, dist_costs = ba(sharded)

    # same starting cost and matching final cost (the problem enters
    # already converged from global_ba, so LM holds it flat)
    np.testing.assert_allclose(float(dist_costs[0]),
                               float(single_costs[0]), rtol=1e-4)
    rel = abs(float(dist_costs[-1]) - float(single_costs[-1])) \
        / max(float(single_costs[-1]), 1e-9)
    assert rel < 0.01, (float(dist_costs[-1]), float(single_costs[-1]))


@pytest.mark.slow
def test_sequence_reconstruction_200_cams():
    """Long-sequence scaling (round-2 verdict item 4): 200 cameras /
    1200 points reconstruct with vectorized host bookkeeping (sparse
    co-visibility seed search, incremental seen counts, batched
    registration) inside a CI-friendly wall-clock budget, with the ATE
    bound holding."""
    import time
    rng = np.random.default_rng(13)
    n_cams, n_pts = 200, 1200
    X, cams, kps, vis = make_sequence(rng, n_pts=n_pts, n_cams=n_cams,
                                      noise=0.2)
    tracks = tracks_from_vis(kps, vis)

    t0 = time.time()
    sfm = IncrementalSfM(tracks, INTR, ba_every=25, register_batch=8)
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    n_reg = len(sfm.rec.registered)
    assert n_reg >= n_cams - 4, f"registered only {n_reg}/{n_cams}"
    costs = sfm.global_ba(iters=8)
    # <=: with the batched-registration driver the reconstruction can
    # enter this BA already at a local optimum (every LM step rejected,
    # cost held flat) — non-increase plus the ATE bound below is the gate
    assert costs[-1] <= costs[0]
    wall = time.time() - t0

    reg = sorted(sfm.rec.registered)
    C_est = np.stack([-(sfm.rec.cam_R[i].T @ sfm.rec.cam_t[i])
                      for i in reg])
    C_gt = np.stack([-(cams[i][0].T @ cams[i][1]) for i in reg])
    rmse = ate_rmse(C_est, C_gt)
    # trajectory spans ~50 units; 1% bound as in the 40-cam test
    assert rmse < 0.5, f"ATE {rmse}"
    # wall-clock regression guard for the host driver (1-core CI box;
    # the pre-vectorization driver took >30 min at this scale)
    assert wall < 900, f"200-cam reconstruction took {wall:.0f}s"
    print(f"200 cams: {n_reg} registered, ATE {rmse:.3f}, {wall:.0f}s")


@pytest.mark.slow
def test_local_ba_windowed_sequence():
    """local_ba (round-5: COLMAP-style windowed BA between rare global
    BAs) must hold the trajectory as accurately as frequent global BA
    on a long forward sequence — the 1000-camera benchmark's O(N*W)
    scaling path. Drift reproducer: ba_every=50/register_batch=8 with
    NO local BA loses this sequence (the round-5 drift probe)."""
    rng = np.random.default_rng(13)
    n_cams = 80
    X, cams, kps, vis = make_sequence(rng, n_cams=n_cams, noise=0.2,
                                      span=0.25 * n_cams + 10,
                                      vis_pts=240)
    tracks = tracks_from_vis(kps, vis)

    sfm = IncrementalSfM(tracks, INTR, ba_every=50, register_batch=8,
                         local_ba_window=12)
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    n_reg = len(sfm.rec.registered)
    assert n_reg >= n_cams - 4, f"registered only {n_reg}/{n_cams}"
    sfm.global_ba(iters=8)

    reg = sorted(sfm.rec.registered)
    C_est = np.stack([-(sfm.rec.cam_R[i].T @ sfm.rec.cam_t[i])
                      for i in reg])
    C_gt = np.stack([-(cams[i][0].T @ cams[i][1]) for i in reg])
    rmse = ate_rmse(C_est, C_gt)
    extent = float(np.linalg.norm(C_gt.max(0) - C_gt.min(0)))
    assert rmse < 0.01 * extent, f"ATE {rmse} vs extent {extent}"
