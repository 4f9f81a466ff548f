"""Incremental SfM: tracks -> seed pair -> PnP registration -> BA,
plus checkpoint/resume, on a synthetic multi-view scene."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from popsift_tpu.sfm.checkpoint import load_reconstruction, save_reconstruction
from popsift_tpu.sfm.evaluate import ate_rmse, camera_centers
from popsift_tpu.sfm.incremental import IncrementalSfM
from popsift_tpu.sfm.pnp import ransac_pnp
from popsift_tpu.sfm.rotation import exp_so3
from popsift_tpu.sfm.tracks import Tracks, build_tracks
from popsift_tpu.utils.device import CACHE_DIR

INTR = np.array([500.0, 500.0, 320.0, 240.0], np.float32)


def make_multiview(rng, n_pts=80, n_cams=5, noise=0.0):
    X = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n_pts, 3)).astype(np.float32)
    cams = []
    for i in range(n_cams):
        w = np.array([0.03 * i, -0.04 * i, 0.02 * i], np.float32)
        R = np.asarray(exp_so3(jnp.asarray(w)))
        C = np.array([0.4 * i, 0.05 * i, -0.08 * i], np.float32)
        cams.append((R.astype(np.float32), (-R @ C).astype(np.float32)))
    fx, fy, cx, cy = INTR
    kps, vis = {}, {}
    for i, (R, t) in enumerate(cams):
        Xc = X @ R.T + t
        x = Xc[:, :2] / Xc[:, 2:3]
        uv = np.stack([fx * x[:, 0] + cx, fy * x[:, 1] + cy], -1)
        if noise > 0:
            uv = uv + rng.normal(0, noise, uv.shape)
        kps[i] = uv.astype(np.float32)
        vis[i] = np.arange(n_pts)
    return X, cams, kps


def tracks_from_gt(kps, n_pts):
    """Ground-truth tracks: feature j in every image is point j."""
    tid, iid, fid, uv = [], [], [], []
    for img, k in kps.items():
        for j in range(n_pts):
            tid.append(j)
            iid.append(img)
            fid.append(j)
            uv.append(k[j])
    return Tracks(track_id=np.asarray(tid), image_id=np.asarray(iid),
                  feature_id=np.asarray(fid),
                  uv=np.stack(uv).astype(np.float32), n_tracks=n_pts)


def test_build_tracks_union_find():
    kps = {0: np.zeros((4, 2), np.float32),
           1: np.ones((4, 2), np.float32),
           2: 2 * np.ones((4, 2), np.float32)}
    matches = {(0, 1): np.array([[0, 1], [1, 2]]),
               (1, 2): np.array([[1, 3], [2, 0]])}
    t = build_tracks(matches, kps)
    # track A: (0,0)-(1,1)-(2,3); track B: (0,1)-(1,2)-(2,0)
    assert t.n_tracks == 2
    assert len(t.track_id) == 6


def test_build_tracks_drops_inconsistent():
    kps = {0: np.zeros((4, 2), np.float32), 1: np.zeros((4, 2), np.float32)}
    # feature (0,0) matches two different features of image 1 -> fold into
    # one track with two obs in image 1 -> dropped
    matches = {(0, 1): np.array([[0, 1], [0, 2]])}
    t = build_tracks(matches, kps)
    assert t.n_tracks == 0


def test_pnp_ransac_with_outliers():
    rng = np.random.default_rng(3)
    X, cams, kps = make_multiview(rng, n_pts=96, n_cams=2)
    R, t = cams[1]
    fx, fy, cx, cy = INTR
    uv = kps[1]
    x = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    # 25% outliers
    n_out = 24
    x[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    res = ransac_pnp(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(x),
                     jnp.ones(len(X), bool), thresh=1e-5)
    assert int(res.n_inliers) >= 96 - n_out - 2
    np.testing.assert_allclose(np.asarray(res.R), R, atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.t), t, atol=1e-2)


@pytest.mark.slow
def test_incremental_reconstruction_and_ate(tmp_path):
    rng = np.random.default_rng(7)
    n_pts, n_cams = 80, 5
    X, cams, kps = make_multiview(rng, n_pts=n_pts, n_cams=n_cams,
                                  noise=0.3)
    tracks = tracks_from_gt(kps, n_pts)
    sfm = IncrementalSfM(tracks, INTR, checkpoint_dir=str(tmp_path / "ck"))
    pair = sfm.initialize()
    assert pair is not None
    while sfm.register_next() is not None:
        pass
    assert len(sfm.rec.registered) == n_cams
    sfm.global_ba(iters=8)

    def centers(pairs):
        return np.stack([-(R.T @ t) for R, t in pairs])

    C_est = centers([(sfm.rec.cam_R[i], sfm.rec.cam_t[i])
                     for i in range(n_cams)])
    C_gt = centers(cams)
    rmse = ate_rmse(C_est, C_gt)
    assert rmse < 0.05, f"ATE {rmse}"

    # checkpoint/resume: latest checkpoint reproduces the state
    rec2 = load_reconstruction(str(tmp_path / "ck"))
    assert rec2.registered == sfm.rec.registered
    np.testing.assert_allclose(rec2.cam_t[2], sfm.rec.cam_t[2], atol=1e-6)
    assert len(rec2.points) == len(sfm.rec.points)


@pytest.mark.slow
def test_fault_injection_resume(tmp_path):
    """Kill an SfM run mid-registration (subprocess hard-exit), resume
    from LATEST, and converge to the same reconstruction as an
    uninterrupted run (VERDICT round-2 item 10)."""
    import os
    import subprocess
    import sys

    ck = str(tmp_path / "ck")
    driver = f"""
import os, sys
sys.path.insert(0, {os.path.dirname(__file__)!r})
sys.path.insert(0, {os.path.join(os.path.dirname(__file__), "..")!r})
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from test_sfm_incremental import INTR, make_multiview, tracks_from_gt
from popsift_tpu.sfm.incremental import IncrementalSfM
rng = np.random.default_rng(7)
X, cams, kps = make_multiview(rng, n_pts=60, n_cams=5, noise=0.0)
tracks = tracks_from_gt(kps, 60)
sfm = IncrementalSfM(tracks, INTR, checkpoint_dir={ck!r})
sfm.initialize()
sfm.register_next()
os._exit(17)    # simulated crash mid-run: no cleanup, no final BA
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", CACHE_DIR)
    p = subprocess.run([sys.executable, "-c", driver], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 17, p.stderr[-3000:]
    assert os.path.exists(os.path.join(ck, "LATEST"))

    # resume from the crash point and finish
    rng = np.random.default_rng(7)
    X, cams, kps = make_multiview(rng, n_pts=60, n_cams=5, noise=0.0)
    tracks = tracks_from_gt(kps, 60)
    sfm = IncrementalSfM.resume(tracks, ck)
    assert len(sfm.rec.registered) == 3     # init pair + 1 registration
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=8)
    assert len(sfm.rec.registered) == 5

    # reference: uninterrupted run on the same scene
    ref = IncrementalSfM(tracks, INTR)
    ref.initialize()
    while ref.register_next() is not None:
        pass
    ref.global_ba(iters=8)

    def centers(rec):
        return np.stack([-(rec.cam_R[i].T @ rec.cam_t[i])
                         for i in range(5)])

    np.testing.assert_allclose(centers(sfm.rec), centers(ref.rec),
                               atol=1e-3)
    assert len(sfm.rec.points) == len(ref.rec.points)


def test_refine_culls_corrupted_points():
    """Iterative refinement (BA -> cull -> retriangulate -> BA) removes
    planted gross structure errors and restores them by
    retriangulation, keeping the ATE bound."""
    rng = np.random.default_rng(9)
    n_pts, n_cams = 80, 5
    X, cams, kps = make_multiview(rng, n_pts=n_pts, n_cams=n_cams,
                                  noise=0.3)
    tracks = tracks_from_gt(kps, n_pts)
    sfm = IncrementalSfM(tracks, INTR)
    sfm.initialize()
    while sfm.register_next() is not None:
        pass
    sfm.global_ba(iters=8)
    n_before = len(sfm.rec.points)

    # corrupt 10 reconstructed points
    bad = list(sfm.rec.points)[:10]
    for tr in bad:
        sfm.rec.points[tr] = sfm.rec.points[tr] + np.float32(3.0)
    assert sfm.cull_points(max_err_px=4.0) >= 8   # detects the damage

    sfm2 = sfm  # refine retriangulates the culled tracks
    sfm2.refine(rounds=2)
    assert len(sfm2.rec.points) >= n_before - 2

    C_est = np.stack([-(sfm2.rec.cam_R[i].T @ sfm2.rec.cam_t[i])
                      for i in range(n_cams)])
    C_gt = np.stack([-(R.T @ t) for R, t in cams])
    assert ate_rmse(C_est, C_gt) < 0.05
