"""End-to-end images->model proof at the user surface.

One scripted run over ~100 rendered frames of a known 3-D scene,
exercising the SAME CLI composition the reference demos with
popsift-demo + popsift-match (/root/reference/src/application/main.cpp:304,
match.cpp:219-274) and continuing into the capability layer the
reference lacks (incremental SfM + COLMAP/PLY export):

  render 100 frames (orbital trajectory, ground-truth camera centers)
    -> popsift-demo   (single-frame extraction CLI, feature text file)
    -> popsift-match  (two-frame matching CLI, essential-gated)
    -> popsift-sfm    (extract all -> retrieval-shortlisted matching ->
                       tracks -> incremental PnP + BA -> --refine ->
                       COLMAP text + PLY export)
    -> ATE of the estimated trajectory vs ground truth (umeyama
       similarity alignment, sfm/evaluate.py)

Writes e2e_proof.json in its work directory (under the temp dir) and
prints it: wall time per
stage, feature / match / track counts, registered cameras, reprojection
cost, ATE. The CLI stages run one after another as child processes; the
parent never initialises JAX on a device while they run (one process per
card).

Usage (CPU: ~20-40 min on one core):
    JAX_PLATFORMS=cpu timeout 5400 python scripts/e2e_proof.py
Optional args: n_frames (default 100), height width (default 240 320).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(tempfile.gettempdir(), "e2e_proof")
OUT = os.path.join(WORK, "e2e_proof.json")


def render_sequence(n_frames=100, h=240, w=320, n_blobs=420, seed=3):
    """Render an orbital fly-around of a 3-D Gaussian-blob scene.

    Every image feature comes from a projected 3-D blob (no
    image-plane texture — that would break multi-view consistency), so
    SIFT keypoints are genuine projections of static structure and the
    recovered trajectory is comparable to ground truth.
    """
    rng = np.random.default_rng(seed)
    # scene: blob cloud in a [-2,2]^2 x [4,8] box in world coords plus
    # a loose ground carpet below, intensities signed around mid-gray
    pts = np.concatenate([
        rng.uniform([-2.2, -1.6, 4.0], [2.2, 1.6, 8.0], (n_blobs * 2 // 3, 3)),
        rng.uniform([-3.0, 1.2, 3.5], [3.0, 1.8, 8.5], (n_blobs // 3, 3)),
    ])
    amp = rng.uniform(55, 130, len(pts)) * rng.choice([-1.0, 1.0], len(pts))
    size = rng.uniform(0.035, 0.16, len(pts))      # world-space radius

    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    centers = []
    frames = []
    look = np.array([0.0, 0.0, 6.0])               # scene centroid
    for f in range(n_frames):
        ang = np.deg2rad(-24.0 + 48.0 * f / max(n_frames - 1, 1))
        c = np.array([3.6 * np.sin(ang), 0.35 * np.sin(3 * ang),
                      6.0 - 5.6 * np.cos(ang)])
        fwd = look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R = np.stack([right, up, fwd])             # world->cam rows
        t = -R @ c
        centers.append(c)

        pc = pts @ R.T + t                         # camera coords
        z = pc[:, 2]
        vis = z > 0.5
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        r_px = fx * size / z                       # projected radius
        img = np.full((h, w), 96.0)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for i in np.nonzero(vis)[0]:
            ri = r_px[i]
            if u[i] < -4 * ri or u[i] > w + 4 * ri:
                continue
            if v[i] < -4 * ri or v[i] > h + 4 * ri:
                continue
            x0 = max(int(u[i] - 4 * ri), 0)
            x1 = min(int(u[i] + 4 * ri) + 1, w)
            y0 = max(int(v[i] - 4 * ri), 0)
            y1 = min(int(v[i] + 4 * ri) + 1, h)
            d2 = ((xx[y0:y1, x0:x1] - u[i]) ** 2
                  + (yy[y0:y1, x0:x1] - v[i]) ** 2)
            img[y0:y1, x0:x1] += amp[i] * np.exp(-d2 / (2 * ri * ri))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames, np.asarray(centers), (fx, fy, cx, cy)


def run(cmd, timeout):
    env = dict(os.environ, PYTHONPATH=".")
    env.pop("PYTHONSTARTUP", None)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=REPO)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-2000:] + res.stderr[-4000:])
        raise SystemExit(f"FAILED ({res.returncode}): {' '.join(cmd)}")
    return res.stdout, dt


def main(n_frames=100, h=240, w=320):
    os.makedirs(WORK, exist_ok=True)
    report = {"frames": n_frames, "size": [h, w]}

    from popsift_tpu.io.image import write_pgm

    t0 = time.perf_counter()
    frames, gt_centers, (fx, fy, cx, cy) = render_sequence(n_frames, h, w)
    paths = []
    for i, fr in enumerate(frames):
        p = os.path.join(WORK, f"frame_{i:04d}.pgm")
        write_pgm(p, fr)
        paths.append(p)
    report["render_s"] = round(time.perf_counter() - t0, 1)

    py = sys.executable
    # 1. popsift-demo: single-frame extraction at the CLI surface
    out, dt = run([py, "-m", "popsift_tpu.cli.demo", "-i", paths[0],
                   "-o", os.path.join(WORK, "feats0.txt"),
                   "--print-time-info"], 1200)
    nfeat = int(next(l for l in out.splitlines()
                     if "Number of features" in l).split()[-1])
    report["demo"] = {"features": nfeat, "wall_s": round(dt, 1)}

    # 2. popsift-match: two-frame matching CLI with essential gating
    out, dt = run([py, "-m", "popsift_tpu.cli.match",
                   "-l", paths[0], "-r", paths[1],
                   "--geom", "essential", "--fx", str(fx)], 1200)
    m_line = next((l for l in out.splitlines() if "matches" in l), "")
    report["match"] = {"stdout_tail": m_line.strip(),
                      "wall_s": round(dt, 1)}

    # 3. popsift-sfm over the full sequence
    rec_path = os.path.join(WORK, "rec.npz")
    out, dt = run([py, "-m", "popsift_tpu.cli.sfm", "-i"] + paths
                  + ["--fx", str(fx), "--fy", str(fy),
                     "--cx", str(cx), "--cy", str(cy),
                     "--retrieval", "8", "--refine",
                     "--export", rec_path,
                     "--export-colmap", os.path.join(WORK, "sparse"),
                     "--export-ply", os.path.join(WORK, "cloud.ply")],
                  7200)
    lines = out.splitlines()
    report["sfm"] = {
        "wall_s": round(dt, 1),
        "tracks": next((l for l in lines if l.startswith("tracks:")), ""),
        "final_ba": next((l for l in lines if "final BA cost" in l), ""),
        "refined": next((l for l in lines if "refined BA cost" in l), ""),
    }

    # 4. ATE vs ground truth
    from popsift_tpu.sfm.evaluate import ate_rmse

    z = np.load(rec_path)
    Rr, tr, reg = z["cam_R"], z["cam_t"], z["registered"]
    id2row = {int(c): k for k, c in enumerate(z["cam_ids"])}
    est, gt = [], []
    for cam in reg:
        k = id2row[int(cam)]
        est.append(-Rr[k].T @ tr[k])
        gt.append(gt_centers[int(cam)])
    rmse = float(ate_rmse(np.asarray(est), np.asarray(gt)))
    traj_len = float(np.sum(np.linalg.norm(np.diff(gt_centers, axis=0),
                                           axis=1)))
    report["ate"] = {"registered": int(len(reg)), "of": n_frames,
                     "rmse": round(rmse, 4),
                     "trajectory_length": round(traj_len, 2),
                     "rmse_pct_of_traj": round(100 * rmse / traj_len, 2)}
    report["colmap_files"] = sorted(os.listdir(os.path.join(WORK, "sparse")))
    report["ply_bytes"] = os.path.getsize(os.path.join(WORK, "cloud.ply"))

    with open(OUT, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    a = sys.argv[1:]
    main(*(int(x) for x in a[:3])) if a else main()
