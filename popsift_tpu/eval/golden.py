"""Golden-fixture cases and the comparisons that gate extraction.

The analog of the reference's bit-exact Oxford compare
(testScripts/testOxfordDataset.sh.in:85-158): the committed
``tests/golden/*.npz`` fixtures were generated by the independent NumPy
oracle (scripts/make_golden.py). :func:`golden_errors` is the one
comparison, used by tests/test_golden.py on the CPU and by
``chip_smoke.py`` on the GPU; :func:`extraction_errors` compares two runs
of the pipeline itself (a device run against a host reference).
"""

from __future__ import annotations

import numpy as np

POS_TOL = 5e-3      # px, octave-scaled refine in f32 vs f64 oracle
SIG_TOL = 1e-3
ORI_TOL = 1e-3      # radians
DESC_TOL = 6e-3     # normalized descriptor component


def synthetic_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Deterministic grayscale test image with blobs, edges and texture —
    enough structure to produce stable SIFT keypoints at several scales."""
    rng_ = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 40.0 + 20.0 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    # gaussian blobs at pseudo-random locations/scales
    for _ in range(12):
        cx, cy = rng_.uniform(0.15, 0.85) * w, rng_.uniform(0.15, 0.85) * h
        s = rng_.uniform(1.5, min(h, w) / 10.0)
        a = rng_.uniform(60, 160) * rng_.choice([-1.0, 1.0])
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    # a couple of hard edges
    img[h // 3:, : w // 4] += 50.0
    img[: h // 5, w // 2:] -= 40.0
    img += rng_.normal(0, 1.0, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def golden_cases() -> dict:
    """name -> (image, SiftConfig, oracle descriptor variant)."""
    from ..config import SiftConfig
    return {
        # default popsift mode, loop descriptors, RootSift
        "scene64_default": (
            synthetic_image(64, 80, seed=3),
            SiftConfig(octaves=3), "loop"),
        # vlfeat compatibility mode + classic L2 norm + igrid
        "scene64_vlfeat_igrid": (
            synthetic_image(64, 80, seed=3),
            SiftConfig(octaves=3, sift_mode="vlfeat", desc_mode="igrid",
                       norm_mode="classic"), "igrid"),
        # larger textured scene, defaults
        "scene120_default": (
            synthetic_image(120, 160, seed=7),
            SiftConfig(octaves=4), "loop"),
        # true grid variant + fixed9 gauss pyramid
        "scene64_grid_fixed9": (
            synthetic_image(64, 80, seed=3),
            SiftConfig(octaves=3, gauss_mode="fixed9", desc_mode="grid"),
            "grid"),
        # iloop descriptor variant + interpolated octave downscale
        "scene64_iloop_interp": (
            synthetic_image(64, 80, seed=3),
            SiftConfig(octaves=3, desc_mode="iloop",
                       downscale_mode="interpolate"), "iloop"),
    }


def flatten_host(host) -> dict:
    """FeaturesHost -> arrays sorted by (x, y, sigma): x, y, sigma,
    num_ori, ori (concatenated), desc (concatenated)."""
    feats = sorted(host.features(),
                   key=lambda f: (round(f.x, 4), round(f.y, 4),
                                  round(f.sigma, 4)))
    x = np.array([f.x for f in feats], np.float32)
    y = np.array([f.y for f in feats], np.float32)
    sigma = np.array([f.sigma for f in feats], np.float32)
    num_ori = np.array([f.num_ori for f in feats], np.int32)
    ori = np.concatenate([np.asarray(f.orientations[:f.num_ori],
                                     np.float32) for f in feats] or
                         [np.zeros(0, np.float32)])
    desc = np.concatenate([f.descriptors for f in feats] or
                          [np.zeros((0, 128), np.float32)])
    return dict(x=x, y=y, sigma=sigma, num_ori=num_ori, ori=ori,
                desc=desc)


def golden_errors(got: dict, want: dict) -> tuple:
    """Compare flattened features with a golden record.

    Returns ``(failures, max_errors)``: the list of violated checks
    (empty when the run matches) and the largest error of each field."""
    if len(got["x"]) != len(want["x"]):
        return ([f"keypoint count {len(got['x'])} vs golden "
                 f"{len(want['x'])}"], {})
    if got["desc"].shape != want["desc"].shape:
        return ([f"descriptor shape {got['desc'].shape} vs golden "
                 f"{want['desc'].shape}"], {})
    err = {k: float(np.max(np.abs(got[k] - want[k]), initial=0.0))
           for k in ("x", "y", "sigma", "ori", "desc")}
    tol = {"x": POS_TOL, "y": POS_TOL, "sigma": SIG_TOL, "ori": ORI_TOL,
           "desc": DESC_TOL}
    fails = [f"{k} error {err[k]:.3g} >= {tol[k]}" for k in tol
             if not err[k] < tol[k]]
    if not np.array_equal(got["num_ori"], want["num_ori"]):
        fails.append("orientation counts differ")
    return fails, err


def extraction_errors(got, ref, count_tol: float = 0.005,
                      pos_tol: float = 0.01, min_matched: float = 0.99,
                      desc_tol: float = DESC_TOL) -> tuple:
    """Compare two FeaturesHost results of the same image.

    Keypoint and descriptor counts must agree within ``count_tol``
    (relative), at least ``min_matched`` of ``got``'s keypoints must
    have a ``ref`` keypoint within ``pos_tol`` px at the same octave
    and orientation count, and those keypoints' descriptors must agree
    within ``desc_tol``. Returns ``(failures, stats)``."""
    stats = {"kp": got.getFeatureCount(), "kp_ref": ref.getFeatureCount(),
             "desc": got.getDescriptorCount(),
             "desc_ref": ref.getDescriptorCount()}
    fails = []
    for k in ("kp", "desc"):
        if abs(stats[k] - stats[k + "_ref"]) > count_tol * max(
                stats[k + "_ref"], 1):
            fails.append(f"{k} count {stats[k]} vs {stats[k + '_ref']}")
    rx, ry = np.asarray(ref.x), np.asarray(ref.y)
    order = np.argsort(rx)
    rxs = rx[order]
    by_kp_g = _descs_by_kp(got)
    by_kp_r = _descs_by_kp(ref)
    matched, derr = 0, 0.0
    for i, (x, y) in enumerate(zip(got.x, got.y)):
        lo, hi = np.searchsorted(rxs, [x - pos_tol, x + pos_tol])
        cand = order[lo:hi]
        cand = cand[np.abs(ry[cand] - y) <= pos_tol]
        cand = cand[ref.octave[cand] == got.octave[i]]
        if not len(cand):
            continue
        j = cand[np.argmin(np.hypot(rx[cand] - x, ry[cand] - y))]
        dg, dr = by_kp_g[i], by_kp_r[j]
        if dg.shape != dr.shape:
            continue
        matched += 1
        if len(dg):
            derr = max(derr, float(np.abs(dg - dr).max()))
    stats["matched"] = matched / max(len(got.x), 1)
    stats["desc_err"] = derr
    if stats["matched"] < min_matched:
        fails.append(f"only {stats['matched']:.4f} of keypoints matched "
                     f"within {pos_tol} px")
    if not derr < desc_tol:
        fails.append(f"matched descriptor error {derr:.3g} >= {desc_tol}")
    return fails, stats


def _descs_by_kp(host) -> list:
    """Per keypoint, its descriptors ordered by orientation angle (the
    slot order ranks peak heights, which near-ties may swap)."""
    rows = [[] for _ in range(len(host.x))]
    for d, kp in enumerate(host.desc_to_kp):
        rows[int(kp)].append(d)
    out = []
    for i, r in enumerate(rows):
        ang = host.orientations[i][host.ori_valid[i]][:len(r)]
        out.append(host.descriptors[np.asarray(r, int)[np.argsort(ang)]])
    return out
