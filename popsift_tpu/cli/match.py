"""popsift-match equivalent: extract from two images and brute-force
match with the ratio test.

Mirrors /root/reference/src/application/match.cpp:219-274 (extraction in
MatchingMode, then FeaturesDev::match) with the match kernel replaced by
the matmul matcher.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np




def build_parser():
    p = argparse.ArgumentParser(
        prog="popsift-match",
        description="SIFT extraction + matching")
    p.add_argument("-l", "--left", required=True, help="left image")
    p.add_argument("-r", "--right", required=True, help="right image")
    p.add_argument("--octaves", type=int, default=-1)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--sigma", type=float, default=1.6)
    p.add_argument("--threshold", type=float, default=0.04)
    p.add_argument("--edge-threshold", dest="edge_limit", type=float, default=10.0)
    p.add_argument("--downsampling", type=float, default=-1.0)
    p.add_argument("--initial-blur", type=float, default=0.5)
    p.add_argument("--gauss-mode", default="vlfeat")
    p.add_argument("--desc-mode", default="loop")
    p.add_argument("--ratio", type=float, default=0.8,
                   help="Lowe ratio on squared L2 (features.cu:223)")
    p.add_argument("--max-print", type=int, default=50,
                   help="cap on printed matches; <= 0 prints ALL "
                        "accepted matches (the reference's "
                        "show_distance prints every one, "
                        "features.cu:228-263)")
    p.add_argument("--geom", choices=["none", "homography", "essential"],
                   default="none",
                   help="two-view RANSAC verification of the accepted "
                        "matches (beyond the reference, which prints "
                        "raw ratio-test matches only): homography in "
                        "pixel space, or essential with --fx intrinsics")
    p.add_argument("--fx", type=float, default=None,
                   help="focal length in px for --geom essential "
                        "(principal point defaults to image center)")
    p.add_argument("--geom-thresh", type=float, default=None,
                   help="RANSAC inlier gate: px for homography "
                        "(default 2.0), normalized-coordinate Sampson "
                        "distance for essential (default 0.01)")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantized matching (exact int32 "
                        "distances, recall >= 0.99 vs exact)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from popsift_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    from popsift_tpu.api import PopSift
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.io.image import load_image
    from popsift_tpu.ops.matching import (match_descriptors,
                                          match_descriptors_q8)

    cfg = SiftConfig(
        octaves=args.octaves, levels=args.levels, sigma=args.sigma,
        threshold=args.threshold, edge_limit=args.edge_limit,
        upscale_factor=-args.downsampling, gauss_mode=args.gauss_mode,
        desc_mode=args.desc_mode, initial_blur=args.initial_blur,
        verbose=args.verbose)

    ps = PopSift(cfg, mode="matching")
    img_l = load_image(args.left)
    img_r = load_image(args.right)
    job_l = ps.enqueue(img_l)
    job_r = ps.enqueue(img_r)
    dev_l = job_l.getDev()
    dev_r = job_r.getDev()

    print(f"left:  {dev_l.getFeatureCount()} features, "
          f"{dev_l.getDescriptorCount()} descriptors")
    print(f"right: {dev_r.getFeatureCount()} features, "
          f"{dev_r.getDescriptorCount()} descriptors")

    matcher = match_descriptors_q8 if args.int8 else match_descriptors
    res = matcher(dev_l.raw.desc, dev_l.raw.desc_valid,
                            dev_r.raw.desc, dev_r.raw.desc_valid,
                            ratio=args.ratio)
    acc = np.asarray(res.accept)
    n_acc = int(acc.sum())
    print(f"accepted matches: {n_acc}")

    host_l = job_l.getHost()
    host_r = job_r.getHost()
    # print matches in a show_distance-like format (features.cu:228-263)
    bi = np.asarray(res.best_idx)
    bd = np.asarray(res.best_dist)
    valid_rows = np.nonzero(np.asarray(dev_l.raw.desc_valid))[0]
    l_kp = np.asarray(dev_l.raw.desc_kp)
    r_kp = np.asarray(dev_r.raw.desc_kp)
    lx, ly = np.asarray(dev_l.raw.x), np.asarray(dev_l.raw.y)
    rx, ry = np.asarray(dev_r.raw.x), np.asarray(dev_r.raw.y)
    # optional two-view geometric verification over accepted matches
    inlier_of_row = None
    if args.geom != "none" and n_acc >= 8:
        import jax
        import jax.numpy as jnp
        rows = np.nonzero(acc)[0]
        pl = np.stack([lx[l_kp[rows]], ly[l_kp[rows]]], 1)
        pr = np.stack([rx[r_kp[bi[rows]]], ry[r_kp[bi[rows]]]], 1)
        N = len(rows)
        cap = max(64, 1 << (N - 1).bit_length())

        def pad(a):
            out = np.zeros((cap, 2), np.float32)
            out[:N] = a
            return jnp.asarray(out)

        vmask = jnp.asarray(np.arange(cap) < N)
        key = jax.random.PRNGKey(0)
        if args.geom == "homography":
            from popsift_tpu.sfm.twoview import ransac_homography
            thr = args.geom_thresh if args.geom_thresh else 2.0
            g = ransac_homography(key, pad(pl), pad(pr), vmask,
                                  thresh=thr * thr)
        else:
            from popsift_tpu.sfm.twoview import ransac_essential
            fx = args.fx or float(max(img_l.shape))
            cx, cy = img_l.shape[1] / 2.0, img_l.shape[0] / 2.0
            nl = (pl - [cx, cy]) / fx
            nr = (pr - [cx, cy]) / fx
            thr = args.geom_thresh if args.geom_thresh else 0.01
            g = ransac_essential(key, pad(nl), pad(nr), vmask,
                                 thresh=thr * thr)
        gi = np.asarray(g.inliers)[:N]
        print(f"geometric verification ({args.geom}): "
              f"{int(gi.sum())}/{N} inliers")
        inlier_of_row = dict(zip(rows.tolist(), gi.tolist()))

    limit = args.max_print if args.max_print > 0 else len(valid_rows)
    shown = 0
    for row in valid_rows:
        if not acc[row] or shown >= limit:
            continue
        lk, rk = l_kp[row], r_kp[bi[row]]
        tag = ""
        if inlier_of_row is not None:
            tag = " inlier" if inlier_of_row.get(int(row)) else " outlier"
        print(f"desc {row}: ({lx[lk]:.2f},{ly[lk]:.2f}) -> "
              f"({rx[rk]:.2f},{ry[rk]:.2f}) d2={bd[row]:.4f} accept"
              f"{tag}")
        shown += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
