"""Compare two feature files in the reference text format.

The formal >= 95% parity gate (BASELINE.json) needs outputs of the CUDA
reference on the same images; this zero-egress environment cannot run
it, so this tool makes the comparison a one-liner for anyone who can:

    # the CUDA reference:    popsift-demo -i img.pgm -o ref.txt
    # this framework:        python -m popsift_tpu.cli.demo -i img.pgm -o ours.txt
    python scripts/oxford/compare_features.py ref.txt ours.txt

Reports keypoint-set overlap at a pixel tolerance and per-matched-pair
descriptor distances (the metric analog of the reference's sorted
`cmp`, testOxfordDataset.sh.in:128-158 — bit-exactness holds only
between identical kernels; XLA's float evaluation order differs).
"""

import argparse
import json
import sys

import numpy as np


def load_feature_file(path):
    """Parse ``x y 1/s^2 0 1/s^2 d0..d127`` lines (Feature::print,
    features.cu:308-328). Returns (xy [N,2], sigma [N], desc [N,128])."""
    rows = np.loadtxt(path, ndmin=2)
    if rows.size == 0:
        return (np.zeros((0, 2)), np.zeros(0), np.zeros((0, 128)))
    if rows.shape[1] != 133:
        raise ValueError(f"{path}: expected 133 columns, got {rows.shape[1]}")
    xy = rows[:, :2]
    with np.errstate(divide="ignore"):
        sigma = 1.0 / np.sqrt(np.maximum(rows[:, 2], 1e-20))
    return xy, sigma, rows[:, 5:]


def compare(a_path, b_path, eps=1.0):
    xy_a, sig_a, d_a = load_feature_file(a_path)
    xy_b, sig_b, d_b = load_feature_file(b_path)
    if len(xy_a) == 0 or len(xy_b) == 0:
        return {"n_a": len(xy_a), "n_b": len(xy_b), "overlap": 0.0}

    # nearest spatial neighbor of every a-row in b
    d2 = ((xy_a[:, None, :] - xy_b[None, :, :]) ** 2).sum(-1)
    nn = d2.argmin(1)
    nn_dist = np.sqrt(d2[np.arange(len(xy_a)), nn])
    matched = nn_dist <= eps

    desc_dist = np.linalg.norm(d_a[matched] - d_b[nn[matched]], axis=1)
    norm = np.maximum(np.linalg.norm(d_a[matched], axis=1), 1e-9)
    return {
        "n_a": int(len(xy_a)),
        "n_b": int(len(xy_b)),
        "overlap": round(float(matched.mean()), 4),
        "mean_pos_err_px": round(float(nn_dist[matched].mean()), 4)
        if matched.any() else None,
        "mean_rel_desc_dist": round(float((desc_dist / norm).mean()), 4)
        if matched.any() else None,
        "parity_pct": round(100.0 * float(matched.mean()), 2),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("reference")
    p.add_argument("candidate")
    p.add_argument("--eps", type=float, default=1.0,
                   help="keypoint match tolerance in pixels")
    args = p.parse_args(argv)
    print(json.dumps(compare(args.reference, args.candidate, args.eps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
