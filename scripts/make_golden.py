"""Generate golden keypoint/descriptor fixtures from the NumPy oracle.

The analog of the reference's ``reference.tgz`` golden outputs
(testScripts/downloadOxfordDataset.sh.in:16-44): per (scene, config)
case the *independent oracle* extracts features and we store the sorted
keypoint set + descriptors in ``tests/golden/<case>.npz``. The committed
fixtures gate CI (tests/test_golden.py) — any semantic drift in the
pipeline fails the compare, replacing the keypoint-count invariant as
the main regression gate.

Regenerate (only when semantics deliberately change):
    python scripts/make_golden.py
The diff of the .npz files then documents the semantic change.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from popsift_tpu.eval.golden import golden_cases  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tests",
                          "golden")


def flatten(feats):
    """Sort features by (x, y, sigma) and flatten to arrays."""
    feats = sorted(feats, key=lambda f: (round(f.x, 4), round(f.y, 4),
                                         round(f.sigma, 4)))
    x = np.array([f.x for f in feats], np.float32)
    y = np.array([f.y for f in feats], np.float32)
    sigma = np.array([f.sigma for f in feats], np.float32)
    num_ori = np.array([len(f.orientations) for f in feats], np.int32)
    ori = np.concatenate([np.asarray(f.orientations, np.float32)
                          for f in feats]) if feats else np.zeros(0)
    desc = np.concatenate([np.stack(f.descriptors).astype(np.float32)
                           for f in feats]) if feats else np.zeros((0, 128))
    return dict(x=x, y=y, sigma=sigma, num_ori=num_ori, ori=ori, desc=desc)


def main():
    from popsift_tpu.oracle import oracle_extract

    only = set(sys.argv[1:])     # regenerate a subset: make_golden.py NAME..
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, (img, cfg, variant) in golden_cases().items():
        if only and name not in only:
            continue
        print(f"generating {name} ...", flush=True)
        feats = oracle_extract(img, cfg, desc_variant=variant)
        arrs = flatten(feats)
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(path, **arrs)
        print(f"  {len(arrs['x'])} keypoints, "
              f"{arrs['desc'].shape[0]} descriptors -> {path}")


if __name__ == "__main__":
    main()
