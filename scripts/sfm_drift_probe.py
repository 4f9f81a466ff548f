"""Localize WHERE the long-sequence incremental SfM drift enters
(round-5: the 1000-camera benchmark registered 921/1000 but failed the
1% ATE gate at 53.9/248 — the 200-camera test passes, so degradation
onsets in between). Prints ATE of the registered subset every N
registrations plus after the final BA/refine.

    PYTHONPATH=:tests JAX_PLATFORMS=cpu python scripts/sfm_drift_probe.py 400
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

from popsift_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main(n_cams=400, ba_every=50, register_batch=16, probe_every=50,
         local_window=0, ba_growth=0.0):
    from test_sfm_scale import INTR, make_sequence, tracks_from_vis

    import popsift_tpu.sfm.incremental as inc
    from popsift_tpu.sfm.evaluate import ate_rmse

    rng = np.random.default_rng(17)
    X, cams, kps, vis = make_sequence(
        rng, n_pts=6 * n_cams, n_cams=n_cams, noise=0.2,
        span=0.25 * n_cams + 10, vis_pts=min(400, 6 * n_cams))
    tracks = tracks_from_vis(kps, vis)

    def ate(sfm):
        reg = sorted(sfm.rec.registered)
        C_est = np.stack([-(sfm.rec.cam_R[i].T @ sfm.rec.cam_t[i])
                          for i in reg])
        C_gt = np.stack([-(cams[i][0].T @ cams[i][1]) for i in reg])
        return len(reg), float(ate_rmse(C_est, C_gt))

    sfm = inc.IncrementalSfM(tracks, INTR, ba_every=ba_every,
                             register_batch=register_batch,
                             local_ba_window=local_window,
                             ba_growth=ba_growth)
    sfm.initialize()
    t0 = time.perf_counter()
    last = 0
    while sfm.register_next() is not None:
        n = len(sfm.rec.registered)
        if n - last >= probe_every:
            last = n
            nr, e = ate(sfm)
            print(json.dumps({"stage": f"reg_{nr}", "ate": round(e, 3),
                              "t": round(time.perf_counter() - t0, 1)}),
                  flush=True)
    nr, e = ate(sfm)
    print(json.dumps({"stage": f"loop_end_{nr}", "ate": round(e, 3)}),
          flush=True)
    costs = sfm.global_ba(iters=10)
    nr, e = ate(sfm)
    print(json.dumps({"stage": "global_ba", "ate": round(e, 3),
                      "cost": float(costs[-1])}), flush=True)
    costs = sfm.refine(rounds=2, ba_iters=8)
    nr, e = ate(sfm)
    print(json.dumps({"stage": "refine", "ate": round(e, 3),
                      "cost": float(costs[-1])}), flush=True)
    # convergence curve of the low-frequency trajectory-bending modes:
    # LM reduces them slowly (small gradient), so long sequences need
    # deeper final BA than the default polish
    for k in range(4):
        costs = sfm.global_ba(iters=15, huber_delta=2.0)
        nr, e = ate(sfm)
        print(json.dumps({"stage": f"deep_ba_{k}", "ate": round(e, 3),
                          "cost": float(costs[-1]),
                          "t": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    a = [float(x) if "." in x else int(x) for x in sys.argv[1:]]
    main(*a)
