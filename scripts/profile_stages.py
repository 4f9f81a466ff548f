"""Per-stage timing of 1080p extraction on the current device, and the
descriptor A/B: the Triton kernel against the plain XLA form.

Each stage runs as its own jitted program on the calibrated 1080p plan
(bench.make_frame frame 0, ``SiftConfig(extrema_capacity=8192)``,
``PopSift.calibrate``), warmed up first, timed on the host clock to
``block_until_ready``; the median of ``--reps`` runs is reported (kernel
and XLA runs interleaved). Stage programs cut the pipeline at octave
boundaries, so their sum is an approximation of the fused frame.

    python scripts/profile_stages.py [--reps 7] [--out stages.json]

Prints one JSON object (and, with ``--out``, writes it with every run's
time) with the device, the card's name and power limit when
``nvidia-smi`` answers, and times in ms.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, *args):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    from bench import make_frame
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.ops.descriptors import (compute_descriptors,
                                             make_descriptor_jobs)
    from popsift_tpu.ops.extrema import detect_extrema
    from popsift_tpu.ops.orientation import assign_orientations
    from popsift_tpu.ops.pyramid import build_pyramid
    from popsift_tpu.pipeline import calibrate_plan, extract
    from popsift_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    img = make_frame(1080, 1920, seed=0)
    cfg = SiftConfig(extrema_capacity=8192)
    plan = calibrate_plan(cfg, [img], 1080, 1920)
    dims = plan.pyramid.dims
    x = jax.device_put(img)

    def detect(dogs):
        return tuple(detect_extrema(d, cfg, plan.ext_caps[o], dims[o][1],
                                    dims[o][0]) for o, d in enumerate(dogs))

    def orient(blurs, exts):
        return tuple(assign_orientations(b, e, cfg)
                     for b, e in zip(blurs, exts))

    def jobs_of(exts, oris):
        return tuple(make_descriptor_jobs(e, r, plan.job_caps[o])
                     for o, (e, r) in enumerate(zip(exts, oris)))

    def descs(impl):
        return jax.jit(lambda blurs, jobs: tuple(
            compute_descriptors(b, j, cfg, impl=impl)
            for b, j in zip(blurs, jobs)))

    fns = {
        "frame_kernel": jax.jit(lambda im: extract(im, plan,
                                                   desc_impl="kernel")),
        "frame_xla": jax.jit(lambda im: extract(im, plan, desc_impl="xla")),
        "pyramid": jax.jit(lambda im: build_pyramid(im, plan.pyramid)),
        "detect": jax.jit(detect),
        "orientation": jax.jit(orient),
        "desc_kernel": descs("kernel"),
        "desc_xla": descs("xla"),
    }
    blurs, dogs = fns["pyramid"](x)
    exts = fns["detect"](dogs)
    oris = fns["orientation"](blurs, exts)
    jobs = jax.jit(jobs_of)(exts, oris)
    inputs = {"frame_kernel": (x,), "frame_xla": (x,), "pyramid": (x,),
              "detect": (dogs,), "orientation": (blurs, exts),
              "desc_kernel": (blurs, jobs), "desc_xla": (blurs, jobs)}

    compile_s = {}
    for k, f in fns.items():
        t0 = time.perf_counter()
        jax.block_until_ready(f(*inputs[k]))
        compile_s[k] = round(time.perf_counter() - t0, 2)
    runs = {k: [] for k in fns}
    for _ in range(args.reps):
        for k, f in fns.items():
            runs[k].append(timed(f, *inputs[k]))
    med = {k: statistics.median(v) for k, v in runs.items()}

    fk = fns["frame_kernel"](x)
    fx = fns["frame_xla"](x)
    d = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        card = None
    res = {
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "octave_caps": list(plan.ext_caps),
        "counts_kernel": [int(fk.n_keypoints), int(fk.n_descriptors)],
        "counts_xla": [int(fx.n_keypoints), int(fx.n_descriptors)],
        "valid_jobs": int(sum(np.asarray(j.valid).sum() for j in jobs)),
        "job_capacity": int(sum(j.valid.shape[0] for j in jobs)),
        "median_ms": med,
        "runs_ms": runs,
        "first_call_s": compile_s,
        "orientation_share_of_frame": med["orientation"]
        / med["frame_kernel"],
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps({k: res[k] for k in res if k != "runs_ms"}))


if __name__ == "__main__":
    main()
