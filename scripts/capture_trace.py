"""Capture a device trace of the 1080p extraction dispatch.

Produces a TensorBoard-compatible profile directory (open with
`tensorboard --logdir <out>`, or summarize the .xplane.pb with
scripts/analyze_trace.py).

    python scripts/capture_trace.py --out <dir> [--frames 4]
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=4)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from popsift_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    from bench import make_frame
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.pipeline import build_extract_plan, extract
    from popsift_tpu.utils.profiling import device_trace, trace_scope

    h, w = 1080, 1920
    cfg = SiftConfig(extrema_capacity=8192)
    caps = (256, 256, 256, 3072, 512, 256, 256, 256, 256)
    plan = build_extract_plan(cfg, h, w, octave_caps=caps)
    batch = jnp.asarray(np.stack(
        [make_frame(h, w, seed=i % 4) for i in range(args.frames)]))

    def scan_fn(xs):
        def body(_, img):
            with trace_scope("extract_frame"):
                out = extract(img, plan)
            return 0, jnp.sum(out.desc) + out.n_keypoints.astype(jnp.float32)
        _, s = jax.lax.scan(body, 0, xs)
        return s

    fn = jax.jit(scan_fn)
    np.asarray(fn(batch))           # compile outside the trace
    with device_trace(args.out):
        np.asarray(fn(batch))
    print(f"trace written to {args.out}")


if __name__ == "__main__":
    main()
