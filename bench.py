"""Benchmark: 1080p SIFT extraction throughput per chip.

Prints ONE JSON line:
  {"metric": "sift_1080p_fps_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 20.3}

Baseline: the reference's best published end-to-end number, 20.3 fps on a
GTX 980 Ti with the notile descriptor variant
(/root/reference/src/popsift/s_desc_notile.cu:18-22, BASELINE.json).

Methodology: synthetic 1920x1080 frames with realistic keypoint density;
per-octave pipeline capacities are sized from a calibration pass (actual
candidate counts + 50% headroom) the way a production deployment would
pin them, then throughput is measured over scan-batched extraction
(16 frames per dispatch at bounded memory footprint — production serving
batches; the reference instead overlaps upload/compute with its 2-stage
host pipeline, popsift.cpp:171-213), with full-field checksums so no
stage dead-code-eliminates. Timing is the slope across k dispatches
chained through a data dependency (see ``_timed``): per-dispatch
overhead cancels, and no two dispatches are identical.

Two pipeline variants are timed and the better one reported:
  * single_scan — lax.scan of per-frame extract() (one frame per step);
  * batched_F   — lax.scan of extract_batch() over chunks of F frames
    (one XLA program computes F frames' kernels together, dividing the
    per-op fixed overhead by F).
The batched variant must reproduce the single-frame per-frame counts
exactly or it is discarded (invariant: 2110 kp / 2505 desc on frame 0).
"""

import json
import sys
import time

import numpy as np


def make_frame(h=1080, w=1920, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (96.0 + 40.0 * np.sin(xx / 9.0) * np.cos(yy / 11.0)
           + 30.0 * np.sin(xx / 37.0 + yy / 23.0))
    for _ in range(64):
        cx, cy = rng.uniform(0.05, 0.95) * w, rng.uniform(0.05, 0.95) * h
        s = rng.uniform(1.5, 24.0)
        a = rng.uniform(40, 120) * rng.choice([-1.0, 1.0])
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    img += rng.normal(0, 2.0, size=(h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _checksum(out):
    import jax.numpy as jnp
    return (jnp.sum(out.desc) + jnp.sum(out.x) + jnp.sum(out.y)
            + jnp.sum(out.sigma) + jnp.sum(out.ori)
            + jnp.sum(out.desc_kp.astype(jnp.float32)))


def measure_matmul_peak_tflops(n=4096, chain=8, reps=3):
    """In-session dense-matmul peak (bf16), chained through a data
    dependency so no dispatch can be short-circuited; MFU is quoted
    against this same-session peak."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((n, n), jnp.bfloat16)

    @jax.jit
    def burn(x):
        y = x
        for _ in range(chain):
            y = (y @ a) * jnp.bfloat16(1e-3)
        return jnp.sum(y.astype(jnp.float32))

    float(np.asarray(burn(a)))                      # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(np.asarray(burn(a)))
        ts.append(time.perf_counter() - t0)
    flops = chain * 2.0 * n ** 3
    return flops / min(ts) / 1e12


def analytic_extraction_gflop(plan):
    """Coarse analytic per-frame op count (f32 FLOPs + comparisons) of
    the extraction pipeline — the 'useful work' numerator for the MFU
    line. Convention: 1 MAC = 2 ops, comparisons/selects count 1; only
    the five structural stages are modeled (pyramid convs + DoG, mask
    stencil, refinement algebra, orientation windows, descriptor
    windows); bookkeeping (compaction, canvas writes) is excluded. This
    deliberately measures algorithmic work, so MFU exposes overhead.
    """
    cfg = plan.config
    L = cfg.total_levels
    ops = 0.0
    kx = plan.pyramid.lvl0_kernel_x.shape[0]
    ky = plan.pyramid.lvl0_kernel_y.shape[0]
    h0, w0 = plan.pyramid.dims[0]
    ops += (kx + ky) * 2.0 * h0 * w0               # octave-0 level 0
    for (h, w) in plan.pyramid.dims:
        for lv in range(1, L):
            k = plan.pyramid.inc_kernels[lv].shape[0]
            ops += 2.0 * k * 2.0 * h * w           # separable blur
        ops += (L - 1.0) * h * w                   # DoG
        ops += (L - 3.0) * h * w * 52.0            # 26-neighbor stencil
    K = plan.total_kp_capacity
    ops += K * 5.0 * 250.0                         # 5-iter refinement
    R = 20                                         # typical ori radius
    ops += K * (2.0 * R + 2.0) ** 2 * 12.0         # orientation windows
    P = 72                                         # typical desc rows
    ops += plan.total_desc_capacity * P * 128.0 * 70.0
    return ops / 1e9


def _timed(fn, x, n_frames, k=4, reps=3):
    """Device-time measurement by dispatch slope.

    ``fn(x, s0) -> (ys, checksum)`` must thread ``s0`` into its result.
    We chain ``k`` dispatches through that scalar (each consumes the
    previous checksum, so the device must execute them serially and no
    two calls have identical arguments), fetch once, and take the slope
    ``t(k) - t(1)``: per-dispatch overhead (enqueue, fetch) cancels; the
    host fetch of a value data-dependent on every dispatch is the
    barrier.
    """
    import jax.numpy as jnp

    ys, c = fn(x, jnp.float32(0.0))   # compile + warm
    float(np.asarray(c))

    def run(n, seed):
        s = jnp.float32(seed)
        t0 = time.perf_counter()
        for _ in range(n):
            _, s = fn(x, s)
        float(np.asarray(s))
        return time.perf_counter() - t0

    t1 = min(run(1, 1 + r) for r in range(reps))
    tk = min(run(k, 100 + r) for r in range(reps))
    dt = tk - t1
    if dt <= max(1e-4, 0.02 * tk):
        # non-positive / sub-jitter slope: timing is invalid, don't
        # fabricate an absurd fps from a clamped denominator.
        return float("nan"), ys, t1
    return (k - 1) * n_frames / dt, ys, t1


def main(h=1080, w=1920, B=16, F=(4, 8, 16)):
    import jax
    import jax.numpy as jnp
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.pipeline import (build_extract_plan, extract,
                                      extract_batch, make_extract_fn)
    from popsift_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    frames = [make_frame(h, w, seed=i) for i in range(4)]

    # calibration: generous uniform capacity to learn the per-octave
    # candidate counts, then pin per-octave capacities with headroom —
    # downstream compute is proportional to padded capacity, so a
    # production deployment right-sizes each octave once per scene.
    cfg = SiftConfig(extrema_capacity=8192)
    plan0 = build_extract_plan(cfg, h, w)
    fn0 = make_extract_fn(plan0)
    out = fn0(frames[0])
    n_kp = int(out.n_keypoints)
    n_desc = int(out.n_descriptors)
    cand = np.asarray(out.octave_candidates)

    caps = tuple(int(max(256, -(-int(c) * 3 // 2) // 128 * 128 + 128))
                 for c in cand)
    plan = build_extract_plan(cfg, h, w, octave_caps=caps)

    batch = jnp.asarray(np.stack([frames[i % len(frames)]
                                  for i in range(B)]))

    # variant 1: single-frame scan (B frames per dispatch, single-frame
    # memory footprint)
    def scan_single(xs, s0):
        def body(c, img):
            o = extract(img, plan)
            return c + _checksum(o), (o.n_keypoints, o.n_descriptors)
        c, ys = jax.lax.scan(body, s0, xs)
        return ys, c

    fps_single, r1, disp_s = _timed(jax.jit(scan_single), batch, B)
    kp_single = [int(k) for k in np.asarray(r1[0])]
    if fps_single != fps_single:  # NaN: slope was noise — timing invalid
        variants = {"single_scan": "timing_invalid"}
        best = ("single_scan", float("-inf"))
    else:
        variants = {"single_scan": round(fps_single, 2)}
        best = ("single_scan", fps_single)

    # variant 2: frame-batched extract (F frames share one kernel launch
    # per stage, layer-axis stacking), swept over chunk sizes. Any
    # failure — compile, OOM, count mismatch — falls back to the
    # single-scan number.
    for Fi in ([F] if isinstance(F, int) else F):
        if B % Fi:
            continue
        try:
            chunks = batch.reshape(B // Fi, Fi, h, w)

            def scan_batched(xs, s0):
                def body(c, imgs):
                    o = extract_batch(imgs, plan)
                    return c + _checksum(o), (o.n_keypoints,
                                              o.n_descriptors)
                c, ys = jax.lax.scan(body, s0, xs)
                return ys, c

            fps_b, rb, _ = _timed(jax.jit(scan_batched), chunks, B)
            kp_b = [int(k) for k in np.asarray(rb[0]).reshape(-1)]
            if fps_b != fps_b:
                variants[f"batched_F{Fi}"] = "timing_invalid"
            elif kp_b == kp_single:
                variants[f"batched_F{Fi}"] = round(fps_b, 2)
                if fps_b > best[1]:
                    best = (f"batched_F{Fi}", fps_b)
            else:
                variants[f"batched_F{Fi}"] = f"COUNT MISMATCH {kp_b[:4]}"
        except Exception as e:  # noqa: BLE001 — bench must always report
            variants[f"batched_F{Fi}"] = f"failed: {type(e).__name__}"

    fps = best[1]
    invalid = fps == float("-inf")

    # MFU vs a same-session measured matmul peak
    try:
        peak_tf = measure_matmul_peak_tflops()
        gflop = analytic_extraction_gflop(plan)
        mfu = (None if invalid
               else round(gflop * fps / (peak_tf * 1e3), 5))
        mfu_detail = {"matmul_peak_tflops_bf16": round(peak_tf, 1),
                      "analytic_gflop_per_frame": round(gflop, 2),
                      "extraction_mfu": mfu}
    except Exception as e:  # noqa: BLE001 — bench must always report
        mfu_detail = {"mfu_error": repr(e)[:120]}

    print(json.dumps({
        "metric": "sift_1080p_fps_per_chip",
        "value": None if invalid else round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": None if invalid else round(fps / 20.3, 3),
        "detail": {"keypoints": n_kp, "descriptors": n_desc,
                   "variant": best[0], "variants": variants,
                   "octave_caps": list(caps),
                   "dispatch_ms": round(disp_s * 1e3, 1),
                   "timing": "slope of k-chained dispatches "
                             "(RTT-free device time)",
                   "device": str(jax.devices()[0]),
                   **mfu_detail},
    }))


if __name__ == "__main__":
    if "--smoke" in sys.argv:   # structure check on CPU: tiny frames
        sys.exit(main(h=96, w=128, B=4, F=(2, 4)))
    sys.exit(main())
