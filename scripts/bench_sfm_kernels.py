"""Roofline check for the SfM hot kernels: brute-force matching and the
Schur-complement BA step (BASELINE.json: "BA and matching kernels must
hit speed-of-light per chip").

Prints one JSON line per kernel with achieved TFLOP/s.

    python scripts/bench_sfm_kernels.py
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp

    from popsift_tpu.utils.device import enable_compile_cache
    enable_compile_cache()

    from popsift_tpu.ops.matching import match_descriptors
    from popsift_tpu.sfm.ba import BAProblem, schur_cg_step

    results = []

    # same-session matmul peak: every MFU below is quoted against THIS
    # allocation's measured ceiling (it varies per round — CLAUDE.md)
    peak_tf = None
    try:
        from bench import measure_matmul_peak_tflops
        peak_tf = measure_matmul_peak_tflops()
        results.append({"metric": "matmul_peak_bf16",
                        "value": round(peak_tf, 1), "unit": "TFLOP/s",
                        "note": "chained 4096^3 bf16 matmuls, "
                                "in-session"})
    except Exception as e:  # noqa: BLE001
        results.append({"metric": "matmul_peak_bf16", "value": None,
                        "error": repr(e)[:120]})

    # --- matching: L=R=16384 descriptors (an SfM-scale image pair).
    # SIFT-like workload, not i.i.d. noise: real descriptors are
    # low-rank (orientation-histogram structure concentrates energy in
    # ~20-40 effective dims), which is exactly what the PCA-sketch
    # cascade exploits — i.i.d. Gaussian data has a flat spectrum and
    # made the recall metric meaningless (round-5: 0.07 "recall" on
    # noise vs >=0.99 on real descriptors in tests/test_matching.py).
    # Model: nonneg low-rank latents + noise, L2-normalized, and the
    # right set = perturbed left set so true NNs exist.
    L = R = 16384
    EFF = 24
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 4)
    A = jax.random.normal(k0, (EFF, 128), jnp.float32)

    def mk(z, knoise):
        d = jax.nn.relu(z @ A + 0.3 * jax.random.normal(
            knoise, (z.shape[0], 128), jnp.float32))
        return d / jnp.linalg.norm(d, axis=1, keepdims=True)

    zl = jax.random.normal(k1, (L, EFF), jnp.float32)
    dl = mk(zl, k2)
    dr = mk(zl + 0.15 * jax.random.normal(k3, (R, EFF), jnp.float32),
            jax.random.PRNGKey(9))
    perm = jax.random.permutation(jax.random.PRNGKey(7), R)
    dr = dr[perm]
    vl = jnp.ones(L, bool)
    vr = jnp.ones(R, bool)

    fn = jax.jit(lambda a, b: match_descriptors(a, vl, b, vr).best_dist)
    np.asarray(fn(dl, dr))
    reps = 10
    t0 = time.perf_counter()
    outs = [fn(dl + i * 1e-30, dr) for i in range(reps)]
    [np.asarray(o) for o in outs]
    dt = (time.perf_counter() - t0) / reps
    flops = 2.0 * L * R * 128          # the distance matmul dominates
    results.append({
        "metric": "match_16k_x_16k", "value": round(dt * 1000, 2),
        "unit": "ms", "tflops": round(flops / dt / 1e12, 2),
        "mfu": (round(flops / dt / 1e12 / peak_tf, 3)
                if peak_tf else None),
        "pairs_per_s": round(1.0 / dt, 1)})

    # --- pruned matching: 16-d PCA sketch prefilter + exact shortlist
    from popsift_tpu.ops.matching import match_descriptors_pruned
    fnp = jax.jit(lambda a, b: match_descriptors_pruned(
        a, vl, b, vr).best_dist)
    np.asarray(fnp(dl, dr))
    t0 = time.perf_counter()
    outs = [fnp(dl + i * 1e-30, dr) for i in range(reps)]
    [np.asarray(o) for o in outs]
    dtp = (time.perf_counter() - t0) / reps
    # recall vs the exact matcher on this workload
    exact = np.asarray(jax.jit(lambda a, b: match_descriptors(
        a, vl, b, vr).best_idx)(dl, dr))
    pruned = np.asarray(jax.jit(lambda a, b: match_descriptors_pruned(
        a, vl, b, vr).best_idx)(dl, dr))
    results.append({
        "metric": "match_16k_x_16k_pruned", "value": round(dtp * 1000, 2),
        "unit": "ms", "speedup_vs_exact": round(dt / dtp, 2),
        "nn_recall_vs_exact": round(float((exact == pruned).mean()), 4),
        "pairs_per_s": round(1.0 / dtp, 1),
        "note": "at R=16k the top_k shortlist costs more than the "
                "saved matmul on this chip — the cascade's win is "
                "asymptotic (matmul term drops 8x; use for larger R "
                "or retrieval shortlists)"})

    # --- int8-quantized matching: integer dot, exact int32 distances ---
    from popsift_tpu.ops.matching import match_descriptors_q8
    dl8 = jnp.abs(dl)
    dr8 = jnp.abs(dr)
    fnq = jax.jit(lambda a, b: match_descriptors_q8(
        a, vl, b, vr).best_dist)
    np.asarray(fnq(dl8, dr8))
    t0 = time.perf_counter()
    outs = [fnq(dl8 + i * 1e-30, dr8) for i in range(reps)]
    [np.asarray(o) for o in outs]
    dtq = (time.perf_counter() - t0) / reps
    exact8 = np.asarray(jax.jit(lambda a, b: match_descriptors(
        a, vl, b, vr).best_idx)(dl8, dr8))
    q8 = np.asarray(jax.jit(lambda a, b: match_descriptors_q8(
        a, vl, b, vr).best_idx)(dl8, dr8))
    results.append({
        "metric": "match_16k_x_16k_int8", "value": round(dtq * 1000, 2),
        "unit": "ms", "speedup_vs_exact": round(dt / dtq, 2),
        "nn_recall_vs_exact": round(float((exact8 == q8).mean()), 4),
        "pairs_per_s": round(1.0 / dtq, 1)})

    # --- BA: one damped GN step, 100 cams / 40k points / 200k obs -----
    rng = np.random.default_rng(0)
    nc, npts, nobs = 100, 40_000, 200_000
    prob = BAProblem(
        cams=jnp.asarray(rng.normal(0, 0.1, (nc, 6)), jnp.float32),
        points=jnp.asarray(rng.uniform([-5, -5, 5], [5, 5, 30],
                                       (npts, 3)), jnp.float32),
        intr=jnp.asarray([1000.0, 1000.0, 960.0, 540.0], jnp.float32),
        obs_cam=jnp.asarray(rng.integers(0, nc, nobs), jnp.int32),
        obs_pt=jnp.asarray(rng.integers(0, npts, nobs), jnp.int32),
        obs_uv=jnp.asarray(rng.normal(960, 200, (nobs, 2)), jnp.float32),
        obs_valid=jnp.ones(nobs, bool),
        cam_fixed=jnp.asarray([True] + [False] * (nc - 1)))

    step = jax.jit(lambda p: schur_cg_step(p, jnp.float32(1e-3),
                                           cg_iters=20)[2])
    np.asarray(step(prob))
    reps = 5
    t0 = time.perf_counter()
    outs = [step(prob._replace(points=prob.points + i * 1e-30))
            for i in range(reps)]
    [np.asarray(o) for o in outs]
    dt = (time.perf_counter() - t0) / reps
    results.append({
        "metric": "ba_gn_step_cg20_100c_40kp_200kobs",
        "value": round(dt * 1000, 2), "unit": "ms",
        "obs_per_s": round(nobs / dt / 1e6, 2),
        "note": "matrix-free CG: scatter/gather-bound (3 segment sums "
                "+ 2 row gathers per CG iteration)"})

    # --- BA: dense-Schur direct step (matmul formulation) -------------
    from popsift_tpu.sfm.ba import schur_dense_step

    dstep = jax.jit(lambda p: schur_dense_step(p, jnp.float32(1e-3))[2])
    np.asarray(dstep(prob))
    t0 = time.perf_counter()
    outs = [dstep(prob._replace(points=prob.points + i * 1e-30))
            for i in range(reps)]
    [np.asarray(o) for o in outs]
    dtd = (time.perf_counter() - t0) / reps
    # dominant term: B = (U Hpp^-1)(6Nc x 3Np) @ U^T(3Np x 6Nc),
    # f32 HIGHEST (6-pass bf16)
    mm_flops = 2.0 * (6 * nc) ** 2 * (3 * npts)
    results.append({
        "metric": "ba_gn_step_dense_100c_40kp_200kobs",
        "value": round(dtd * 1000, 2), "unit": "ms",
        "obs_per_s": round(nobs / dtd / 1e6, 2),
        "schur_matmul_gflop": round(mm_flops / 1e9, 1),
        "schur_mfu": (round(mm_flops / dtd / 1e12 / peak_tf, 3)
                      if peak_tf else None),
        "speedup_vs_cg": round(dt / dtd, 2),
        "note": "explicit dense reduced system as matmuls + direct "
                "solve (exact step, no CG tolerance)"})

    # --- global SfM: rotation + translation averaging -----------------
    from popsift_tpu.sfm.global_sfm import (rotation_averaging,
                                            translation_averaging)
    from popsift_tpu.sfm.rotation import exp_so3

    ncam = 512
    rng = np.random.default_rng(0)
    R_gt = np.asarray(exp_so3(jnp.asarray(
        rng.normal(0, 1, (ncam, 3)).astype(np.float32))))
    ei = np.concatenate([np.arange(ncam - 1),
                         rng.integers(0, ncam - 1, 4 * ncam)])
    ej = np.concatenate([np.arange(1, ncam),
                         (ei[ncam - 1:] + 1
                          + rng.integers(0, ncam // 2, 4 * ncam))
                         % ncam])
    keep = ei != ej
    ei, ej = np.minimum(ei, ej)[keep], np.maximum(ei, ej)[keep]
    Rrel = np.einsum("eab,ecb->eac", R_gt[ej], R_gt[ei]).astype(
        np.float32)
    ra = jax.jit(lambda r: rotation_averaging(
        ncam, jnp.asarray(ei), jnp.asarray(ej), r)[0])
    np.asarray(ra(jnp.asarray(Rrel)))
    t0 = time.perf_counter()
    for i in range(reps):
        np.asarray(ra(jnp.asarray(Rrel + i * 1e-30)))
    dt = (time.perf_counter() - t0) / reps
    results.append({
        "metric": f"rotation_averaging_{ncam}cams_{len(ei)}edges",
        "value": round(dt * 1000, 2), "unit": "ms",
        "note": "20 IRLS rounds, one [n,n] Laplacian solve each"})

    C_gt = rng.uniform(-5, 5, (ncam, 3)).astype(np.float32)
    d = C_gt[ej] - C_gt[ei]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ta = jax.jit(lambda dd: translation_averaging(
        ncam, jnp.asarray(ei), jnp.asarray(ej), dd)[0])
    np.asarray(ta(jnp.asarray(d)))
    t0 = time.perf_counter()
    for i in range(reps):
        np.asarray(ta(jnp.asarray(d + i * 1e-30)))
    dt = (time.perf_counter() - t0) / reps
    results.append({
        "metric": f"translation_averaging_{ncam}cams_{len(ei)}edges",
        "value": round(dt * 1000, 2), "unit": "ms",
        "note": "12 IRLS rounds, one [3n,3n] solve each"})

    for r in results:
        print(json.dumps(r))


if __name__ == "__main__":
    sys.exit(main())
