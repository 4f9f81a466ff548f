"""JAX descriptor extraction vs NumPy oracle golden tests."""

import jax
import jax.numpy as jnp
import numpy as np

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops.descriptors import (
    DescriptorJobs,
    compute_descriptors,
    make_descriptor_jobs,
    normalize_descriptors,
)
from popsift_tpu.oracle import (
    oracle_pyramid,
    oracle_extrema,
    oracle_orientations,
    oracle_descriptor_grid,
    oracle_descriptor_loop,
)
from popsift_tpu.oracle.sift_oracle import normalize_descriptor


def _collect_jobs(img, cfg, max_jobs=24, variant="grid"):
    """Oracle extrema + orientations packed as descriptor jobs, together
    with oracle descriptors for each job."""
    blurs, dogs = oracle_pyramid(img, cfg)
    per_octave = []
    for octv, (blur, dog) in enumerate(zip(blurs, dogs)):
        exts = oracle_extrema(dog, cfg, octv)
        xs, ys, sigmas, lvls, angs, wants = [], [], [], [], [], []
        for e in exts:
            for ang in oracle_orientations(blur, e, cfg):
                if len(xs) >= max_jobs:
                    break
                xs.append(e.x)
                ys.append(e.y)
                sigmas.append(e.sigma)
                lvls.append(e.level)
                angs.append(ang)
                if variant == "grid":
                    wants.append(oracle_descriptor_grid(blur, e, ang, cfg))
                else:
                    wants.append(oracle_descriptor_loop(blur, e, ang, cfg))
        if xs:
            per_octave.append((blur, xs, ys, sigmas, lvls, angs, wants))
    return per_octave


def _jobs_from_lists(xs, ys, sigmas, lvls, angs, cap):
    F = len(xs)
    pad = cap - F
    mk = lambda a, dt: jnp.asarray(np.pad(np.asarray(a, dt), (0, pad)))
    return DescriptorJobs(
        x=mk(xs, np.float32), y=mk(ys, np.float32),
        sigma=mk(sigmas, np.float32), level=mk(lvls, np.int32),
        ang=mk(angs, np.float32),
        kp_index=jnp.zeros(cap, jnp.int32),
        valid=jnp.asarray(np.arange(cap) < F),
        count=jnp.int32(F))


def test_descriptors_match_oracle(small_image):
    # the 40x40 formulation is the reference's igrid/notile; the name
    # "grid" now maps to the rounded-address variant (round 2)
    cfg = SiftConfig(octaves=2, desc_mode="igrid")
    per_octave = _collect_jobs(small_image, cfg)
    assert per_octave
    checked = 0
    for blur, xs, ys, sigmas, lvls, angs, wants in per_octave:
        cap = len(xs) + 3
        jobs = _jobs_from_lists(xs, ys, sigmas, lvls, angs, cap)
        got = jax.jit(lambda b, j: compute_descriptors(b, j, cfg))(
            jnp.asarray(blur), jobs)
        got = np.asarray(got)
        for i, want in enumerate(wants):
            scale = max(1.0, float(np.abs(want).max()))
            err = np.abs(got[i] - want).max() / scale
            assert err < 2e-3, f"job {i} desc rel err {err}"
            checked += 1
        # padded jobs produce zero descriptors
        for i in range(len(wants), cap):
            assert np.abs(got[i]).max() == 0.0
    assert checked >= 4


def test_descriptor_normalization_matches_oracle():
    rng = np.random.default_rng(0)
    d = np.abs(rng.standard_normal((6, 128))).astype(np.float32) * 37.0
    for mode in ("rootsift", "classic"):
        cfg = SiftConfig(norm_mode=mode, norm_multiplier=9)
        got = np.asarray(jax.jit(
            lambda x: normalize_descriptors(x, cfg))(jnp.asarray(d)))
        for i in range(d.shape[0]):
            want = normalize_descriptor(d[i], cfg)
            assert np.abs(got[i] - want).max() < 2e-2 * np.abs(want).max()


def test_descriptors_loop_match_oracle(small_image):
    cfg = SiftConfig(octaves=2, desc_mode="loop")
    per_octave = _collect_jobs(small_image, cfg, variant="loop")
    assert per_octave
    checked = 0
    for blur, xs, ys, sigmas, lvls, angs, wants in per_octave:
        cap = len(xs) + 3
        jobs = _jobs_from_lists(xs, ys, sigmas, lvls, angs, cap)
        got = jax.jit(lambda b, j: compute_descriptors(b, j, cfg))(
            jnp.asarray(blur), jobs)
        got = np.asarray(got)
        for i, want in enumerate(wants):
            scale = max(1.0, float(np.abs(want).max()))
            err = np.abs(got[i] - want).max() / scale
            assert err < 2e-3, f"loop job {i} desc rel err {err}"
            checked += 1
        for i in range(len(wants), cap):
            assert np.abs(got[i]).max() == 0.0
    assert checked >= 4


def test_chunked_equals_unchunked(small_image):
    cfg = SiftConfig(octaves=1, desc_mode="grid")
    per_octave = _collect_jobs(small_image, cfg, max_jobs=10)
    blur, xs, ys, sigmas, lvls, angs, _ = per_octave[0]
    jobs = _jobs_from_lists(xs, ys, sigmas, lvls, angs, len(xs))
    blur_j = jnp.asarray(blur)
    full = np.asarray(jax.jit(
        lambda b, j: compute_descriptors(b, j, cfg, chunk=1024))(blur_j, jobs))
    chunked = np.asarray(jax.jit(
        lambda b, j: compute_descriptors(b, j, cfg, chunk=4))(blur_j, jobs))
    assert np.allclose(full, chunked, atol=1e-5)


def test_make_jobs_flattening(small_image):
    from popsift_tpu.ops.extrema import detect_extrema
    from popsift_tpu.ops.orientation import assign_orientations
    cfg = SiftConfig(octaves=1)
    blurs, dogs = oracle_pyramid(small_image, cfg)
    H, W = dogs[0].shape[1:]
    cap = cfg.capacity_for_octave(H, W)

    def run(dog, blur):
        ext = detect_extrema(dog, cfg, cap, W, H)
        oris = assign_orientations(blur, ext, cfg)
        jobs = make_descriptor_jobs(ext, oris, cap + cap // 4)
        return ext, oris, jobs

    ext, oris, jobs = jax.jit(run)(jnp.asarray(dogs[0]), jnp.asarray(blurs[0]))
    n_jobs = int(jobs.count)
    assert n_jobs == int(np.asarray(oris.num_ori).sum())
    for i in range(n_jobs):
        kp = int(jobs.kp_index[i])
        assert bool(ext.valid[kp])
        assert float(jobs.sigma[i]) == float(ext.sigma[kp])


def test_variant_cross_consistency(small_image):
    """Cross-variant agreement (the reference ships TEST.sh to compare
    descriptor variants pairwise, testScripts/TEST.sh:19-73): grid and
    loop formulations must produce strongly correlated descriptors for
    the same keypoints."""
    import jax
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.pipeline import build_extract_plan, extract

    h, w = small_image.shape
    descs = {}
    for mode in ("loop", "grid"):
        cfg = SiftConfig(octaves=3, desc_mode=mode, extrema_capacity=256)
        plan = build_extract_plan(cfg, h, w)
        out = jax.jit(lambda x: extract(x, plan))(small_image)
        valid = np.asarray(out.desc_valid)
        descs[mode] = np.asarray(out.desc)[valid]
    n = min(len(descs["loop"]), len(descs["grid"]))
    assert n >= 3
    a, b = descs["loop"][:n], descs["grid"][:n]
    # same job ordering: compare row-wise cosine similarity
    num = (a * b).sum(1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12
    cos = num / den
    assert np.median(cos) > 0.9, np.median(cos)


def test_segmented_jobs_match_per_octave():
    """make_descriptor_jobs_segmented (one sort for all octaves) must
    reproduce per-segment make_descriptor_jobs exactly, including
    front-packing order, validity, counts and levels."""
    import jax.numpy as jnp
    from popsift_tpu.config import ORIENTATION_MAX_COUNT
    from popsift_tpu.ops.descriptors import (
        make_descriptor_jobs, make_descriptor_jobs_segmented)
    from popsift_tpu.ops.extrema import OctaveExtrema
    from popsift_tpu.ops.orientation import OctaveOrientations

    rng = np.random.default_rng(21)
    caps = (16, 48, 8)
    jcaps = (20, 56, 12)
    N = sum(caps)
    O = ORIENTATION_MAX_COUNT
    x = rng.uniform(0, 100, N).astype(np.float32)
    y = rng.uniform(0, 100, N).astype(np.float32)
    sig = rng.uniform(1, 4, N).astype(np.float32)
    lev = rng.integers(1, 4, N).astype(np.int32)
    ori = rng.uniform(-3, 3, (N, O)).astype(np.float32)
    ov = rng.random((N, O)) < 0.35

    offs = np.concatenate([[0], np.cumsum(caps)]).astype(int)
    segs = tuple((int(offs[i]), caps[i], jcaps[i]) for i in range(3))
    jobs, counts = make_descriptor_jobs_segmented(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(sig),
        jnp.asarray(lev), jnp.asarray(ori), jnp.asarray(ov), segs)

    joff = np.concatenate([[0], np.cumsum(jcaps)]).astype(int)
    for i in range(3):
        s, K, jc = segs[i]
        ext = OctaveExtrema(
            x=jnp.asarray(x[s:s + K]), y=jnp.asarray(y[s:s + K]),
            s=jnp.asarray(np.zeros(K, np.float32)),
            level=jnp.asarray(lev[s:s + K]),
            sigma=jnp.asarray(sig[s:s + K]),
            cell=jnp.asarray(np.zeros(K, np.int32)),
            valid=jnp.asarray(np.ones(K, bool)),
            count=jnp.int32(K), n_candidates=jnp.int32(K),
            n_dropped=jnp.int32(0))
        oris = OctaveOrientations(
            ori=jnp.asarray(ori[s:s + K]),
            ori_valid=jnp.asarray(ov[s:s + K]),
            num_ori=jnp.asarray(ov[s:s + K].sum(1).astype(np.int32)))
        ref = make_descriptor_jobs(ext, oris, jc)
        sl = slice(int(joff[i]), int(joff[i + 1]))
        assert np.array_equal(np.asarray(jobs.kp_index[sl]),
                              np.asarray(ref.kp_index))
        assert np.array_equal(np.asarray(jobs.valid[sl]),
                              np.asarray(ref.valid))
        assert np.array_equal(np.asarray(jobs.x[sl]), np.asarray(ref.x))
        assert np.array_equal(np.asarray(jobs.ang[sl]),
                              np.asarray(ref.ang))
        assert np.array_equal(np.asarray(jobs.level[sl]),
                              np.asarray(ref.level))
        assert int(counts[i]) == int(ref.count)
