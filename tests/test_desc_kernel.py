"""The Triton descriptor kernel (ops/pallas/desc.py) against the plain
XLA reference ``_descriptor_loop_chunk``, in interpret mode on the CPU,
plus the wrapper around it: empty input, small images, row bounds, vmap,
and the choice of implementation by platform and descriptor mode. The
compiled kernel runs only on a GPU (``gpu`` marker); ``chip_smoke.py``
makes the same comparison on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops.descriptors import (DescriptorJobs,
                                         _descriptor_loop_chunk,
                                         compute_descriptors,
                                         loop_patch_radius)
from popsift_tpu.ops.pallas.desc import descriptor_loop_triton, support_radius
from popsift_tpu.ops.patches import pad_for_patches

CFG = SiftConfig()
RADIUS = loop_patch_radius(CFG)
SIGMA_BUCKETS = {"small": (1.2, 2.0), "medium": (2.0, 3.2),
                 "large": (3.2, 4.5)}


def _blur(H, W, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(64, 32, size=(CFG.total_levels, H, W))
                       .astype(np.float32))


def _jobs(F, H, W, n_valid, sigma_range, seed=1):
    rng = np.random.default_rng(seed)
    return DescriptorJobs(
        x=jnp.asarray(rng.uniform(0, W - 1, F).astype(np.float32)),
        y=jnp.asarray(rng.uniform(0, H - 1, F).astype(np.float32)),
        sigma=jnp.asarray(rng.uniform(*sigma_range, F).astype(np.float32)),
        level=jnp.asarray(rng.integers(0, CFG.total_levels, F)
                          .astype(np.int32)),
        ang=jnp.asarray(rng.uniform(-np.pi, np.pi, F).astype(np.float32)),
        kp_index=jnp.arange(F, dtype=jnp.int32),
        valid=jnp.asarray(np.arange(F) < n_valid),
        count=jnp.int32(n_valid))


def _reference(blur, jobs, y_bounds=None):
    img = pad_for_patches(blur, 2 * RADIUS + 1)
    return np.asarray(_descriptor_loop_chunk(img, blur.shape[-2:], jobs,
                                             RADIUS, y_bounds=y_bounds))


def _assert_close(got, want, valid):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale)
    assert not np.any(got[~np.asarray(valid)])


@pytest.mark.parametrize("bucket", sorted(SIGMA_BUCKETS))
@pytest.mark.parametrize("fill", ["full", "partial", "empty"])
def test_kernel_matches_reference(bucket, fill):
    H, W, F = 96, 128, 12
    n_valid = {"full": F, "partial": F // 2, "empty": 0}[fill]
    blur = _blur(H, W)
    jobs = _jobs(F, H, W, n_valid, SIGMA_BUCKETS[bucket])
    got = np.asarray(descriptor_loop_triton(blur, jobs, RADIUS,
                                            interpret=True))
    _assert_close(got, _reference(blur, jobs), jobs.valid)
    if n_valid:
        assert np.abs(got[:n_valid]).max() > 0


@pytest.mark.parametrize("hw", [(35, 41), (64, 128)])
def test_kernel_on_images_smaller_than_the_window(hw):
    """The reference edge-pads images smaller than its static patch; the
    kernel reads the image in place with masks."""
    H, W = hw
    blur = _blur(H, W, seed=2)
    jobs = _jobs(8, H, W, 8, SIGMA_BUCKETS["large"], seed=3)
    got = np.asarray(descriptor_loop_triton(blur, jobs, RADIUS,
                                            interpret=True))
    _assert_close(got, _reference(blur, jobs), jobs.valid)


def test_kernel_row_bounds_as_traced_scalars():
    """The sharded row-band path passes y_bounds computed on the device."""
    H, W = 96, 128
    blur = _blur(H, W, seed=4)
    jobs = _jobs(8, H, W, 8, SIGMA_BUCKETS["medium"], seed=5)

    @jax.jit
    def run(lo, hi):
        return descriptor_loop_triton(blur, jobs, RADIUS, y_bounds=(lo, hi),
                                      interpret=True)

    got = np.asarray(run(jnp.int32(20), jnp.int32(70)))
    _assert_close(got, _reference(blur, jobs, y_bounds=(20, 70)),
                  jobs.valid)


def test_kernel_empty_job_list():
    blur = _blur(32, 32)
    jobs = _jobs(0, 32, 32, 0, SIGMA_BUCKETS["small"])
    assert descriptor_loop_triton(blur, jobs, RADIUS).shape == (0, 128)


def test_kernel_under_vmap():
    """extract_batch vmaps the pipeline over frames, kernel included."""
    H, W = 48, 64
    blurs = jnp.stack([_blur(H, W, seed=s) for s in (6, 7)])
    jobs = _jobs(6, H, W, 5, SIGMA_BUCKETS["small"], seed=8)
    got = np.asarray(jax.vmap(lambda b: descriptor_loop_triton(
        b, jobs, RADIUS, interpret=True))(blurs))
    for f in range(2):
        _assert_close(got[f], _reference(blurs[f], jobs), jobs.valid)


def test_support_radius_within_static_bound():
    """The per-job scan radius never exceeds the static patch radius for
    sigmas the detector can produce (sn < maxlevel - 0.5)."""
    s_max = CFG.sigma * 2.0 ** ((CFG.total_levels - 1.5) / CFG.levels)
    sig = jnp.linspace(0.5, s_max, 64)
    r = np.asarray(support_radius(sig))
    assert r.max() <= RADIUS and np.all(np.diff(r) >= 0)


@pytest.mark.parametrize("mode", ["loop", "iloop", "grid", "igrid"])
@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_implementation_choice(mode, platform):
    """compute_descriptors picks the kernel exactly for the loop variant
    in a program lowered for a CUDA GPU; everything else is XLA."""
    cfg = SiftConfig(desc_mode=mode)
    blur = _blur(32, 48)
    jobs = _jobs(4, 32, 48, 4, SIGMA_BUCKETS["small"])
    text = jax.jit(lambda b, j: compute_descriptors(b, j, cfg)).trace(
        blur, jobs).lower(lowering_platforms=(platform,)).as_text()
    assert ("sift_desc_loop" in text) == (mode == "loop"
                                          and platform == "cuda")


@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_forced_implementation(impl):
    """impl= forces one form on any platform (the kernel lowers for CUDA
    even when traced on the CPU)."""
    blur = _blur(32, 48)
    jobs = _jobs(4, 32, 48, 4, SIGMA_BUCKETS["small"])
    text = jax.jit(lambda b, j: compute_descriptors(
        b, j, CFG, impl=impl)).trace(blur, jobs).lower(
            lowering_platforms=("cuda",)).as_text()
    assert ("sift_desc_loop" in text) == (impl == "kernel")


def test_unknown_implementation_rejected():
    blur = _blur(32, 48)
    jobs = _jobs(4, 32, 48, 4, SIGMA_BUCKETS["small"])
    with pytest.raises(ValueError):
        compute_descriptors(blur, jobs, CFG, impl="cuda")


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu):
    H, W, F = 256, 320, 64
    blur = _blur(H, W, seed=9)
    jobs = _jobs(F, H, W, F - 5, SIGMA_BUCKETS["large"], seed=10)
    got = np.asarray(jax.jit(lambda b, j: descriptor_loop_triton(
        b, j, RADIUS))(blur, jobs))
    _assert_close(got, _reference(blur, jobs), jobs.valid)


@pytest.mark.parametrize("path", ["batched", "sharded"])
def test_mesh_programs_lower_for_cuda(path):
    """The kernel inside shard_map lowers through the Triton route (in
    Python, no GPU needed): varying-axis checking would put pvary casts
    in its body, which that lowering rejects."""
    from popsift_tpu.parallel.batch import make_batched_extract_fn
    from popsift_tpu.parallel.mesh import make_mesh
    from popsift_tpu.parallel.spatial import make_sharded_extract_fn

    if path == "batched":
        fn = make_batched_extract_fn(SiftConfig(octaves=2,
                                                extrema_capacity=64),
                                     48, 64, make_mesh(4))
        x = jnp.zeros((4, 48, 64), jnp.uint8)
    else:
        fn, _ = make_sharded_extract_fn(
            SiftConfig(octaves=3, extrema_capacity=128), 224, 160,
            make_mesh(4, axis_name="sp"))
        x = jnp.zeros((224, 160), jnp.uint8)
    text = fn.trace(x).lower(lowering_platforms=("cuda",)).as_text()
    assert "sift_desc_loop" in text
