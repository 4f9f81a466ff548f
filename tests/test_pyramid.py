"""JAX pyramid vs NumPy oracle golden tests."""

import jax
import jax.numpy as jnp
import numpy as np

from popsift_tpu.config import SiftConfig
from popsift_tpu.ops.pyramid import build_pyramid, build_pyramid_plan
from popsift_tpu.oracle import oracle_pyramid


def _compare(img, cfg, atol=2e-3):
    plan = build_pyramid_plan(cfg, *img.shape)
    fn = jax.jit(lambda x: build_pyramid(x, plan))
    blurs_j, dogs_j = fn(img)
    blurs_o, dogs_o = oracle_pyramid(img, cfg)
    assert len(blurs_j) == len(blurs_o)
    for o, (bj, bo) in enumerate(zip(blurs_j, blurs_o)):
        bj = np.asarray(bj)
        assert bj.shape == bo.shape, f"octave {o} shape"
        err = np.abs(bj - bo).max()
        assert err < atol, f"octave {o} blur max err {err}"
    for o, (dj, do) in enumerate(zip(dogs_j, dogs_o)):
        err = np.abs(np.asarray(dj) - do).max()
        assert err < atol, f"octave {o} dog max err {err}"


def test_pyramid_matches_oracle(small_image):
    _compare(small_image, SiftConfig(octaves=3))


def test_pyramid_matches_oracle_odd_size():
    rng = np.random.default_rng(5)
    img = (rng.uniform(0, 255, size=(61, 83))).astype(np.uint8)
    _compare(img, SiftConfig(octaves=3))


def test_pyramid_matches_oracle_no_upscale(small_image):
    _compare(small_image, SiftConfig(octaves=2, upscale_factor=0.0))


def test_pyramid_matches_oracle_more_levels(small_image):
    _compare(small_image, SiftConfig(octaves=2, levels=4))


def test_pyramid_strategy_branches(small_image):
    """Direct scaling and relative-all modes build and stay close to the
    incremental pyramid (same target sigmas, different accumulation)."""
    import jax
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.ops.pyramid import build_pyramid, build_pyramid_plan

    h, w = small_image.shape
    base_cfg = SiftConfig(octaves=3)
    base_plan = build_pyramid_plan(base_cfg, h, w)
    base_blurs, _ = jax.jit(lambda x: build_pyramid(x, base_plan))(small_image)

    for kw in ({"scaling_mode": "direct"},
               {"gauss_mode": "vlfeat-relative-all"}):
        cfg = SiftConfig(octaves=3, **kw)
        plan = build_pyramid_plan(cfg, h, w)
        blurs, dogs = jax.jit(lambda x: build_pyramid(x, plan))(small_image)
        for o, (b, bb) in enumerate(zip(blurs, base_blurs)):
            assert b.shape == bb.shape
            # interior agreement within a few gray levels
            d = np.abs(np.asarray(b) - np.asarray(bb))[:, 4:-4, 4:-4]
            # direct scaling is a documented accuracy trade-off in the
            # reference; divergence grows with octave
            assert d.mean() < 3.0 + 1.5 * o, (kw, o, d.mean())


def test_interleave2x2(rng):
    from popsift_tpu.ops.pyramid import _interleave2x2
    H, W = 64, 128
    planes = [jnp.asarray(rng.normal(size=(H, W)).astype(np.float32))
              for _ in range(4)]
    out = np.asarray(_interleave2x2(((planes[0], planes[1]),
                                     (planes[2], planes[3]))))
    p00, p01, p10, p11 = [np.asarray(p) for p in planes]
    np.testing.assert_array_equal(out[0::2, 0::2], p00)
    np.testing.assert_array_equal(out[0::2, 1::2], p01)
    np.testing.assert_array_equal(out[1::2, 0::2], p10)
    np.testing.assert_array_equal(out[1::2, 1::2], p11)


def test_polyphase_lvl0_matches_gather_path(rng):
    """The polyphase 2x-upscale path must reproduce the generic
    resample+conv path to f32 tolerance."""
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.ops.pyramid import build_pyramid_plan, _octave0_level0
    import dataclasses
    cfg = SiftConfig()
    h, w = 37, 53
    plan = build_pyramid_plan(cfg, h, w)
    img = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    fast = np.asarray(_octave0_level0(jnp.asarray(img), plan))
    # force the generic path by lying about the shift (still 1.0 value,
    # so compare against a plan whose dims break the structural test)
    slow_plan = dataclasses.replace(plan, shift0=plan.shift0 + 0.0)
    object.__setattr__  # noqa: B018
    # build the generic result by calling the internals directly
    from popsift_tpu.ops.pyramid import _lerp_rows, _conv1d_valid
    oh, ow = plan.dims[0]
    kx = plan.lvl0_kernel_x
    pad = (kx.shape[0] - 1) // 2
    x = jnp.asarray(img).astype(jnp.float32) / 255.0
    ys = (np.arange(oh, dtype=np.float64) + plan.shift0) * (h / oh) - 0.5
    xs = (np.arange(-pad, ow + pad, dtype=np.float64)
          + plan.shift0) * (w / ow) - 0.5
    r = _lerp_rows(x, ys)
    r = _lerp_rows(r.T, xs).T
    out = _conv1d_valid(r, kx, axis=1) * 255.0
    ky = plan.lvl0_kernel_y
    pady = (ky.shape[0] - 1) // 2
    out = jnp.pad(out, ((pady, pady), (0, 0)), mode="edge")
    slow = np.asarray(_conv1d_valid(out, ky, axis=0))
    np.testing.assert_allclose(fast, slow, atol=2e-3)
