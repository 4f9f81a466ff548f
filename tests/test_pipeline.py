"""End-to-end extraction pipeline vs oracle, plus public API tests."""

import io

import jax
import numpy as np
import pytest

from popsift_tpu.api import PopSift
from popsift_tpu.config import SiftConfig
from popsift_tpu.pipeline import build_extract_plan, make_extract_fn
from popsift_tpu.oracle import oracle_extract


def _match_features(host, oracle_feats, pos_tol=5e-3, desc_tol=5e-3):
    """Greedy 1-1 matching between pipeline and oracle feature sets."""
    assert host.getFeatureCount() == len(oracle_feats), \
        f"kp count {host.getFeatureCount()} vs oracle {len(oracle_feats)}"
    got = list(host.features())
    used = [False] * len(oracle_feats)
    for g in got:
        bi, bd = -1, None
        for i, o in enumerate(oracle_feats):
            if used[i]:
                continue
            d = abs(g.x - o.x) + abs(g.y - o.y)
            if bd is None or d < bd:
                bd, bi = d, i
        assert bd is not None and bd < pos_tol, f"unmatched keypoint {g.x},{g.y}"
        used[bi] = True
        o = oracle_feats[bi]
        assert abs(g.sigma - o.sigma) < 1e-3
        assert g.num_ori == len(o.orientations), \
            f"num_ori {g.num_ori} vs {len(o.orientations)}"
        for j in range(g.num_ori):
            dd = np.abs(g.descriptors[j] - o.descriptors[j]).max()
            assert dd < desc_tol, f"desc err {dd}"


@pytest.mark.slow
def test_pipeline_matches_oracle_end_to_end(small_image):
    cfg = SiftConfig(octaves=3)
    ps = PopSift(cfg)
    job = ps.enqueue(small_image)
    host = job.get()
    feats = oracle_extract(small_image, cfg, desc_variant="loop")
    assert host.getFeatureCount() > 3
    _match_features(host, feats)


def test_pipeline_runs_and_is_jittable(small_image):
    cfg = SiftConfig(octaves=2)
    plan = build_extract_plan(cfg, *small_image.shape)
    fn = make_extract_fn(plan)
    out = fn(small_image)
    assert int(out.n_keypoints) > 0
    assert int(out.n_descriptors) >= int(out.n_keypoints)
    # second call hits the jit cache
    out2 = fn(small_image)
    assert int(out2.n_keypoints) == int(out.n_keypoints)


def test_features_text_format(small_image):
    ps = PopSift(SiftConfig(octaves=2))
    host = ps.enqueue(small_image).get()
    buf = io.StringIO()
    host.print(buf)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == host.getDescriptorCount()
    parts = lines[0].split()
    # x y 1/s^2 0 1/s^2 + 128 descriptor values (features.cu:308-328)
    assert len(parts) == 5 + 128
    assert parts[3] == "0"
    assert abs(float(parts[2]) - float(parts[4])) < 1e-9


def test_reverse_map_consistency(small_image):
    ps = PopSift(SiftConfig(octaves=2))
    host = ps.enqueue(small_image).get()
    assert host.desc_to_kp.min() >= 0
    assert host.desc_to_kp.max() < host.getFeatureCount()
    counts = np.bincount(host.desc_to_kp, minlength=host.getFeatureCount())
    assert (counts == host.num_ori).all()


def test_grid_filter_budget(small_image):
    cfg = SiftConfig(octaves=3, filter_max_extrema=4, filter_grid_size=1)
    ps = PopSift(cfg)
    host = ps.enqueue(small_image).get()
    cfg_off = SiftConfig(octaves=3)
    host_off = PopSift(cfg_off).enqueue(small_image).get()
    assert host.getFeatureCount() <= 4
    assert host_off.getFeatureCount() > host.getFeatureCount()


def test_scan_batched_extraction(small_image):
    """The production batching mode (lax.scan over frames, bench.py)
    must produce per-frame results identical to single calls."""
    import jax
    import jax.numpy as jnp
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.pipeline import build_extract_plan, extract

    h, w = small_image.shape
    cfg = SiftConfig(octaves=3, extrema_capacity=128)
    plan = build_extract_plan(cfg, h, w)
    imgs = np.stack([small_image, 255 - small_image])

    def scanfn(xs):
        def body(_, im):
            out = extract(im, plan)
            return 0, (out.n_keypoints, jnp.sum(out.desc))
        return jax.lax.scan(body, 0, xs)[1]

    nk, ds = jax.jit(scanfn)(jnp.asarray(imgs))
    for i in range(2):
        ref = jax.jit(lambda x: extract(x, plan))(imgs[i])
        assert int(nk[i]) == int(ref.n_keypoints)
        np.testing.assert_allclose(float(ds[i]),
                                   float(jnp.sum(ref.desc)), rtol=1e-5)


def test_deprecated_init_execute_shims(small_image):
    """Deprecated blocking API (PopSift::init/execute,
    popsift.h:122-139): init warms the plan, execute = enqueue + get."""
    import warnings
    ps = PopSift(SiftConfig(octaves=2))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ps.init(small_image.shape[1], small_image.shape[0])
        host = ps.execute(small_image)
    assert any(issubclass(w.category, DeprecationWarning) for w in rec)
    ref = ps.enqueue(small_image).get()
    assert host.getFeatureCount() == ref.getFeatureCount()
    assert host.getDescriptorCount() == ref.getDescriptorCount()


def test_matching_mode_get_returns_dev(small_image):
    """In matching mode SiftJob.get resolves to the device-resident
    FeaturesDev (matchPrepareLoop, popsift.cpp:215-236) with no host
    compaction; extracting mode keeps returning FeaturesHost."""
    from popsift_tpu.api import FeaturesDev, FeaturesHost
    cfg = SiftConfig(octaves=2)
    dev = PopSift(cfg, mode="matching").enqueue(small_image).get()
    assert isinstance(dev, FeaturesDev)
    host = PopSift(cfg).enqueue(small_image).get()
    assert isinstance(host, FeaturesHost)
    assert dev.getDescriptorCount() == host.getDescriptorCount()


def test_extract_batch_fallback_parity(small_image):
    """extract_batch (the per-frame body vmapped over frames) must match
    per-frame single extraction exactly."""
    import jax
    import jax.numpy as jnp
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.pipeline import (build_extract_plan, extract,
                                      extract_batch)

    h, w = small_image.shape
    cfg = SiftConfig(octaves=3, extrema_capacity=128)
    plan = build_extract_plan(cfg, h, w)
    imgs = jnp.asarray(np.stack([small_image, 255 - small_image]))

    out = jax.jit(lambda x: extract_batch(x, plan))(imgs)
    for i in range(2):
        ref = jax.jit(lambda x: extract(x, plan))(imgs[i])
        assert int(out.n_keypoints[i]) == int(ref.n_keypoints)
        assert int(out.n_descriptors[i]) == int(ref.n_descriptors)
        np.testing.assert_allclose(np.asarray(out.desc[i]),
                                   np.asarray(ref.desc), rtol=1e-6)


@pytest.mark.parametrize("F", [1, 3])
def test_extract_batch_matches_extract(small_image, F):
    """Batch sizes beside test_extract_batch_fallback_parity's F=2."""
    import jax
    import jax.numpy as jnp
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.pipeline import (build_extract_plan, extract,
                                      extract_batch)

    h, w = small_image.shape
    plan = build_extract_plan(SiftConfig(octaves=3, extrema_capacity=128),
                              h, w)
    imgs = jnp.asarray(np.stack([np.roll(small_image, 7 * f, axis=1)
                                 for f in range(F)]))
    out = jax.jit(lambda x: extract_batch(x, plan))(imgs)
    single = jax.jit(lambda x: extract(x, plan))
    for f in range(F):
        ref = single(imgs[f])
        for k in ("n_keypoints", "n_descriptors"):
            assert int(getattr(out, k)[f]) == int(getattr(ref, k))
        np.testing.assert_allclose(np.asarray(out.x[f]),
                                   np.asarray(ref.x), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(out.desc[f]),
                                   np.asarray(ref.desc), rtol=1e-6)
