"""Restartable batch extraction: crash mid-job, resume, no recompute."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import synthetic_image
from popsift_tpu.utils.device import CACHE_DIR

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _write_frames(d, n=5):
    paths = []
    for i in range(n):
        img = synthetic_image(48, 64, seed=i)
        p = os.path.join(d, f"frame{i}.pgm")
        with open(p, "wb") as fh:
            fh.write(b"P5\n64 48\n255\n" + img.tobytes())
        paths.append(p)
    return paths


def test_batch_job_runs_and_resumes(tmp_path):
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.runtime.batchjob import BatchExtractJob

    frames = _write_frames(str(tmp_path), 4)
    out = str(tmp_path / "feat")
    cfg = SiftConfig(octaves=2, extrema_capacity=64)

    job = BatchExtractJob(out, cfg)
    stats = job.run(frames)
    assert stats == {"done": 4, "skipped": 0}
    npzs = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    assert len(npzs) == 4
    d = np.load(os.path.join(out, npzs[0]))
    assert d["descriptors"].shape[1] == 128

    # re-run: everything skipped, outputs untouched
    mtimes = {f: os.path.getmtime(os.path.join(out, f)) for f in npzs}
    stats2 = BatchExtractJob(out, cfg).run(frames)
    assert stats2 == {"done": 0, "skipped": 4}
    for f in npzs:
        assert os.path.getmtime(os.path.join(out, f)) == mtimes[f]


@pytest.mark.slow
def test_batch_job_crash_resume(tmp_path):
    """Kill the job subprocess after 2 frames; the resumed run completes
    the remaining frames without recomputing the finished ones."""
    frames = _write_frames(str(tmp_path), 5)
    out = str(tmp_path / "feat")

    driver = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from popsift_tpu.config import SiftConfig
from popsift_tpu.runtime.batchjob import BatchExtractJob

count = 0
def bomb(path, feats):
    global count
    count += 1
    if count == 2:
        os._exit(23)       # crash: no cleanup, manifest mid-append ok

job = BatchExtractJob({out!r}, SiftConfig(octaves=2, extrema_capacity=64))
job.run({frames!r}, on_frame=bomb)
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", CACHE_DIR)
    p = subprocess.run([sys.executable, "-c", driver], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 23, p.stderr[-2000:]

    manifest = os.path.join(out, "MANIFEST.jsonl")
    recs = [json.loads(l) for l in open(manifest) if l.strip()]
    assert len(recs) == 2

    from popsift_tpu.config import SiftConfig
    from popsift_tpu.runtime.batchjob import BatchExtractJob
    done_before = {r["frame"] for r in recs}
    stats = BatchExtractJob(out, SiftConfig(octaves=2,
                                            extrema_capacity=64)).run(frames)
    assert stats == {"done": 3, "skipped": 2}
    recs2 = [json.loads(l) for l in open(manifest) if l.strip()]
    assert len(recs2) == 5
    assert {r["frame"] for r in recs2} == set(frames)
    # the two pre-crash frames were not recomputed
    assert {r["frame"] for r in recs2[:2]} == done_before


def test_batch_job_batched_matches_per_frame(tmp_path):
    """batch=3 groups frames into one device program (enqueue_batch);
    outputs must be identical to the per-frame path."""
    from popsift_tpu.config import SiftConfig
    from popsift_tpu.runtime.batchjob import BatchExtractJob

    frames = _write_frames(str(tmp_path), 4)
    cfg = SiftConfig(octaves=2, extrema_capacity=64)

    out1 = str(tmp_path / "f1")
    out3 = str(tmp_path / "f3")
    s1 = BatchExtractJob(out1, cfg, batch=1).run(frames)
    s3 = BatchExtractJob(out3, cfg, batch=3).run(frames)
    assert s1 == s3 == {"done": 4, "skipped": 0}
    for f in sorted(os.listdir(out1)):
        if not f.endswith(".npz"):
            continue
        a = np.load(os.path.join(out1, f))
        b = np.load(os.path.join(out3, f))
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0,
                                       err_msg=f"{f}:{k}")
