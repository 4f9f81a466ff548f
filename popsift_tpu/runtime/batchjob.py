"""Restartable batch extraction jobs.

The reference processes one image at a time and exits on any failure
(debug_macros.cu:36-45); a production deployment runs hours-long
extraction sweeps where a crash must not lose completed work. This
runner gives extraction the same elastic story the SfM engine has
(sfm/checkpoint.py):

* per-frame results are written atomically (tmp + rename) as .npz;
* a MANIFEST.jsonl append-only log records completed frames (with the
  output checksum) — a torn final line from a crash is detected and
  ignored;
* re-running the same job directory skips frames already in the
  manifest, so a killed job resumes where it stopped.

Decoding runs through the native host pipeline when available
(runtime/native.py worker threads overlap decode with device compute, the
stage-1 upload thread analog, popsift.cpp:171-180).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _atomic_write_npz(path: str, payload: dict):
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as fh:
        np.savez_compressed(fh, **payload)
    os.replace(tmp, path)


def _load_manifest(path: str) -> dict:
    """Read MANIFEST.jsonl; skip a torn (crash-truncated) last line."""
    done = {}
    if not os.path.exists(path):
        return done
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue       # torn tail from a crash mid-append
            done[rec["frame"]] = rec
    return done


class BatchExtractJob:
    """Extract features for many frames with crash-safe resume.

    Usage::

        job = BatchExtractJob(out_dir, config)
        stats = job.run(paths)      # resumes automatically on re-run
    """

    def __init__(self, out_dir: str, config=None, verbose: bool = False,
                 batch: int = 1):
        from ..config import SiftConfig
        self.out_dir = out_dir
        self.config = config or SiftConfig()
        self.verbose = verbose
        self.batch = max(1, int(batch))
        os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(out_dir, "MANIFEST.jsonl")

    def _out_path(self, frame: str) -> str:
        stem = os.path.splitext(os.path.basename(frame))[0]
        return os.path.join(self.out_dir, f"{stem}.features.npz")

    def run(self, paths, on_frame=None) -> dict:
        """Process ``paths``; returns {"done": n, "skipped": n}.

        ``on_frame(path, features)`` is called after each completed
        frame (test hook; also where a fault injector can crash us).
        """
        from ..api import PopSift

        done = _load_manifest(self.manifest_path)
        ps = PopSift(self.config)

        try:
            from . import native
            pipeline = native.HostPipeline(threads=2)
        except ImportError:
            pipeline = None

        def decode(path):
            if pipeline is not None and path.lower().endswith(
                    (".pgm", ".ppm", ".pnm")):
                return pipeline.submit(path)
            from ..io.image import load_image

            class _Imm:
                def __init__(self, img):
                    self._img = img

                def get(self):
                    return self._img
            return _Imm(load_image(path))

        pending = [p for p in paths if p not in done]
        skipped = len(paths) - len(pending)
        n_done = 0
        # decode ahead of compute with a small lookahead window (the
        # native pipeline queue is bounded; submitting everything up
        # front could block against our own consumption order)
        import collections
        lookahead = max(4, 2 * self.batch)
        window = collections.deque()
        idx = 0
        manifest = open(self.manifest_path, "a")
        try:
            while idx < len(pending) or window:
                while idx < len(pending) and len(window) < lookahead:
                    window.append((pending[idx], decode(pending[idx])))
                    idx += 1
                # pull up to self.batch consecutive same-shaped frames
                # and extract them as ONE device program (enqueue_batch);
                # a shape change ends the group early (per-frame fallback)
                group = [(window[0][0], window.popleft()[1].get())]
                while (window and len(group) < self.batch
                       and window[0][1].get().shape == group[0][1].shape
                       and window[0][1].get().dtype == group[0][1].dtype):
                    group.append((window[0][0], window.popleft()[1].get()))
                if len(group) == 1:
                    jobs = [ps.enqueue(group[0][1])]
                else:
                    jobs = ps.enqueue_batch([im for _, im in group])
                for (path, _), job in zip(group, jobs):
                    feats = job.get()
                    out = self._out_path(path)
                    _atomic_write_npz(out, dict(
                        x=feats.x, y=feats.y, sigma=feats.sigma,
                        octave=feats.octave, num_ori=feats.num_ori,
                        orientations=feats.orientations,
                        descriptors=feats.descriptors,
                        desc_to_kp=feats.desc_to_kp))
                    rec = {"frame": path, "out": os.path.basename(out),
                           "n_kp": feats.getFeatureCount(),
                           "n_desc": feats.getDescriptorCount(),
                           "checksum": round(
                               float(np.sum(feats.descriptors)), 3)}
                    manifest.write(json.dumps(rec) + "\n")
                    manifest.flush()
                    os.fsync(manifest.fileno())
                    n_done += 1
                    if self.verbose:
                        print(f"[batch] {path}: {rec['n_kp']} kp")
                    if on_frame is not None:
                        on_frame(path, feats)
        finally:
            manifest.close()
            if pipeline is not None:
                pipeline.close()
        return {"done": n_done, "skipped": skipped}
