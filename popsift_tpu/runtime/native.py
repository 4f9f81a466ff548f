"""ctypes bindings for the native host runtime (native/popsift_host.cpp).

Exposes:

* :func:`decode_pnm` / :func:`write_pgm` — fast C++ PNM codec with the
  reference's integer RGB->gray semantics (pgmread.cpp:17-33).
* :class:`HostPipeline` — worker-thread decode/staging pipeline with a
  bounded queue and future-style jobs: the equivalent of the
  reference's stage-1 upload thread + image pool
  (popsift.cpp:171-180, 19-28).

Import raises ImportError when no C++ toolchain is available; callers
fall back to the pure-Python paths in :mod:`popsift_tpu.io.image`.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from .build import lib_path

try:
    _so = lib_path()
except Exception as _e:            # compiler present but build failed
    raise ImportError(f"native host runtime build failed: {_e}") from _e
if _so is None:
    raise ImportError("native host runtime unavailable (no C++ toolchain)")

try:
    _lib = C.CDLL(_so)
except OSError as _e:
    # e.g. a stale/foreign prebuilt .so incompatible with this platform;
    # surface as ImportError so callers fall back to the Python codec
    raise ImportError(f"native host runtime unloadable: {_e}") from _e

_lib.ps_pnm_decode_gray.restype = C.c_int
_lib.ps_pnm_decode_gray.argtypes = [
    C.c_char_p, C.c_size_t, C.POINTER(C.c_uint32), C.POINTER(C.c_uint32),
    C.c_void_p]
_lib.ps_pgm_write.restype = C.c_int
_lib.ps_pgm_write.argtypes = [C.c_char_p, C.c_char_p, C.c_uint32, C.c_uint32]
_lib.ps_pipeline_create.restype = C.c_void_p
_lib.ps_pipeline_create.argtypes = [C.c_int, C.c_size_t]
_lib.ps_pipeline_submit_file.restype = C.c_void_p
_lib.ps_pipeline_submit_file.argtypes = [C.c_void_p, C.c_char_p]
_lib.ps_pipeline_submit_bytes.restype = C.c_void_p
_lib.ps_pipeline_submit_bytes.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
_lib.ps_job_wait.restype = C.c_int
_lib.ps_job_wait.argtypes = [C.c_void_p]
_lib.ps_job_poll.restype = C.c_int
_lib.ps_job_poll.argtypes = [C.c_void_p]
_lib.ps_job_data.restype = C.POINTER(C.c_uint8)
_lib.ps_job_data.argtypes = [C.c_void_p, C.POINTER(C.c_uint32),
                             C.POINTER(C.c_uint32)]
_lib.ps_job_release.restype = None
_lib.ps_job_release.argtypes = [C.c_void_p]
_lib.ps_pipeline_jobs_done.restype = C.c_uint64
_lib.ps_pipeline_jobs_done.argtypes = [C.c_void_p]
_lib.ps_pipeline_destroy.restype = None
_lib.ps_pipeline_destroy.argtypes = [C.c_void_p]
_lib.ps_runtime_version.restype = C.c_char_p
_lib.ps_features_write.restype = C.c_int
_lib.ps_features_write.argtypes = [
    C.c_char_p, C.c_uint64, C.POINTER(C.c_float), C.POINTER(C.c_float),
    C.POINTER(C.c_float), C.POINTER(C.c_float), C.c_int]

_STATUS = {0: "ok", 1: "io error", 2: "format error", 3: "bad argument",
           4: "bad state"}


def version() -> str:
    return _lib.ps_runtime_version().decode()


def decode_pnm(data: bytes) -> np.ndarray:
    """Decode P2/P3/P5/P6 bytes to uint8 grayscale [H, W]."""
    w = C.c_uint32()
    h = C.c_uint32()
    rc = _lib.ps_pnm_decode_gray(data, len(data), C.byref(w), C.byref(h),
                                 None)
    if rc != 0:
        raise ValueError(f"PNM decode failed: {_STATUS.get(rc, rc)}")
    out = np.empty((h.value, w.value), np.uint8)
    rc = _lib.ps_pnm_decode_gray(
        data, len(data), C.byref(w), C.byref(h),
        out.ctypes.data_as(C.c_void_p))
    if rc != 0:
        raise ValueError(f"PNM decode failed: {_STATUS.get(rc, rc)}")
    return out


def read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_pnm(fh.read())


def write_features(path: str, x: np.ndarray, y: np.ndarray,
                   sigma: np.ndarray, desc: np.ndarray,
                   write_as_uchar: bool = False) -> None:
    """Stream the reference feature text format (one line per
    descriptor, Feature::print, features.cu:308-328) from flat
    per-descriptor arrays. ~100x faster than the per-feature Python
    loop for big feature sets; uses C %g (6 significant digits), the
    same formatting as the reference's ostream<<float."""
    n = int(desc.shape[0])
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    sigma = np.ascontiguousarray(sigma, np.float32)
    desc = np.ascontiguousarray(desc, np.float32)
    if x.shape[0] != n or y.shape[0] != n or sigma.shape[0] != n \
            or desc.shape[1] != 128:
        raise ValueError("write_features expects per-descriptor arrays")
    fp = C.POINTER(C.c_float)
    rc = _lib.ps_features_write(
        path.encode(), n, x.ctypes.data_as(fp), y.ctypes.data_as(fp),
        sigma.ctypes.data_as(fp), desc.ctypes.data_as(fp),
        1 if write_as_uchar else 0)
    if rc != 0:
        raise IOError(f"feature write failed: {_STATUS.get(rc, rc)}")


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError("write_pgm expects [H, W] uint8")
    h, w = img.shape
    rc = _lib.ps_pgm_write(path.encode(), img.ctypes.data_as(C.c_char_p),
                           w, h)
    if rc != 0:
        raise IOError(f"PGM write failed: {_STATUS.get(rc, rc)}")


class DecodeJob:
    """Future-style handle to one decode job (SiftJob analog,
    popsift.h:40-71, for the staging stage)."""

    def __init__(self, handle, pipeline):
        self._h = handle
        self._pl = pipeline
        self._result = None
        self._error = None

    def done(self) -> bool:
        if self._h is None:
            return True            # finished (either result or error)
        return bool(_lib.ps_job_poll(self._h))

    def get(self) -> np.ndarray:
        """Block until decoded; returns uint8 [H, W] (copies out of the
        staging slab so the slab can be recycled immediately)."""
        if self._result is not None:
            return self._result
        if self._h is None:
            # handle already released by a previous failed get(); calling
            # into the library with NULL would segfault
            raise IOError(f"decode job failed: {self._error}")
        rc = _lib.ps_job_wait(self._h)
        if rc != 0:
            _lib.ps_job_release(self._h)
            self._h = None
            self._error = _STATUS.get(rc, rc)
            raise IOError(f"decode job failed: {self._error}")
        w = C.c_uint32()
        h = C.c_uint32()
        ptr = _lib.ps_job_data(self._h, C.byref(w), C.byref(h))
        buf = np.ctypeslib.as_array(ptr, shape=(h.value, w.value))
        self._result = np.array(buf, np.uint8)   # copy out of the slab
        _lib.ps_job_release(self._h)
        self._h = None
        return self._result


class HostPipeline:
    """Threaded decode/staging pipeline with bounded-queue backpressure.

    Usage::

        with HostPipeline(threads=2) as pl:
            jobs = [pl.submit(p) for p in paths]     # overlaps with compute
            for j in jobs:
                img = j.get()
    """

    def __init__(self, threads: int = 2, queue_capacity: int = 8):
        self._h = _lib.ps_pipeline_create(threads, queue_capacity)

    def submit(self, path: str) -> DecodeJob:
        job = _lib.ps_pipeline_submit_file(self._h, path.encode())
        if not job:
            raise RuntimeError("pipeline is shutting down")
        return DecodeJob(job, self)

    def submit_bytes(self, data: bytes) -> DecodeJob:
        job = _lib.ps_pipeline_submit_bytes(self._h, data, len(data))
        if not job:
            raise RuntimeError("pipeline is shutting down")
        return DecodeJob(job, self)

    @property
    def jobs_done(self) -> int:
        return int(_lib.ps_pipeline_jobs_done(self._h))

    def close(self):
        if self._h:
            _lib.ps_pipeline_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
