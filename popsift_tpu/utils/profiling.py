"""Tracing / profiling utilities.

Counterpart of the reference's observability hooks:

* NVTX ranges (compile-gated macros, /root/reference/src/popsift/
  popsift.h:22-27, sift_pyramid.cu:25-30) -> :func:`trace_scope`, which
  enters a ``jax.profiler.TraceAnnotation`` (shows up in XProf/
  TensorBoard timelines) and a ``jax.named_scope`` (shows up in HLO op
  names) simultaneously.
* the CUDA-event timer ``BriefDuration`` (common/debug_macros.h:81-114)
  -> :class:`BriefDuration`, which times a block with true device
  synchronization and optional running statistics.
* ``--print-time-info`` style reporting -> :class:`StageTimer` with a
  printable per-stage summary.

All helpers are no-ops in cost when tracing is not active; JAX traces
annotate metadata only.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def trace_scope(name: str):
    """Annotate a host-side region for the profiler AND name the ops
    traced inside it (both XProf timeline and HLO module naming)."""
    with jax.profiler.TraceAnnotation(name):
        with jax.named_scope(name):
            yield


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profile (XProf) for the enclosed block::

        with device_trace("/tmp/profile"):
            fn(x).block_until_ready()
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class BriefDuration:
    """Synchronized block timer (BriefDuration, debug_macros.h:81-114).

    Unlike the reference's cudaEvent pair this must block on the device
    queue; pass the result pytree to ``stop`` so only the measured
    computation is awaited::

        t = BriefDuration("extract")
        out = fn(x)
        ms = t.stop(out)
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        ms = (time.perf_counter() - self._t0) * 1000.0
        if self.name:
            print(f"[{self.name}] {ms:.2f} ms")
        return ms


@dataclass
class StageTimer:
    """Accumulates per-stage wall times across frames; prints a summary
    (the --print-time-info reporting the reference declares but never
    wires up, main.cpp:117)."""

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result_ref: list | None = None):
        t0 = time.perf_counter()
        yield
        dt = (time.perf_counter() - t0) * 1000.0
        total, count = self.stages.get(name, (0.0, 0))
        self.stages[name] = (total + dt, count + 1)

    def summary(self) -> str:
        lines = ["stage                     total(ms)   mean(ms)  calls"]
        for name, (total, count) in sorted(self.stages.items()):
            lines.append(f"{name:24s} {total:10.2f} {total / count:10.2f}"
                         f" {count:6d}")
        return "\n".join(lines)

    def print(self):
        print(self.summary())
