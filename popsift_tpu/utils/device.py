"""Device enumeration and capability report.

Counterpart of the reference's ``device_prop_t`` printer
(/root/reference/src/popsift/common/device_prop.cu:18-87): lists the
devices visible to this process and the mesh topology facts that matter
for planning shardings.
"""

from __future__ import annotations

import os

import jax

# fixed cache location when JAX_COMPILATION_CACHE_DIR is unset: the
# checkout root, found from this file (popsift_tpu/utils/device.py)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache is ``<checkout>/.jax_cache``
    (a fixed path, since the path is part of the cache key).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def device_report(verbose: bool = True) -> list:
    """Return (and optionally print) a per-device capability summary."""
    rows = []
    for d in jax.devices():
        row = {
            "id": d.id,
            "platform": d.platform,
            "kind": getattr(d, "device_kind", "?"),
            "process": d.process_index,
            "coords": getattr(d, "coords", None),
            "core_on_chip": getattr(d, "core_on_chip", None),
        }
        try:
            stats = d.memory_stats() or {}
            row["hbm_bytes"] = stats.get("bytes_limit")
            row["hbm_in_use"] = stats.get("bytes_in_use")
        except Exception:
            pass
        rows.append(row)
    if verbose:
        print(f"backend: {jax.default_backend()}  "
              f"processes: {jax.process_count()}  "
              f"devices: {jax.device_count()} "
              f"(local {jax.local_device_count()})")
        for r in rows:
            hbm = r.get("hbm_bytes")
            hbm_s = f"{hbm / 2**30:.1f} GiB" if hbm else "?"
            print(f"  [{r['id']}] {r['kind']} (proc {r['process']}, "
                  f"coords {r['coords']}) hbm={hbm_s}")
    return rows


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the multi-host JAX runtime (jax.distributed).

    Pass all three arguments for CPU/GPU multi-process runs (nothing
    detects a cluster on its own). Idempotent.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise
