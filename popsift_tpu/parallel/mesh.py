"""Device mesh helpers.

The reference is strictly single-GPU (SURVEY.md §2.7: no NCCL/MPI
anywhere); all multi-chip structure in this framework is new, built on
``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(
            f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis_name,))


def make_mesh_2d(dp: int, mp: int, names=("dp", "mp")) -> Mesh:
    """2-D mesh (data x model/spatial) for mixed sharding."""
    devs = jax.devices()
    if dp * mp > len(devs):
        raise ValueError(f"requested {dp * mp} devices, have {len(devs)}")
    return Mesh(np.array(devs[:dp * mp]).reshape(dp, mp), names)


def device_report() -> str:
    """Human-readable device listing (device_prop_t analog,
    common/device_prop.cu:18-87)."""
    lines = []
    for d in jax.devices():
        lines.append(f"id={d.id} kind={d.device_kind} "
                     f"platform={d.platform} process={d.process_index}")
    return "\n".join(lines)
