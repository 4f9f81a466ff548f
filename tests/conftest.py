"""Test configuration: the suite runs on the CPU with an 8-device virtual
mesh, so sharding tests run anywhere. Tests of code that runs only on the
GPU carry the ``gpu`` marker and skip here (see the ``gpu`` fixture)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# pin the platforms even where a site configuration set others
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest

from popsift_tpu.eval.golden import synthetic_image  # noqa: F401 (re-export)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_image():
    return synthetic_image(64, 80, seed=3)


@pytest.fixture(scope="session")
def medium_image():
    return synthetic_image(120, 160, seed=7)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU — decided when the test runs, never
    at import. On the card: ``JAX_PLATFORMS=cuda,cpu python -m pytest
    -m gpu tests/``."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled kernel; no interpret "
                    "mode); chip_smoke.py runs the same check on the card")
