"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on the CPU backend with
``xla_force_host_platform_device_count`` standing in for several cards.
Tests that need a GPU carry the ``gpu`` marker and skip here; the GPU runs
are ``chip_smoke.py`` and ``bench.py``.
"""

import os

# XLA_FLAGS must be in the environment before the CPU backend initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Select the CPU backend through the config API as well as JAX_PLATFORMS, so
# the tests never take a GPU's memory from a process measuring on it.
jax.config.update("jax_platforms", "cpu")

# f64 on the CPU backend lets tests compare Jacobians against finite
# differences tightly; library code is dtype-polymorphic and runs f32 on
# the GPU.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
