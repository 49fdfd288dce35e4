"""Test configuration: run on a virtual 8-device CPU mesh by default.

XLA's host platform is forced to expose 8 CPU devices so Mesh/shard_map
paths are exercised without several accelerators (the reference has no
test suite at all — SURVEY.md §4). Must run before jax initialises, hence
the env mutation at import time. ``JAX_PLATFORMS`` set by the caller wins,
so the ``gpu``-marked tests can run on a card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU. Decided here, when the test runs,
    so every test worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/` on the card")
