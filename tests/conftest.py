"""Test configuration: run everything on a virtual multi-device CPU mesh.

Multi-device code paths are exercised without hardware by forcing the CPU
backend with 8 virtual devices.  Tests that need a GPU carry the ``gpu``
marker and take the ``gpu_device`` fixture, which skips them here.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("E3_COMPUTE_DTYPE", "float32")

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the process has none (decided when the
    test runs, never at import or collection)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return gpus[0]
