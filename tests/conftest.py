"""Test configuration: an 8-device virtual CPU platform by default.

Unit tests run on a virtual 8-device CPU mesh (the multi-device paths are
exercised there), so XLA_FLAGS is set before the CPU client exists. A run
that sets JAX_PLATFORMS itself keeps it: the tests marked `gpu` run on a
card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu \
        tests/test_kmer.py tests/test_extract_native.py
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX sees none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu -m gpu")
    return devs[0]
