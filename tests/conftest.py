"""Test configuration: run everything on CPU with 8 virtual devices.

Multi-device sharding paths (jax.sharding.Mesh + shard_map) are validated on
a virtual 8-device CPU mesh, so the suite needs no accelerator.  The flags
must be set before JAX initializes its backends.  Tests marked ``gpu`` skip
here; ``python chip_smoke.py`` runs the same checks on a CUDA GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
# Oracle tests compare against float64 numpy references; x64 stays available
# while library code remains explicitly float32 on its hot paths.
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Skip tests marked ``gpu`` unless JAX's default backend is a CUDA GPU
    (never true under this conftest's CPU pinning; the marker keeps them
    runnable unchanged wherever the suite is pointed at a GPU)."""
    if jax.default_backend() == "gpu":
        return
    skip = pytest.mark.skip(
        reason="needs a CUDA GPU; `python chip_smoke.py` runs this check on the card"
    )
    for item in items:
        if "gpu" in item.keywords:
            item.add_marker(skip)
