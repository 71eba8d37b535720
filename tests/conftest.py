"""Shared fixtures.

The test process forces 4 virtual host devices (set BEFORE the first jax
import — jax locks the device count at first initialization) so the sharded
serving identity matrix (tests/test_mesh_serve.py) can build 1x2 / 2x1 /
2x2 ``(data, model)`` meshes on CPU CI. Single-device tests are unaffected:
uncommitted arrays and unsharded jits still resolve to device 0, so every
pre-mesh test sees exactly the old semantics. The production 512-device
dry-run still runs via subprocess with its own XLA_FLAGS
(launch/dryrun.py)."""
import os

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               ).strip()

import jax
import jax.numpy as jnp
import pytest


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow (the exhaustive "
                          "serving identity matrices)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: exhaustive/expensive test, skipped unless "
        "--runslow (tier-1 stays fast; representatives still run)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's Hopper kernels); "
        "skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def f32_opts():
    from repro.models import ModelOptions
    return ModelOptions(attn_impl="ref", scan_impl="ref", dtype=jnp.float32)
