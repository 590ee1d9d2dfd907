"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding tests use the standard fake-cluster trick
(xla_force_host_platform_device_count) so pjit/shard_map paths are exercised
without several cards; single-device numerics run on CPU device 0.  The
platform is pinned through jax.config as well as JAX_PLATFORMS so the suite
stays on the CPU whatever the environment says.

Marker ``slow``: long tests, deselected by ``-m 'not slow'``.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
