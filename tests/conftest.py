"""Test configuration: run JAX on 8 virtual CPU devices.

Multi-device sharding is validated on a host-platform device mesh; the
GPU runs are made by ``chip_smoke.py``.  The platform is set through
jax.config as well as the environment, so an earlier import of jax cannot
leave another backend in place.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, REPO)
