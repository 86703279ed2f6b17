"""Test config: run all tests on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere: the tests run on the
CPU (chip_smoke.py exercises the GPU); multi-chip sharding is validated
on xla_force_host_platform_device_count=8 CPU devices.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# keep CPU test executables out of the persistent compile cache (CPU AOT
# entries are specific to the host's -march features)
os.environ["CANU_TPU_NO_COMPILE_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

assert jax.devices()[0].platform == "cpu", jax.devices()

# Make the repo root importable regardless of pytest rootdir config.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
