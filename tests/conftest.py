"""Test configuration: run everything on CPU with 8 virtual devices.

This is the "fake backend" trick the reference never had (its gtest suite
required a physical CUDA GPU): multi-device sharding tests execute on a
virtual 8-device CPU mesh via XLA's host-platform device-count flag. The
platform is set through the config API so the tests stay on the CPU even
where a GPU is visible.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_max_isa" not in flags:
    # this host class reports AMX/AVX512 features whose XLA:CPU codegen
    # intermittently SIGSEGVs under suite-level load (cpu_aot_loader logs a
    # machine-feature mismatch first); capping the ISA avoids those paths
    flags = (flags + " --xla_cpu_max_isa=AVX2").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# no persistent compile cache on the CPU backend (utils/jaxcache.py), even
# when the environment names a JAX_COMPILATION_CACHE_DIR
jax.config.update("jax_enable_compilation_cache", False)
