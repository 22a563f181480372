"""Test harness config: run all tests on a virtual 8-device CPU mesh.

The GPU is exercised by chip_smoke.py; tests must be deterministic and
fast anywhere, so we force the CPU backend with 8 virtual devices for
sharding tests (SURVEY.md §4's "implication for the rebuild"). The
platform is set through jax.config as well as the environment, so it
holds even if jax was imported before this file.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
