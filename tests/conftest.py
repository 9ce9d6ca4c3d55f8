"""Test harness: hermetic CPU backend with 8 virtual devices.

Tests need no accelerator: the sharding tests simulate an 8-device mesh on
CPU (SURVEY.md §4: `XLA_FLAGS=--xla_force_host_platform_device_count`), and
everything else is resolution-independent math that behaves identically
across backends.  What only the GPU can show is checked on the card by
`python chip_smoke.py`.

The platform is chosen through jax.config, which takes effect as long as no
backend has been *initialized* yet, whatever JAX_PLATFORMS said.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the repo's
# .jax_cache/): XLA-CPU compiles of the wavefront depth loop take 20-30 s
# each and dominate suite wall time; cached reruns take a few minutes.
from spt_tpu.utils.cache import enable_default_cache  # noqa: E402

enable_default_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
