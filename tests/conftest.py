"""Test configuration: JAX on the CPU with 8 virtual devices, so the
multi-device sharding paths run without accelerators (SURVEY.md §4
"multi-node without a cluster"). A JAX_PLATFORMS already set wins, which is
how the `gpu`-marked tests run on the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_cuda_ntt.py
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent XLA compile cache: the slow tier is dominated by CPU-JAX
# compiles of reference-scale executables (utils/compcache.py).
from abc_tpu.utils.compcache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()
