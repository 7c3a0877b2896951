"""Persistent XLA compilation cache.

The reference pays no compile cost (SEAL is ahead-of-time C++); our
whole-program JIT path (runtime/jit_executor.py) can spend minutes in XLA
for reference-scale programs. JAX's persistent compilation cache makes that
a once-per-checkout cost instead of once-per-process: the CLI, the bench
harness, the benchsuite and the tests call enable_persistent_cache() before
touching the device.

Location: where JAX_COMPILATION_CACHE_DIR points (JAX reads it itself, and
nothing is set here), else the fixed directory .jax_cache/ beside the
abc_tpu package. The path is part of the cache key, so it never moves.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_ENABLED = False


def enable_persistent_cache() -> str:
    """Idempotently turn on JAX's persistent compilation cache; returns the
    directory in use. Call before the first compile."""
    global _ENABLED
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if _ENABLED:
        return DEFAULT_DIR
    import jax
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    # JAX's own floor (jax_persistent_cache_min_compile_time_secs, 1 s)
    # keeps the thousands of trivial test executables out of the cache
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    _ENABLED = True
    return DEFAULT_DIR
