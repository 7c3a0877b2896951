"""The Hopper NTT kernel (abc_tpu/_native_src/ntt_cuda.cu) as JAX operations.

The CUDA source is compiled with nvcc for sm_90a at first use, into
build/cuda/ beside the package, under a name that hashes the source and the
build command, and is registered as two XLA FFI targets. `fwd`/`inv` take
the same tables as crypto.ntt._fwd_stages/_inv_stages and return identical
bits. The kernel folds any leading batch dimensions of [..., L, n] into rows;
under jax.vmap the tables stay unbatched (vmap_method="expand_dims"), and
inside shard_map the call sees each device's local limbs.

A CUDA kernel has no interpret mode: on the CPU the plain stage loop is the
transform, and tests/test_cuda_ntt.py checks this module's Python side and
the kernel's index schedule against it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "_native_src", "ntt_cuda.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")

# log2 of the elements one thread block holds in shared memory: a transform
# with n <= 2^log_block is one block per row, a larger one splits into a
# column pass and a row pass. 0 lets the kernel pick it from the call's full
# size, batch included, which the wrapper cannot see under vmap (see the .cu
# header); tests and scripts/ntt_kernel_ab.py pass explicit values.
LOG_BLOCK = 0

_TARGETS = (("abc_ntt_fwd", "AbcNttFwd"), ("abc_ntt_inv", "AbcNttInv"))
_LIB = None


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_command(out: str) -> list:
    import jax.ffi
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", out, SRC]


def library_path() -> str:
    with open(SRC, "rb") as f:
        key = f.read() + " ".join(build_command("")).encode()
    return os.path.join(BUILD_DIR,
                        f"libabc_ntt_{hashlib.sha256(key).hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library unless this source was built already;
    returns its path. Raises RuntimeError when nvcc is missing or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(build_command(tmp), capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"CUDA NTT build needs nvcc: {exc}") from exc
    if r.returncode != 0:
        raise RuntimeError("CUDA NTT build failed:\n" + r.stderr[-4000:])
    os.replace(tmp, so)
    return so


def load() -> None:
    """Build (if needed), load and register the FFI targets, once."""
    global _LIB
    if _LIB is not None:
        return
    import jax
    lib = ctypes.cdll.LoadLibrary(build())
    for name, symbol in _TARGETS:
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(getattr(lib, symbol)),
                                    platform="CUDA")
    _LIB = lib


def _call(target: str, a, tables, log_block: int):
    import jax
    import jax.numpy as jnp
    a = jnp.asarray(a).astype(jnp.uint32)
    return jax.ffi.ffi_call(
        target, jax.ShapeDtypeStruct(a.shape, jnp.uint32),
        vmap_method="expand_dims")(a, *tables, log_block=np.int64(log_block))


def fwd(a, tw, twsh, q, log_block: int = LOG_BLOCK):
    """Forward negacyclic NTT of [..., L, n] (natural → bit-reversed)."""
    return _call("abc_ntt_fwd", a, (tw, twsh, q), log_block)


def inv(a, tw, twsh, q, n_inv, n_inv_sh, log_block: int = LOG_BLOCK):
    """Inverse of fwd, n^-1 folded in."""
    return _call("abc_ntt_inv", a, (tw, twsh, q, n_inv, n_inv_sh), log_block)
