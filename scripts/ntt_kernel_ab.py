"""Time the CUDA NTT kernel against the XLA stage loop on one GPU.

    python scripts/ntt_kernel_ab.py [--out chiprun_out/ntt_ab.json]

1. Transform alone: forward and inverse at n in {8192, 16384, 32768} over
   each preset's full limb chain, B in {1, 8, 64}, for the kernel at several
   block sizes (log_block; >= log2 n is one block per row) and for
   fwd_xla/inv_xla. Each time is the median of 3 two-point estimates over a
   dependent fori_loop chain, per = (t(c) - t(c/2)) / (c/2).
2. End to end, with every hot-path transform switched between the kernel and
   the stage loop: the n=8192 BFV mult+relin chain at B=1 and B=8, and
   config6's t_computation (benchsuite.laplace_e2e), in the order kernel,
   xla, xla, kernel.

Prints one line per measurement and writes everything to --out.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _two_point(f, x, chain: int, reps: int = 3) -> float:
    """Seconds per application of f, from a dependent chain."""
    import jax
    import jax.numpy as jnp

    run = jax.jit(lambda v, c: jax.lax.fori_loop(0, c, lambda i, u: f(u), v))

    def t(c):
        c = jnp.int32(c)
        jax.block_until_ready(run(x, c))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(x, c))
            best = min(best, time.perf_counter() - t0)
        return best

    ests = sorted((t(chain) - t(chain // 2)) / (chain // 2)
                  for _ in range(reps))
    return ests[len(ests) // 2]


def transform_sweep(sizes, batches, blocks) -> list:
    import jax.numpy as jnp
    from abc_tpu.crypto.ntt import NttContext
    from abc_tpu.crypto.params import BfvParams
    from abc_tpu.ops import cuda_ntt

    rows = []
    rng = np.random.default_rng(0)
    for n in sizes:
        moduli = list(BfvParams.create(n).coeff_modulus)
        ctx = NttContext(n, moduli, engine="jx32")
        L = len(moduli)
        for B in batches:
            x = jnp.asarray(rng.integers(0, min(moduli), size=(B, L, n),
                                         dtype=np.uint64).astype(np.uint32))
            chain = max(8, 2048 // B)
            variants = {"xla": (ctx.fwd_xla, ctx.inv_xla)}
            for lb in blocks:
                variants[f"kernel_lb{lb}"] = (
                    functools.partial(cuda_ntt.fwd, tw=ctx.fwd_tw,
                                      twsh=ctx.fwd_tw_sh, q=ctx.q,
                                      log_block=lb),
                    functools.partial(cuda_ntt.inv, tw=ctx.inv_tw,
                                      twsh=ctx.inv_tw_sh, q=ctx.q,
                                      n_inv=ctx.n_inv,
                                      n_inv_sh=ctx.n_inv_sh, log_block=lb))
            for name, (f, i) in variants.items():
                row = {"n": n, "L": L, "B": B, "variant": name,
                       "fwd_us": _two_point(f, x, chain) * 1e6,
                       "inv_us": _two_point(i, x, chain) * 1e6}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def _use(variant: str):
    """Route every hot-path transform to the kernel or the stage loop."""
    from abc_tpu.crypto import ntt
    from abc_tpu.ops import cuda_ntt
    if not hasattr(cuda_ntt, "_kernel_fwd"):
        cuda_ntt._kernel_fwd, cuda_ntt._kernel_inv = cuda_ntt.fwd, cuda_ntt.inv
    if variant == "xla":
        cuda_ntt.fwd = lambda a, tw, twsh, q, **_: ntt._jx_fwd(a, tw, twsh, q)
        cuda_ntt.inv = lambda a, tw, twsh, q, ni, nish, **_: ntt._jx_inv(
            a, tw, twsh, q, ni, nish)
    else:
        cuda_ntt.fwd, cuda_ntt.inv = cuda_ntt._kernel_fwd, cuda_ntt._kernel_inv


def end_to_end() -> list:
    import jax
    import jax.numpy as jnp
    from abc_tpu.benchsuite import laplace_e2e
    from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu.crypto.params import BfvParams

    rows = []
    ctx = BfvContext(BfvParams.create(8192, engine="jx32", seed=123))
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    a = jnp.asarray(ctx.encrypt(ctx.encode([1, 2, 3, 4])).data)
    b = jnp.asarray(ctx.encrypt(ctx.encode([5, 6, 7, 8])).data)
    for variant in ("kernel", "xla", "xla", "kernel"):
        _use(variant)
        for B in (1, 8):
            if B == 1:
                f = lambda v: ctx.multiply(BfvCiphertext(v),
                                           BfvCiphertext(b)).data
                x = a
            else:
                bB = jnp.broadcast_to(b[None], (B,) + b.shape)
                f = jax.vmap(lambda v, w: ctx.multiply(
                    BfvCiphertext(v), BfvCiphertext(w)).data)
                f = functools.partial(lambda g, v: g(v, bB), f)
                x = jnp.broadcast_to(a[None], (B,) + a.shape)
            per = _two_point(f, x, max(16, 256 // B))
            row = {"workload": "bfv_n8192_mult_relin", "B": B,
                   "variant": variant, "ops_per_s": B / per}
            rows.append(row)
            print(json.dumps(row), flush=True)
        csv, extra, _ = laplace_e2e()
        row = {"workload": "config6_laplace_n16384", "variant": variant,
               "t_computation_ms": csv["t_computation"],
               "xla_compile_ms": extra["xla_compile_ms"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    _use("kernel")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/ntt_ab.json")
    ap.add_argument("--blocks", default="10,11,12,16",
                    help="kernel log_block values to sweep")
    args = ap.parse_args()

    import jax
    from abc_tpu.ops import cuda_ntt
    from abc_tpu.utils.compcache import enable_persistent_cache

    enable_persistent_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit("ntt_kernel_ab.py needs a GPU")
    cuda_ntt.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card, flush=True)
    record = {"card": card, "device_kind": jax.devices()[0].device_kind,
              "default_log_block": cuda_ntt.LOG_BLOCK}
    record["transform"] = transform_sweep(
        (8192, 16384, 32768), (1, 8, 64),
        [int(b) for b in args.blocks.split(",")])
    record["end_to_end"] = end_to_end()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
