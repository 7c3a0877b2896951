"""Hybrid key-switch A/B for mult+relin at n=8192 (round 5).

The mult+relin speed-of-light census (bench.py) prices the relin
decompose at L·(L+1) = 42 of 154 NTT rows (27%) under ks_digits=1.
Hybrid digits (k=2: α=3 digit rows over L+2 columns) cut the decompose to
3·8 = 24 rows at the price of one extra special prime in every other row
(L+2 vs L+1 columns) and a second mod-switch division. This script
measures both variants on the real chip with the standard protocol
(median of K_EST alternating two-point chain estimates).

Note: k=2 at n=8192 uses 8 30-bit moduli = 240 bits > the 218-bit
HE-standard budget (dev-grade measurement of the KERNEL-shape question;
a production k=2 chain would drop one data limb).

    python scripts/hybrid_ks_ab.py          # the default device
    python scripts/hybrid_ks_ab.py cpu      # CPU sanity
"""

import sys
import time
import warnings

import numpy as np

import jax
import jax.numpy as jnp

if len(sys.argv) > 1 and sys.argv[1] == "cpu":
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from abc_tpu.utils.compcache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext  # noqa: E402
from abc_tpu.crypto.params import BfvParams  # noqa: E402

N = 8192
CHAIN = 256 if len(sys.argv) <= 1 or sys.argv[1] != "cpu" else 4
REPEATS = 3
K_EST = 5


def make_step(ctx):
    def step(x, y):
        return ctx.multiply(BfvCiphertext(x), BfvCiphertext(y)).data
    return step


def make_chain(step, c):
    @jax.jit
    def chained(x, y):
        return jax.lax.fori_loop(0, c, lambda i, v: step(v, y), x)
    return chained


def timed(f, *args):
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    variants = {}
    for k in (1, 2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # k=2 over-budget (doc'd)
            ctx = BfvContext(BfvParams.create(N, engine="jx32", seed=123,
                                              ks_digits=k))
        ctx.ensure_eval_ready()
        ctx.get_relin_key()
        a = ctx.encrypt(ctx.encode([1, 2, 3, 4]))
        b = ctx.encrypt(ctx.encode([5, 6, 7, 8]))
        out = ctx.multiply(a, b)
        assert ctx.decode(ctx.decrypt(out))[:4] == [5, 12, 21, 32], \
            f"k={k} correctness"
        step = make_step(ctx)
        variants[k] = {
            "fns": {c: make_chain(step, c) for c in (CHAIN, CHAIN // 2)},
            "args": (jnp.asarray(np.asarray(a.data)),
                     jnp.asarray(np.asarray(b.data))),
        }
    est = {1: [], 2: []}
    for _ in range(K_EST):
        for k in (1, 2):
            v = variants[k]
            tf = timed(v["fns"][CHAIN], *v["args"])
            th = timed(v["fns"][CHAIN // 2], *v["args"])
            est[k].append((tf - th) / (CHAIN // 2))
    for k in (1, 2):
        e = sorted(est[k])
        med = e[len(e) // 2]
        print(f"ks_digits={k}: {1.0 / med:.1f} ops/s "
              f"[{1.0 / e[-1]:.1f}-{1.0 / e[0]:.1f}]")
    ratio = sorted(est[1])[K_EST // 2] / sorted(est[2])[K_EST // 2]
    print(f"hybrid_k2_speedup_over_k1: {ratio:.3f}x on "
          f"{jax.default_backend()}")


if __name__ == "__main__":
    main()
