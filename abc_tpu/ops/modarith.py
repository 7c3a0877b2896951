"""Vectorized modular arithmetic over RNS limbs.

This is the foundation of the crypto engine (the SEAL replacement,
SURVEY.md §7): every polynomial is a uint32 array of shape [L, n]
(L RNS limbs of < 31-bit primes), and every op here is elementwise over it.

Two interchangeable engines:
  * `np64` — NumPy uint64 reference: trivially correct, used as the oracle
    and for host-side precomputation.
  * `jx32` — JAX uint32, jit-able on the device: the 64-bit products
    required by modular reduction are built from 16-bit limb splits in plain
    jnp (SURVEY.md §7 "hard parts" #1). General products use Barrett
    reduction; fixed-operand products (twiddle factors) use Shoup's trick
    with a precomputed companion word.

All jx32 routines require q < 2^30 so lazy sums stay below 2^32.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# NumPy uint64 reference engine
# ---------------------------------------------------------------------------

class np64:
    """Reference engine: correctness-first, uint64 NumPy."""

    @staticmethod
    def add(a, b, q):
        r = a.astype(np.uint64) + b.astype(np.uint64)
        return np.where(r >= q, r - q, r).astype(np.uint32)

    @staticmethod
    def sub(a, b, q):
        a = a.astype(np.uint64)
        b = b.astype(np.uint64)
        return np.where(a >= b, a - b, a + q - b).astype(np.uint32)

    @staticmethod
    def neg(a, q):
        a = a.astype(np.uint64)
        return np.where(a == 0, 0, q - a).astype(np.uint32)

    @staticmethod
    def mul(a, b, q, mu=None):
        """a·b mod q. With a valid Barrett mu (= floor(2^60/q), nonzero for
        all 30-bit data primes) this is division-free — u64 hardware modulo
        dominated the np64 interpreter profile (~44 ms per BEHZ contraction
        at n=8192) before this."""
        mu_arr = None if mu is None else np.asarray(mu, dtype=np.uint64)
        if (mu_arr is not None and max(a.size, b.size) >= (1 << 16)
                and np.asarray(q).ndim >= 1 and np.asarray(q).shape[-1] == 1):
            try:  # threaded C++ path (native/modpoly.cpp mul_mod_rows)
                from abc_tpu.ops import native
                if native.available():
                    return native.mul_mod_rows(a, b, np.asarray(q), mu_arr)
            except Exception:
                pass
        v = a.astype(np.uint64) * b.astype(np.uint64)          # < 2^60
        if mu_arr is None or not mu_arr.all():
            return (v % q).astype(np.uint32)
        q64 = np.asarray(q, dtype=np.uint64)
        t = v >> np.uint64(30)                                  # < 2^30
        z = (t * mu_arr) >> np.uint64(30)   # floor(v/q)-3 ≤ z ≤ floor(v/q)
        r = v - z * q64                                         # < 4q < 2^32
        for _ in range(3):
            r = np.where(r >= q64, r - q64, r)
        return r.astype(np.uint32)

    @staticmethod
    def mul_shoup(a, w, w_shoup, q):
        """Fixed-operand Shoup multiply, division-free: r = a·w − hi·q with
        hi = floor(a·w_shoup/2^32); true r < 2q so one subtract corrects."""
        a64 = a.astype(np.uint64)
        w64 = np.asarray(w, dtype=np.uint64)
        wsh = np.asarray(w_shoup, dtype=np.uint64)
        q64 = np.asarray(q, dtype=np.uint64)
        hi = (a64 * wsh) >> np.uint64(32)
        mask = np.uint64(0xFFFFFFFF)
        r = (a64 * w64 - hi * q64) & mask                       # < 2q
        return np.where(r >= q64, r - q64, r).astype(np.uint32)


# ---------------------------------------------------------------------------
# JAX uint32 engine
# ---------------------------------------------------------------------------

def _jnp():
    import jax.numpy as jnp
    return jnp


class jx32:
    """Device engine: uint32 lanes, 16-bit-split wide multiplies."""

    @staticmethod
    def umulhi(a, b):
        """Exact high 32 bits of a 32×32→64 product, built from 16-bit halves.

        All intermediate sums provably fit in uint32 for arbitrary uint32
        inputs: a1*b0 + (a0*b0>>16) ≤ 2^32-2^17+2^16 < 2^32, etc.
        """
        jnp = _jnp()
        a = a.astype(jnp.uint32)
        b = b.astype(jnp.uint32)
        mask = jnp.uint32(0xFFFF)
        a0, a1 = a & mask, a >> 16
        b0, b1 = b & mask, b >> 16
        t = a1 * b0 + ((a0 * b0) >> 16)
        t2 = a0 * b1 + (t & mask)
        return a1 * b1 + (t >> 16) + (t2 >> 16)

    @staticmethod
    def add(a, b, q):
        jnp = _jnp()
        r = a + b  # < 2^31, no wrap
        return jnp.where(r >= q, r - q, r)

    @staticmethod
    def sub(a, b, q):
        jnp = _jnp()
        return jnp.where(a >= b, a - b, a + q - b)

    @staticmethod
    def neg(a, q):
        jnp = _jnp()
        return jnp.where(a == 0, jnp.uint32(0), q - a)

    @staticmethod
    def mul(a, b, q, mu):
        """Barrett: r = a·b mod q for a,b < q < 2^30, mu = floor(2^60/q) < 2^32.

        v = a·b < 2^60; t = floor(v/2^30) < 2^30; z = floor(t·mu/2^30)
        satisfies floor(v/q) - 3 ≤ z ≤ floor(v/q), so the remainder fits in
        32 bits (< 4q < 2^32) and at most three conditional subtractions
        correct it.
        """
        jnp = _jnp()
        hi = jx32.umulhi(a, b)
        lo = a * b
        t = (hi << 2) | (lo >> 30)
        # z = floor(t*mu / 2^30) from the 64-bit product (hi2, lo2) of t·mu
        hi2 = jx32.umulhi(t, mu)
        lo2 = t * mu
        z = (hi2 << 2) | (lo2 >> 30)
        r = lo - z * q  # low 32 bits suffice: true remainder < 4q < 2^32
        r = jnp.where(r >= q, r - q, r)
        r = jnp.where(r >= q, r - q, r)
        r = jnp.where(r >= q, r - q, r)
        return r

    @staticmethod
    def mul_shoup(a, w, w_shoup, q):
        """Shoup: r = a·w mod q for fixed w with companion
        w_shoup = floor(w·2^32/q). Result in [0, q)."""
        jnp = _jnp()
        hi = jx32.umulhi(a, w_shoup)
        r = a * w - hi * q  # mod 2^32; true value in [0, 2q)
        return jnp.where(r >= q, r - q, r)


# ---------------------------------------------------------------------------
# host-side constant helpers
# ---------------------------------------------------------------------------

def barrett_mu(q: int) -> int:
    """mu = floor(2^60 / q) for the jx32 Barrett path.

    Valid (fits uint32) only for q in [2^29, 2^30) — the prime range all
    parameter presets use. For smaller moduli (e.g. the 20-bit plain modulus,
    np64-only) returns 0 as a placeholder; jx32 contexts assert the range.
    """
    if q < (1 << 29):
        return 0
    assert q < (1 << 30), "jx32 engine requires primes below 2^30"
    return (1 << 60) // q


def shoup(w: int, q: int) -> int:
    """Companion word floor(w·2^32/q) for Shoup multiplication."""
    return (w << 32) // q


def get_engine(name: str):
    return {"np64": np64, "jx32": jx32}[name]


def default_engine() -> str:
    """The engine a factory uses when none is named: jx32 on an
    accelerator, np64 (host NumPy and the C++ engine) on the CPU."""
    import jax
    return "np64" if jax.default_backend() == "cpu" else "jx32"
