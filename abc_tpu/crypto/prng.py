"""Counter-based PRNG (Threefry-2x32) for key/encryption randomness.

Why a custom PRNG: the uniform components of keys and encryptions (the `a`
polynomial of every RLWE sample) are the BULK of key material — [α, L+k, n]
uint32 per switching key, ~23 MB at n=16384. Generating them from a
(seed, stream) pair with a counter-based generator means:

  * the jx32 engine can generate them ON DEVICE inside a jitted keygen —
    no host→device transfer of key-sized arrays;
  * the np64 engine computes the SAME arrays on the host, preserving the
    np64↔jx32 bit-exactness contract (tests/test_prng.py,
    test_bfv.py::test_jx32_engine_bit_exact_full_pipeline);
  * keys become "seeded": a key is reproducible from (context seed, key id)
    — the same trick SEAL uses for Serializable<PublicKey> (half-size
    serialized keys, the `a` part is a PRNG seed).

Threefry-2x32 is the 20-round counter-based cipher of Salmon et al.
(SC'11), the same core JAX's own PRNG uses. Each counter produces 64
bits; a uniform residue mod q is the 64-bit draw reduced mod q (bias
2^-34 — negligible; SEAL's rejection sampling is not expressible in a
fixed-shape jit).

Streams are identified by strings ("pk", "relin/d0", "galois_3/d2",
"enc/17") compressed into the key words via SHA-256 + one Threefry block —
draw-order independent, so np64 and jx32 contexts agree even if they
materialize keys in different orders.

Seed domains: a context's master seed is split into a PUBLIC domain seed
(uniform `a` streams — the part a SEAL-style Serializable<PublicKey>
serializer may publish to halve key sizes) and a SECRET domain seed
(ternary secrets, Gaussian errors) via `split_domain`. Publishing the
public seed therefore reveals nothing about the error/secret streams:
recovering the master from a domain seed is a Threefry key-recovery.

SECURITY LIMITATION (documented, accepted for a benchmarking framework):
the Gaussian error and ternary secret draws go through numpy's PCG64
(`seeded_rng`), which is not a CSPRNG, and auto-generated master seeds
carry 63 bits of OS entropy. The bit-exactness contract (np64 == jx32 ==
CUDA kernel == C++, tests/test_prng.py, test_bfv.py) is about reproducibility,
not cryptographic hardening; production use would swap `seeded_rng` for a
counter-PRF Gaussian sampler and 256-bit seeds.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def derive_key(seed: int, stream: str) -> Tuple[int, int]:
    """(k0, k1) words for a (seed, stream) pair.

    The stream LABEL is hashed with SHA-256 and 128 bits of it are
    compressed into the 64-bit working key through one Threefry block
    keyed by the seed (two hash words as the counter, two XORed into the
    output). Label separation therefore rests on 128 bits of SHA-256, not
    on a 32-bit crc (labels are data-dependent — e.g. "galois_<g>/d<i>"
    per rotation key — and a silent label collision would reuse the same
    uniform `a` across two RLWE samples, leaking key material)."""
    h0, h1, h2, h3 = struct.unpack(
        "<4I", hashlib.sha256(stream.encode()).digest()[:16])
    x0, x1 = threefry2x32(np, seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                          np.uint32(h0).reshape(()), np.uint32(h1).reshape(()))
    return int(x0) ^ h2, int(x1) ^ h3


def split_domain(master_seed: int, domain: str) -> int:
    """63-bit sub-seed for a named domain of a master seed.

    Used to separate the PUBLIC randomness domain (uniform `a` streams,
    publishable for SEAL-style seeded-key compression) from the SECRET
    domain (ternary secrets, Gaussian errors): both are Threefry outputs
    of the master, so one domain seed does not reveal the other (or the
    master) without a Threefry key recovery."""
    hi, lo = random_bits_np(master_seed, f"seed-domain/{domain}", ())
    return ((int(hi) << 32) | int(lo)) & 0x7FFFFFFFFFFFFFFF


def _rotl(xp, x, r: int):
    return (x << xp.uint32(r)) | (x >> xp.uint32(32 - r))


def threefry2x32(xp, k0, k1, c0, c1):
    """One Threefry-2x32 block per counter element: (c0, c1) → (y0, y1).

    xp is numpy or jax.numpy; c0/c1 are uint32 arrays of equal shape.
    k0/k1 may be Python ints OR uint32 arrays broadcastable against the
    counters (the jitted key-generation paths pass one key word pair per
    digit row). Matches the reference cipher round-for-round (5 groups of
    4 rounds, key injection after each group)."""
    import contextlib
    if isinstance(k0, (int, np.integer)):
        k0 = xp.uint32(k0)
    else:
        k0 = k0.astype(xp.uint32)
    if isinstance(k1, (int, np.integer)):
        k1 = xp.uint32(k1)
    else:
        k1 = k1.astype(xp.uint32)
    # uint32 wraparound is the cipher's modular arithmetic — silence
    # numpy's scalar-overflow RuntimeWarning (jnp never warns)
    guard = np.errstate(over="ignore") if xp is np \
        else contextlib.nullcontext()
    with guard:
        ks = (k0, k1, k0 ^ k1 ^ xp.uint32(_PARITY))
        x0 = c0.astype(xp.uint32) + ks[0]
        x1 = c1.astype(xp.uint32) + ks[1]
        for g in range(5):
            for r in _ROTATIONS[g % 2]:
                x0 = x0 + x1
                x1 = _rotl(xp, x1, r)
                x1 = x1 ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + xp.uint32(g + 1)
    return x0, x1


def random_bits_np(seed: int, stream: str, shape: Tuple[int, ...]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Two uint32 planes of the given shape (the hi/lo words of a 64-bit
    draw per element), NumPy host path."""
    k0, k1 = derive_key(seed, stream)
    total = int(np.prod(shape)) if shape else 1
    ctr = np.arange(total, dtype=np.uint32)
    hi, lo = threefry2x32(np, k0, k1, ctr, np.zeros_like(ctr))
    return hi.reshape(shape), lo.reshape(shape)


def uniform_rns_np(seed: int, stream: str, moduli: Sequence[int],
                   n: int) -> np.ndarray:
    """[L, n] uint32 with row l uniform mod moduli[l] (64-bit draw reduced;
    independent uniform residues are uniform over Z_q by CRT)."""
    L = len(moduli)
    hi, lo = random_bits_np(seed, stream, (L, n))
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    q = np.asarray(moduli, dtype=np.uint64).reshape(L, 1)
    return (v % q).astype(np.uint32)


def uniform_rns_jx_keys(k0, k1, moduli: Sequence[int], n: int):
    """jx32 uniform RNS polynomials from key WORDS — BIT-IDENTICAL to the
    per-stream uniform_rns_np calls, u32-only math, safe inside jit
    (shapes/moduli static, keys may be tracers).

    k0/k1: scalars → returns [L, n]; arrays of shape [α] → returns
    [α, L, n] where row j uses key pair (k0[j], k1[j]) — one jitted call
    builds every digit of a switching key.

    The 64-bit value hi·2^32+lo is reduced mod q via its base-2^16 digits
    w3..w0 folded with the precomputed 2^16-power residues (all Barrett
    operands < q)."""
    import jax.numpy as jnp
    from abc_tpu.ops.modarith import barrett_mu, jx32

    L = len(moduli)
    if any(barrett_mu(m) == 0 for m in moduli):
        raise ValueError(f"uniform_rns_jx requires moduli in [2^29, 2^30) "
                         f"(jx32 Barrett range); got {moduli}")
    ctr = jnp.arange(L * n, dtype=jnp.uint32).reshape(L, n)
    batched = not isinstance(k0, (int, np.integer)) and \
        getattr(k0, "ndim", 0) >= 1
    if batched:
        k0 = k0.reshape(k0.shape + (1, 1))
        k1 = k1.reshape(k1.shape + (1, 1))
        ctr = jnp.broadcast_to(ctr, k0.shape[:-2] + (L, n))
    hi, lo = threefry2x32(jnp, k0, k1, ctr, jnp.zeros_like(ctr))
    q = jnp.asarray([[m] for m in moduli], dtype=jnp.uint32)
    mu = jnp.asarray([[barrett_mu(m)] for m in moduli], dtype=jnp.uint32)
    # per-limb residues of 2^16, 2^32, 2^48 (host ints, tiny tables)
    p16 = jnp.asarray([[(1 << 16) % m] for m in moduli], dtype=jnp.uint32)
    p32 = jnp.asarray([[(1 << 32) % m] for m in moduli], dtype=jnp.uint32)
    p48 = jnp.asarray([[(1 << 48) % m] for m in moduli], dtype=jnp.uint32)
    mask = jnp.uint32(0xFFFF)
    w0, w1 = lo & mask, lo >> 16
    w2, w3 = hi & mask, hi >> 16
    # digits < 2^16 < q (30-bit primes): direct Barrett mults are in-range
    acc = jx32.mul(w3, p48, q, mu)
    acc = jx32.add(acc, jx32.mul(w2, p32, q, mu), q)
    acc = jx32.add(acc, jx32.mul(w1, p16, q, mu), q)
    return jx32.add(acc, w0, q)


def uniform_rns_jx(seed: int, stream: str, moduli: Sequence[int], n: int):
    """(seed, stream)-keyed convenience wrapper over uniform_rns_jx_keys."""
    k0, k1 = derive_key(seed, stream)
    return uniform_rns_jx_keys(k0, k1, moduli, n)


def seeded_rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy Generator for the SMALL host-side draws (ternary secrets,
    Gaussian errors) keyed by the same (seed, stream) space."""
    k0, k1 = derive_key(seed, stream)
    return np.random.default_rng((k0 << 32) | k1)
