"""NTT + modular-arithmetic kernel tests: bit-exactness of the jx32 (device
uint32) engine against the np64 reference, round trips, and the evaluation
-order convention that the batch encoder relies on."""

import numpy as np
import pytest

from abc_tpu.crypto.ntt import NttContext, bit_reverse, negacyclic_mul_naive
from abc_tpu.crypto.numthy import (
    crt_compose, find_minimal_2nth_root, gen_ntt_primes, is_prime, modinv,
)
from abc_tpu.ops.modarith import barrett_mu, get_engine, shoup


# --- number theory ------------------------------------------------------------

def test_gen_ntt_primes():
    n = 1024
    primes = gen_ntt_primes(30, 3, n)
    assert len(set(primes)) == 3
    for q in primes:
        assert is_prime(q) and q % (2 * n) == 1 and q < 2 ** 30


def test_2nth_root():
    n = 64
    q = gen_ntt_primes(30, 1, n)[0]
    psi = find_minimal_2nth_root(n, q)
    assert pow(psi, 2 * n, q) == 1
    assert pow(psi, n, q) == q - 1


def test_crt_compose():
    moduli = [7, 11, 13]
    x = 542
    residues = [x % m for m in moduli]
    assert crt_compose(residues, moduli) == x


# --- modular arithmetic engines -----------------------------------------------

def _random_u32(shape, bound, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, bound, size=shape, dtype=np.uint64).astype(np.uint32)


def test_jx32_umulhi_exact():
    jx = get_engine("jx32")
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    # include extreme corners
    a[:4] = [0, 1, 2 ** 32 - 1, 2 ** 32 - 1]
    b[:4] = [0, 2 ** 32 - 1, 2 ** 32 - 1, 1]
    import jax.numpy as jnp
    got = np.asarray(jx.umulhi(jnp.asarray(a.astype(np.uint32)),
                               jnp.asarray(b.astype(np.uint32))))
    expected = ((a * b) >> np.uint64(32)).astype(np.uint32)
    np.testing.assert_array_equal(got, expected)


def test_jx32_barrett_mul_matches_np64():
    import jax.numpy as jnp
    q = gen_ntt_primes(30, 1, 1024)[0]
    mu = barrett_mu(q)
    a = _random_u32((8, 4096), q, 1)
    b = _random_u32((8, 4096), q, 2)
    qa = np.uint32(q)
    ref = get_engine("np64").mul(a, b, np.uint64(q))
    got = np.asarray(get_engine("jx32").mul(
        jnp.asarray(a), jnp.asarray(b), jnp.uint32(qa), jnp.uint32(mu)))
    np.testing.assert_array_equal(got, ref)


def test_jx32_shoup_mul_matches():
    import jax.numpy as jnp
    q = gen_ntt_primes(29, 1, 1024)[0]
    w = 123456789 % q
    wsh = shoup(w, q)
    a = _random_u32((4096,), q, 3)
    ref = (a.astype(np.uint64) * w % q).astype(np.uint32)
    got = np.asarray(get_engine("jx32").mul_shoup(
        jnp.asarray(a), jnp.uint32(w), jnp.uint32(wsh), jnp.uint32(q)))
    np.testing.assert_array_equal(got, ref)


def test_jx32_add_sub_neg():
    import jax.numpy as jnp
    q = 536813569
    jx = get_engine("jx32")
    a = _random_u32((1000,), q, 4)
    b = _random_u32((1000,), q, 5)
    qj = jnp.uint32(q)
    np.testing.assert_array_equal(
        np.asarray(jx.add(jnp.asarray(a), jnp.asarray(b), qj)),
        ((a.astype(np.uint64) + b) % q).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jx.sub(jnp.asarray(a), jnp.asarray(b), qj)),
        ((a.astype(np.int64) - b + q) % q).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jx.neg(jnp.asarray(a), qj)),
        ((q - a.astype(np.int64)) % q).astype(np.uint32))


# --- NTT ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 64, 256])
def test_ntt_roundtrip_np64(n):
    moduli = gen_ntt_primes(30, 2, n)
    ctx = NttContext(n, moduli)
    a = _random_u32((2, n), min(moduli), 6)
    np.testing.assert_array_equal(ctx.inv(ctx.fwd(a)), a)


def test_ntt_matches_naive_negacyclic_mul():
    n = 32
    moduli = gen_ntt_primes(30, 2, n)
    ctx = NttContext(n, moduli)
    rng = np.random.default_rng(7)
    a = np.stack([rng.integers(0, q, n).astype(np.uint32) for q in moduli])
    b = np.stack([rng.integers(0, q, n).astype(np.uint32) for q in moduli])
    got = ctx.negacyclic_mul(a, b)
    for l, q in enumerate(moduli):
        expected = negacyclic_mul_naive(a[l], b[l], q)
        np.testing.assert_array_equal(got[l], expected)


def test_ntt_evaluation_order_convention():
    # forward output position p = evaluation at psi^(2*bitrev(p)+1)
    n = 8
    logn = 3
    q = gen_ntt_primes(30, 1, n)[0]
    ctx = NttContext(n, [q])
    psi = ctx.psi[0]
    rng = np.random.default_rng(8)
    a = rng.integers(0, q, n).astype(np.uint32)
    A = ctx.fwd(a.reshape(1, n))[0]
    for p in range(n):
        e = 2 * bit_reverse(p, logn) + 1
        point = pow(psi, e, q)
        val = sum(int(a[i]) * pow(point, i, q) for i in range(n)) % q
        assert int(A[p]) == val, f"position {p}"


def test_ntt_jx32_bit_exact_vs_np64():
    n = 256
    moduli = gen_ntt_primes(30, 3, n)
    ctx_np = NttContext(n, moduli, engine="np64")
    ctx_jx = NttContext(n, moduli, engine="jx32")
    a = np.stack([_random_u32((n,), q, 9 + i) for i, q in enumerate(moduli)])
    import jax.numpy as jnp
    aj = jnp.asarray(a)
    np.testing.assert_array_equal(np.asarray(ctx_jx.fwd(aj)), ctx_np.fwd(a))
    np.testing.assert_array_equal(np.asarray(ctx_jx.inv(aj)), ctx_np.inv(a))
    # full product pipeline
    b = np.stack([_random_u32((n,), q, 19 + i) for i, q in enumerate(moduli)])
    np.testing.assert_array_equal(
        np.asarray(ctx_jx.negacyclic_mul(aj, jnp.asarray(b))),
        ctx_np.negacyclic_mul(a, b))


def test_ntt_batched_leading_dims():
    n = 64
    moduli = gen_ntt_primes(30, 2, n)
    ctx = NttContext(n, moduli)
    a = np.stack([np.stack([_random_u32((n,), q, 30 + i) for q in moduli])
                  for i in range(3)])  # [3, L, n]
    out = ctx.fwd(a)
    assert out.shape == a.shape
    for i in range(3):
        np.testing.assert_array_equal(out[i], ctx.fwd(a[i]))
