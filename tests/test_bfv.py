"""BFV scheme tests: encode/decode round trips, encrypt/decrypt, homomorphic
add/sub/plain-mult, rotations — np64 engine at small n for speed.

Reference test tier: test/runtime/SealCiphertextFactoryTest.cpp op matrix.
"""

import numpy as np
import pytest

from abc_tpu.crypto.bfv import BfvContext, Plaintext
from abc_tpu.crypto.params import BfvParams


@pytest.fixture(scope="module")
def ctx():
    return BfvContext(BfvParams.create(1024, seed=42))


def enc_values(ctx, values):
    return ctx.encrypt(ctx.encode(values))


def dec_values(ctx, ct, count):
    return ctx.decode(ctx.decrypt(ct))[:count]


def test_params_create():
    p = BfvParams.create(1024)
    assert p.L >= 1 and p.plain_modulus % (2 * 1024) == 1
    assert all(q % (2 * 1024) == 1 for q in p.coeff_modulus)
    assert len(set(p.coeff_modulus)) == len(p.coeff_modulus)
    assert p.plain_modulus not in p.coeff_modulus


def test_encode_decode_roundtrip(ctx):
    vals = [1, 2, 3, -4, 0, 7, 100000, -99999]
    pt = ctx.encode(vals)
    assert ctx.decode(pt)[:len(vals)] == vals


def test_encode_decode_full_slots(ctx):
    n = ctx.params.n
    vals = [(i * 37 - 500) % 1000 for i in range(n)]
    got = ctx.decode(ctx.encode(vals))
    assert got == [v % ctx.params.plain_modulus for v in vals] or got is not None
    # exact check with centered decode
    t = ctx.params.plain_modulus
    expected = [((v % t) if (v % t) <= t // 2 else (v % t) - t) for v in vals]
    assert got == expected


def test_encrypt_decrypt(ctx):
    vals = [5, -3, 12345, 0, 1]
    ct = enc_values(ctx, vals)
    assert dec_values(ctx, ct, len(vals)) == vals
    assert ctx.noise_budget(ct) > 0


def test_homomorphic_add_sub(ctx):
    a = enc_values(ctx, [1, 2, 3, -7])
    b = enc_values(ctx, [10, -20, 30, 7])
    assert dec_values(ctx, ctx.add(a, b), 4) == [11, -18, 33, 0]
    assert dec_values(ctx, ctx.sub(a, b), 4) == [-9, 22, -27, -14]
    assert dec_values(ctx, ctx.negate(a), 4) == [-1, -2, -3, 7]


def test_add_sub_plain(ctx):
    a = enc_values(ctx, [1, 2, 3])
    p = ctx.encode([100, 200, 300])
    assert dec_values(ctx, ctx.add_plain(a, p), 3) == [101, 202, 303]
    assert dec_values(ctx, ctx.sub_plain(a, p), 3) == [-99, -198, -297]
    assert dec_values(ctx, ctx.sub_from_plain(a, p), 3) == [99, 198, 297]


def test_multiply_plain(ctx):
    a = enc_values(ctx, [1, 2, 3, -4])
    p = ctx.encode([10, -10, 7, 7])
    assert dec_values(ctx, ctx.multiply_plain(a, p), 4) == [10, -20, 21, -28]


def test_multiply_plain_budget_drops(ctx):
    a = enc_values(ctx, [3] * 8)
    before = ctx.noise_budget(a)
    after = ctx.noise_budget(ctx.multiply_plain(a, ctx.encode([1000] * 8)))
    assert after < before and after > 0


def test_rotate_rows_left(ctx):
    n = ctx.params.n
    vals = list(range(16))
    ct = enc_values(ctx, vals)
    rot = ctx.rotate_rows(ct, 1)
    got = dec_values(ctx, rot, 15)
    # positive steps rotate each row left: slot i takes old slot i+1
    assert got == vals[1:16]


def test_rotate_rows_negative_wraps(ctx):
    n = ctx.params.n
    half = n // 2
    vals = [7] * half  # fill row 0 entirely
    vals[0] = 1
    ct = ctx.encrypt(ctx.encode(vals))
    rot = ctx.rotate_rows(ct, -4)
    got = ctx.decode(ctx.decrypt(rot))
    # row 0 rotated right by 4: the 1 moves from slot 0 to slot 4
    assert got[4] == 1 and got[0] == 7 and got[3] == 7 and got[5] == 7


def test_rotate_columns_swaps_rows(ctx):
    n = ctx.params.n
    half = n // 2
    vals = [1] * half + [2] * half
    ct = ctx.encrypt(ctx.encode(vals))
    got = ctx.decode(ctx.decrypt(ctx.rotate_columns(ct)))
    assert got[:half] == [2] * half and got[half:] == [1] * half


def test_rotation_composes(ctx):
    vals = list(range(32))
    ct = enc_values(ctx, vals)
    r = ctx.rotate_rows(ctx.rotate_rows(ct, 3), 2)
    assert dec_values(ctx, r, 20) == vals[5:25]


def test_noise_budget_positive_after_rotation(ctx):
    ct = enc_values(ctx, [1, 2, 3])
    assert ctx.noise_budget(ctx.rotate_rows(ct, 1)) > 0


# --- ct-ct multiplication (BEHZ) ------------------------------------------------

def test_multiply_basic(ctx):
    a = enc_values(ctx, [1, 2, 3, -4, 0, 100])
    b = enc_values(ctx, [5, -6, 7, 8, 9, 100])
    prod = ctx.multiply(a, b)
    assert prod.size == 2
    assert dec_values(ctx, prod, 6) == [5, -12, 21, -32, 0, 10000]
    assert ctx.noise_budget(prod) > 0


def test_multiply_without_relin_decrypts(ctx):
    a = enc_values(ctx, [3, -5])
    b = enc_values(ctx, [7, 11])
    prod = ctx.multiply(a, b, relinearize=False)
    assert prod.size == 3
    assert dec_values(ctx, prod, 2) == [21, -55]


def test_square(ctx):
    a = enc_values(ctx, [0, 1, -1, 12, -300])
    assert dec_values(ctx, ctx.square(a), 5) == [0, 1, 1, 144, 90000]


def test_multiply_then_add_and_rotate(ctx):
    a = enc_values(ctx, [1, 2, 3, 4])
    b = enc_values(ctx, [10, 20, 30, 40])
    prod = ctx.multiply(a, b)          # [10, 40, 90, 160]
    s = ctx.add(prod, a)               # [11, 42, 93, 164]
    r = ctx.rotate_rows(s, 1)          # [42, 93, 164, ...]
    assert dec_values(ctx, r, 3) == [42, 93, 164]


def test_multiply_depth_two():
    # depth 2 needs headroom: the dev q (90 bits) with a 20-bit t leaves
    # ~2^69 of noise room vs ~2^70 depth-2 noise — so use a 16-bit t here
    ctx = BfvContext(BfvParams.create(1024, seed=42, plain_bits=16))
    a = enc_values(ctx, [2, 3])
    b = enc_values(ctx, [5, 7])
    c = enc_values(ctx, [11, 13])
    p1 = ctx.multiply(a, b)
    p2 = ctx.multiply(p1, c)
    assert dec_values(ctx, p2, 2) == [110, 273]
    assert ctx.noise_budget(p2) > 0


def test_noise_budget_decreases_monotonically(ctx):
    a = enc_values(ctx, [2, 3])
    b = enc_values(ctx, [5, 7])
    fresh = ctx.noise_budget(a)
    after1 = ctx.noise_budget(ctx.multiply(a, b))
    assert fresh > after1 > 0


# --- cross-engine bit-exactness (SURVEY.md §7 hard part #2) --------------------

def test_jx32_engine_bit_exact_full_pipeline():
    """Same seed → identical keys; every homomorphic op must produce
    bit-identical ciphertexts on the np64 (CPU oracle) and jx32 (device
    uint32) engines."""
    import numpy as np
    c_np = BfvContext(BfvParams.create(1024, seed=7, engine="np64"))
    c_jx = BfvContext(BfvParams.create(1024, seed=7, engine="jx32"))

    vals_a, vals_b = [1, -2, 3000, 4], [9, 8, -7, 6]
    a_np, a_jx = c_np.encrypt(c_np.encode(vals_a)), c_jx.encrypt(c_jx.encode(vals_a))
    b_np, b_jx = c_np.encrypt(c_np.encode(vals_b)), c_jx.encrypt(c_jx.encode(vals_b))
    np.testing.assert_array_equal(np.asarray(a_jx.data), a_np.data)

    r_np = c_np.rotate_rows(c_np.multiply(c_np.add(a_np, b_np), b_np), 2)
    r_jx = c_jx.rotate_rows(c_jx.multiply(c_jx.add(a_jx, b_jx), b_jx), 2)
    np.testing.assert_array_equal(np.asarray(r_jx.data), r_np.data)
    expected = [(x + y) * y for x, y in zip(vals_a, vals_b)][2:]
    assert dec_values(c_np, r_np, 2) == expected


def test_precomputed_operand_multiply(ctx):
    """multiply with hoisted operand NTT forms is bit-identical to the
    plain path (the serving optimization for fixed multipliers)."""
    a = ctx.encrypt(ctx.encode([2, 3, 4]))
    b = ctx.encrypt(ctx.encode([5, 6, 7]))
    b_pre = ctx.precompute_mult_operand(b)
    plain = ctx.multiply(a, b)
    hoisted = ctx.multiply(a, b, b_pre=b_pre)
    both = ctx.multiply(a, b, a_pre=ctx.precompute_mult_operand(a),
                        b_pre=b_pre)
    import numpy as np
    assert np.array_equal(np.asarray(plain.data), np.asarray(hoisted.data))
    assert np.array_equal(np.asarray(plain.data), np.asarray(both.data))
    assert dec_values(ctx, hoisted, 3) == [10, 18, 28]


# ---------------------------------------------------------------- hybrid KS
# k ≥ 2 digit decomposition (BfvParams.ks_digits): the SEAL ≥3.6 hybrid
# key-switch variant. Semantics must be indistinguishable from k=1
# (decrypts to the same plaintext, comparable noise budgets) while the
# decomposition shrinks from L·(L+1) to ceil(L/k)·(L+k) NTT rows.

@pytest.mark.parametrize("k", [2, 3, 5])
def test_hybrid_ks_multiply_relin_decrypts(k):
    ctx = BfvContext(BfvParams.create(1024, seed=42, ks_digits=k))
    assert ctx.params.num_ks_digits == -(-ctx.params.L // k)
    assert ctx.full == ctx.params.L + k
    a = ctx.encrypt(ctx.encode([3, 1, 4, 1, 5]))
    b = ctx.encrypt(ctx.encode([2, 7, 1, 8, 2]))
    c = ctx.multiply(a, b)
    assert ctx.decode(ctx.decrypt(c))[:5] == [6, 7, 4, 8, 10]
    assert ctx.noise_budget(c) > 0


@pytest.mark.parametrize("k", [2, 3])
def test_hybrid_ks_rotation_matrix(k):
    ctx = BfvContext(BfvParams.create(1024, seed=1, ks_digits=k))
    ct = ctx.encrypt(ctx.encode([1, 2, 3, 4]))
    rot = ctx.rotate_rows(ct, 1)
    assert ctx.decode(ctx.decrypt(rot))[:3] == [2, 3, 4]
    back = ctx.rotate_rows(rot, -1)
    assert ctx.decode(ctx.decrypt(back))[:4] == [1, 2, 3, 4]
    cols = ctx.rotate_columns(ct)
    dec = ctx.decode(ctx.decrypt(cols))
    assert dec[512:516] == [1, 2, 3, 4]


def test_hybrid_ks_matches_k1_semantics():
    """Same plaintext program under k=1 and k=2 decrypts identically
    (noise differs; the message must not)."""
    results = {}
    for k in (1, 2):
        ctx = BfvContext(BfvParams.create(1024, seed=9, ks_digits=k))
        a = ctx.encrypt(ctx.encode([6, 2, 8]))
        b = ctx.encrypt(ctx.encode([3, 3, 3]))
        c = ctx.multiply(a, b)
        c = ctx.rotate_rows(c, 2)
        c = ctx.multiply(c, a)
        results[k] = ctx.decode(ctx.decrypt(c))[:3]
    # a·b = [18,6,24,0,…]; rotate-left-2 → [24,0,…]; ×a → [24·6,0,0]
    assert results[1] == results[2] == [144, 0, 0]


def test_hybrid_ks_jx32_bit_exact():
    """np64 and jx32 engines agree bit-for-bit under k=2 (same seed, same
    rng draw order)."""
    def run(engine):
        ctx = BfvContext(BfvParams.create(1024, engine=engine, seed=11,
                                          ks_digits=2))
        ctx.get_relin_key()
        ctx.get_galois_key(pow(3, 2, 2 * 1024))
        a = ctx.encrypt(ctx.encode([3, 1, 4, 1, 5]))
        b = ctx.encrypt(ctx.encode([2, 7, 1, 8, 2]))
        c = ctx.rotate_rows(ctx.multiply(a, b), 2)
        return np.asarray(c.data)
    assert np.array_equal(run("np64"), run("jx32"))


def test_hybrid_ks_hoisted_rotations(ctx):
    ctx2 = BfvContext(BfvParams.create(1024, seed=5, ks_digits=2))
    ct = ctx2.encrypt(ctx2.encode([10, 20, 30, 40, 50]))
    outs = ctx2.hoisted_rotations(ct, [0, 1, 2])
    assert ctx2.decode(ctx2.decrypt(outs[0]))[:5] == [10, 20, 30, 40, 50]
    assert ctx2.decode(ctx2.decrypt(outs[1]))[:4] == [20, 30, 40, 50]
    assert ctx2.decode(ctx2.decrypt(outs[2]))[:3] == [30, 40, 50]


def test_hybrid_ks_decompose_row_count():
    """The decomposition NTT batch shrinks: [α, L+k, n] not [L, L+1, n]."""
    ctx = BfvContext(BfvParams.create(1024, seed=3, ks_digits=2))
    L = ctx.params.L
    d = ctx._uniform_rns(L, "test")
    D = ctx._decompose_ntt(d)
    assert D.shape == (ctx.params.num_ks_digits, L + 2, 1024)
    assert ctx.params.num_ks_digits * (L + 2) < L * (L + 1)


def test_encrypt_many_batched_bit_exact_vs_np64():
    """encrypt_many pads the device batch to 16 with ZERO samples (no rng
    draws for padding lanes), so a jx32 batch of 3 must equal three np64
    single encrypts bit-for-bit — same seed, same draw order."""
    c_np = BfvContext(BfvParams.create(1024, seed=77, engine="np64"))
    c_jx = BfvContext(BfvParams.create(1024, seed=77, engine="jx32"))
    pts = [[1, 2, 3], [4, 5], [6]]
    want = [c_np.encrypt(c_np.encode(v)) for v in pts]
    got = c_jx.encrypt_many([c_jx.encode(v) for v in pts])
    for w, g in zip(want, got):
        assert np.array_equal(w.data, np.asarray(g.data))
    # and decrypt round-trips on the device path
    assert c_jx.decode(c_jx.decrypt(got[0]))[:3] == [1, 2, 3]


def test_device_key_arrays_bit_exact_vs_host():
    """Round 4: the jx32 batched device key composition (in-jit uniform
    regeneration + device-derived target secrets) must produce the SAME
    key arrays as the np64 host loop — asserted directly on the key
    material, not just through the op pipeline."""
    def keys(engine):
        ctx = BfvContext(BfvParams.create(1024, engine=engine, seed=19,
                                          ks_digits=2))
        g = pow(3, 1, 2 * 1024)
        ks = ctx.materialize_keys(["relin", f"galois_{g}"])
        return {k: (np.asarray(v[0]), np.asarray(v[1]))
                for k, v in ks.items()}
    host, dev = keys("np64"), keys("jx32")
    assert host.keys() == dev.keys()
    for k in host:
        assert np.array_equal(host[k][0], dev[k][0]), k
        assert np.array_equal(host[k][1], dev[k][1]), k
