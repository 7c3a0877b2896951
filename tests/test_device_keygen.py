"""Round-5 t_keygen / t_decryption reductions:

* device-side public-key build (_keygen_dev_jit): only the [n] int8
  secret/error samples cross the host boundary; outputs must be
  BIT-IDENTICAL to the host keygen;
* the pre-sliced decrypt view (_dev_s_ntt_L), so decrypt() does not pay
  an eager _dev_s_ntt_full[:L] slice in a dispatch of its own;
* the reduced-width key census (jit_executor._census_key_ids).
"""

import numpy as np
import pytest


@pytest.fixture()
def dev_keygen_env(monkeypatch):
    # the jitted build path is gated off CPU by default (per-context
    # compile cost in tests); force it here to pin bit-exactness
    monkeypatch.setenv("ABC_TPU_DEVICE_KEYGEN", "1")


def test_device_keygen_bit_exact(dev_keygen_env):
    from abc_tpu.crypto.bfv import BfvContext
    from abc_tpu.crypto.params import BfvParams

    ctx = BfvContext(BfvParams.create(1024, engine="jx32", seed=42))
    assert np.array_equal(np.asarray(ctx._dev_s_ntt_full), ctx.s_ntt_full)
    assert np.array_equal(np.asarray(ctx._dev_pk_b),
                          np.asarray(ctx.pk_b_ntt))
    assert np.array_equal(np.asarray(ctx._dev_pk_a),
                          np.asarray(ctx.pk_a_ntt))
    assert np.array_equal(np.asarray(ctx._dev_s_ntt_L),
                          ctx.s_ntt_full[:ctx.params.L])
    ct = ctx.encrypt(ctx.encode([3, 1, 4]))
    assert ctx.decode(ctx.decrypt(ct))[:3] == [3, 1, 4]
    prod = ctx.multiply(ct, ct)
    assert ctx.decode(ctx.decrypt(prod))[:3] == [9, 1, 16]
    rot = ctx.rotate_rows(ct, 1)
    assert ctx.decode(ctx.decrypt(rot))[:2] == [1, 4]


def test_device_keygen_matches_transfer_path():
    """Same seed through the jitted build and the plain-transfer build
    must install identical device keys (engines interoperate)."""
    from abc_tpu.crypto.bfv import BfvContext
    from abc_tpu.crypto.params import BfvParams

    import os
    ctx_plain = BfvContext(BfvParams.create(1024, engine="jx32", seed=7))
    os.environ["ABC_TPU_DEVICE_KEYGEN"] = "1"
    try:
        ctx_dev = BfvContext(BfvParams.create(1024, engine="jx32", seed=7))
    finally:
        del os.environ["ABC_TPU_DEVICE_KEYGEN"]
    for attr in ("_dev_s_ntt_full", "_dev_pk_b", "_dev_pk_a",
                 "_dev_s_ntt_L"):
        assert np.array_equal(np.asarray(getattr(ctx_plain, attr)),
                              np.asarray(getattr(ctx_dev, attr))), attr


def test_census_reduced_width_matches_program_keys():
    """The reduced-width census must record exactly the keys the program
    needs — rotations' galois elements come from the REAL ring degree,
    not the shadow width."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    factory = BfvCiphertextFactory(slots=1024, engine="jx32", seed=3)
    prog = ("secret int a = x * x; a = a + rotate(x, 3); "
            "a = a + rotate(x, -2); return a;")
    jp = jit_compile_program(prog, "secret int x = {1,2,3,4};", "out = a;",
                             factory)
    n = 1024
    want = {"relin",
            f"galois_{pow(3, 3 % (n // 2), 2 * n)}",
            f"galois_{pow(3, -2 % (n // 2), 2 * n)}"}
    assert set(jp._key_args) == want
    # slot 1 = x[1]² + rotate(x,3)[1] + rotate(x,-2)[1]
    #        = 2² + pad(4) + pad(4) = 12 (last-element padding)
    assert jp.run()["out"][1] == 12
