"""Multi-chip "full step" used by __graft_entry__.dryrun_multichip and the
sharding tests: a batched encrypted computation jitted over a 2-D
(dp × limb) mesh.

Per batched ciphertext pair: ct_sum = a ⊞ b, then rotate_rows(ct_sum, 1) with
the key-switch decomposition contraction sharded over "limb" (a psum)
while the batch is sharded over "dp". This exercises both mesh axes with real
collectives in a single jitted shard_map program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from abc_tpu.crypto.bfv import BfvContext
from abc_tpu.crypto.numthy import gen_ntt_primes
from abc_tpu.crypto.params import BfvParams
from abc_tpu.parallel.sharding import (
    _local_key_switch_partials, _psum_mod, _shard_map, make_mesh,
)


def build_context(n: int, data_limbs: int, seed: int = 11) -> BfvContext:
    """BFV context with an explicit number of data limbs (so the limb mesh
    axis divides L evenly)."""
    t = gen_ntt_primes(20, 1, n)[0]
    primes = gen_ntt_primes(30, data_limbs + 1, n, exclude=[t])
    return BfvContext(BfvParams(n=n, coeff_modulus=primes, plain_modulus=t,
                                engine="jx32", seed=seed))


def make_multichip_step(ctx: BfvContext, mesh: Mesh, steps: int = 1):
    """Returns a jitted step: (batch_a, batch_b, ksk_b, ksk_a) → batch_out.

    batch_*: [B, 2, L, n] sharded over "dp" on axis 0
    ksk_*:   [L, L+1, n]  sharded over "limb" on axis 0
    """
    L = ctx.params.L
    n = ctx.params.n
    limb_size = mesh.shape["limb"]
    assert L % limb_size == 0, "limb mesh axis must divide L"
    Lk = L // limb_size
    g = pow(3, steps % (n // 2), 2 * n)
    gather, sign_pos = ctx._galois_perm(g)
    gather = jnp.asarray(np.asarray(gather))
    sign_pos = jnp.asarray(np.asarray(sign_pos))
    perm_eval = jnp.asarray(ctx._galois_perm_eval(g))
    q_q = ctx.q_q
    q_full = ctx._tab["q_full"]
    mu_full = ctx._tab["mu_full"]
    e = ctx.engine

    def kernel(a, b, kb, ka):
        # a, b: [Bl, 2, L, n] local batch shard. Hoisted rotation form:
        # decompose the UNtouched c1, permute the decomposition in the NTT
        # domain (matches BfvContext.apply_galois bit-exactly).
        s = e.add(a, b, q_q)
        d_all = s[:, 1]                                     # [Bl, L, n]
        i = jax.lax.axis_index("limb")
        d_loc = jax.lax.dynamic_slice_in_dim(d_all, i * Lk, Lk, axis=1)
        pb, pa = jax.vmap(
            lambda dd: _local_key_switch_partials(ctx, dd, kb, ka,
                                                  perm_eval=perm_eval))(d_loc)
        pb = _psum_mod(pb, q_full, mu_full, "limb", e)
        pa = _psum_mod(pa, q_full, mu_full, "limb", e)
        acc_b = ctx.ntt_qp.inv(pb)
        acc_a = ctx.ntt_qp.inv(pa)
        k0 = jax.vmap(ctx._mod_switch_down)(acc_b)
        k1 = jax.vmap(ctx._mod_switch_down)(acc_a)
        c0g = s[:, 0][..., gather]
        c0g = jnp.where(sign_pos, c0g, e.neg(c0g, q_q))
        c0 = e.add(c0g, k0, q_q)
        return jnp.stack([c0, k1], axis=1)                  # [Bl, 2, L, n]

    sharded = _shard_map(
        kernel, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("limb", None, None), P("limb", None, None)),
        out_specs=P("dp"),
        check_vma=False)
    return jax.jit(sharded)


def run_production_dryrun(n_devices: int, verbose: bool = True) -> dict:
    """Production-shape multichip dryrun (BASELINE configs 2/5 sizes):

      * BFV n=8192 batched rotate step on the dp × limb mesh — the
        key-switch decomposition contraction psums over "limb";
      * CKKS n=32768 (BASELINE config 5) multiply+relin with coefficients
        sharded over all devices — distributed-NTT ppermute exchanges.

    Returns (and prints) per-phase collective-traffic censuses from the
    compiled HLO: table construction, memory footprints and psum widths
    all change at production size, so the tiny-shape dryrun alone is not
    evidence the production program compiles. CPU-mesh execution is slow
    but one step of each is enough to prove compile + execute + decrypt."""
    import json as _json
    import time as _time

    from abc_tpu.parallel.report import collective_report

    devices = jax.devices()
    dp = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    limb = n_devices // dp
    mesh = make_mesh(dp=dp, limb=limb, devices=devices)
    n = 8192
    # smallest multiple of the limb axis ≥ the n=8192 preset's 6 data limbs
    data_limbs = limb * (-(-6 // limb))
    ctx = build_context(n=n, data_limbs=data_limbs, seed=17)
    B = 2 * dp
    batch_vals = [[j + 2 for j in range(4)] for _ in range(B)]
    a = jnp.stack([jnp.asarray(np.asarray(ctx.encrypt(ctx.encode(v)).data))
                   for v in batch_vals])
    b = jnp.stack([jnp.asarray(np.asarray(ctx.encrypt(ctx.encode(v)).data))
                   for v in batch_vals])
    ksk_b, ksk_a = ctx.get_galois_key(pow(3, 1, 2 * n))
    step = make_multichip_step(ctx, mesh, steps=1)
    t0 = _time.perf_counter()
    out = jax.block_until_ready(step(a, b, ksk_b, ksk_a))
    bfv_first_ms = (_time.perf_counter() - t0) * 1e3   # includes compile
    t0 = _time.perf_counter()
    jax.block_until_ready(step(a, b, ksk_b, ksk_a))
    bfv_ms = (_time.perf_counter() - t0) * 1e3         # steady state
    from abc_tpu.crypto.bfv import BfvCiphertext
    got = ctx.decode(ctx.decrypt(BfvCiphertext(np.asarray(out[0]))))[:3]
    expected = [2 * v for v in batch_vals[0][1:4]]
    assert got == expected, f"production BFV dryrun mismatch: {got}"
    bfv_coll = collective_report(step, a, b, ksk_b, ksk_a)

    # compiled-program phase at production shape (SURVEY §7 step 9): the
    # hamming workload through the full pipeline on the dp×limb mesh
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    hamming_src = (
        "int sum = 0;"
        "for (int i = 0; i < n; i = i + 1) {"
        "  sum = sum + (x[i]-y[i])*(x[i]-y[i]);"
        "}"
        "return sum;")
    rng = np.random.default_rng(9)
    B_p = 2 * dp
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B_p)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B_p)]
    fac = BfvCiphertextFactory(context=ctx)     # reuse the n=8192 context
    t0 = _time.perf_counter()
    jp = jit_compile_program(
        hamming_src,
        f"secret int x = {{{','.join(map(str, xs[0]))}}}; "
        f"secret int y = {{{','.join(map(str, ys[0]))}}}; int n = 4;",
        "out = sum;", fac, mesh=mesh, batch_values={"x": xs, "y": ys})
    raw = jax.block_until_ready(jp.run_raw(jp.secret_inputs))
    prog_first_ms = (_time.perf_counter() - t0) * 1e3
    t0 = _time.perf_counter()
    jax.block_until_ready(jp.run_raw(jp.secret_inputs))
    prog_ms = (_time.perf_counter() - t0) * 1e3
    got_p = [row[0] for row in jp.decrypt_outputs(raw)["out"]]
    oracle_p = [sum(int(a != b) for a, b in zip(x, y))
                for x, y in zip(xs, ys)]
    assert got_p == oracle_p, \
        f"production compiled-program mismatch: {got_p} != {oracle_p}"
    prog_coll = collective_report(jp._jitted, jp.secret_inputs,
                                  jp._key_args)

    # CKKS n=32768 coefficient-sharded multiply+relin (BASELINE config 5)
    from abc_tpu.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
    from abc_tpu.parallel.dist_ckks import DistCkksMultiplier
    from jax.sharding import Mesh as _Mesh

    n_c = 32768
    coeff_mesh = _Mesh(np.asarray(devices[:n_devices]), ("coeff",))
    cparams = CkksParams.create(n_c, levels=8, engine="jx32", seed=23)
    cctx = CkksContext(cparams)
    cctx.get_relin_key()
    dist = DistCkksMultiplier(cctx, coeff_mesh)
    vals = np.linspace(0.1, 0.9, 64)
    ca = cctx.encrypt(cctx.encode(vals))
    cb = cctx.encrypt(cctx.encode(vals))
    jitted = jax.jit(dist)
    t0 = _time.perf_counter()
    prod = jax.block_until_ready(
        jitted(jnp.asarray(np.asarray(ca.data)),
               jnp.asarray(np.asarray(cb.data))))
    ckks_first_ms = (_time.perf_counter() - t0) * 1e3  # includes compile
    t0 = _time.perf_counter()
    jax.block_until_ready(
        jitted(jnp.asarray(np.asarray(ca.data)),
               jnp.asarray(np.asarray(cb.data))))
    ckks_ms = (_time.perf_counter() - t0) * 1e3        # steady state
    ct = CkksCiphertext(np.asarray(prod), ca.level, ca.scale * cb.scale)
    got_c = cctx.decode(cctx.decrypt(ct)).real[:64]
    errc = float(np.max(np.abs(got_c - vals * vals)))
    assert errc < 0.05, f"production CKKS dryrun mismatch: err={errc}"
    ckks_coll = collective_report(jitted, jnp.asarray(np.asarray(ca.data)),
                                  jnp.asarray(np.asarray(cb.data)))

    report = {
        "bfv": {"n": n, "L": ctx.params.L, "mesh": {"dp": dp, "limb": limb},
                "batch": B, "step_ms": round(bfv_ms, 1),
                "first_call_ms_incl_compile": round(bfv_first_ms, 1),
                "collectives_per_step": bfv_coll,
                "axis_attribution": "all-reduce = key-switch psum over "
                                    "'limb'; 'dp' moves zero bytes"},
        "compiled_program": {
            "workload": "hamming (full pipeline: parse->passes->"
                        "vectorize->whole-program JIT)",
            "n": n, "mesh": {"dp": dp, "limb": limb}, "batch": B_p,
            "step_ms": round(prog_ms, 1),
            "first_call_ms_incl_compile": round(prog_first_ms, 1),
            "decrypted_ok": True,
            "collectives_per_step": prog_coll},
        "ckks": {"n": n_c, "L": cparams.L, "coeff_devices": n_devices,
                 "step_ms": round(ckks_ms, 1),
                 "first_call_ms_incl_compile": round(ckks_first_ms, 1),
                 "collectives_per_step": ckks_coll,
                 "axis_attribution": "collective-permute = distributed-NTT "
                                     "butterfly exchanges over 'coeff'"},
    }
    if verbose:
        print("dryrun production shapes OK: " + _json.dumps(report))
    return report


def run_dryrun(n_devices: int, n: int = 256, verbose: bool = True) -> None:
    """Build an n_devices mesh, jit the full sharded step, run one step on
    tiny shapes, and check the decrypted result against the expected values."""
    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} devices, found {len(devices)} "
            f"({devices[0].platform}); for a virtual CPU mesh call "
            "__graft_entry__.dryrun_multichip(n, cpu_mesh=True)")
    dp = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    limb = n_devices // dp
    mesh = make_mesh(dp=dp, limb=limb, devices=devices)

    ctx = build_context(n=n, data_limbs=limb)
    B = 2 * dp
    batch_vals = [[j + 1 for j in range(4)] for _ in range(B)]
    cts_a = [ctx.encrypt(ctx.encode(v)) for v in batch_vals]
    cts_b = [ctx.encrypt(ctx.encode(v)) for v in batch_vals]
    a = jnp.stack([jnp.asarray(np.asarray(c.data)) for c in cts_a])
    b = jnp.stack([jnp.asarray(np.asarray(c.data)) for c in cts_b])
    ksk_b, ksk_a = ctx.get_galois_key(pow(3, 1, 2 * n))

    step = make_multichip_step(ctx, mesh, steps=1)
    out = jax.block_until_ready(step(a, b, ksk_b, ksk_a))

    # verify one batch element decrypts to rotate(a+b, 1)
    from abc_tpu.crypto.bfv import BfvCiphertext
    got = ctx.decode(ctx.decrypt(BfvCiphertext(np.asarray(out[0]))))[:3]
    expected = [2 * v for v in batch_vals[0][1:4]]
    assert got == expected, f"dryrun mismatch: {got} != {expected}"
    if verbose:
        print(f"dryrun_multichip OK: mesh dp={dp} x limb={limb}, "
              f"n={n}, L={ctx.params.L}, batch={B}, decrypted {got}")

    # COMPILED-PROGRAM phase (SURVEY §7 build-order step 9): the hamming
    # DSL workload through the FULL pipeline (parse → passes → vectorize →
    # whole-program JIT) onto the same dp × limb mesh — a batch of
    # independent input pairs sharded over "dp", every key-switch
    # contraction limb-sharded — decrypt-checked against the oracle.
    from abc_tpu.parallel.report import collective_report
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    hamming_src = (
        "int sum = 0;"
        "for (int i = 0; i < n; i = i + 1) {"
        "  sum = sum + (x[i]-y[i])*(x[i]-y[i]);"
        "}"
        "return sum;")
    rng = np.random.default_rng(5)
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    ctx_prog = build_context(n=n, data_limbs=limb, seed=31)
    fac = BfvCiphertextFactory(context=ctx_prog)
    jp = jit_compile_program(
        hamming_src,
        f"secret int x = {{{','.join(map(str, xs[0]))}}}; "
        f"secret int y = {{{','.join(map(str, ys[0]))}}}; int n = 4;",
        "out = sum;", fac, mesh=mesh, batch_values={"x": xs, "y": ys})
    got_p = [row[0] for row in jp.run()["out"]]
    oracle = [sum(int(a != b) for a, b in zip(x, y))
              for x, y in zip(xs, ys)]
    assert got_p == oracle, f"compiled-program dryrun mismatch: {got_p}"
    prog_coll = collective_report(jp._jitted, jp.secret_inputs,
                                  jp._key_args)
    if verbose:
        import json as _json2
        print(f"dryrun compiled-program OK: hamming via full pipeline, "
              f"mesh dp={dp} x limb={limb}, batch={B}, decrypted {got_p}, "
              f"collectives {_json2.dumps(prog_coll)}")

    # second axis: coefficient-sharded CKKS multiply+relin (ppermute
    # butterfly exchanges inside the NTT, BASELINE config 5)
    from jax.sharding import Mesh as _Mesh

    from abc_tpu.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
    from abc_tpu.parallel.dist_ckks import DistCkksMultiplier

    coeff_mesh = _Mesh(np.asarray(devices[:n_devices]), ("coeff",))
    cparams = CkksParams.create(n, levels=3, engine="jx32", seed=13)
    cctx = CkksContext(cparams)
    cctx.get_relin_key()
    dist = DistCkksMultiplier(cctx, coeff_mesh)
    vals = np.linspace(0.1, 0.9, n // 2)
    ca = cctx.encrypt(cctx.encode(vals))
    cb = cctx.encrypt(cctx.encode(vals))
    prod = jax.block_until_ready(
        jax.jit(dist)(jnp.asarray(np.asarray(ca.data)),
                      jnp.asarray(np.asarray(cb.data))))
    ct = CkksCiphertext(np.asarray(prod), ca.level, ca.scale * cb.scale)
    got_c = cctx.decode(cctx.decrypt(ct)).real[:n // 2]
    assert np.max(np.abs(got_c - vals * vals)) < 0.05, "coeff-shard mismatch"
    if verbose:
        print(f"dryrun coeff-sharded CKKS OK: coeff={n_devices}, n={n}, "
              f"max err {np.max(np.abs(got_c - vals * vals)):.4f}")

    # production shapes (BFV n=8192, CKKS n=32768) with collective census —
    # slow on a CPU mesh but one step each; ABC_TPU_DRYRUN_FAST=1 skips
    import os as _os
    if not _os.environ.get("ABC_TPU_DRYRUN_FAST"):
        run_production_dryrun(n_devices, verbose=verbose)
