"""Smoke test of the encrypted-program path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpu   # four GPUs: the mesh phases only

One process drives the card(s); its only subprocesses are nvidia-smi and the
nvcc build of the NTT kernel. Phases, each of which raises on failure:

  1. device      JAX must see GPUs (no CPU fallback); prints the card's name
                 and power limit, device_kind and the compile-cache dir
  2. build       compiles the CUDA NTT library (ops/cuda_ntt.py)
  3. ntt         kernel and XLA stage loop vs the np64 oracle, bit for bit,
                 at n = 2048..32768 over each preset's full limb chain,
                 B in {1, 8}, plus one NttContext.subset() view
  4. ops         BFV n=8192 multiply+relin and a Galois rotation, decrypted;
                 CKKS n=32768 L=8 ks_digits=2 multiply+relin+rescale,
                 bit-identical to np64 and decoded within CKKS_TOL
  5. main path   config6's LaplaceSharpening at n=16384 through
                 jit_compile_program with the default engine; then one
                 auto_params BFV program and one auto_params float program
  6. gpu tests   the `gpu`-marked tests of tests/, on the card

The last line is one JSON object naming the device. The phase functions
take their sizes as arguments, so tests/test_chip_smoke.py rehearses them
on the CPU at n=256.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# decoded CKKS slots vs the float oracle: the tolerance tests/test_ckks.py
# holds a multiply+relin+rescale to
CKKS_TOL = {"rtol": 1e-3, "atol": 1e-3}

HAMMING = ("int sum = 0;"
           "for (int i = 0; i < n; i = i + 1) {"
           "  sum = sum + (x[i]-y[i])*(x[i]-y[i]);"
           "}"
           "return sum;")


def _say(*parts) -> None:
    print(*parts, flush=True)


def _timed(label: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _say(f"[{label}] ok in {time.perf_counter() - t0:.1f} s")
    return out


def _hamming_inputs(x, y) -> str:
    return (f"secret int x = {{{','.join(map(str, x))}}}; "
            f"secret int y = {{{','.join(map(str, y))}}}; int n = {len(x)};")


def _float_outputs(jaxpr) -> list:
    """Avals of every floating-point value a jaxpr computes, nested
    sub-jaxprs (jit, loops, conditionals) included."""
    found = []
    for eq in jaxpr.eqns:
        found += [v.aval for v in eq.outvars
                  if np.issubdtype(v.aval.dtype, np.floating)]
        for p in eq.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    found += _float_outputs(sub)
    return found


# ----------------------------------------------------------------- phases
def phase_device(count: int):
    """Return the devices; raise unless there are `count` GPUs."""
    import jax
    from abc_tpu.utils.compcache import enable_persistent_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{devs[0].platform}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke.py needs {count} GPUs, found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    _say("nvidia-smi:", smi.stdout.strip().replace("\n", " | "))
    _say(f"device_kind: {devs[0].device_kind} x{len(devs)}; compile cache: "
         f"{enable_persistent_cache()}")
    return devs[:count]


def phase_build() -> float:
    from abc_tpu.ops import cuda_ntt
    t0 = time.perf_counter()
    cuda_ntt.load()
    secs = time.perf_counter() - t0
    _say(f"cuda ntt library {cuda_ntt.library_path()} built/loaded in "
         f"{secs:.1f} s")
    return secs


def preset_chains(sizes=(2048, 8192, 16384, 32768)) -> dict:
    """n -> full production limb chain (data primes + special prime)."""
    from abc_tpu.crypto.params import BfvParams
    return {n: list(BfvParams.create(n).coeff_modulus) for n in sizes}


def phase_ntt(chains: dict, batches=(1, 8), seed: int = 0) -> None:
    """jx32 fwd/inv (the platform's transform) and fwd_xla/inv_xla against
    the np64 NttContext, bit for bit, plus one subset() view per size."""
    import jax
    from abc_tpu.crypto.ntt import NttContext

    rng = np.random.default_rng(seed)
    for n, moduli in chains.items():
        c64 = NttContext(n, moduli, engine="np64")
        c32 = NttContext(n, moduli, engine="jx32")
        L = len(moduli)
        for B in batches:
            shape = (L, n) if B == 1 else (B, L, n)
            x = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64)
                 % np.asarray(moduli, dtype=np.uint64)[:, None]
                 ).astype(np.uint32)
            want_f, want_i = c64.fwd(x), c64.inv(x)
            for name, f, i in (("kernel", c32.fwd, c32.inv),
                               ("xla", c32.fwd_xla, c32.inv_xla)):
                got_f = np.asarray(jax.block_until_ready(f(x)))
                got_i = np.asarray(jax.block_until_ready(i(x)))
                if not (np.array_equal(got_f, want_f)
                        and np.array_equal(got_i, want_i)):
                    raise AssertionError(
                        f"ntt {name} differs from np64 at n={n} L={L} B={B}")
        rows = list(range(1, L, 2))
        s64, s32 = c64.subset(rows), c32.subset(rows)
        xs = x[..., rows, :]
        if not (np.array_equal(np.asarray(s32.fwd(xs)), s64.fwd(xs))
                and np.array_equal(np.asarray(s32.inv(xs)), s64.inv(xs))):
            raise AssertionError(f"ntt subset view differs at n={n}")
        _say(f"ntt n={n} L={L} B={list(batches)}: kernel and xla "
             f"bit-equal to np64 (fwd, inv, subset of {len(rows)} limbs)")


def phase_bfv_ops(params) -> None:
    """ct·ct multiply+relin and a Galois rotation, jitted, decrypted."""
    import jax
    from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext

    ctx = BfvContext(params)
    n, t = params.n, params.plain_modulus
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    steps = 3
    ctx.get_galois_key(pow(3, steps, 2 * n))
    va = [(7 * i + 1) % 256 for i in range(32)]
    vb = [(5 * i + 3) % 256 for i in range(32)]
    a = ctx.encrypt(ctx.encode(va))
    b = ctx.encrypt(ctx.encode(vb))
    mul = jax.jit(lambda x, y: ctx.multiply(BfvCiphertext(x),
                                            BfvCiphertext(y)).data)
    rot = jax.jit(lambda x: ctx.rotate_rows(BfvCiphertext(x), steps).data)
    prod = ctx.decode(ctx.decrypt(BfvCiphertext(np.asarray(
        mul(a.data, b.data)))))[:32]
    if prod != [x * y % t for x, y in zip(va, vb)]:
        raise AssertionError(f"BFV n={n} multiply decrypts to {prod[:8]}...")
    got = ctx.decode(ctx.decrypt(BfvCiphertext(np.asarray(rot(a.data)))))
    if got[:32 - steps] != va[steps:]:
        raise AssertionError(f"BFV n={n} rotation decrypts to {got[:8]}...")
    _say(f"bfv n={n} L={params.L}: multiply+relin and rotate({steps}) "
         "decrypt-equal to the plaintext results")


def phase_ckks_ops(n: int, levels: int, ks_digits: int, seed: int = 3,
                   scale_bits: int = 30):
    """Multiply+relin+rescale on jx32 (jitted) vs np64: bit-identical
    ciphertexts, and decoded slots within CKKS_TOL of the float product.
    Also checks that the jitted step computes no floating point. The scale
    matches the 30-bit primes, so the rescaled product keeps scale ~2^30."""
    import jax
    from abc_tpu.crypto.ckks import CkksCiphertext, CkksContext, CkksParams

    kw = dict(levels=levels, seed=seed, ks_digits=ks_digits,
              scale_bits=scale_bits)
    c64 = CkksContext(CkksParams.create(n, **kw))
    c32 = CkksContext(CkksParams.create(n, engine="jx32", **kw))
    va = np.linspace(-2.0, 2.0, 64)
    vb = np.cos(np.arange(64))
    a64, b64 = c64.encrypt(c64.encode(va)), c64.encrypt(c64.encode(vb))
    a32, b32 = c32.encrypt(c32.encode(va)), c32.encrypt(c32.encode(vb))
    r64 = c64.multiply(a64, b64)
    c32.get_relin_key()

    def step(x, y):
        return c32.multiply(CkksCiphertext(x, a32.level, a32.scale),
                            CkksCiphertext(y, b32.level, b32.scale)).data

    floats = _float_outputs(jax.make_jaxpr(step)(a32.data, b32.data).jaxpr)
    if floats:
        raise AssertionError(f"CKKS step computes floats: {floats[:3]}")
    d32 = np.asarray(jax.jit(step)(a32.data, b32.data))
    if not np.array_equal(d32, np.asarray(r64.data)):
        raise AssertionError(f"CKKS n={n} jx32 product differs from np64")
    got = np.real(c32.decode(c32.decrypt(
        CkksCiphertext(d32, r64.level, r64.scale))))[:64]
    np.testing.assert_allclose(got, va * vb, **CKKS_TOL)
    _say(f"ckks n={n} L={levels} ks_digits={ks_digits}: multiply+relin+"
         f"rescale bit-identical to np64, no float op in the step, max "
         f"|decoded - product| {np.max(np.abs(got - va * vb)):.2e} "
         f"(tolerance {CKKS_TOL})")


def phase_main_path(slots: int, engine=None, size: int = 4) -> None:
    """config6 through jit_compile_program with a default-engine factory,
    then one auto_params BFV and one auto_params float (CKKS) program."""
    import jax
    from abc_tpu.benchsuite import laplace_e2e
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    csv, extra, jp = laplace_e2e(slots=slots, engine=engine, size=size)
    if jp.factory.params.engine != "jx32":
        raise AssertionError("the default engine did not resolve to jx32")
    kind = jax.devices()[0].device_kind
    _say(f"config6 laplace n={jp.factory.params.n} engine="
         f"{jp.factory.params.engine} on {kind}: decrypt-equal to the oracle;"
         " CSV ms " + json.dumps({k: round(v, 3) for k, v in csv.items()})
         + f"; xla_compile_ms {extra['xla_compile_ms']:.1f}")
    mem = jp._jitted.lower(jp.secret_inputs, jp._key_args).compile() \
        .memory_analysis()
    _say(f"config6 step memory_analysis: {mem}")

    x, y = [1, 0, 1, 1, 0, 1, 1, 0], [1, 1, 0, 1, 0, 0, 1, 1]
    jp = jit_compile_program(HAMMING, _hamming_inputs(x, y), "out = sum;",
                             auto_params=True, seed=5)
    got = jp.run()["out"][0]
    if got != sum(int(a != b) for a, b in zip(x, y)):
        raise AssertionError(f"auto_params hamming decrypts to {got}")
    _say(f"auto_params hamming: BFV n={jp.factory.params.n}, "
         f"decrypts to {got}")

    jp = jit_compile_program("secret double acc = w0 * w1; return acc;",
                             "secret double w0 = {1.5,2.0,-0.5}; "
                             "secret double w1 = {0.25,-3.0,4.0};",
                             "out = acc;", auto_params=True, seed=5)
    if not isinstance(jp.factory, CkksCiphertextFactory):
        raise AssertionError("float program did not route to CKKS")
    got = np.asarray(jp.run()["out"][:3])
    np.testing.assert_allclose(got, [0.375, -6.0, -2.0], rtol=1e-2,
                               atol=1e-2)
    _say(f"auto_params float: CKKS n={jp.factory.params.n}, decrypts to "
         f"{np.round(got, 4).tolist()}")


def phase_gpu_tests() -> None:
    """The `gpu`-marked tests, in this process, on the card. Only the files
    that hold such tests are collected: others import helpers as
    `tests.<module>`, which a `tests` package installed elsewhere on the
    machine can shadow."""
    import pathlib

    import pytest

    os.environ["JAX_PLATFORMS"] = "cuda"
    tests = pathlib.Path(__file__).resolve().parent / "tests"
    files = [str(f) for f in sorted(tests.glob("test_*.py"))
             if "@pytest.mark.gpu" in f.read_text()]
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider"] + files)
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")


def phase_four_gpu(devices, n_bfv: int = 8192, n_ckks: int = 32768,
                   batch: int = 4) -> None:
    """The mesh path on four devices: the hamming program on
    make_mesh(dp=2, limb=2), decrypt-equal per element to single-device
    runs; DistCkksMultiplier over a 4-device coefficient mesh, bit-equal
    to the single-device multiply; and the collectives each one emits."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from abc_tpu.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
    from abc_tpu.parallel.dist_ckks import DistCkksMultiplier
    from abc_tpu.parallel.dryrun import build_context
    from abc_tpu.parallel.report import collective_report
    from abc_tpu.parallel.sharding import make_mesh
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    mesh = make_mesh(dp=2, limb=2, devices=devices)
    rng = np.random.default_rng(9)
    xs = [[int(v) for v in rng.integers(0, 2, 8)] for _ in range(batch)]
    ys = [[int(v) for v in rng.integers(0, 2, 8)] for _ in range(batch)]
    fac = BfvCiphertextFactory(context=build_context(n=n_bfv, data_limbs=4,
                                                     seed=21))
    jp = jit_compile_program(HAMMING, _hamming_inputs(xs[0], ys[0]),
                             "out = sum;", fac, mesh=mesh,
                             batch_values={"x": xs, "y": ys})
    got = [row[0] for row in jp.run()["out"]]
    single_fac = BfvCiphertextFactory(context=build_context(
        n=n_bfv, data_limbs=4, seed=21))
    singles = [jit_compile_program(HAMMING, _hamming_inputs(x, y),
                                   "out = sum;", single_fac).run()["out"][0]
               for x, y in zip(xs, ys)]
    oracle = [sum(int(a != b) for a, b in zip(x, y)) for x, y in zip(xs, ys)]
    if not (got == singles == oracle):
        raise AssertionError(f"mesh hamming {got}, single {singles}, "
                             f"oracle {oracle}")
    rep = collective_report(jp._jitted, jp.secret_inputs, jp._key_args)
    if "all-reduce" not in rep:
        raise AssertionError(f"mesh hamming emits no all-reduce: {rep}")
    _say(f"mesh hamming BFV n={n_bfv} dp=2 x limb=2: {got} equal to single-"
         f"device runs and the oracle; collectives {json.dumps(rep)}")

    cctx = CkksContext(CkksParams.create(n_ckks, levels=8, engine="jx32",
                                         seed=23))
    cctx.get_relin_key()
    dist = DistCkksMultiplier(cctx, Mesh(np.asarray(devices), ("coeff",)))
    vals = np.linspace(0.1, 0.9, 64)
    ca = cctx.encrypt(cctx.encode(vals))
    cb = cctx.encrypt(cctx.encode(vals[::-1].copy()))
    a, b = jnp.asarray(ca.data), jnp.asarray(cb.data)
    got = np.asarray(jax.jit(dist)(a, b))
    want = np.asarray(jax.jit(lambda x, y: cctx.multiply(
        CkksCiphertext(x, ca.level, ca.scale),
        CkksCiphertext(y, cb.level, cb.scale), rescale=False).data)(a, b))
    if not np.array_equal(got, want):
        raise AssertionError("coefficient-sharded CKKS multiply differs "
                             "from the single-device multiply")
    rep = collective_report(jax.jit(dist), a, b)
    if "collective-permute" not in rep:
        raise AssertionError(f"sharded CKKS emits no collective-permute: "
                             f"{rep}")
    _say(f"coeff-sharded CKKS n={n_ckks} over {len(devices)} devices: "
         f"bit-equal to one device; collectives {json.dumps(rep)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the four-GPU mesh phases")
    args = ap.parse_args(argv)
    count = 4 if args.four_gpu else 1

    devices = _timed("device", phase_device, count)
    _timed("build", phase_build)
    if args.four_gpu:
        _timed("four-gpu", phase_four_gpu, devices)
    else:
        from abc_tpu.crypto.params import BfvParams
        _timed("ntt", phase_ntt, preset_chains())
        _timed("bfv", phase_bfv_ops,
               BfvParams.create(8192, engine="jx32", seed=1))
        _timed("ckks", phase_ckks_ops, 32768, 8, 2)
        _timed("main path", phase_main_path, 16384)
        _timed("gpu tests", phase_gpu_tests)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
