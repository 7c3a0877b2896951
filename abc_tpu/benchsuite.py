"""Staged benchmark suite — the six staged configs, runnable for real.

The reference's benchmark program writes a HARDCODED CSV (ast_demo,
examples/main.cpp:39-46); every number here is measured. Each config prints
one JSON line {"metric", "value", "unit", "vs_baseline", ...}. The
vs_baseline denominators are documented SEAL-CPU stand-ins, CALIBRATED in
BASELINE.md §"CPU baseline calibration": bounded above by a Harvey-butterfly
op-census derivation (SEAL ≈ 40-150 ops/s single-thread for config 2 —
the 40 used here is the conservative end, so speedups are lower bounds up
to ~4×) and below by this repo's own measured CPU host engine (8.4 ops/s,
BASELINE.md); configs 3/5 scale config 2 by each workload's NTT-row census:

  config 1  cardio end-to-end on the dummy scheme (CPU)
            vs the reference ast_demo CSV's t_computation placeholder.
  config 2  BFV n=8192 ct-ct mult+relin on the device
            vs SEAL ≈ 40 ops/s on m5n.xlarge.
  config 3  batched hamming distance (mult+relin + 2 Galois rotations,
            log-depth rotate-reduce) on the device vs SEAL ≈ 18 ops/s
            (25 ms mult+relin + 2×15 ms rotations).
  config 4  cone-rewriting multiplicative-depth reduction: depth before/
            after on the Aubry-style benchmark circuit + compile time.
  config 5  CKKS n=32768 mult+relin on one device vs SEAL ≈ 10 ops/s (the
            coefficient-sharded multiply is validated bit-exact by the tests
            and `chip_smoke.py --four-gpu`, not timed here).
  config 6  encrypted LaplaceSharpening end to end at n=16384 through the
            whole-program JIT, in the reference's CSV schema.

Timing protocol: dependent ops chained under lax.fori_loop and timed at two
chain lengths; the difference cancels the fixed per-call cost, so reported
numbers are sequential per-op latencies.
"""

from __future__ import annotations

import json
import time
from typing import Dict


def _chain_ops_per_s(step, arg0, args, chain: int, repeats: int = 3) -> float:
    """Steady-state ops/s of `step` chained under fori_loop, measured at TWO
    chain lengths and differenced, so the fixed per-call cost (dispatch,
    transfer) does not fold into the per-op number."""
    import jax

    def make(c):
        @jax.jit
        def chained(x):
            return jax.lax.fori_loop(0, c, lambda i, v: step(v, *args), x)
        return chained

    def best(f):
        jax.block_until_ready(f(arg0))
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(arg0))
            times.append(time.perf_counter() - t0)
        return min(times)

    full_f, half_f = make(chain), make(chain // 2)
    # host contention can invert a pair (t_full < t_half) — the old
    # max(…, 1e-9) clamp then published an absurd huge rate; discard and
    # retry inverted pairs, nan if nothing validates
    for _ in range(3):
        t_full = best(full_f)
        t_half = best(half_f)
        if t_full > t_half:
            return (chain // 2) / (t_full - t_half)
    return float("nan")


# --------------------------------------------------------------------------
def config1_cardio_dummy() -> Dict:
    """Cardio risk score: parse → circuit lowering → dummy-scheme run."""
    from abc_tpu.cli import run_benchmark
    r = run_benchmark("cardio", backend="dummy", slots=1024, runs=3)
    ms = r["t_computation"]
    return {"metric": "config1_cardio_dummy_e2e", "value": round(ms, 3),
            "unit": "ms", "vs_baseline": round(38315.0 / max(ms, 1e-9), 2),
            "note": "baseline = reference ast_demo placeholder CSV "
                    "t_computation (examples/main.cpp:41-42)"}


def config2_bfv_mult_relin(chain: int = 2048) -> Dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu.crypto.params import BfvParams

    ctx = BfvContext(BfvParams.create(8192, engine="jx32", seed=123))
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    a = ctx.encrypt(ctx.encode([1, 2, 3, 4]))
    b = ctx.encrypt(ctx.encode([5, 6, 7, 8]))

    def step(x, y):
        return ctx.multiply(BfvCiphertext(x), BfvCiphertext(y)).data

    ops = _chain_ops_per_s(step, jnp.asarray(np.asarray(a.data)),
                           (jnp.asarray(np.asarray(b.data)),), chain)
    return {"metric": f"config2_bfv_n8192_mult_relin ({jax.default_backend()})",
            "value": round(ops, 2), "unit": "ops/s",
            "vs_baseline": round(ops / 40.0, 2),
            "note": "same op as bench.py's mult_relin block under a "
                    "DIFFERENT protocol (one two-point estimate at chain "
                    f"{chain}, best-of-{3} repeats, vs the headline's "
                    "median of 5 independent estimates at chain 512) — "
                    "the ~3-5% disagreement between the two numbers is "
                    "protocol, not drift"}


def config3_batched_hamming(chain: int = 512) -> Dict:
    """Batched hamming distance over 4 packed slots: d = (x−y)²,
    rotate-reduce with 2 Galois rotations — one mult+relin + 2 rotations +
    3 adds per iteration (the reference's HammingDistanceTest workload,
    compiled by the batching pass to exactly this op sequence)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu.crypto.params import BfvParams

    ctx = BfvContext(BfvParams.create(8192, engine="jx32", seed=7))
    ctx.ensure_eval_ready()
    ctx.get_relin_key()
    ctx.get_galois_key(pow(3, 1, 2 * ctx.params.n))
    ctx.get_galois_key(pow(3, 2, 2 * ctx.params.n))
    x = ctx.encrypt(ctx.encode([1, 1, 0, 1]))
    y = ctx.encrypt(ctx.encode([1, 0, 1, 1]))

    def hamming(xd, yd):
        d = ctx.sub(BfvCiphertext(xd), BfvCiphertext(yd))
        sq = ctx.multiply(d, d)
        s = ctx.add(sq, ctx.rotate_rows(sq, 2))
        s = ctx.add(s, ctx.rotate_rows(s, 1))
        return s.data

    ops = _chain_ops_per_s(lambda v, yd: hamming(v, yd),
                           jnp.asarray(np.asarray(x.data)),
                           (jnp.asarray(np.asarray(y.data)),), chain)
    # correctness of one pass (slot 0 holds the distance = 2)
    out = hamming(jnp.asarray(np.asarray(x.data)),
                  jnp.asarray(np.asarray(y.data)))
    got = ctx.decode(ctx.decrypt(BfvCiphertext(np.asarray(out))))[0]
    return {"metric": f"config3_batched_hamming_n8192 ({jax.default_backend()})",
            "value": round(ops, 2), "unit": "ops/s",
            "vs_baseline": round(ops / 18.0, 2),
            "correct": got == 2,
            "note": "per op: 1 ct-ct mult+relin + 2 Galois rotations + adds;"
                    " baseline = SEAL CPU stand-in 18 ops/s"}


def _cone_measured_runtime(bits: int = 16, n: int = 2048, t_bits: int = 14,
                           batch: int = 8, repeats: int = 5) -> Dict:
    """Execute sorting_gt{bits} ENCRYPTED before and after cone rewriting,
    each on a modulus chain sized by the noise model — the depth win
    converted into a measured runtime win (round-5; previously config4
    reported static depth/gates only).

    Protocol: & → mult, ^ → add over Z_t (exact ring re-interpretation,
    passes/cone_rewriter.arithmetize_netlist), whole-program JIT, batched
    two-point timing (vmap over `batch` rows, t(B) − t(B/2) differencing
    cancels the fixed per-call cost), median of `repeats`. Gate:
    decrypted outputs equal before vs after (the rewrite is a ring
    identity)."""
    import math

    import jax
    import jax.numpy as jnp

    from abc_tpu import circuits
    from abc_tpu.crypto.bfv import BfvContext
    from abc_tpu.crypto.noise import analyze_circuit, estimate_noise_bits
    from abc_tpu.crypto.numthy import gen_ntt_primes
    from abc_tpu.crypto.params import BfvParams
    from abc_tpu.parser import Parser
    from abc_tpu.passes.cone_rewriter import (
        arithmetize_netlist, program_mult_depth, run_cone_rewriting,
    )
    from abc_tpu.passes.pipeline import (
        CompiledProgram, input_types_from_ast,
    )
    from abc_tpu.passes.type_checking import run_type_checking
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import JittedProgram

    src = circuits.sorting_comparator(bits)
    inputs_src = circuits.sorting_comparator_inputs(bits)
    input_ast = Parser.parse(inputs_src)
    output_ast = Parser.parse("out = gt;")
    itypes = input_types_from_ast(input_ast)

    result: Dict = {}
    decrypted = {}
    for mode in ("before", "after"):
        ast = Parser.parse(src)
        if mode == "after":
            run_cone_rewriting(ast, flow_select=True)
        depth = program_mult_depth(ast)
        arithmetize_netlist(ast)
        tcv = run_type_checking(ast, itypes)
        compiled = CompiledProgram(ast=ast, tcv=tcv, input_types=itypes)
        need = estimate_noise_bits(analyze_circuit(compiled), n, t_bits) \
            + t_bits + 10
        limbs = max(2, math.ceil(need / 30))
        t = gen_ntt_primes(t_bits, 1, n)[0]
        primes = gen_ntt_primes(30, limbs + 1, n, exclude=[t])
        ctx = BfvContext(BfvParams(n=n, coeff_modulus=primes,
                                   plain_modulus=t, engine="jx32", seed=77))
        jp = JittedProgram(compiled, BfvCiphertextFactory(context=ctx),
                           input_ast, output_ast)
        decrypted[mode] = jp.run()["out"][0]
        keys = jp._key_args

        def timed(bv):
            stacked = {k: jnp.stack([v] * bv)
                       for k, v in jp.secret_inputs.items()}
            f = jax.jit(lambda b, kk: jax.vmap(
                lambda s: jp._fn_keyed(s, kk))(b))
            jax.block_until_ready(f(stacked, keys))
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                jax.block_until_ready(f(stacked, keys))
                ts.append(time.perf_counter() - t0)
            return sorted(ts)[len(ts) // 2]

        # retry pairs whose differenced work is implausibly small (<1 ms —
        # these evals are ≥1 ms each): host jitter can invert a pair
        for _ in range(3):
            d = timed(batch) - timed(batch // 2)
            if d > 1e-3 * (batch // 2):
                break
        per = max(d, 1e-9) / (batch // 2)
        result[mode] = {"depth": depth, "data_limbs": limbs,
                        "ms_per_eval": round(per * 1e3, 2),
                        "evals_per_s": round(1.0 / per, 2)}
    result["decrypt_equal"] = decrypted["before"] == decrypted["after"]
    result["measured_speedup"] = round(
        result["before"]["ms_per_eval"] /
        max(result["after"]["ms_per_eval"], 1e-9), 2)
    result["protocol"] = (
        f"sorting_gt{bits} arithmetized over Z_t (t={t_bits} bits), "
        f"n={n}, chain sized per-variant by crypto/noise.py; batched "
        f"two-point timing B={batch}")
    return result


def config4_cone_rewriting(measure_runtime: bool = True) -> Dict:
    """Multiplicative-depth reduction on the NAMED boolean circuits
    (BASELINE config 4: "chi-squared / sorting"): the chi-squared test
    statistic, the 16-bit sorting comparator (greater-than ripple chain),
    and a 4x4-bit odd-even sorting network. Flow-based minimum-cone
    selection (Aubry Alg. 3) vs the greedy fallback: reports depth
    before/after AND the gate cost (mul/AND gates added) of each."""
    from abc_tpu import circuits
    from abc_tpu.parser import Parser
    from abc_tpu.passes.cone_rewriter import (
        mul_gate_count, multiplicative_depth, program_mult_depth,
        run_cone_rewriting,
    )
    from abc_tpu.ast_ir.nodes import Assignment, Return, VariableDeclaration

    def stats(ast):
        gates = 0
        for s in ast.iter_preorder():
            e = None
            if isinstance(s, Assignment):
                e = s.value
            elif isinstance(s, VariableDeclaration) and s.value is not None:
                e = s.value
            elif isinstance(s, Return) and s.value is not None:
                e = s.value
            if e is not None:
                gates += mul_gate_count(e)
        return program_mult_depth(ast), gates

    out = {}
    t0 = time.perf_counter()
    for name, src in (("chi_squared", circuits.chi_squared()),
                      ("sorting_gt16", circuits.sorting_comparator(16)),
                      ("sorting_gt32", circuits.sorting_comparator(32)),
                      ("cardio_netlist", circuits.cardio_netlist()),
                      ("sorting_network_4x4", circuits.sorting_network(4, 4))):
        row = {}
        for mode, flow in (("flow", True), ("greedy", False)):
            ast = Parser.parse(src)
            d0, g0 = stats(ast)
            cr = run_cone_rewriting(ast, flow_select=flow)
            d1, g1 = stats(ast)
            row[mode] = {"depth": [d0, d1], "gates": [g0, g1],
                         "rewrites": cr.rewrites_applied}
        out[name] = row
    compile_ms = (time.perf_counter() - t0) * 1e3

    gt = out["sorting_gt16"]["flow"]
    d0, d1 = gt["depth"]
    rec = {"metric": "config4_cone_rewriting_mult_depth",
           "value": d1, "unit": "mult-depth (sorting_gt16)",
           "depth_before": d0,
           "vs_baseline": round(d0 / max(d1, 1), 2),
           "circuits": out,
           "compile_ms": round(compile_ms, 2),
           "note": "flow = Aubry Alg. 3 minimum vertex cut over C^AND; "
                   "greedy = deepest-first fallback. gates = mul/AND "
                   "count before/after (the cost of the depth saved)"}
    if measure_runtime:
        rec["measured"] = _cone_measured_runtime()
    return rec


def config5_ckks_sharded(chain: int = 256) -> Dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from abc_tpu.crypto.ckks import CkksCiphertext, CkksContext, CkksParams

    n = 32768
    # hybrid key switching (ks_digits=2) halves the relin decomposition:
    # ceil(8/2)*(8+2) = 40 forward-NTT rows vs 8*9 = 72 at k=1
    params = CkksParams.create(n, levels=8, engine="jx32", seed=3,
                               ks_digits=2)
    ctx = CkksContext(params)
    ctx.get_relin_key()
    L = params.L
    rng = np.random.default_rng(0)
    ct = jnp.asarray(rng.integers(0, 2 ** 29, size=(2, L, n),
                                  dtype=np.uint64).astype(np.uint32))

    def step(x):
        a = CkksCiphertext(x, L, params.scale)
        return ctx.multiply(a, a, rescale=False).data

    ops = _chain_ops_per_s(lambda v: step(v), ct, (), chain)
    return {"metric": f"config5_ckks_n32768_mult_relin "
                      f"({jax.default_backend()})",
            "value": round(ops, 2), "unit": "ops/s",
            "vs_baseline": round(ops / 10.0, 2),
            "note": "hybrid ks_digits=2 relin (40 decompose-NTT rows vs 72 "
                    "at k=1); the coeff-sharded multiply is validated "
                    "bit-exact separately at ks_digits=1 on the 8-device "
                    "virtual mesh (tests/test_dist_ckks.py); this timing is "
                    "single-device k=2"}


LAPLACE_SRC = """
  int weightMatrix = {1, 1, 1, 1, -8, 1, 1, 1, 1};
  secret int img2 = img;
  for (int x = 1; x < imgSize-1; x = x + 1) {
    for (int y = 1; y < imgSize-1; y = y + 1) {
      secret int value = 0;
      for (int j = -1; j < 2; j = j + 1) {
        for (int i = -1; i < 2; i = i + 1) {
          value = value + weightMatrix[(i + 1)*3 + j + 1]
              *img[(x + i)*imgSize + y + j];
        }
      }
      img2[imgSize*x + y] = 2*img[imgSize*x + y] - value;
    }
  }
  return img2;
"""


def laplace_inputs(size: int = 4, seed: int = 7):
    """(inputs_src, oracle output) of the reference's LaplaceSharpening on
    a random size×size image (LaplaceSharpeningTest.cpp:17,151-161)."""
    import random
    rng = random.Random(seed)
    img = [rng.randrange(0, 256) for _ in range(size * size)]
    inputs_src = ("secret int img = {" + ",".join(map(str, img)) + "};"
                  f" int imgSize = {size};")
    weights = [1, 1, 1, 1, -8, 1, 1, 1, 1]
    want = list(img)
    for x in range(1, size - 1):
        for y in range(1, size - 1):
            conv = sum(weights[(i + 1) * 3 + j + 1] *
                       img[(x + i) * size + (y + j)]
                       for j in range(-1, 2) for i in range(-1, 2))
            want[x * size + y] = 2 * img[x * size + y] - conv
    return inputs_src, want


def laplace_e2e(slots: int = 16384, engine=None, seed: int = 23,
                size: int = 4):
    """One keygen → encrypt → run → decrypt pass of LaplaceSharpening
    through jit_compile_program with a fresh BfvCiphertextFactory (engine
    None = the platform default), decrypt-checked against the plain oracle.

    Returns (csv, extra, jp): csv holds the reference's four phases in ms;
    extra the first run's XLA compile (xla_compile_ms), the DSL parse and
    program setup (program_setup_ms) and the setup split (setup_phase_ms).
    CSV attribution: t_keygen = factory (context + keys) + switching-key
    census/build/placement, as the reference's factory ctor builds
    relin+galois keys (SealCiphertextFactory.cpp:72-100);
    t_input_encryption = batched device encryption of the secret inputs
    plus the BEHZ set-up (eval_ready); t_computation = best of 3 runs after
    the compiling one; t_decryption = best of 7."""
    import jax

    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    inputs_src, want = laplace_inputs(size)
    t0 = time.perf_counter()
    factory = BfvCiphertextFactory(slots=slots, engine=engine, seed=seed)
    t_factory = (time.perf_counter() - t0) * 1e3
    jp = jit_compile_program(LAPLACE_SRC, inputs_src, "out = img2;", factory)
    ph = jp.phase_ms
    t0 = time.perf_counter()
    got = jp.run()["out"][:size * size]
    t_compile = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError(f"laplace decrypt mismatch: {got} != {want}")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(jp.run_raw(jp.secret_inputs))
        runs.append(time.perf_counter() - t0)
    raw = jax.block_until_ready(jp.run_raw(jp.secret_inputs))
    decs = []
    for _ in range(7):
        t0 = time.perf_counter()
        jp.decrypt_outputs(raw)
        decs.append(time.perf_counter() - t0)
    csv = {"t_keygen": t_factory + ph.get("key_census", 0)
           + ph.get("key_build", 0) + ph.get("key_put", 0),
           "t_input_encryption": ph.get("encrypt", 0)
           + ph.get("eval_ready", 0),
           "t_computation": min(runs) * 1e3,
           "t_decryption": min(decs) * 1e3}
    phases = dict(ph, factory_ctor=t_factory)
    extra = {"xla_compile_ms": t_compile,
             "program_setup_ms": ph.get("parse_compile", 0)
             + ph.get("setup_other", 0),
             "setup_phase_ms": phases}
    return csv, extra, jp


def config6_laplace_n16384_e2e() -> Dict:
    """Encrypted LaplaceSharpening end-to-end at the REFERENCE's parameters
    (n=16384, MATRIX_SIZE=4) in the reference's own CSV schema (the SoK
    placeholder row its demo bench hardcodes, examples/main.cpp:39-46).
    The flow runs TWICE with fresh factories: the first pass compiles the
    executables (its compile time is xla_compile_ms, the analogue of the
    reference's untimed ahead-of-time C++ build); the second, steady-state
    pass gives the CSV phases."""
    import jax

    jax.devices()   # backend boot is library init, not keygen (the
                    # reference's t_keygen likewise excludes loading SEAL)
    _, first, _ = laplace_e2e()
    csv, extra, _ = laplace_e2e()
    t_comp = csv["t_computation"]
    return {"metric": f"config6_laplace_n16384_e2e ({jax.default_backend()})",
            "value": round(t_comp, 1), "unit": "ms t_computation",
            "vs_baseline": round(38315.0 / max(t_comp, 1e-9), 2),
            "csv_schema": {k: round(v, 1) for k, v in csv.items()},
            "xla_compile_ms": round(first["xla_compile_ms"], 1),
            "program_setup_ms": round(extra["program_setup_ms"], 1),
            "setup_phase_ms": {k: round(v, 1) for k, v in
                               extra["setup_phase_ms"].items()},
            "note": "baseline = the SoK CSV row the reference's demo bench "
                    "hardcodes (415,1117,38315,37; examples/main.cpp:39-46); "
                    "decrypted output verified against the plain oracle; "
                    "CSV phases are the steady-state (second) pass. "
                    "t_computation is one dispatch per run, best of 3."}


def _chain_ops_per_s_1arg(step, arg0, chain, repeats=3):  # pragma: no cover
    return _chain_ops_per_s(lambda v: step(v), arg0, (), chain, repeats)


CONFIGS = {
    1: config1_cardio_dummy,
    2: config2_bfv_mult_relin,
    3: config3_batched_hamming,
    4: config4_cone_rewriting,
    5: config5_ckks_sharded,
    6: config6_laplace_n16384_e2e,
}


# shorter chains for bench.py's default mode: long enough that the two-point
# difference, (chain/2) x per-op, dwarfs per-call jitter, short enough to
# keep the whole suite to minutes
_FAST_KW = {
    2: {"chain": 1024},
    3: {"chain": 512},
    5: {"chain": 256},
}


def run_suite_dict(configs=None, fast: bool = False) -> Dict[str, Dict]:
    """Run the staged suite and return {config name: result dict} (used by
    bench.py). A config that raises is recorded with an "error" field and
    the suite goes on; callers must treat such a record as a failure."""
    from abc_tpu.utils.compcache import enable_persistent_cache
    enable_persistent_cache()
    import sys
    import traceback

    out: Dict[str, Dict] = {}
    for k in sorted(configs or CONFIGS):
        kw = _FAST_KW.get(k, {}) if fast else {}
        t0 = time.perf_counter()
        try:
            out[f"config{k}"] = CONFIGS[k](**kw)
        except Exception as exc:  # keep the suite going
            traceback.print_exc()
            out[f"config{k}"] = {"metric": f"config{k} (failed)",
                                 "value": 0.0, "unit": "-",
                                 "vs_baseline": 0.0, "error": str(exc)[:200]}
        print(f"config{k}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return out


def run_suite(configs=None) -> int:
    """Print one JSON line per config; returns 1 if any config failed."""
    results = run_suite_dict(configs).values()
    for result in results:
        print(json.dumps(result), flush=True)
    return int(any("error" in r for r in results))
