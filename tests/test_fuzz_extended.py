"""Round-5 fuzz families closing the round-4 coverage gaps (VERDICT weak 1):

1. VECTORIZER WRITE EMISSIONS — random programs over indexed writes
   (full-coverage maps, uniform-offset partial coverage, literal outliers,
   accumulation chains, ExpressionList re-packs, per-slot products), the
   exact emission paths (vectorizer.py §4) the read-only gen_program space
   never reached. ALL-ON vs ALL-OFF on the dummy backend.
2. WHOLE-PROGRAM JIT — the same seeded program families run through
   JittedProgram (jx32 engine) and asserted equal to the tree-walking
   executor; previously the stack's central device path was exercised
   only by hand-written cases.
3. CKKS — random approximate-arithmetic programs (depth-capped), decrypted
   output vs a numpy float oracle; exercises the round-5 automatic
   level/scale alignment (crypto/ckks.py _align).
"""

import random

import numpy as np
import pytest

from abc_tpu.parser import Parser
from abc_tpu.passes.pipeline import (
    CompileOptions, Compiler, input_types_from_ast,
)
from abc_tpu.runtime.dummy import DummyCiphertextFactory
from abc_tpu.runtime.executor import RuntimeVisitor
from abc_tpu.runtime.values import AbstractCiphertext

from tests.test_pipeline_fuzz import ALL_OFF, ALL_ON, gen_program, run_with


# ---------------------------------------------------------------------------
# 1. vectorizer write-emission fuzz
# ---------------------------------------------------------------------------

def gen_vector_program(rng: random.Random):
    """(inputs_src, program_src, output_src, compare_spec): a random
    straight-line program dominated by indexed WRITES, hitting the
    vectorizer's slot-plan folding, outlier mask-mult, partial-coverage
    and rotate-reduce emissions. compare_spec = [(output_name, n_slots)].
    """
    veclen = rng.choice([4, 8])
    nvec = 2
    inputs = []
    for v in range(nvec):
        vals = [rng.randint(0, 9) for _ in range(veclen)]
        inputs.append(f"secret int v{v} = {{{','.join(map(str, vals))}}};")
    inputs.append(f"int k = {rng.randint(2, 5)};")

    stmts = ["secret int x = v0;"]
    outs = [("x", veclen)]
    tmp = 0
    for _ in range(rng.randint(1, 3)):
        kind = rng.randrange(6)
        src = f"v{rng.randrange(nvec)}"
        if kind == 0:
            # full-coverage map; same const (scalar fold) or per-slot
            # consts (vector constant emission)
            op = rng.choice(["+", "-", "*"])
            same_c = rng.random() < 0.5
            c = rng.randint(1, 5)
            for i in range(veclen):
                cc = c if same_c else rng.randint(1, 5)
                stmts.append(f"x[{i}] = {src}[{i}] {op} {cc};")
        elif kind == 1:
            # uniform-offset PARTIAL coverage (x = x***keep + E***write)
            d = rng.randint(1, veclen - 2)
            op = rng.choice(["+", "*"])
            c = rng.randint(1, 3)
            for i in range(veclen - d):
                stmts.append(f"x[{i}] = {src}[{i + d}] {op} {c};")
        elif kind == 2:
            # literal OUTLIER inside a full-coverage map (mask-mult + add)
            j_out = rng.randrange(veclen)
            lit = rng.randint(0, 9)
            for i in range(veclen):
                if i == j_out:
                    stmts.append(f"x[{i}] = {lit};")
                else:
                    stmts.append(f"x[{i}] = {src}[{i}] * 2;")
        elif kind == 3:
            # accumulation chain → log-depth rotate-reduce (slot 0 defined)
            name = f"s{tmp}"
            tmp += 1
            hi = rng.randint(2, veclen)
            stmts.append(f"secret int {name} = 0;")
            for i in range(hi):
                stmts.append(f"{name} = {name} + {src}[{i}];")
            outs.append((name, 1))
        elif kind == 4:
            # ExpressionList re-pack mid-program
            name = f"y{tmp}"
            tmp += 1
            vals = [rng.randint(0, 5) for _ in range(veclen)]
            stmts.append(
                f"secret int {name} = {{{','.join(map(str, vals))}}};")
            stmts.append(f"x = x + {name};")
        else:
            # per-slot products (batchableExpressionVectorizable spec)
            for i in range(veclen):
                stmts.append(f"x[{i}] = v0[{i}] * v1[{i}];")
    stmts.append("return x;")
    output_src = " ".join(f"o_{name} = {name};" for name, _ in outs)
    return " ".join(inputs), " ".join(stmts), output_src, outs


@pytest.mark.parametrize("seed", range(60))
def test_vectorizer_write_fuzz(seed):
    rng = random.Random(7000 + seed)
    inputs_src, program_src, output_src, outs = gen_vector_program(rng)
    base = run_with(inputs_src, program_src, output_src, ALL_OFF)
    opt = run_with(inputs_src, program_src, output_src, ALL_ON)
    for (bn, bv), (on, ov), (_, ncmp) in zip(base, opt, outs):
        assert bn == on
        assert bv[:ncmp] == ov[:ncmp], (
            f"seed {seed}: write-emission divergence on {bn}\n"
            f"inputs: {inputs_src}\nprogram: {program_src}\n"
            f"base={bv[:ncmp]} opt={ov[:ncmp]}")


# ---------------------------------------------------------------------------
# 2. whole-program JIT fuzz (jx32)
# ---------------------------------------------------------------------------

_JIT_FACTORY = []


def _jit_factory():
    """One shared jx32 factory for the whole family: per-factory key builds
    compile fresh XLA executables (~3 s each on CPU), and the keys are
    deterministic (seed=11) — sharing cuts the family's wall time ~3×."""
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    if not _JIT_FACTORY:
        _JIT_FACTORY.append(
            BfvCiphertextFactory(slots=1024, engine="jx32", seed=11))
    return _JIT_FACTORY[0]


def _run_jit(inputs_src, program_src, output_src, options, factory):
    from abc_tpu.runtime.jit_executor import jit_compile_program
    jp = jit_compile_program(program_src, inputs_src, output_src, factory,
                             options=options)
    return jp.run()


def _assert_jit_matches_dummy(seed, inputs_src, program_src, output_src,
                              compare_spec):
    """compare_spec: [(name, n_slots)] or None (all outputs, 8 slots)."""
    base = run_with(inputs_src, program_src, output_src, ALL_ON)
    factory = _jit_factory()
    jit_out = _run_jit(inputs_src, program_src, output_src, ALL_ON, factory)
    if compare_spec is None:
        compare_spec = [(name, 8) for name, _ in base]
    for (bn, bv), (_, ncmp) in zip(base, compare_spec):
        jv = [int(v) for v in jit_out[bn]]
        assert bv[:ncmp] == jv[:ncmp], (
            f"seed {seed}: JIT diverged from tree-walker on {bn}\n"
            f"inputs: {inputs_src}\nprogram: {program_src}\n"
            f"walker={bv[:ncmp]} jit={jv[:ncmp]}")


@pytest.mark.parametrize("seed", range(25))
def test_jit_fuzz_read_programs(seed):
    """gen_program family (reads/rotates/loops/plain ifs) through the
    whole-program JIT; multiplicative depth capped for the n=1024 budget."""
    rng = random.Random(8000 + seed)
    while True:
        inputs_src, program_src, output_src, scalar_mixed = gen_program(rng)
        if program_src.count("acc * ") + program_src.count("* v") <= 2:
            break
    n_cmp = 1 if scalar_mixed else 8
    base = run_with(inputs_src, program_src, output_src, ALL_ON)
    spec = [(name, n_cmp) for name, _ in base]
    _assert_jit_matches_dummy(seed, inputs_src, program_src, output_src, spec)


@pytest.mark.parametrize("seed", range(25))
def test_jit_fuzz_write_programs(seed):
    """gen_vector_program family (vectorized write emissions) through the
    whole-program JIT."""
    rng = random.Random(9000 + seed)
    while True:
        inputs_src, program_src, output_src, outs = gen_vector_program(rng)
        if program_src.count("*") <= 2:     # depth cap for n=1024
            break
    _assert_jit_matches_dummy(seed, inputs_src, program_src, output_src, outs)


# ---------------------------------------------------------------------------
# 3. CKKS fuzz (approximate compare, rescale-aware depth cap)
# ---------------------------------------------------------------------------

def gen_ckks_program(rng: random.Random, slots: int):
    """(inputs_src, program_src, oracle): random float vector program with
    multiplicative depth ≤ 2; oracle = numpy float64 over `slots` lanes
    (last-element padding, rotations cyclic over the slot row)."""
    veclen = 8
    vecs = {}
    inputs = []
    for v in range(2):
        vals = [round(rng.uniform(-2.0, 2.0), 2) for _ in range(veclen)]
        inputs.append(f"secret double w{v} = {{{','.join(map(str, vals))}}};")
        padded = np.full(slots, vals[-1], dtype=np.float64)
        padded[:veclen] = vals
        vecs[f"w{v}"] = padded

    acc = vecs["w0"].copy()
    stmts = ["secret double acc = w0;"]
    depth = 0
    for _ in range(rng.randint(2, 5)):
        kind = rng.randrange(5)
        src = f"w{rng.randrange(2)}"
        if kind == 0:
            op = rng.choice(["+", "-"])
            stmts.append(f"acc = acc {op} {src};")
            acc = acc + vecs[src] if op == "+" else acc - vecs[src]
        elif kind == 1 and depth < 2:
            stmts.append(f"acc = acc * {src};")
            acc = acc * vecs[src]
            depth += 1
        elif kind == 2:
            steps = rng.randint(-3, 3)
            stmts.append(f"acc = acc + rotate({src}, {steps});")
            acc = acc + np.roll(vecs[src], -steps)
        elif kind == 3 and depth < 2:
            c = round(rng.uniform(0.5, 1.5), 2)
            stmts.append(f"acc = acc * {c};")
            acc = acc * c
            depth += 1
        else:
            c = round(rng.uniform(-1.0, 1.0), 2)
            stmts.append(f"acc = acc + {c};")
            acc = acc + c
    stmts.append("return acc;")
    return " ".join(inputs), " ".join(stmts), acc


@pytest.mark.parametrize("seed", range(50))
def test_ckks_fuzz_vs_numpy_oracle(seed):
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory

    factory = CkksCiphertextFactory(n=512, levels=4, engine="np64", seed=3,
                                    scale_bits=30)
    rng = random.Random(10_000 + seed)
    inputs_src, program_src, oracle = gen_ckks_program(
        rng, factory.slot_count)
    input_ast = Parser.parse(inputs_src)
    output_ast = Parser.parse("out = acc;")
    compiled = Compiler(ALL_ON).compile_source(
        program_src, input_types_from_ast(input_ast))
    rv = RuntimeVisitor(factory, input_ast, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    ((_, value),) = rv.get_output(output_ast)
    assert isinstance(value, AbstractCiphertext)
    got = np.asarray(factory.decrypt(value))
    assert np.allclose(got[:8], oracle[:8], atol=5e-2), (
        f"seed {seed}\ninputs: {inputs_src}\nprogram: {program_src}\n"
        f"got={got[:8]}\nwant={oracle[:8]}")


@pytest.mark.parametrize("seed", range(25))
def test_ckks_fuzz_tight_params(seed):
    """The same family under the TIGHT parameter regime auto-params picks
    for depth-2 circuits (levels=3, scale_bits=28): every depth-2 chain
    ends on ONE 30-bit limb, so any add that lifts scales upward instead
    of bridging the fresh side down wraps the last limb (the
    test_auto_params_fuzz seed-4 bug class). levels=4/scale_bits=30
    above masks that hazard; this pins it open."""
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory

    factory = CkksCiphertextFactory(n=512, levels=3, engine="np64", seed=3,
                                    scale_bits=28)
    rng = random.Random(12_000 + seed)
    inputs_src, program_src, oracle = gen_ckks_program(
        rng, factory.slot_count)
    input_ast = Parser.parse(inputs_src)
    output_ast = Parser.parse("out = acc;")
    compiled = Compiler(ALL_ON).compile_source(
        program_src, input_types_from_ast(input_ast))
    rv = RuntimeVisitor(factory, input_ast, compiled.secret_tainted)
    rv.execute_ast(compiled.ast)
    ((_, value),) = rv.get_output(output_ast)
    assert isinstance(value, AbstractCiphertext)
    got = np.asarray(factory.decrypt(value))
    assert np.allclose(got[:8], oracle[:8], atol=5e-2), (
        f"seed {seed}\ninputs: {inputs_src}\nprogram: {program_src}\n"
        f"got={got[:8]}\nwant={oracle[:8]}")


# ---------------------------------------------------------------------------
# 4. CKKS whole-program JIT fuzz (round 5 follow-up): the lazy
# relin/rescale backend's jit protocol (static (level, scale) metadata
# alongside traced arrays) under random programs
# ---------------------------------------------------------------------------

_CKKS_JIT_FACTORY = []


def _ckks_jit_factory():
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory
    if not _CKKS_JIT_FACTORY:
        _CKKS_JIT_FACTORY.append(CkksCiphertextFactory(
            n=512, levels=4, engine="jx32", seed=3, scale_bits=30))
    return _CKKS_JIT_FACTORY[0]


@pytest.mark.parametrize("seed", range(15))
def test_ckks_jit_fuzz_vs_numpy_oracle(seed):
    from abc_tpu.runtime.jit_executor import jit_compile_program

    factory = _ckks_jit_factory()
    rng = random.Random(11_000 + seed)
    inputs_src, program_src, oracle = gen_ckks_program(
        rng, factory.slot_count)
    jp = jit_compile_program(program_src, inputs_src, "out = acc;",
                             factory, options=ALL_ON)
    got = np.asarray(jp.run()["out"])
    assert np.allclose(got[:8], oracle[:8], atol=5e-2), (
        f"seed {seed}\ninputs: {inputs_src}\nprogram: {program_src}\n"
        f"got={got[:8]}\nwant={oracle[:8]}")


# ---------------------------------------------------------------------------
# 5. MESH-path fuzz (round 5, slow tier): random programs through the
# dp × limb compiled-mesh executor vs the single-device JIT
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("seed", range(5))
def test_mesh_jit_fuzz_matches_single_device(seed):
    import jax

    from abc_tpu.parallel.dryrun import build_context
    from abc_tpu.parallel.sharding import make_mesh
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = random.Random(12_000 + seed)
    while True:
        inputs_src, program_src, output_src, scalar_mixed = gen_program(rng)
        if program_src.count("acc * ") + program_src.count("* v") <= 1:
            break
    mesh = make_mesh(dp=2, limb=4)
    fac_mesh = BfvCiphertextFactory(
        context=build_context(n=256, data_limbs=4, seed=41))
    jp = jit_compile_program(program_src, inputs_src, output_src, fac_mesh,
                             options=ALL_ON, mesh=mesh)
    mesh_out = jp.run()

    fac_single = BfvCiphertextFactory(
        context=build_context(n=256, data_limbs=4, seed=41))
    jp1 = jit_compile_program(program_src, inputs_src, output_src,
                              fac_single, options=ALL_ON)
    single_out = jp1.run()
    n_cmp = 1 if scalar_mixed else 8
    for name, single_vals in single_out.items():
        for row in mesh_out[name]:      # every dp row same inputs
            assert [int(v) for v in row][:n_cmp] == \
                [int(v) for v in single_vals][:n_cmp], (
                f"seed {seed} {name}\nprogram: {program_src}\n"
                f"mesh={row[:n_cmp]} single={single_vals[:n_cmp]}")
