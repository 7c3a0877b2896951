"""abc_tpu — an FHE compiler and execution stack on JAX.

A brand-new framework with the capabilities of the MarbleHE/ABC optimizing FHE
compiler (reference: /root/reference): a C-like DSL with a `secret` type
qualifier is parsed into an AST IR, transformed by compiler passes
(type/secrecy inference, secret-branch circuit lowering, compile-time
expression simplification, loop unrolling, cone rewriting for multiplicative
depth, automatic SIMD batching), and executed by a runtime whose FHE engine is
JAX RNS polynomial arithmetic on an NVIDIA GPU instead of Microsoft SEAL on
the CPU.

Layering (mirrors reference layer map, SURVEY.md §1):
  ast_ir   — IR core            (ref: include/ast_opt/ast/)
  parser   — DSL frontend       (ref: include/ast_opt/parser/)
  utils    — scopes/operators   (ref: include/ast_opt/utilities/)
  passes   — compiler passes    (ref: include/ast_opt/visitor/)
  runtime  — program execution  (ref: include/ast_opt/runtime/)
  crypto   — BFV/CKKS RNS engine (ref: external Microsoft SEAL)
  ops      — modular arithmetic, the CUDA NTT kernel and the C++ host
             engine (ref: SEAL's native C++ kernels)
  parallel — device-mesh sharding of ciphertexts (no reference equivalent)
"""

__version__ = "0.2.0"

# the one-stop API: parse → compile → run (see README Quick start)
from abc_tpu.parser import Parser  # noqa: F401,E402
from abc_tpu.passes.pipeline import (  # noqa: F401,E402
    CompileOptions, Compiler, compile_program, input_types_from_ast,
    run_compiled,
)
