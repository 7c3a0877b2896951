"""Collective-traffic census of a compiled sharded program.

The reference has no distributed backend at all (SURVEY.md §2.6 —
"Distributed communication backend: absent"); for this rebuild the
scaling story is governed by how many bytes each mesh axis moves per step.
This module extracts that number from the OPTIMIZED HLO of a compiled
jitted function: every all-reduce / all-gather / all-to-all /
collective-permute / reduce-scatter op is counted with its payload bytes
(shape product × dtype size). The result feeds SCALING.md and the
production-shape multichip dryrun artifact.
"""

from __future__ import annotations

import re
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1, "u8": 1, "s8": 1, "u16": 2, "s16": 2, "bf16": 2, "f16": 2,
    "u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8, "f64": 8,
}

# "%all-reduce.7 = u32[7,8192] all-reduce(...)" or tuple-typed variants;
# -start forms appear when the compiler splits a collective for overlap.
_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[^\s(]+))\s+"
    r"(all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter)"
    r"(-start)?\(")
_SHAPE_RE = re.compile(r"(pred|bf16|f16|f32|f64|u8|u16|u32|u64|s8|s16|s32|s64)"
                       r"\[([0-9,]*)\]")


def _type_bytes(type_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        size = _DTYPE_BYTES[dtype]
        count = 1
        for d in dims.split(","):
            if d:
                count *= int(d)
        total += count * size
    return total


def hlo_collective_stats(hlo_text: str) -> Dict[str, Dict[str, int]]:
    """{collective kind: {"ops": count, "bytes": payload bytes}} for one
    optimized-HLO module text (output shapes; -done ops are skipped so
    split -start/-done pairs count once)."""
    stats: Dict[str, Dict[str, int]] = {}
    for m in _COLL_RE.finditer(hlo_text):
        kind = m.group(2)
        entry = stats.setdefault(kind, {"ops": 0, "bytes": 0})
        entry["ops"] += 1
        entry["bytes"] += _type_bytes(m.group(1))
    return stats


def collective_report(jitted, *args) -> Dict[str, Dict[str, int]]:
    """Compile `jitted` (a jax.jit-wrapped callable) for `args` and census
    its collectives. Uses the same executable cache as a direct call."""
    compiled = jitted.lower(*args).compile()
    texts = compiled.as_text()
    if isinstance(texts, (list, tuple)):  # one module per partition
        texts = "\n".join(texts)
    return hlo_collective_stats(texts)


def format_report(stats: Dict[str, Dict[str, int]]) -> str:
    if not stats:
        return "no collectives"
    parts = [f"{k}: {v['ops']} ops / {v['bytes'] / 1e6:.3f} MB"
             for k, v in sorted(stats.items())]
    return ", ".join(parts)
