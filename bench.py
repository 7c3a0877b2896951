"""Benchmark harness: device measurements, printed as ONE JSON line.

    python bench.py                 # NTT + mult+relin batch curves, then
                                    # the staged suite (benchsuite.py)
    python bench.py --suite [N ...] # staged configs only, one line each
    python bench.py --out PATH      # full record (default
                                    # build/bench_suite.json)

The parent stays off JAX and runs each measurement in a worker process, one
after another, so only one process holds the card at a time. A worker that
fails, finds no accelerator, or reports a failed config makes bench.py exit
non-zero and name the phase. Every result names the device it ran on.

Curves: RNS-NTT butterflies/s at n=16384 over the full 14-limb chain and
BFV n=8192 ct·ct mult+relin ops/s, at B in BATCHES (B > 1 vmaps B
independent dependent chains). Each point is the median of K_EST two-point
chain estimates, per_op = (t(chain) - t(chain/2)) / (chain/2), which cancels
the fixed per-call cost. The mult+relin census counts the NTT rows and the
elementwise u32 ops of one multiply from an abstract trace (no compile).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SEAL_CPU_BASELINE_OPS_PER_S = 40.0
SEAL_CPU_NTT_BUTTERFLIES_PER_S = 2.0e8
N = 8192
N_NTT = 16384
CHAIN = 512        # dependent mult+relin ops per call at B=1 (÷B above)
CHAIN_NTT = 2048   # dependent forward transforms per call at B=1 (÷B above)
BATCHES = (1, 8, 16, 64)
REPEATS = 3        # timed calls per chain length within one estimate
K_EST = 5          # independent two-point estimates; median + min/max
WORKER_TIMEOUT_S = 1500
SUITE_TIMEOUT_S = 3000

_WORKER = r"""
import json, sys, time
import numpy as np
import jax, jax.numpy as jnp
from abc_tpu.utils.compcache import enable_persistent_cache
enable_persistent_cache()
if jax.default_backend() == "cpu":
    raise SystemExit("bench worker found no accelerator")
from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu.crypto.ntt import NttContext
from abc_tpu.crypto.params import BfvParams

N, N_NTT, REPEATS, K_EST = %d, %d, %d, %d
CHAIN, CHAIN_NTT, BATCHES = %d, %d, %r

def timed(f, *args):
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)

def estimates(make_chain, chain, *args):
    # host contention can invert a pair (t_full < t_half): such pairs are
    # dropped and retried; a run where nothing validates reports nan
    fulls = {}
    def t(c):
        if c not in fulls:
            fulls[c] = make_chain(c)
        return timed(fulls[c], *args)
    out, fixed, attempts = [], [], 0
    while len(out) < K_EST and attempts < 3 * K_EST:
        attempts += 1
        t_full, t_half = t(chain), t(chain // 2)
        per = (t_full - t_half) / (chain // 2)
        if per <= 0:
            continue
        out.append(per)
        fixed.append(2 * t_half - t_full)
    if not out:
        return float("nan"), float("nan"), float("nan"), 0.0
    out.sort()
    return out[len(out) // 2], out[0], out[-1], sorted(fixed)[len(fixed)//2]

# --- ct-ct mult+relin at n=8192 (config 2) ---------------------------------
ctx = BfvContext(BfvParams.create(N, engine="jx32", seed=123))
ctx.ensure_eval_ready()
ctx.get_relin_key()
a = ctx.encrypt(ctx.encode([1, 2, 3, 4]))
b = ctx.encrypt(ctx.encode([5, 6, 7, 8]))

def mult(x, y):
    return ctx.multiply(BfvCiphertext(x), BfvCiphertext(y)).data

def make_chain(c):
    def chain(x, y):
        return jax.lax.fori_loop(0, c, lambda i, v: mult(v, y), x)
    return chain

mult_curve = {}
a0, b0 = jnp.asarray(a.data), jnp.asarray(b.data)
for B in BATCHES:
    if B == 1:
        mk = lambda c: jax.jit(make_chain(c))
        aB, bB = a0, b0
    else:
        mk = lambda c: jax.jit(jax.vmap(make_chain(c)))
        aB = jnp.broadcast_to(a0[None], (B,) + a0.shape)
        bB = jnp.broadcast_to(b0[None], (B,) + b0.shape)
    med, lo, hi, fixed = estimates(mk, max(8, CHAIN // B), aB, bB)
    mult_curve[B] = {"ops_per_s": B / med,
                     "ops_per_s_min": B / hi, "ops_per_s_max": B / lo,
                     "fixed_call_ms": fixed * 1e3}
    print(f"mult+relin B={B}: {B / med} ops/s", file=sys.stderr, flush=True)

# --- mult+relin census: one abstract trace of the same step ------------------
census = {"ntt_rows": 0, "elem_ops": 0, "_in_ntt": 0}

def _counted(orig):
    # engine ops inside a transform are the NTT's own; elem_ops counts only
    # the BEHZ/key-switch elementwise work
    def g(x):
        census["ntt_rows"] += int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
        census["_in_ntt"] += 1
        try:
            return orig(x)
        finally:
            census["_in_ntt"] -= 1
    return g

_saved = []
for inst in {id(i): i for i in (ctx.ntt_q, ctx.ntt_qp, ctx._behz.ntt_q,
                                ctx._behz.ntt_bsk)}.values():
    _saved.append((inst, inst.fwd, inst.inv))
    inst.fwd, inst.inv = _counted(inst.fwd), _counted(inst.inv)

from abc_tpu.ops.modarith import jx32 as _jx
_OPS_PER_EL = {"mul": 19, "add": 2, "sub": 2, "neg": 2, "mul_shoup": 6}
_orig_ops = {k: getattr(_jx, k) for k in _OPS_PER_EL}
def _wrap_op(orig, cost):
    def f(*args):
        if not census["_in_ntt"]:
            shapes = [getattr(x, "shape", ()) for x in args[:2]]
            census["elem_ops"] += cost * int(
                np.prod(np.broadcast_shapes(*shapes)))
        return orig(*args)
    return staticmethod(f)
for _k, _orig in _orig_ops.items():
    setattr(_jx, _k, _wrap_op(_orig, _OPS_PER_EL[_k]))
try:
    jax.eval_shape(mult, a0, b0)
finally:
    for inst, f, i in _saved:
        inst.fwd, inst.inv = f, i
    for _k, _orig in _orig_ops.items():
        setattr(_jx, _k, _orig)

# --- RNS-NTT butterflies/s at n=16384, full 14-limb chain --------------------
moduli = list(BfvParams.create(N_NTT, engine="jx32", seed=5).coeff_modulus)
ntt = NttContext(N_NTT, moduli, engine="jx32")
rows = len(moduli)
rng = np.random.default_rng(0)
x0 = jnp.asarray(rng.integers(0, min(moduli), size=(rows, N_NTT),
                              dtype=np.uint64).astype(np.uint32))

def make_ntt_chain(c):
    return jax.jit(lambda v: jax.lax.fori_loop(0, c, lambda i, u: ntt.fwd(u),
                                               v))

butterflies_per_fwd = rows * (N_NTT // 2) * (N_NTT.bit_length() - 1)
ntt_curve = {}
for B in BATCHES:
    xB = x0 if B == 1 else jnp.broadcast_to(x0[None], (B,) + x0.shape)
    med, lo, hi, fixed = estimates(make_ntt_chain, max(16, CHAIN_NTT // B), xB)
    ntt_curve[B] = {
        "Gbf_s": B * butterflies_per_fwd / med / 1e9,
        "Gbf_s_min": B * butterflies_per_fwd / hi / 1e9,
        "Gbf_s_max": B * butterflies_per_fwd / lo / 1e9,
        "us_per_fwd": med * 1e6 / B,
        "fixed_call_ms": fixed * 1e3,
    }
    print(f"ntt B={B}: {med * 1e6 / B} us/fwd", file=sys.stderr, flush=True)

d = jax.devices()[0]
print(json.dumps({
    "device": {"platform": d.platform, "kind": d.device_kind,
               "count": len(jax.devices())},
    "timing_protocol": "median of %%d two-point chain estimates" %% K_EST,
    "mult_relin_curve": mult_curve,
    "ntt_curve": ntt_curve,
    "ntt_rows": rows,
    "mult_relin_census": {k: v for k, v in census.items()
                          if not k.startswith("_")},
}))
""" % (N, N_NTT, REPEATS, K_EST, CHAIN, CHAIN_NTT, BATCHES)

_SUITE_WORKER = r"""
import json
import jax
from abc_tpu.utils.compcache import enable_persistent_cache
enable_persistent_cache()
if jax.default_backend() == "cpu":
    raise SystemExit("bench suite worker found no accelerator")
from abc_tpu.benchsuite import run_suite_dict
d = jax.devices()[0]
out = run_suite_dict(fast=True)
out["device"] = {"platform": d.platform, "kind": d.device_kind,
                 "count": len(jax.devices())}
print(json.dumps(out))
"""


def _run_worker(code: str, timeout: float):
    """Run one worker; its last stdout line parsed as JSON, or an error
    string saying why there is none. The worker's stderr (its progress and
    tracebacks) passes straight through, so a killed run shows how far it
    got."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + \
        os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           stdout=subprocess.PIPE, text=True, timeout=timeout,
                           env=env)
    except subprocess.TimeoutExpired:
        return f"timed out after {timeout} s"
    if r.returncode != 0:
        return f"exit {r.returncode} (its stderr is above)"
    lines = r.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        return f"no JSON result line: {r.stdout.strip()[-500:]}"


def _mult_relin_census(result):
    """The mult+relin op census of one multiply: NTT rows and elementwise
    u32 ops, and the rows per measured second at B=1."""
    census = result.get("mult_relin_census")
    m1 = result.get("mult_relin_curve", {}).get("1") or \
        result.get("mult_relin_curve", {}).get(1)
    if not census or not m1 or not m1.get("ops_per_s"):
        return {"error": "census or measurements missing"}
    return {"ntt_rows": census["ntt_rows"],
            "elem_u32_ops": census["elem_ops"],
            "ntt_rows_per_s": census["ntt_rows"] * m1["ops_per_s"]}


def _failed_configs(suite: dict) -> list:
    return sorted(k for k, v in suite.items()
                  if isinstance(v, dict) and "error" in v)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--suite":
        from abc_tpu.benchsuite import run_suite
        return run_suite([int(x) for x in argv[1:]] or None)
    here = os.path.dirname(os.path.abspath(__file__))
    out_path = os.path.join(here, "build", "bench_suite.json")
    if argv[:1] == ["--out"]:
        out_path = argv[1]

    result = _run_worker(_WORKER, WORKER_TIMEOUT_S)
    if not isinstance(result, dict):
        print(f"bench.py: curves worker failed: {result}", file=sys.stderr)
        return 1
    suite = _run_worker(_SUITE_WORKER, SUITE_TIMEOUT_S)
    if not isinstance(suite, dict):
        print(f"bench.py: suite worker failed: {suite}", file=sys.stderr)
        return 1
    device = result["device"]
    ntt_curve = result["ntt_curve"]
    mult_curve = result["mult_relin_curve"]
    n1, m8 = ntt_curve["1"], mult_curve.get("8", {})
    full = {
        "device": device,
        "ntt": {
            "metric": f"rns_ntt_butterflies_per_s_n{N_NTT}"
                      f"_L{result['ntt_rows']}",
            "unit": "Gbutterflies/s",
            "timing": result["timing_protocol"],
            "batch_curve": ntt_curve,
            "vs_baseline": n1["Gbf_s"] * 1e9 / SEAL_CPU_NTT_BUTTERFLIES_PER_S,
        },
        "mult_relin": {
            "metric": f"bfv_n{N}_ct_mult_relin",
            "unit": "ops/s",
            "batch_curve": mult_curve,
            "census": _mult_relin_census(result),
            "vs_baseline": m8.get("ops_per_s", 0.0)
            / SEAL_CPU_BASELINE_OPS_PER_S,
        },
        "suite": suite,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(full, f, indent=1)
    line = {
        "metric": full["ntt"]["metric"],
        "value": n1["Gbf_s"],
        "unit": "Gbutterflies/s",
        "device": device,
        "spread": [n1["Gbf_s_min"], n1["Gbf_s_max"]],
        "ntt_Gbf_s_by_batch": {b: v["Gbf_s"] for b, v in ntt_curve.items()},
        "mult_relin_ops_s_by_batch": {b: v["ops_per_s"]
                                      for b, v in mult_curve.items()},
        "suite": _compact_suite(suite),
        "full": out_path,
    }
    failed = _failed_configs(suite)
    if failed:
        line["failed"] = failed
    print(json.dumps(line))
    if failed:
        print(f"bench.py: suite configs failed: {failed}", file=sys.stderr)
        return 1
    return 0


def _compact_suite(suite):
    """Digest the staged-suite dict down to config → headline value."""
    if not isinstance(suite, dict):
        return "suite worker failed/timed out"
    digest = {}
    for k, v in sorted(suite.items()):
        if not k.startswith("config") or not isinstance(v, dict):
            continue
        entry = {"value": v.get("value"), "unit": v.get("unit", "")[:48]}
        if "error" in v:
            entry["error"] = str(v["error"])[:60]
        if "csv_schema" in v:
            entry["csv"] = v["csv_schema"]
        digest[k] = entry
    return digest


if __name__ == "__main__":
    sys.exit(main())
