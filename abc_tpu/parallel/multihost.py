"""Multi-process execution harness on the CPU.

The reference is a single-process CPU program (SURVEY.md §2.6: "Distributed
communication backend: absent"). This module runs the sharded programs
across several PROCESSES on one machine, each a JAX process on the CPU
platform with virtual devices, joined by `jax.distributed` with Gloo
collectives. It exercises the multi-process code path (device placement,
process-spanning meshes, cross-process psum/ppermute) that
single-process `xla_force_host_platform_device_count` meshes cannot. It is
a CPU harness: one process per GPU across hosts is not built yet.

  * `init_multihost` — `jax.distributed.initialize` on the CPU platform.
  * Two mesh layouts for the BFV batched-rotation step
    (parallel/dryrun.py):
      - `batch-over-dcn`: dp axis = processes (each owns a batch shard; no
        cross-process traffic in the step), limb axis = local devices.
      - `limb-over-dcn`: limb axis = processes, so the key-switch
        decomposition contraction psums ACROSS processes.
  * CKKS coefficient sharding over ALL devices of ALL hosts: the
    distributed NTT's ppermute butterfly exchanges cross the host boundary
    (parallel/dist_ntt.py).
  * A launcher (`python -m abc_tpu.parallel.multihost --nproc N`) that
    spawns N worker processes on this machine, collects their JSON
    reports, and prints a summary line — the same harness
    tests/test_multihost.py runs in CI.

Every worker decrypts its addressable output shards and a
`process_allgather` (itself a cross-process collective) cross-checks that
all processes agree bit-exactly with the single-process oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_count: int = 4) -> None:
    """Initialize jax.distributed for one worker process on the CPU
    platform with `local_device_count` virtual devices (Gloo collectives).
    Must run before any other JAX use in the process."""
    import re
    flags = os.environ.get("XLA_FLAGS", "")
    # REPLACE any inherited value (e.g. the test conftest's 8-device flag)
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    os.environ["XLA_FLAGS"] = (
        flags +
        f" --xla_force_host_platform_device_count={local_device_count}"
    ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def host_chip_mesh(layout: str = "batch-over-dcn"):
    """A (dp × limb) mesh spanning every device of every process.

    batch-over-dcn: dp=processes, limb=local devices (local key-switch psum).
    limb-over-dcn:  dp=local devices, limb=processes (cross-process psum).
    """
    import jax
    from jax.sharding import Mesh

    nproc = jax.process_count()
    local = jax.local_device_count()
    devs = np.asarray(jax.devices()).reshape(nproc, local)
    if layout == "batch-over-dcn":
        return Mesh(devs, ("dp", "limb"))
    if layout == "limb-over-dcn":
        return Mesh(devs.T, ("dp", "limb"))
    raise ValueError(f"unknown layout {layout!r}")


def _global_array(mesh, spec, host_np):
    """Distribute a host-replicated numpy array over the mesh (every
    process holds the full array; each device gets its slice)."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_np.shape, sharding, lambda idx: host_np[idx])


def run_multihost_bfv(layout: str, n: int = 256, data_limbs: int = None,
                      batch_per_dp: int = 2, repeats: int = 3,
                      verbose: bool = True) -> Dict:
    """The full sharded BFV step (add + Galois rotation with sharded
    key switch) on a process-spanning mesh; returns a timing/traffic report
    and asserts bit-exact decryption on every host."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from abc_tpu.crypto.bfv import BfvCiphertext
    from abc_tpu.parallel.dryrun import build_context, make_multichip_step
    from abc_tpu.parallel.report import collective_report

    mesh = host_chip_mesh(layout)
    dp, limb = mesh.shape["dp"], mesh.shape["limb"]
    if data_limbs is None:
        data_limbs = limb
    else:          # round up to a multiple of the limb mesh axis
        data_limbs = limb * (-(-data_limbs // limb))
    ctx = build_context(n=n, data_limbs=data_limbs, seed=11)

    B = batch_per_dp * dp
    batch_vals = [[(i + j + 1) % 7 + 1 for j in range(4)] for i in range(B)]
    # deterministic on every process (same seed) → identical ciphertexts
    a_np = np.stack([np.asarray(ctx.encrypt(ctx.encode(v)).data)
                     for v in batch_vals])
    b_np = np.stack([np.asarray(ctx.encrypt(ctx.encode(v)).data)
                     for v in batch_vals])
    kb, ka = ctx.get_galois_key(pow(3, 1, 2 * n))
    kb_np, ka_np = np.asarray(kb), np.asarray(ka)

    a = _global_array(mesh, P("dp"), a_np)
    b = _global_array(mesh, P("dp"), b_np)
    ksk_b = _global_array(mesh, P("limb", None, None), kb_np)
    ksk_a = _global_array(mesh, P("limb", None, None), ka_np)

    step = make_multichip_step(ctx, mesh)
    out = jax.block_until_ready(step(a, b, ksk_b, ksk_a))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(step(a, b, ksk_b, ksk_a))
        times.append(time.perf_counter() - t0)

    # every host decrypts ITS addressable output shards and checks them
    # (dedupe: the batch shard of one dp row is replicated across that
    # row's limb-axis devices)
    checked = 0
    seen = set()
    for shard in out.addressable_shards:
        if shard.index in seen:
            continue
        seen.add(shard.index)
        data = np.asarray(shard.data)
        i0 = shard.index[0].start or 0
        for k in range(data.shape[0]):
            got = ctx.decode(ctx.decrypt(BfvCiphertext(data[k])))[:3]
            expected = [2 * v for v in batch_vals[i0 + k][1:4]]
            assert got == expected, \
                f"host {jax.process_index()} shard {i0 + k}: " \
                f"{got} != {expected}"
            checked += 1

    # cross-host agreement: allgather each host's checked count + a content
    # checksum of its local shards — a real cross-process collective
    uniq = {s.index: s for s in out.addressable_shards}
    local_sum = int(sum(int(np.asarray(s.data, dtype=np.uint64).sum())
                        for s in uniq.values()) % (2 ** 31))
    gathered = multihost_utils.process_allgather(
        np.asarray([checked, local_sum], dtype=np.int64))
    traffic = collective_report(step, a, b, ksk_b, ksk_a)
    report = {
        "layout": layout, "nproc": jax.process_count(),
        "mesh": {"dp": dp, "limb": limb},
        "n": n, "L": ctx.params.L, "batch": B,
        "step_ms": round(min(times) * 1e3, 3),
        "ct_shards_checked_this_host": checked,
        "ct_shards_checked_all_hosts": int(gathered[:, 0].sum()),
        "shard_checksums": gathered[:, 1].tolist(),
        "collectives": traffic,
    }
    if verbose and jax.process_index() == 0:
        print("multihost BFV OK:", json.dumps(report), flush=True)
    return report


def run_multihost_compiled(n: int = 256, verbose: bool = True) -> Dict:
    """The COMPILED hamming workload (full pipeline + whole-program JIT,
    runtime/jit_executor mesh mode) on a PROCESS-SPANNING dp × limb mesh:
    dp = hosts (one batch shard per host, zero cross-host bytes), limb =
    per-host devices (key-switch psum inside each host). Every process
    compiles the same program with the same seeds, so the global arrays
    JittedProgram places are value-identical across processes (the jax
    multi-process contract). Each host decrypts ITS addressable output
    shards against the oracle; an allgather cross-checks the counts."""
    import jax
    from jax.experimental import multihost_utils

    from abc_tpu.parallel.dryrun import build_context
    from abc_tpu.parallel.report import collective_report
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu.runtime.jit_executor import jit_compile_program

    mesh = host_chip_mesh("batch-over-dcn")
    dp, limb = mesh.shape["dp"], mesh.shape["limb"]
    # ≥4 data limbs (multiple of the limb axis): the hamming circuit needs
    # ~60 noise bits + the 20-bit plaintext, beyond a 2-limb chain
    data_limbs = limb * (-(-4 // limb))
    ctx = build_context(n=n, data_limbs=data_limbs, seed=33)
    fac = BfvCiphertextFactory(context=ctx)
    B = 2 * dp
    rng = np.random.default_rng(7)
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(B)]
    src = ("int sum = 0;"
           "for (int i = 0; i < n; i = i + 1) {"
           "  sum = sum + (x[i]-y[i])*(x[i]-y[i]);"
           "}"
           "return sum;")
    jp = jit_compile_program(
        src,
        f"secret int x = {{{','.join(map(str, xs[0]))}}}; "
        f"secret int y = {{{','.join(map(str, ys[0]))}}}; int n = 4;",
        "out = sum;", fac, mesh=mesh, batch_values={"x": xs, "y": ys})
    import jax as _jax
    raw = _jax.block_until_ready(jp.run_raw(jp.secret_inputs))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _jax.block_until_ready(jp.run_raw(jp.secret_inputs))
        times.append(time.perf_counter() - t0)
    arr = raw["out"]
    oracle = [sum(int(a != b) for a, b in zip(x, y))
              for x, y in zip(xs, ys)]
    checked = 0
    seen = set()
    for shard in arr.addressable_shards:
        if shard.index in seen:
            continue
        seen.add(shard.index)
        data = np.asarray(shard.data)
        i0 = shard.index[0].start or 0
        for k in range(data.shape[0]):
            got = fac.decrypt(fac.jit_unpack(data[k],
                                             jp._out_meta["out"]))[0]
            assert got == oracle[i0 + k], \
                f"host {jax.process_index()} batch {i0 + k}: " \
                f"{got} != {oracle[i0 + k]}"
            checked += 1
    gathered = multihost_utils.process_allgather(
        np.asarray([checked], dtype=np.int64))
    report = {
        "workload": "hamming via full pipeline (jit_compile_program mesh)",
        "nproc": jax.process_count(), "mesh": {"dp": dp, "limb": limb},
        "n": n, "L": ctx.params.L, "batch": B,
        "step_ms": round(min(times) * 1e3, 3),
        "ct_shards_checked_this_host": checked,
        "ct_shards_checked_all_hosts": int(gathered.sum()),
        "collectives": collective_report(jp._jitted, jp.secret_inputs,
                                         jp._key_args),
    }
    if verbose and jax.process_index() == 0:
        print("multihost COMPILED-PROGRAM OK:", json.dumps(report),
              flush=True)
    return report


def run_multihost_ckks(n: int = 256, levels: int = 3,
                       verbose: bool = True) -> Dict:
    """CKKS multiply+relin with coefficients sharded over EVERY device of
    every process: the distributed NTT's ppermute exchanges cross processes."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from abc_tpu.crypto.ckks import CkksCiphertext, CkksContext, CkksParams
    from abc_tpu.parallel.dist_ckks import DistCkksMultiplier
    from abc_tpu.parallel.report import collective_report

    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, ("coeff",))
    params = CkksParams.create(n, levels=levels, engine="jx32", seed=13)
    ctx = CkksContext(params)
    ctx.get_relin_key()
    dist = DistCkksMultiplier(ctx, mesh)
    vals = np.linspace(0.1, 0.9, n // 2)
    ca = np.asarray(ctx.encrypt(ctx.encode(vals)).data)
    cb = np.asarray(ctx.encrypt(ctx.encode(vals)).data)
    # ciphertexts replicated in; output replicated out (the final
    # all-gather is itself a cross-host collective) so every process can
    # decrypt the full result
    level = params.L
    jitted = jax.jit(dist, out_shardings=NamedSharding(mesh, P()))
    a = _global_array(mesh, P(), ca)
    b = _global_array(mesh, P(), cb)
    prod = jax.block_until_ready(jitted(a, b, dist.ksk_b, dist.ksk_a))
    prod_np = np.asarray(prod)
    ct = CkksCiphertext(prod_np, level, params.scale * params.scale)
    got = ctx.decode(ctx.decrypt(ct)).real[:n // 2]
    err = float(np.max(np.abs(got - vals * vals)))
    assert err < 0.05, f"coeff-shard mismatch across hosts: err={err}"
    report = {
        "nproc": jax.process_count(), "coeff_devices": len(devs),
        "n": n, "L": params.L, "max_err": round(err, 6),
        "collectives": collective_report(jitted, a, b,
                                         dist.ksk_b, dist.ksk_a),
    }
    if verbose and jax.process_index() == 0:
        print("multihost CKKS OK:", json.dumps(report), flush=True)
    return report


# --------------------------------------------------------------------------
# worker / launcher CLI

def _worker_main(args) -> None:
    init_multihost(args.coordinator, args.nproc, args.process_id,
                   args.local_devices)
    import jax
    out = {"process_id": args.process_id,
           "process_count": jax.process_count(),
           "global_devices": jax.device_count()}
    n_bfv = args.n_bfv or args.n
    limbs = args.bfv_limbs or None
    out["bfv_batch_over_dcn"] = run_multihost_bfv(
        "batch-over-dcn", n=n_bfv, data_limbs=limbs, verbose=False)
    out["bfv_limb_over_dcn"] = run_multihost_bfv(
        "limb-over-dcn", n=n_bfv, data_limbs=limbs, verbose=False)
    out["compiled_program"] = run_multihost_compiled(
        n=min(n_bfv, 512), verbose=False)
    if args.ckks:
        out["ckks_coeff_sharded"] = run_multihost_ckks(
            n=args.n_ckks or args.n, levels=args.levels, verbose=False)
    print("MHRESULT " + json.dumps(out), flush=True)


def launch(nproc: int, local_devices: int = 4, n: int = 256,
           ckks: bool = True, timeout_s: float = 900,
           n_bfv: int = 0, n_ckks: int = 0, bfv_limbs: int = 0,
           levels: int = 3) -> List[Dict]:
    """Spawn nproc worker processes on this machine and collect their
    reports. Returns the per-process result dicts (sorted by process id)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(nproc):
        cmd = [sys.executable, "-m", "abc_tpu.parallel.multihost", "worker",
               "--coordinator", coordinator, "--nproc", str(nproc),
               "--process-id", str(pid),
               "--local-devices", str(local_devices), "--n", str(n),
               "--n-bfv", str(n_bfv), "--n-ckks", str(n_ckks),
               "--bfv-limbs", str(bfv_limbs), "--levels", str(levels)]
        if ckks:
            cmd.append("--ckks")
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env))
    results = []
    deadline = time.time() + timeout_s
    for p in procs:
        remaining = max(1.0, deadline - time.time())
        try:
            stdout, stderr = p.communicate(timeout=remaining)
        except subprocess.TimeoutExpired:
            for q in procs:   # kill exactly the PIDs we started
                if q.poll() is None:
                    q.kill()
            raise RuntimeError("multihost worker timed out")
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost worker failed (rc={p.returncode}):\n"
                f"{stderr[-2000:]}")
        for line in stdout.splitlines():
            if line.startswith("MHRESULT "):
                results.append(json.loads(line[len("MHRESULT "):]))
    results.sort(key=lambda r: r["process_id"])
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="abc_tpu.parallel.multihost")
    sub = ap.add_subparsers(dest="cmd")
    w = sub.add_parser("worker")
    w.add_argument("--coordinator", required=True)
    w.add_argument("--nproc", type=int, required=True)
    w.add_argument("--process-id", type=int, required=True)
    w.add_argument("--local-devices", type=int, default=4)
    w.add_argument("--n", type=int, default=256)
    w.add_argument("--n-bfv", type=int, default=0)
    w.add_argument("--n-ckks", type=int, default=0)
    w.add_argument("--bfv-limbs", type=int, default=0)
    w.add_argument("--levels", type=int, default=3)
    w.add_argument("--ckks", action="store_true")
    ln = sub.add_parser("launch")
    ln.add_argument("--nproc", type=int, default=2)
    ln.add_argument("--local-devices", type=int, default=4)
    ln.add_argument("--n", type=int, default=256)
    ln.add_argument("--production", action="store_true",
                    help="BASELINE production shapes: BFV n=8192 L=8 "
                         "dp x limb, CKKS n=32768 L=8 coeff-sharded")
    ln.add_argument("--no-ckks", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "worker":
        _worker_main(args)
    else:
        nproc = getattr(args, "nproc", 2)
        kw = {}
        if getattr(args, "production", False):
            kw = dict(n_bfv=8192, bfv_limbs=8, n_ckks=32768, levels=8,
                      timeout_s=3600)
        results = launch(nproc, args.local_devices, args.n,
                         ckks=not args.no_ckks, **kw)
        print(json.dumps({"nproc": nproc, "ok": True,
                          "process0": results[0]}, indent=2))


if __name__ == "__main__":
    main()
