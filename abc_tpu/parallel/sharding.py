"""Multi-chip sharding of FHE evaluation over a jax.sharding.Mesh.

The reference is single-process/single-threaded (SURVEY.md §2.6); its only
parallel axis is ciphertext SIMD slots. The device axes added here:

  * dp   — data parallelism over a BATCH of ciphertexts (independent lanes)
  * limb — key-switch decomposition parallelism: the hybrid key-switch inner
           product Σ_i D_i ⊙ ksk_i contracts over the L decomposition limbs;
           sharding i across devices makes each device NTT + multiply only
           its slice of the switching key, then one psum combines the
           [L+1, n] accumulators. The per-device win: the O(L·(L+1)·n)
           NTT/multiply work scales 1/devices while only 2·(L+1)·n words
           cross the interconnect.

All functions are shard_map-based and jit-able end to end.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from abc_tpu.crypto.bfv import BfvContext

try:
    from jax import shard_map as _shard_map          # jax ≥ 0.8
except ImportError:                                   # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map


def make_mesh(dp: int = 1, limb: int = 1,
              devices: Optional[list] = None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if dp * limb > len(devices):
        raise ValueError(f"mesh {dp}x{limb} needs {dp * limb} devices, "
                         f"have {len(devices)}")
    dev_array = np.asarray(devices[:dp * limb]).reshape(dp, limb)
    return Mesh(dev_array, ("dp", "limb"))


def _local_key_switch_partials(ctx: BfvContext, d, ksk_b, ksk_a,
                               perm_eval=None):
    """Per-shard key-switch work: lift + NTT + multiply THIS shard's
    decomposition limbs, returning partial accumulators over the full base.

    d:      [Lk, n]   this shard's decomposition-limb residues
    ksk_*:  [Lk, L+1, n] this shard's slice of the switching key
    perm_eval: optional NTT-domain Galois permutation applied to the
               decomposition AFTER its forward NTTs (the hoisted rotation
               formulation, matching BfvContext.apply_galois)
    returns ([L+1, n], [L+1, n]) partial sums (pre-psum)
    """
    if ctx.params.ks_digits != 1:
        raise ValueError(
            "limb-sharded key switching implements the k=1 layout; build "
            "the context with ks_digits=1")
    full = ctx.params.L + 1
    n = ctx.params.n
    Lk = d.shape[0]
    q_full = ctx._tab["q_full"].reshape(1, full, 1)
    mu_full = ctx._tab["mu_full"].reshape(1, full, 1)
    e = ctx.engine
    lifted = jnp.broadcast_to(d[:, None, :], (Lk, full, n))
    lifted = jnp.where(lifted >= q_full, lifted - q_full, lifted)
    D = ctx.ntt_qp.fwd(lifted)
    if perm_eval is not None:
        D = D[..., perm_eval]
    tb = e.mul(D, ksk_b, q_full, mu_full)
    ta = e.mul(D, ksk_a, q_full, mu_full)
    # local accumulation (modular): fold over this shard's limbs
    acc_b, acc_a = tb[0], ta[0]
    for k in range(1, Lk):
        acc_b = e.add(acc_b, tb[k], ctx._tab["q_full"])
        acc_a = e.add(acc_a, ta[k], ctx._tab["q_full"])
    return acc_b, acc_a


def _psum_mod(x, q, mu, axis_name, engine):
    """Modular psum: residues x < q < 2^30 summed across the mesh axis.

    Direct psum would overflow uint32 (k·q ≥ 2^32 for k ≥ 4), so psum the
    16-bit halves separately (exact: k·2^16 ≪ 2^32 for any realistic mesh),
    then recombine mod q with one Barrett multiply:
        value = hi_s·2^16 + lo_s,  r = hi_s·2^16 mod q + lo_s mod q.
    Valid for up to 2^14 devices along the axis.
    """
    lo_s = jax.lax.psum(x & jnp.uint32(0xFFFF), axis_name)   # < k·2^16
    hi_s = jax.lax.psum(x >> 16, axis_name)                  # < k·2^14
    hi_part = engine.mul(hi_s, jnp.broadcast_to(jnp.uint32(1 << 16), q.shape),
                         q, mu)
    lo_red = jnp.where(lo_s >= q, lo_s - q, lo_s)            # lo_s < 2·q
    lo_red = jnp.where(lo_red >= q, lo_red - q, lo_red)
    return engine.add(hi_part, lo_red, q)


def sharded_key_switch(ctx: BfvContext, mesh: Mesh, d, ksk) -> Tuple:
    """Key switch with the decomposition axis sharded over mesh axis "limb".

    d: [L, n] replicated; ksk: ([L, L+1, n], [L, L+1, n]) sharded on axis 0.
    Returns (k0, k1) [L, n] coefficient-domain, replicated.
    """
    ksk_b, ksk_a = ksk
    full = ctx.params.L + 1

    def kernel(d_shard, kb, ka):
        acc_b, acc_a = _local_key_switch_partials(ctx, d_shard, kb, ka)
        q_full = ctx._tab["q_full"]
        mu_full = ctx._tab["mu_full"]
        acc_b = _psum_mod(acc_b, q_full, mu_full, "limb", ctx.engine)
        acc_a = _psum_mod(acc_a, q_full, mu_full, "limb", ctx.engine)
        acc_b = ctx.ntt_qp.inv(acc_b)
        acc_a = ctx.ntt_qp.inv(acc_a)
        return ctx._mod_switch_down(acc_b), ctx._mod_switch_down(acc_a)

    f = _shard_map(kernel, mesh=mesh,
                  in_specs=(P("limb", None), P("limb", None, None),
                            P("limb", None, None)),
                  out_specs=(P(None, None), P(None, None)),
                  check_vma=False)
    return f(d, ksk_b, ksk_a)


def sharded_rotate_rows(ctx: BfvContext, mesh: Mesh, ct_data, steps: int):
    """Galois rotation with the key-switch contraction sharded over "limb",
    in the HOISTED formulation (decompose the untouched c1, permute the
    decomposition in the NTT domain) — bit-identical to the single-device
    BfvContext.apply_galois (tests/test_sharding.py)."""
    n = ctx.params.n
    steps = steps % (n // 2)
    if steps == 0:
        return ct_data
    g = pow(3, steps, 2 * n)
    gather, sign_pos = ctx._galois_perm(g)
    perm_eval = jnp.asarray(ctx._galois_perm_eval(g))
    qv = ctx.q_q
    ksk_b, ksk_a = ctx._ksk_device(ctx.get_galois_key(g))
    full = ctx.params.L + 1

    def kernel(d_shard, kb, ka):
        acc_b, acc_a = _local_key_switch_partials(ctx, d_shard, kb, ka,
                                                  perm_eval=perm_eval)
        q_full = ctx._tab["q_full"]
        mu_full = ctx._tab["mu_full"]
        acc_b = _psum_mod(acc_b, q_full, mu_full, "limb", ctx.engine)
        acc_a = _psum_mod(acc_a, q_full, mu_full, "limb", ctx.engine)
        acc_b = ctx.ntt_qp.inv(acc_b)
        acc_a = ctx.ntt_qp.inv(acc_a)
        return ctx._mod_switch_down(acc_b), ctx._mod_switch_down(acc_a)

    f = _shard_map(kernel, mesh=mesh,
                   in_specs=(P("limb", None), P("limb", None, None),
                             P("limb", None, None)),
                   out_specs=(P(None, None), P(None, None)),
                   check_vma=False)
    k0, k1 = f(ct_data[1], ksk_b, ksk_a)
    c0g = ct_data[0][..., gather]
    c0g = jnp.where(jnp.asarray(sign_pos), c0g, ctx.engine.neg(c0g, qv))
    c0 = ctx.engine.add(c0g, k0, qv)
    return jnp.stack([c0, k1])
