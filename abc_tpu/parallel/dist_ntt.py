"""Coefficient-sharded negacyclic NTT over a device mesh axis.

Config 5 and SURVEY.md §2.6: the second device-parallel axis for
one ciphertext (beyond RNS limbs) is the polynomial COEFFICIENT axis —
shard the degree-n polynomial into D contiguous blocks of S = n/D
coefficients, one per device, and turn the NTT's long-stride butterfly
stages into inter-device exchanges (collective-permute).

Decomposition (Cooley-Tukey forward, natural → bit-reversed order, same
convention as crypto/ntt.py so results are BIT-IDENTICAL to the local
transform):

  * stages with stride t ≥ S (the first log2 D stages): butterfly partners
    live at the same local offset on device d ± t/S, and the twiddle is
    CONSTANT per device (blocks span ≥ 2 shards). Each stage is ONE
    jax.lax.ppermute block swap + elementwise math — the hypercube
    ("binary-exchange") form of the FFT all-to-all. Total traffic is
    log2(D)·S words/device vs S words for a four-step transpose; we trade
    that factor for keeping one uniform butterfly code path and zero
    data reshuffling of the coefficient order.
  * stages with stride t < S: fully device-local. For block-contiguous
    sharding the local stage loop of device d is EXACTLY a size-S NTT
    stage loop whose stage-m twiddle block is the global table slice
    w[m·(D+d) : m·(D+d)+m] — precomputed per device below and sharded
    alongside the data, so the inner loop reuses the engine's fused math.

The inverse transform mirrors this (Gentleman-Sande: local stages first,
then log2 D exchange stages, then the n^{-1} scaling, which is local).

Everything here is shard_map-compatible pure-jnp (runs on the virtual CPU
mesh for tests and under pjit on real slices); the reference has no
analogue — SEAL's NTT is a single-core loop (SURVEY.md §2.6).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map as _shard_map          # jax ≥ 0.8
except ImportError:                                   # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from abc_tpu.ops.modarith import jx32


class DistNttContext:
    """Per-device tables for a coefficient-sharded NTT of one NttContext.

    ctx:  an NttContext (engine jx32) with n = D·S
    D:    number of shards along the mesh axis that will carry coefficients
    """

    def __init__(self, ctx, D: int, pipeline_chunks: int = 2):
        n, L = ctx.n, len(ctx.moduli)
        assert n % D == 0 and D & (D - 1) == 0, "D must be a power of two"
        S = n // D
        assert S >= 2, "shard must hold at least 2 coefficients"
        self.ctx = ctx
        self.D, self.S, self.n, self.L = D, S, n, L
        self.logD = D.bit_length() - 1
        # Cross-stage exchange pipelining: the exchange-stage butterfly is
        # ELEMENTWISE over the local [L, S] block, so the block splits into
        # `pipeline_chunks` independent (permute → combine) chains per
        # stage. All chunk permutes are issued before any combine, giving
        # XLA's async collective scheduler (-start/-done separation)
        # compute to overlap each transfer with: chunk c's butterfly math
        # hides chunk c+1's ppermute, ~(nc−1)/nc of the exchange time once
        # per-chunk compute ≥ per-chunk transfer. nc=1 restores the
        # sequential round-3 schedule. (round-4 verdict item 6)
        assert pipeline_chunks >= 1 and S % pipeline_chunks == 0, \
            "pipeline_chunks must divide the shard length"
        self.pipeline_chunks = pipeline_chunks

        fwd_tw = np.asarray(ctx.fwd_tw)      # [L, n], stage-m block at [m, 2m)
        fwd_sh = np.asarray(ctx.fwd_tw_sh)
        inv_tw = np.asarray(ctx.inv_tw)
        inv_sh = np.asarray(ctx.inv_tw_sh)

        # cross-stage twiddles: stage s (m = 2^s < D) uses ONE twiddle per
        # device: w[m + d // (2·t/S)] with t = n/(2m) → index m + d·m/D·... :
        # b = d // (2·t_sh), t_sh = t/S = D/(2m) → w_idx = m + d·m//D? No:
        # b = d // (D/m) exactly (verified in tests bit-exactly vs ctx.fwd).
        cross_f = np.zeros((D, self.logD, L), dtype=np.uint32)
        cross_fs = np.zeros_like(cross_f)
        cross_i = np.zeros((D, self.logD, L), dtype=np.uint32)
        cross_is = np.zeros_like(cross_i)
        for s in range(self.logD):
            m = 1 << s
            for d in range(D):
                idx = m + d // (D // m)
                cross_f[d, s] = fwd_tw[:, idx]
                cross_fs[d, s] = fwd_sh[:, idx]
                cross_i[d, s] = inv_tw[:, idx]
                cross_is[d, s] = inv_sh[:, idx]

        # local-stage tables: device d's size-S stage loop reads stage-m
        # block from global indices [m·(D+d), m·(D+d)+m) — pack into the
        # standard layout (stage m at [m, 2m)) of a size-S table per device.
        loc_f = np.zeros((D, L, S), dtype=np.uint32)
        loc_fs = np.zeros_like(loc_f)
        loc_i = np.zeros((D, L, S), dtype=np.uint32)
        loc_is = np.zeros_like(loc_i)
        m = 1
        while m < S:
            for d in range(D):
                g0 = m * (D + d)
                loc_f[d, :, m:2 * m] = fwd_tw[:, g0:g0 + m]
                loc_fs[d, :, m:2 * m] = fwd_sh[:, g0:g0 + m]
                loc_i[d, :, m:2 * m] = inv_tw[:, g0:g0 + m]
                loc_is[d, :, m:2 * m] = inv_sh[:, g0:g0 + m]
            m *= 2

        self.cross_f, self.cross_fs = jnp.asarray(cross_f), jnp.asarray(cross_fs)
        self.cross_i, self.cross_is = jnp.asarray(cross_i), jnp.asarray(cross_is)
        self.loc_f, self.loc_fs = jnp.asarray(loc_f), jnp.asarray(loc_fs)
        self.loc_i, self.loc_is = jnp.asarray(loc_i), jnp.asarray(loc_is)
        self.q = jnp.asarray(np.asarray(ctx.q))            # [L, 1]
        self.mu = jnp.asarray(np.asarray(ctx.mu))          # [L, 1] Barrett
        self.n_inv = jnp.asarray(np.asarray(ctx.n_inv))    # [L, 1]
        self.n_inv_sh = jnp.asarray(np.asarray(ctx.n_inv_sh))

    # ---------------------------------------------------------------- helpers
    def _pairs(self, t_sh: int):
        """ppermute pairing: device d ↔ d XOR t_sh (block exchange)."""
        return [(d, d ^ t_sh) for d in range(self.D)]

    def _local_stages_fwd(self, x, tw, tw_sh, batch):
        S, L = self.S, self.L
        e = jx32
        m = 1
        while m < S:
            t = S // (2 * m)
            v = x.reshape(batch + (L, m, 2, t))
            w = tw[:, m:2 * m].reshape((L, m, 1))
            wsh = tw_sh[:, m:2 * m].reshape((L, m, 1))
            q = self.q.reshape((L, 1, 1))
            u = v[..., 0, :]
            wv = e.mul_shoup(v[..., 1, :], w, wsh, q)
            x = jnp.stack([e.add(u, wv, q), e.sub(u, wv, q)],
                          axis=-2).reshape(batch + (L, S))
            m *= 2
        return x

    def _local_stages_inv(self, x, tw, tw_sh, batch):
        S, L = self.S, self.L
        e = jx32
        m = S // 2
        while m >= 1:
            t = S // (2 * m)
            v = x.reshape(batch + (L, m, 2, t))
            w = tw[:, m:2 * m].reshape((L, m, 1))
            wsh = tw_sh[:, m:2 * m].reshape((L, m, 1))
            q = self.q.reshape((L, 1, 1))
            u = v[..., 0, :]
            vv = v[..., 1, :]
            s_ = e.add(u, vv, q)
            d_ = e.mul_shoup(e.sub(u, vv, q), w, wsh, q)
            x = jnp.stack([s_, d_], axis=-2).reshape(batch + (L, S))
            m //= 2
        return x

    # --------------------------------------------------------------- transforms
    def fwd_local(self, x, cross_f, cross_fs, loc_f, loc_fs, axis: str):
        """Per-shard forward NTT body (call inside shard_map).

        x: [..., L, S] this device's coefficient block; cross/loc tables are
        this device's slices ([logD, L] / [L, S]).
        """
        batch = x.shape[:-2]
        L = self.L
        e = jx32
        d = jax.lax.axis_index(axis)
        nc = self.pipeline_chunks
        for s in range(self.logD):
            m = 1 << s
            t_sh = self.D // (2 * m)
            w = cross_f[s].reshape((L, 1))
            wsh = cross_fs[s].reshape((L, 1))
            is_u = (d % (2 * t_sh)) < t_sh

            def combine(xc, pc):
                wv = e.mul_shoup(jnp.where(is_u, pc, xc), w, wsh, self.q)
                return jnp.where(is_u, e.add(xc, wv, self.q),
                                 e.sub(pc, wv, self.q))

            if nc == 1:
                x = combine(x, jax.lax.ppermute(x, axis, self._pairs(t_sh)))
            else:
                # issue EVERY chunk's exchange before any combine: the
                # chains are independent, so the combine of chunk c
                # overlaps the in-flight transfer of chunk c+1
                chunks = jnp.split(x, nc, axis=-1)
                partners = [jax.lax.ppermute(c, axis, self._pairs(t_sh))
                            for c in chunks]
                x = jnp.concatenate(
                    [combine(c, p) for c, p in zip(chunks, partners)],
                    axis=-1)
        return self._local_stages_fwd(x, loc_f, loc_fs, batch)

    def inv_local(self, x, cross_i, cross_is, loc_i, loc_is, axis: str):
        """Per-shard inverse NTT body (exact inverse of fwd_local)."""
        batch = x.shape[:-2]
        L = self.L
        e = jx32
        d = jax.lax.axis_index(axis)
        nc = self.pipeline_chunks
        x = self._local_stages_inv(x, loc_i, loc_is, batch)
        for s in range(self.logD - 1, -1, -1):
            m = 1 << s
            t_sh = self.D // (2 * m)
            w = cross_i[s].reshape((L, 1))
            wsh = cross_is[s].reshape((L, 1))
            is_u = (d % (2 * t_sh)) < t_sh

            def combine(xc, pc):
                s_new = e.add(xc, pc, self.q)                    # u-side
                d_new = e.mul_shoup(e.sub(pc, xc, self.q), w, wsh, self.q)
                return jnp.where(is_u, s_new, d_new)

            if nc == 1:
                x = combine(x, jax.lax.ppermute(x, axis, self._pairs(t_sh)))
            else:
                chunks = jnp.split(x, nc, axis=-1)
                partners = [jax.lax.ppermute(c, axis, self._pairs(t_sh))
                            for c in chunks]
                x = jnp.concatenate(
                    [combine(c, p) for c, p in zip(chunks, partners)],
                    axis=-1)
        return e.mul_shoup(x, self.n_inv, self.n_inv_sh, self.q)

    # ------------------------------------------------------------ mesh wrappers
    def make_fwd(self, mesh: Mesh, axis: str = "coeff", extra_specs=()):
        """shard_map-wrapped forward NTT: [..., L, n] sharded on the last
        axis → same sharding, NTT domain."""
        xs = P(*(extra_specs + (None, axis)))

        def body(x, cf, cfs, lf, lfs):
            return self.fwd_local(x, cf[0], cfs[0], lf[0], lfs[0], axis)

        f = _shard_map(body, mesh=mesh,
                       in_specs=(xs, P(axis), P(axis), P(axis), P(axis)),
                       out_specs=xs, check_vma=False)
        return lambda x: f(x, self.cross_f, self.cross_fs,
                           self.loc_f, self.loc_fs)

    def make_inv(self, mesh: Mesh, axis: str = "coeff", extra_specs=()):
        xs = P(*(extra_specs + (None, axis)))

        def body(x, ci, cis, li, lis):
            return self.inv_local(x, ci[0], cis[0], li[0], lis[0], axis)

        f = _shard_map(body, mesh=mesh,
                       in_specs=(xs, P(axis), P(axis), P(axis), P(axis)),
                       out_specs=xs, check_vma=False)
        return lambda x: f(x, self.cross_i, self.cross_is,
                           self.loc_i, self.loc_is)

    def make_negacyclic_mul(self, mesh: Mesh, axis: str = "coeff",
                            extra_specs=()):
        """Distributed full polynomial product in R_q: fwd ⊙ fwd → inv.
        The pointwise multiply is embarrassingly parallel over shards."""
        fwd = self.make_fwd(mesh, axis, extra_specs)
        inv = self.make_inv(mesh, axis, extra_specs)
        q_col, mu_col = self.q, self.mu

        def mul(a, b):
            prod = jx32.mul(fwd(a), fwd(b), q_col, mu_col)
            return inv(prod)
        return mul
