"""BEHZ full-RNS BFV ciphertext multiplication (Bajard-Eynard-Hasan-Zucca).

Float-free RNS implementation of BFV ct·ct multiply — the same construction
SEAL uses behind the reference's SealCiphertext::multiply
(SealCiphertext.cpp:102-124, 99% of the reference's cycles per SURVEY.md §3.3).
Float-free: every step below is exact uint32 limb math on the device.

Pipeline (BEHZ16, §4):
  1. fastbconv_m_tilde : lift both ciphertexts from base q to Bsk ∪ {m̃}
     (multiply by m̃ = 2^16 first so the conversion overflow is removable)
  2. sm_mrq            : small Montgomery reduction mod m̃ — makes the Bsk
     representation EXACT (α + r can hold no multiple of m̃ when m̃ > 2L)
  3. tensor product    : (c0·d0, c0·d1 + c1·d0, c1·d1) via NTT in q and Bsk
  4. fast_floor        : floor(t·e/q) computed in Bsk
  5. fastbconv_sk      : exact conversion Bsk → q via Shenoy-Kumaresan (m_sk)

Base sizes: Bsk = (L+1 B-primes) ∪ {m_sk} so that B·m_sk > n·t·q with margin
(30·(L+2) ≥ 30L+34+margin bits).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from abc_tpu.crypto.ntt import NttContext
from abc_tpu.crypto.numthy import gen_ntt_primes, modinv
from abc_tpu.crypto.params import BfvParams
from abc_tpu.ops.modarith import barrett_mu

M_TILDE_BITS = 16
M_TILDE = 1 << M_TILDE_BITS
_MASK = M_TILDE - 1


class BehzContext:
    """Precomputed tables + auxiliary-base NTT for BEHZ multiplication."""

    def __init__(self, params: BfvParams, ntt_q: NttContext = None):
        self.params = params
        L, n, t = params.L, params.n, params.plain_modulus
        qs = params.data_primes
        q_big = params.q
        assert M_TILDE > 2 * (L + 2), "m_tilde must exceed 2·(base size)"

        # auxiliary primes: L+1 B-primes + m_sk, all 30-bit, disjoint from q∪{P,t}
        aux = gen_ntt_primes(30, L + 2, n, exclude=params.coeff_modulus + [t])
        self.b_primes = aux[:-1]
        self.m_sk = aux[-1]
        self.bsk = self.b_primes + [self.m_sk]          # size L+2
        B_big = 1
        for b in self.b_primes:
            B_big *= b

        self.ntt_q = ntt_q or NttContext(n, qs, engine=params.engine)
        self.ntt_bsk = NttContext(n, self.bsk, engine=params.engine)

        host = {}
        as_col = lambda v: np.asarray(v, dtype=np.uint32).reshape(-1, 1)
        # step 1: y_i = [x_i · m̃ · (q/q_i)^{-1}]_{q_i}
        qhat = [q_big // qi for qi in qs]
        qhat_inv = [modinv(qh % qi, qi) for qh, qi in zip(qhat, qs)]
        host["mtilde_qhatinv_mod_q"] = as_col(
            [(M_TILDE * hi) % qi for hi, qi in zip(qhat_inv, qs)])
        host["qhatinv_mod_q"] = as_col(qhat_inv)
        # conversion tables  [L, dst]
        host["qhat_mod_bsk"] = np.asarray(
            [[qh % b for b in self.bsk] for qh in qhat], dtype=np.uint32)
        host["qhat_mod_mtilde"] = as_col([qh % M_TILDE for qh in qhat])
        # step 2
        host["neg_qinv_mod_mtilde"] = np.uint32(
            (-modinv(q_big % M_TILDE, M_TILDE)) % M_TILDE)
        host["q_mod_bsk"] = as_col([q_big % b for b in self.bsk])
        host["mtilde_inv_mod_bsk"] = as_col(
            [modinv(M_TILDE, b) for b in self.bsk])
        # step 4
        host["t_mod_q"] = as_col([t % qi for qi in qs])
        host["t_mod_bsk"] = as_col([t % b for b in self.bsk])
        host["qinv_mod_bsk"] = as_col([modinv(q_big % b, b) for b in self.bsk])
        # step 5 (Shenoy-Kumaresan over B with m_sk)
        bhat = [B_big // b for b in self.b_primes]
        host["bhatinv_mod_b"] = as_col(
            [modinv(bh % b, b) for bh, b in zip(bhat, self.b_primes)])
        host["bhat_mod_q"] = np.asarray(
            [[bh % qi for qi in qs] for bh in bhat], dtype=np.uint32)
        host["bhat_mod_msk"] = as_col([bh % self.m_sk for bh in bhat])
        host["binv_mod_msk"] = np.uint32(modinv(B_big % self.m_sk, self.m_sk))
        host["B_mod_q"] = as_col([B_big % qi for qi in qs])
        host["msk_mod_q"] = as_col([self.m_sk % qi for qi in qs])

        self.msk_half = self.m_sk >> 1
        self.q_cols = as_col(qs)
        self.mu_q = as_col([barrett_mu(qi) for qi in qs])
        self.bsk_cols = as_col(self.bsk)
        self.mu_bsk = as_col([barrett_mu(b) for b in self.bsk])
        self.msk_col = np.uint32(self.m_sk)
        self.mu_msk = np.uint32(barrett_mu(self.m_sk))

        self._on_device = params.engine == "jx32"
        if self._on_device:
            import jax.numpy as jnp
            self.tab = {k: jnp.asarray(v) for k, v in host.items()}
            for name in ("q_cols", "mu_q", "bsk_cols", "mu_bsk"):
                setattr(self, name, jnp.asarray(getattr(self, name)))
        else:
            self.tab = host
        self.engine = self.ntt_q.engine

    # ------------------------------------------------------------------ helpers
    def _fastconv(self, y, table, dst_q, dst_mu):
        """Σ_i y_i·table[i, d] mod dst_d — the RNS base-conversion contraction.
        y: [..., K, n], table: [K, D] → out [..., D, n].

        Fusion note (round-2 review item 5): an accumulate-over-limbs form
        that avoids materializing the [..., K, D, n] product tensor was
        measured on the real chip at n=8192 single-ct mult+relin — 3451
        ops/s vs 3597 for this vectorized form, i.e. XLA already fuses the
        contraction and the broadcast form schedules slightly better. The
        elementwise BEHZ work is ~30% of the op; the NTT rows dominate
        (docs/DESIGN_NOTES.md)."""
        e = self.engine
        prod = e.mul(y[..., :, None, :], table[:, :, None],
                     dst_q[None, :, :], dst_mu[None, :, :])
        return _acc_mod(prod, dst_q, e, axis=-3)

    def _to_bsk(self, x):
        """Exact base extension q → Bsk of x ∈ [0,q)^n ([..., L, n] residues).

        fastbconv_m_tilde + sm_mrq: with m̃ = 2^16 > 2L the correction is
        exact (no q-overflow survives), see module docstring.
        """
        e = self.engine
        xp = _xp(x)
        y = e.mul(x, self.tab["mtilde_qhatinv_mod_q"], self.q_cols, self.mu_q)
        conv_b = self._fastconv(y, self.tab["qhat_mod_bsk"],
                                self.bsk_cols, self.mu_bsk)
        # conversion residue mod m̃ (power of two: mask arithmetic)
        terms = (y & _MASK) * self.tab["qhat_mod_mtilde"]   # [..., L, n] < 2^32
        conv_mt = (terms & _MASK).sum(axis=-2) & _MASK \
            if isinstance(terms, np.ndarray) else \
            ((terms & _MASK).sum(axis=-2) & _MASK)
        r = (conv_mt * self.tab["neg_qinv_mod_mtilde"]) & _MASK
        # centered r: subtract m̃ when r ≥ m̃/2  → handle as r - m̃ mod b
        r = r.astype(xp.uint32) if hasattr(r, "astype") else r
        ge = r >= (M_TILDE >> 1)
        r_b = xp.where(ge[..., None, :],
                       e.sub(r[..., None, :], xp.uint32(M_TILDE) *
                             xp.ones_like(self.bsk_cols), self.bsk_cols),
                       r[..., None, :])
        qr = e.mul(self.tab["q_mod_bsk"], r_b, self.bsk_cols, self.mu_bsk)
        return e.mul(e.add(conv_b, qr, self.bsk_cols),
                     self.tab["mtilde_inv_mod_bsk"], self.bsk_cols, self.mu_bsk)

    def _fast_floor(self, e_q, e_bsk):
        """floor(t·e/q) in base Bsk, inputs in (q, Bsk) coeff domain."""
        en = self.engine
        tq = en.mul(e_q, self.tab["t_mod_q"], self.q_cols, self.mu_q)
        tb = en.mul(e_bsk, self.tab["t_mod_bsk"], self.bsk_cols, self.mu_bsk)
        y = en.mul(tq, self.tab["qhatinv_mod_q"], self.q_cols, self.mu_q)
        conv = self._fastconv(y, self.tab["qhat_mod_bsk"],
                              self.bsk_cols, self.mu_bsk)
        return en.mul(en.sub(tb, conv, self.bsk_cols),
                      self.tab["qinv_mod_bsk"], self.bsk_cols, self.mu_bsk)

    def _from_bsk(self, x_bsk):
        """Exact conversion Bsk → q (Shenoy-Kumaresan with m_sk)."""
        e = self.engine
        xp = _xp(x_bsk)
        xb, x_msk = x_bsk[..., :-1, :], x_bsk[..., -1, :]
        y = e.mul(xb, self.tab["bhatinv_mod_b"],
                  self.bsk_cols[:-1], self.mu_bsk[:-1])
        conv_q = self._fastconv(y, self.tab["bhat_mod_q"], self.q_cols, self.mu_q)
        conv_msk = self._fastconv(y, self.tab["bhat_mod_msk"],
                                  self.msk_col.reshape(1, 1),
                                  self.mu_msk.reshape(1, 1))[..., 0, :]
        alpha = e.mul(e.sub(conv_msk, x_msk, self.msk_col),
                      self.tab["binv_mod_msk"], self.msk_col, self.mu_msk)
        # centered α, reduced mod each q_j (uniform 30-bit primes)
        a_red = xp.where(alpha[..., None, :] >= self.q_cols,
                         alpha[..., None, :] - self.q_cols,
                         alpha[..., None, :])
        neg = alpha > xp.uint32(self.msk_half)
        a_cent = xp.where(neg[..., None, :],
                          e.sub(a_red, self.tab["msk_mod_q"], self.q_cols),
                          a_red)
        corr = e.mul(self.tab["B_mod_q"], a_cent, self.q_cols, self.mu_q)
        return e.sub(conv_q, corr, self.q_cols)

    # ------------------------------------------------------------------ multiply
    def precompute_operand(self, ct_data) -> Tuple:
        """(fwd-NTT over q, fwd-NTT over Bsk) of a ciphertext — the
        per-operand half of `multiply`. Hoist this for an operand reused
        across many multiplies (a fixed multiplier in a dependent chain, a
        shared factor in a product tree): each reuse skips 2·(2L+2)
        transform rows plus the Bsk lift. Conceptual analogue of SEAL's
        transform_to_ntt operand pre-transformation."""
        return (self.ntt_q.fwd(ct_data), self.ntt_bsk.fwd(self._to_bsk(ct_data)))

    def multiply(self, ct1_data, ct2_data, pre1: Tuple = None,
                 pre2: Tuple = None):
        """[2, L, n] × [2, L, n] → [3, L, n] (pre-relinearization).
        pre1/pre2: optional precompute_operand results for the operands."""
        nq, nb = self.ntt_q, self.ntt_bsk
        # Precomputes are caller-owned caches: validate the shapes so a
        # stale/swapped tuple fails loudly instead of producing a silently
        # wrong product. (Value correspondence is the caller's contract.)
        for pre, ct in ((pre1, ct1_data), (pre2, ct2_data)):
            if pre is not None:
                fq, fb = pre
                if fq.shape != ct.shape or fb.shape[:-2] != ct.shape[:-2] \
                        or fb.shape[-2] != self.bsk_cols.shape[0] \
                        or fb.shape[-1] != ct.shape[-1]:
                    raise ValueError(
                        f"precompute_operand shape mismatch: got NTT-q "
                        f"{fq.shape} / NTT-Bsk {fb.shape} for ciphertext "
                        f"{ct.shape}; precomputes must come from "
                        "precompute_operand on this exact operand")
        same = ct1_data is ct2_data        # square: share the operand's lift
        # tensor product in NTT domain, separately per base
        # (measured: stacking both ciphertexts into one [2,2,L,n] NTT call
        # costs more in copies than the extra batch amortization saves).
        # Explicit reuse for squaring: the GPU kernel is a custom call XLA
        # will not CSE, so the dedup must happen here.
        f1q, f1b = pre1 if pre1 is not None else \
            (nq.fwd(ct1_data), nb.fwd(self._to_bsk(ct1_data)))
        if pre2 is not None:
            f2q, f2b = pre2
        elif same:
            f2q, f2b = f1q, f1b
        else:
            f2q, f2b = nq.fwd(ct2_data), nb.fwd(self._to_bsk(ct2_data))
        e = self.engine

        def tensor(f1, f2, q, mu):
            e0 = e.mul(f1[0], f2[0], q, mu)
            m01 = e.mul(f1[0], f2[1], q, mu)
            m10 = e.mul(f1[1], f2[0], q, mu)
            e1 = e.add(m01, m10, q)
            e2 = e.mul(f1[1], f2[1], q, mu)
            return _stack([e0, e1, e2])

        eq = nq.inv(tensor(f1q, f2q, self.q_cols, self.mu_q))
        eb = nb.inv(tensor(f1b, f2b, self.bsk_cols, self.mu_bsk))
        floor_b = self._fast_floor(eq, eb)
        return self._from_bsk(floor_b)


# --------------------------------------------------------------------- helpers

def _xp(arr):
    if isinstance(arr, np.ndarray):
        return np
    import jax.numpy as jnp
    return jnp


def _stack(parts):
    return _xp(parts[0]).stack(parts)


def _acc_mod(terms, q, engine, axis=0):
    if isinstance(terms, np.ndarray):
        s = terms.astype(np.uint64).sum(axis=axis)
        return (s % q.astype(np.uint64)).astype(np.uint32)
    K = terms.shape[axis]
    import jax.numpy as jnp
    moved = jnp.moveaxis(terms, axis, 0)
    acc = moved[0]
    for k in range(1, K):
        acc = engine.add(acc, moved[k], q)
    return acc
