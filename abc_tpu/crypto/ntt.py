"""Negacyclic NTT over RNS limbs — the workhorse of the crypto engine.

Replaces SEAL's NTT (used inside every multiply/rotate the reference
dispatches to, SealCiphertext.cpp:121-124). Layout: polynomials are
uint32 arrays [..., L, n]; each limb transforms independently, which is what
makes RNS-limb sharding across devices communication-free for NTTs
(SURVEY.md §2.6).

Algorithm: iterative Cooley-Tukey (forward, natural → bit-reversed order)
with Gentleman-Sande inverse built as the exact stage-by-stage inverse, so
correctness holds by construction. Twiddles ψ^brv(k) are precomputed per limb
with Shoup companions for the fixed-operand multiplication path.

Evaluation-order convention (verified by tests/test_ntt.py):
  forward-NTT output position p holds the evaluation of the polynomial at
  ψ^(2·bitrev(p)+1). The batch encoder builds its slot↔position maps on top
  of this convention.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from abc_tpu.crypto.numthy import find_minimal_2nth_root, modinv
from abc_tpu.ops.modarith import barrett_mu, get_engine, shoup


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _bit_reverse_vec(n: int, bits: int) -> np.ndarray:
    """[n] int64: bit_reverse(k, bits) for all k, vectorized."""
    k = np.arange(n, dtype=np.uint64)
    r = np.zeros(n, dtype=np.uint64)
    for _ in range(bits):
        r = (r << np.uint64(1)) | (k & np.uint64(1))
        k >>= np.uint64(1)
    return r.astype(np.int64)


_EVAL_PERM_TABLES = {}


def eval_perm_tables(n: int):
    """(e, pos_of_exp) for evaluation-domain Galois permutations: forward-NTT
    position p holds the eval at ψ^{e[p]} (e[p] = 2·brv(p)+1), and
    pos_of_exp inverts that map over the odd exponents mod 2n. Cached at
    MODULE level — these depend only on n, and rebuilding them per context
    per galois element (a 16384-iteration Python loop each) measured ~350 ms
    of every fresh-context key build at n=16384."""
    if n not in _EVAL_PERM_TABLES:
        logn = n.bit_length() - 1
        e = 2 * _bit_reverse_vec(n, logn) + 1
        pos_of_exp = np.empty(2 * n, dtype=np.int64)
        pos_of_exp[e] = np.arange(n)
        _EVAL_PERM_TABLES[n] = (e, pos_of_exp)
    return _EVAL_PERM_TABLES[n]


def _power_table(base: int, n: int, q: int) -> np.ndarray:
    """[n] uint64: base^i mod q by iterative doubling (q < 2^32 so products
    stay inside uint64). Replaces the former per-index Python loop — table
    construction dominated context setup (~1s at n=8192)."""
    out = np.empty(n, dtype=np.uint64)
    out[0] = 1
    filled = 1
    step = base % q
    while filled < n:
        take = min(filled, n - filled)
        out[filled:filled + take] = out[:take] * np.uint64(step) % np.uint64(q)
        step = step * step % q
        filled += take
    return out


_LIMB_TABLE_CACHE: dict = {}
_DEV_TABLE_CACHE: dict = {}


def _limb_tables(n: int, q: int):
    """(psi, fwd, fwd_sh, inv, inv_sh, ninv, ninv_sh) for one (n, modulus)
    pair — module-memoized: the tables are a pure function of (n, q), and
    a context build ran ~25 ms of power-table construction per limb set at
    n=16384, recurring for EVERY fresh context (the benchsuite's config6
    t_keygen pays it on the factory ctor)."""
    key = (n, q)
    hit = _LIMB_TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    brv = _bit_reverse_vec(n, n.bit_length() - 1)
    psi = find_minimal_2nth_root(n, q)
    qv = np.uint64(q)
    fwd_p = _power_table(psi, n, q)[brv]          # psi^brv(k)
    inv_p = _power_table(modinv(psi, q), n, q)[brv]
    ninv = modinv(n, q)
    out = (psi,
           fwd_p.astype(np.uint32),
           # shoup companion floor(w·2^32/q): w < 2^30 so w<<32 < 2^62
           ((fwd_p << np.uint64(32)) // qv).astype(np.uint32),
           inv_p.astype(np.uint32),
           ((inv_p << np.uint64(32)) // qv).astype(np.uint32),
           ninv, shoup(ninv, q))
    _LIMB_TABLE_CACHE[key] = out
    return out


class NttContext:
    """Precomputed twiddle tables for one (n, moduli) pair."""

    def __init__(self, n: int, moduli: Sequence[int], engine: str = "np64"):
        assert n & (n - 1) == 0, "n must be a power of two"
        self.n = n
        self.logn = n.bit_length() - 1
        self.moduli = list(moduli)
        self.engine_name = engine
        self.engine = get_engine(engine)
        L = len(self.moduli)

        fwd = np.zeros((L, n), dtype=np.uint32)
        inv = np.zeros((L, n), dtype=np.uint32)
        fwd_sh = np.zeros((L, n), dtype=np.uint32)
        inv_sh = np.zeros((L, n), dtype=np.uint32)
        n_inv = np.zeros((L, 1), dtype=np.uint32)
        n_inv_sh = np.zeros((L, 1), dtype=np.uint32)
        self.psi = []
        for l, q in enumerate(self.moduli):
            psi, fwd[l], fwd_sh[l], inv[l], inv_sh[l], ninv, ninv_sh_v = \
                _limb_tables(n, q)
            self.psi.append(psi)
            n_inv[l, 0] = ninv
            n_inv_sh[l, 0] = ninv_sh_v

        self.q = np.asarray(self.moduli, dtype=np.uint32).reshape(L, 1)
        self.mu = np.asarray([barrett_mu(q) for q in self.moduli],
                             dtype=np.uint32).reshape(L, 1)
        self.fwd_tw, self.fwd_tw_sh = fwd, fwd_sh
        self.inv_tw, self.inv_tw_sh = inv, inv_sh
        self.n_inv, self.n_inv_sh = n_inv, n_inv_sh
        if engine == "jx32":
            assert all((1 << 29) <= q < (1 << 30) for q in self.moduli), \
                "jx32 engine requires 30-bit moduli (Barrett range)"
            import jax
            # device tables are module-cached by (n, moduli): equal-parameter
            # contexts (fresh factories in a serving loop) share one
            # immutable copy instead of transferring ~1 MB each
            names = ("q", "mu", "fwd_tw", "fwd_tw_sh", "inv_tw",
                     "inv_tw_sh", "n_inv", "n_inv_sh")
            dkey = (n, tuple(self.moduli))
            dev = _DEV_TABLE_CACHE.get(dkey)
            if dev is None:
                dev = jax.device_put(tuple(getattr(self, n_)
                                           for n_ in names))
                _DEV_TABLE_CACHE[dkey] = dev
            for n_, v in zip(names, dev):
                setattr(self, n_, v)
            self._bind_device_transforms()
            self.negacyclic_mul = jax.jit(self.negacyclic_mul)
        elif engine == "np64":
            self._attach_native()

    def _bind_device_transforms(self) -> None:
        """jx32 transforms, chosen once from the platform. fwd_xla/inv_xla
        are the plain stage loop, jitted at MODULE level with the tables as
        arguments, so every context and subset of one shape shares one
        executable. On a GPU, fwd/inv are the CUDA kernel
        (ops/cuda_ntt.py) on the same tables; a kernel that cannot be built
        or loaded raises. Elsewhere fwd/inv are the stage loop."""
        import jax
        self.fwd_xla = lambda a: _jx_fwd(a, self.fwd_tw, self.fwd_tw_sh,
                                         self.q)
        self.inv_xla = lambda a: _jx_inv(a, self.inv_tw, self.inv_tw_sh,
                                         self.q, self.n_inv, self.n_inv_sh)
        if jax.default_backend() == "gpu":
            from abc_tpu.ops import cuda_ntt
            cuda_ntt.load()
            self.fwd = lambda a: cuda_ntt.fwd(a, self.fwd_tw, self.fwd_tw_sh,
                                              self.q)
            self.inv = lambda a: cuda_ntt.inv(a, self.inv_tw, self.inv_tw_sh,
                                              self.q, self.n_inv,
                                              self.n_inv_sh)
        else:
            self.fwd, self.inv = self.fwd_xla, self.inv_xla

    def _attach_native(self) -> None:
        """Swap in the C++ engine (native/modpoly.cpp) for host transforms —
        bit-identical, ~10x faster than the NumPy stage loop. Disable with
        ABC_TPU_NO_NATIVE=1."""
        import os
        if os.environ.get("ABC_TPU_NO_NATIVE"):
            return
        try:
            from abc_tpu.ops.native import NativeNtt
            native = NativeNtt(self)
        except Exception:
            return  # no compiler available: keep the NumPy path
        self._native = native
        self.fwd = native.fwd
        self.inv = native.inv
        self.pointwise_mul = native.pointwise_mul

    def subset(self, indices) -> "NttContext":
        """A view of this context restricted to the given limb rows (no
        recomputation) — used for CKKS leveled operations where dropped
        primes leave the chain.

        Cached per index tuple: callers may request subsets inside a jit
        trace (CKKS key switch does, once per level), and rebuilding the
        device twiddle tables as in-trace constants re-runs their gathers
        at run time (XLA does not hoist them out of loop bodies).
        Cache insertion is gated on trace_state_clean(): tables built
        during a trace are tracers in jax 0.9 and must not outlive it."""
        from abc_tpu.utils.tracing import trace_state_clean
        key = tuple(indices)
        cache = getattr(self, "_subset_cache", None)
        if cache is None:
            cache = self._subset_cache = {}
        if key in cache:
            return cache[key]
        indices = list(key)
        view = object.__new__(NttContext)
        view.n = self.n
        view.logn = self.logn
        view.moduli = [self.moduli[i] for i in indices]
        view.engine_name = self.engine_name
        view.engine = self.engine
        view.psi = [self.psi[i] for i in indices]
        idx = np.asarray(list(indices), dtype=np.int64)
        for name in ("q", "mu", "fwd_tw", "fwd_tw_sh", "inv_tw",
                     "inv_tw_sh", "n_inv", "n_inv_sh"):
            setattr(view, name, getattr(self, name)[idx])
        if self.engine_name == "jx32":
            import jax
            view._bind_device_transforms()
            view.negacyclic_mul = jax.jit(NttContext.negacyclic_mul.__get__(view))
        elif self.engine_name == "np64":
            view._attach_native()
        if trace_state_clean():
            cache[key] = view
        return view

    # --- transforms -----------------------------------------------------------
    def fwd(self, a):
        """Forward negacyclic NTT along the last axis ([..., L, n])."""
        return _fwd_stages(self.engine, a, self.fwd_tw, self.fwd_tw_sh,
                           self.q)

    def inv(self, a):
        """Inverse negacyclic NTT along the last axis (exact inverse of fwd)."""
        return _inv_stages(self.engine, a, self.inv_tw, self.inv_tw_sh,
                           self.q, self.n_inv, self.n_inv_sh)

    # --- pointwise helpers ------------------------------------------------------
    def pointwise_mul(self, a, b):
        return self.engine.mul(a, b, self.q, self.mu)

    def add(self, a, b):
        return self.engine.add(a, b, self.q)

    def sub(self, a, b):
        return self.engine.sub(a, b, self.q)

    def neg(self, a):
        return self.engine.neg(a, self.q)

    def negacyclic_mul(self, a, b):
        """Full polynomial product in R_q = Z_q[x]/(x^n+1) via NTT."""
        return self.inv(self.pointwise_mul(self.fwd(a), self.fwd(b)))


def _fwd_stages(e, a, fwd_tw, fwd_tw_sh, q_col):
    """Cooley-Tukey stage loop over explicit tables (engine-generic)."""
    n = a.shape[-1]
    batch = a.shape[:-2]
    L = a.shape[-2]
    m = 1
    while m < n:
        t = n // (2 * m)
        x = a.reshape(batch + (L, m, 2, t))
        w = fwd_tw[:, m:2 * m].reshape((L, m, 1))
        wsh = fwd_tw_sh[:, m:2 * m].reshape((L, m, 1))
        q = q_col.reshape((L, 1, 1))
        u = x[..., 0, :]
        v = e.mul_shoup(x[..., 1, :], w, wsh, q)
        a = _stack_pairs(e.add(u, v, q), e.sub(u, v, q), batch, L, m, t)
        m *= 2
    return a


def _inv_stages(e, a, inv_tw, inv_tw_sh, q_col, n_inv, n_inv_sh):
    """Gentleman-Sande stage loop (exact inverse of _fwd_stages)."""
    n = a.shape[-1]
    batch = a.shape[:-2]
    L = a.shape[-2]
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        x = a.reshape(batch + (L, m, 2, t))
        w = inv_tw[:, m:2 * m].reshape((L, m, 1))
        wsh = inv_tw_sh[:, m:2 * m].reshape((L, m, 1))
        q = q_col.reshape((L, 1, 1))
        u = x[..., 0, :]
        v = x[..., 1, :]
        s = e.add(u, v, q)
        d = e.mul_shoup(e.sub(u, v, q), w, wsh, q)
        a = _stack_pairs(s, d, batch, L, m, t)
        m //= 2
    return e.mul_shoup(a, n_inv, n_inv_sh, q_col)


# Module-level jitted jx32 transforms: tables are ARGUMENTS, so every
# context/subset with matching shapes shares one compiled executable per
# shape (per-context jit closures would recompile each time).
_JX_JIT = {}


def _jx_fwd(a, tw, twsh, q):
    if "fwd" not in _JX_JIT:
        import jax
        eng = get_engine("jx32")
        _JX_JIT["fwd"] = jax.jit(
            lambda a, tw, twsh, q: _fwd_stages(eng, a, tw, twsh, q))
    return _JX_JIT["fwd"](a, tw, twsh, q)


def _jx_inv(a, tw, twsh, q, n_inv, n_inv_sh):
    if "inv" not in _JX_JIT:
        import jax
        eng = get_engine("jx32")
        _JX_JIT["inv"] = jax.jit(
            lambda a, tw, twsh, q, ni, nish:
            _inv_stages(eng, a, tw, twsh, q, ni, nish))
    return _JX_JIT["inv"](a, tw, twsh, q, n_inv, n_inv_sh)


def _stack_pairs(top, bot, batch, L, m, t):
    xp = np if isinstance(top, np.ndarray) else _jnp()
    out = xp.stack([top, bot], axis=-2)  # [..., L, m, 2, t]
    return out.reshape(batch + (L, m * 2 * t))


def _jnp():
    import jax.numpy as jnp
    return jnp


def negacyclic_mul_naive(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Schoolbook negacyclic product (test oracle), one limb."""
    n = a.shape[-1]
    res = np.zeros(n, dtype=object)
    for i in range(n):
        for j in range(n):
            k = i + j
            v = int(a[i]) * int(b[j])
            if k >= n:
                res[k - n] -= v
            else:
                res[k] += v
    return np.asarray([int(x) % q for x in res], dtype=np.uint32)
