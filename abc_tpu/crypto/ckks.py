"""RNS-CKKS scheme: approximate arithmetic over real/complex slot vectors.

The reference plans CKKS but never built it (compile-time define
HAVE_SEAL_CKKS in CMakeLists.txt:216 and an empty README section
"CKKS Scheme-Specific Optimizations", README.md:105-107). This module is the
implementation: leveled RNS ciphertexts [2, l, n] uint32, NTT
tensor products, hybrid key switching with configurable digit size
k = ks_digits (the BFV construction of crypto/bfv.py, leveled: full-level
keys over α = ⌈L/k⌉ digits stay valid at every level because the partial
digit's sub-product still recombines exactly — see the factor-table comment
in __init__), and EXACT RNS rescaling (drop the last data prime via
centered division — no floats on the hot path).

Encoding uses the canonical embedding via FFT with the same slot→evaluation
ordering as the BFV batch encoder (exponents ±3^i mod 2n), so Galois slot
rotations are the SAME automorphism machinery (x → x^(3^k)).

Scale management is standard CKKS: scale multiplies under ct·ct multiply and
divides by the dropped prime at rescale; decode uses the tracked scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from abc_tpu.crypto.ntt import NttContext, bit_reverse
from abc_tpu.crypto.numthy import centered, gen_ntt_primes, modinv
from abc_tpu.ops.modarith import barrett_mu
from abc_tpu.utils.errors import RuntimeExecutionError


@dataclass
class CkksParams:
    n: int
    coeff_modulus: List[int]          # data primes + ks_digits special primes (last)
    scale: float = float(1 << 25)
    engine: str = "np64"
    seed: Optional[int] = None
    error_std: float = 3.2
    ks_digits: int = 1                # hybrid key-switch digit size k = number
                                      # of special primes; digits = ceil(l/k)
                                      # at ciphertext level l (see BfvParams)

    def __post_init__(self):
        if not 1 <= self.ks_digits < len(self.coeff_modulus):
            raise ValueError(
                f"ks_digits={self.ks_digits} must satisfy 1 <= ks_digits < "
                f"len(coeff_modulus)={len(self.coeff_modulus)} (there must "
                f"be at least one data prime)")

    @property
    def data_primes(self) -> List[int]:
        return self.coeff_modulus[:self.L]

    @property
    def special_primes(self) -> List[int]:
        """The k key-switching special primes (trailing moduli)."""
        return self.coeff_modulus[self.L:]

    @property
    def special_prime(self) -> int:
        """P = product of the special primes (the key-switch scaling factor)."""
        out = 1
        for p in self.special_primes:
            out *= p
        return out

    @property
    def L(self) -> int:
        return len(self.coeff_modulus) - self.ks_digits

    @property
    def num_ks_digits(self) -> int:
        """α = number of key-switch digits at FULL level."""
        return -(-self.L // self.ks_digits)

    @property
    def digit_groups(self) -> List[List[int]]:
        """Data-prime index groups per key-switch digit (size ≤ k each)."""
        k = self.ks_digits
        return [list(range(j * k, min((j + 1) * k, self.L)))
                for j in range(self.num_ks_digits)]

    @property
    def slot_count(self) -> int:
        return self.n // 2

    @staticmethod
    def create(n: int, levels: int = 3, engine: str = "np64",
               seed: Optional[int] = None, scale_bits: int = 25,
               ks_digits: int = 1) -> "CkksParams":
        """Preset with 30-bit primes. Precision note: after a rescale the
        scale drops to 2^(2·scale_bits − 30), and rotation/relin noise is
        ~2^17 absolute (n·B_err) — at the default scale_bits=25 a
        post-rescale ciphertext carries only ~2^20 scale, so rotations on
        it see ~10-15%% relative error (measured; engine-independent).
        Workloads that rotate AFTER rescaling should use scale_bits≈29 so
        the scale is roughly prime-sized and stays put across rescales
        (the SEAL/Lattigo convention); the default keeps headroom for
        multiply-heavy, rotate-early circuits."""
        from abc_tpu.crypto.params import check_modulus_budget
        if ks_digits < 1 or ks_digits > levels:
            raise ValueError(f"ks_digits must be in [1, levels={levels}]")
        primes = gen_ntt_primes(30, levels + ks_digits, n)
        # 30·(levels+ks_digits) total bits must fit the HE-standard budget
        # for n (same guard as the BFV presets, crypto/params.py); warns on
        # dev-grade over-budget sets instead of refusing them.
        check_modulus_budget(n, primes, what=f"CkksParams(n={n}, levels={levels})")
        return CkksParams(n=n, coeff_modulus=primes, scale=float(1 << scale_bits),
                          engine=engine, seed=seed, ks_digits=ks_digits)


@dataclass
class CkksCiphertext:
    data: object            # [k, level, n] uint32, coefficient domain
    level: int              # number of active data limbs
    scale: float

    @property
    def size(self) -> int:
        return self.data.shape[0]


@dataclass
class CkksPlaintext:
    coeffs_rns: np.ndarray  # [level, n] residues of round(scale·m)
    level: int
    scale: float


class CkksContext:
    """Keys + tables for one CKKS parameter set."""

    def __init__(self, params: CkksParams):
        self.params = params
        # operation counters (same schema as BfvContext.counters)
        self.counters = {"relin": 0, "galois": 0, "decomp": 0,
                         "decomp_hit": 0, "mult": 0}
        n, moduli = params.n, params.coeff_modulus
        assert len({q.bit_length() for q in moduli}) == 1
        self._on_device = params.engine == "jx32"

        self.hqp = NttContext(n, moduli, engine="np64")
        self.ntt_qp = NttContext(n, moduli, engine=params.engine) \
            if self._on_device else self.hqp
        self.engine = self.ntt_qp.engine

        L, P = params.L, params.special_prime
        k = params.ks_digits
        self.full = L + k                  # size of the full extended base q∪P
        qs = params.data_primes
        host: Dict[str, np.ndarray] = {}
        host["q_full"] = np.asarray(moduli, dtype=np.uint32).reshape(-1, 1)
        host["mu_full"] = np.asarray([barrett_mu(q) for q in moduli],
                                     dtype=np.uint32).reshape(-1, 1)
        # mod-switch-down: divide by one special prime at a time (specials in
        # reverse order); per-step tables over the remaining FULL base, sliced
        # to the active limbs per level at use (rows are absolute limb
        # indices: data primes 0..L-1, specials L..L+k-1)
        self._msd_half = []
        for s in range(k):
            ps = params.special_primes[s]
            rest = moduli[:L + s]
            host[f"msd_p_mod_{s}"] = np.asarray(
                [ps % r for r in rest], dtype=np.uint32).reshape(-1, 1)
            host[f"msd_p_inv_{s}"] = np.asarray(
                [modinv(ps, r) for r in rest], dtype=np.uint32).reshape(-1, 1)
            self._msd_half.append(ps >> 1)
        # rescale tables: dropping prime q_l needs [q_l]_qj and q_l^{-1} mod qj
        drop_mod = np.zeros((L, L, 1), dtype=np.uint32)
        drop_inv = np.zeros((L, L, 1), dtype=np.uint32)
        for l in range(L):           # dropping limb l
            for j in range(L):
                if j != l:
                    drop_mod[l, j, 0] = qs[l] % qs[j]
                    drop_inv[l, j, 0] = modinv(qs[l], qs[j])
        host["drop_mod"] = drop_mod
        host["drop_inv"] = drop_inv

        # hybrid key-switch factors at FULL level: P·W_j mod every modulus,
        # W_j = Q̂_j·[Q̂_j^{-1}]_{Q_j} over the full data modulus Q (same
        # construction as BfvContext; see crypto/bfv.py module doc). The keys
        # stay valid at every lower level l because mod an ACTIVE prime q_r:
        # W_j ≡ 1 if r ∈ digit j (W_j ≡ 1 mod Q_j and q_r | Q_j regardless of
        # which other digit primes are dropped), W_j ≡ 0 otherwise — so the
        # level-restricted digit decomposition (digit products over active
        # primes only) recombines to d mod q^{(l)} exactly, Lattigo-style.
        alpha = params.num_ks_digits
        q_big = 1
        for q in qs:
            q_big *= q
        fac = np.zeros((alpha, self.full, 1), dtype=np.uint32)
        digit_products = []
        for j, grp in enumerate(params.digit_groups):
            Qj = 1
            for i in grp:
                Qj *= qs[i]
            digit_products.append(Qj)
            qhat = q_big // Qj
            w = qhat * modinv(qhat % Qj, Qj)
            for r, qr in enumerate(moduli):
                fac[j, r, 0] = (P * w) % qr
        self._ks_factors_full = fac
        host["ks_factors"] = fac

        # per-level digit fast-base-conversion tables (k ≥ 2): digit groups
        # intersected with the active limbs; short/partial digits pad with
        # inv_qhat = 0 rows (contribute exactly 0). Base = active ∪ specials.
        self._dec_tabs: Dict[int, Dict[str, np.ndarray]] = {}
        if k > 1:
            for level in range(1, L + 1):
                groups = [[i for i in grp if i < level]
                          for grp in params.digit_groups]
                groups = [g for g in groups if g]
                a_l = len(groups)
                cols = qs[:level] + params.special_primes
                gather = np.zeros((a_l, k), dtype=np.int64)
                inv_qhat = np.zeros((a_l, k, 1), dtype=np.uint32)
                q_src = np.ones((a_l, k, 1), dtype=np.uint32) * np.uint32(qs[0])
                qhat_ext = np.zeros((a_l, k, level + k, 1), dtype=np.uint32)
                for j, grp in enumerate(groups):
                    Qj = 1
                    for i in grp:
                        Qj *= qs[i]
                    for i, gi in enumerate(grp):
                        qi = qs[gi]
                        qh = Qj // qi
                        gather[j, i] = gi
                        q_src[j, i, 0] = qi
                        inv_qhat[j, i, 0] = modinv(qh % qi, qi)
                        for r, qr in enumerate(cols):
                            qhat_ext[j, i, r, 0] = qh % qr
                mu_src = np.vectorize(barrett_mu)(
                    q_src.astype(np.int64)).astype(np.uint32)
                self._dec_tabs[level] = dict(
                    alpha=a_l, gather=gather, inv_qhat=inv_qhat,
                    q_src=q_src, mu_src=mu_src, qhat_ext=qhat_ext)
        self._host = host

        if self._on_device:
            import jax.numpy as jnp
            self._dev = jnp.asarray
            self._tab = {name: jnp.asarray(v) for name, v in host.items()}
            # eager device copies of the per-level decomposition tables
            # (gather stays host numpy — it is an index set)
            for level, tabs in self._dec_tabs.items():
                for name in ("inv_qhat", "q_src", "mu_src", "qhat_ext"):
                    tabs[name] = jnp.asarray(tabs[name])
        else:
            self._dev = lambda x: x
            self._tab = host

        # slot map shares the BFV layout machinery: slot i ↔ exponent 3^i
        logn = n.bit_length() - 1
        m = 2 * n
        self._slot_exponents = np.empty(n // 2, dtype=np.int64)
        g = 1
        for i in range(n // 2):
            self._slot_exponents[i] = g
            g = g * 3 % m

        # Same two-domain randomness design as BfvContext (round 4 —
        # previously CKKS drew uniform material from the host Generator,
        # making keys draw-ORDER-dependent): uniform RLWE components come
        # from the counter PRNG at (PUBLIC-domain seed, stream), secrets
        # and errors from the SECRET domain, so keys are reproducible from
        # (master seed, key id) alone and the public seed is publishable.
        from abc_tpu.crypto.prng import split_domain
        self._master_seed = params.seed if params.seed is not None else \
            int(np.random.default_rng().integers(0, 2 ** 63))
        self._prng_seed = split_domain(self._master_seed, "public")
        self._sec_seed = split_domain(self._master_seed, "secret")
        self.rng = np.random.default_rng(self._sec_seed)
        self._keygen()
        self.relin_key: Optional[Tuple] = None
        self.galois_keys: Dict[int, Tuple] = {}
        self._perm_cache: Dict[int, Tuple] = {}

        # Precompute every leveled NTT-context view EAGERLY (outside any jit
        # trace): _key_switch/_ntt_at request these inside traces, where
        # fresh device tables would be per-trace constants that XLA leaves
        # inside loop bodies, re-running their gathers at run time.
        if self._on_device:
            for level in range(1, L + 1):
                self.ntt_qp.subset(list(range(level)))
                self.ntt_qp.subset(list(range(level)) +
                                   list(range(L, L + k)))

    # ------------------------------------------------------------------ sampling
    def _sample_ternary(self) -> np.ndarray:
        return self.rng.integers(-1, 2, size=self.params.n).astype(np.int64)

    def _sample_error(self) -> np.ndarray:
        e = np.rint(self.rng.normal(0.0, self.params.error_std, self.params.n))
        return np.clip(e, -19, 19).astype(np.int64)

    def _lift_signed(self, coeffs, limb_indices: Sequence[int]) -> np.ndarray:
        moduli = [self.params.coeff_modulus[i] for i in limb_indices]
        out = np.empty((len(moduli), self.params.n), dtype=np.uint32)
        for j, qj in enumerate(moduli):
            out[j] = np.mod(coeffs, qj).astype(np.uint32)
        return out

    @property
    def public_seed(self) -> int:
        """The PUBLIC-domain seed (see BfvContext.public_seed): regenerates
        every uniform `a` component; the only seed a seeded-key serializer
        may publish."""
        return self._prng_seed

    def _uniform_rns(self, limb_indices: Sequence[int],
                     stream: str) -> np.ndarray:
        """Uniform RNS rows from the counter PRNG at (PUBLIC-domain seed,
        stream): ONE [full, n] draw over the whole base, row-sliced to the
        requested limbs — any limb subset regenerates identical rows, and
        the scheme matches BfvContext's exactly, so the device keygen path
        (uniform_rns_jx_keys) and the seeded-checkpoint regeneration are
        shared between the schemes."""
        from abc_tpu.crypto.prng import uniform_rns_np
        full = uniform_rns_np(self._prng_seed, stream,
                              self.params.coeff_modulus, self.params.n)
        return np.ascontiguousarray(full[list(limb_indices)])

    def _keygen(self) -> None:
        L = self.params.L
        full = list(range(self.full))
        self.s_coeffs = self._sample_ternary()
        self.s_ntt_full = self.hqp.fwd(self._lift_signed(self.s_coeffs, full))
        a_ntt = self._uniform_rns(list(range(L)), "pk")
        hq = self.hqp.subset(list(range(L)))
        e_ntt = hq.fwd(self._lift_signed(self._sample_error(), list(range(L))))
        as_ntt = hq.pointwise_mul(a_ntt, self.s_ntt_full[:L])
        self.pk_b_ntt = hq.sub(hq.neg(as_ntt), e_ntt)
        self.pk_a_ntt = a_ntt
        self._hq = hq
        if self._on_device:
            import jax
            self._dev_s_ntt_full = jax.device_put(self.s_ntt_full)

    def sync_device_keys(self) -> None:
        """Refresh the jx32 device secret copy from the HOST arrays after a
        checkpoint restore — the constructor's fresh keygen installed a
        device copy of a DIFFERENT secret, and decrypt/device key builds
        read it (advisor r4). No-op on host engines."""
        if self._on_device:
            import jax
            self._dev_s_ntt_full = jax.device_put(self.s_ntt_full)

    # ------------------------------------------------------------------ keys
    def _make_ksk(self, s2_ntt_full: np.ndarray, stream: str) -> Tuple:
        """Full-level switching key [α, L+k, n] (one row per hybrid digit);
        leveled use slices rows and limb columns. Host numpy (trace-safe).
        `stream` ("relin" / "galois_<g>") keys the uniform + error draws,
        so the key is reproducible from (master seed, key id) regardless
        of materialization order."""
        from abc_tpu.crypto.prng import seeded_rng
        h = self.hqp
        n, full = self.params.n, self.full
        alpha = self.params.num_ks_digits
        rng_e = seeded_rng(self._sec_seed, f"{stream}/e")
        # float32 draws: same scheme as BfvContext._ksk_errors (round 5)
        errors = np.clip(
            np.rint(rng_e.standard_normal((alpha, n), dtype=np.float32)
                    * np.float32(self.params.error_std)),
            -19, 19).astype(np.int64)
        ksk_b = np.empty((alpha, full, n), dtype=np.uint32)
        ksk_a = np.empty((alpha, full, n), dtype=np.uint32)
        for j in range(alpha):
            a_j = self._uniform_rns(list(range(full)), f"{stream}/d{j}")
            e_j = h.fwd(self._lift_signed(errors[j], list(range(full))))
            term = h.engine.mul(s2_ntt_full, self._ks_factors_full[j],
                                h.q, h.mu)
            ksk_b[j] = h.add(h.sub(h.neg(h.pointwise_mul(a_j, self.s_ntt_full)),
                                   e_j), term)
            ksk_a[j] = a_j
        return ksk_b, ksk_a

    def _make_ksk_device(self, stream: str, g) -> Tuple:
        """Device-built switching key (jx32): reuses BfvContext's batched
        composition verbatim — the uniform digits regenerate in-jit from
        (public seed, stream), the target secret (s² for relin, τ_g(s) for
        galois) derives from the device-resident s_ntt_full, and only the
        int8 error samples cross the host→device boundary. Bit-identical
        to the host _make_ksk (cross-engine test)."""
        import jax
        from abc_tpu.crypto.bfv import _ksk_batch_jit
        from abc_tpu.crypto.prng import derive_key, seeded_rng
        n, alpha = self.params.n, self.params.num_ks_digits
        moduli = tuple(self.params.coeff_modulus)
        K_pad = 2
        k0s = np.zeros((K_pad, alpha), dtype=np.uint32)
        k1s = np.zeros((K_pad, alpha), dtype=np.uint32)
        for row, st in enumerate((stream, "pad/0")):
            for i in range(alpha):
                k0s[row, i], k1s[row, i] = derive_key(self._prng_seed,
                                                      f"{st}/d{i}")
        rng_e = seeded_rng(self._sec_seed, f"{stream}/e")
        errors = np.zeros((K_pad, alpha, n), dtype=np.int8)
        # float32 draws — must match _make_ksk exactly (round 5)
        errors[0] = np.clip(
            np.rint(rng_e.standard_normal((alpha, n), dtype=np.float32)
                    * np.float32(self.params.error_std)),
            -19, 19).astype(np.int8)
        perms = np.zeros((K_pad, n), dtype=np.int32)
        is_relin = np.zeros((K_pad, 1, 1), dtype=bool)
        if g is None:
            is_relin[0] = True
            perms[0] = np.arange(n, dtype=np.int32)
        else:
            perms[0] = self._galois_perm_eval(g).astype(np.int32)
        k0d, k1d, e_dev, p_dev, r_dev = jax.device_put(
            (k0s, k1s, errors, perms, is_relin))
        outs = _ksk_batch_jit(moduli, K_pad)(
            k0d, k1d, e_dev, p_dev, r_dev, self._dev_s_ntt_full,
            self._tab["ks_factors"], self._tab["q_full"],
            self._tab["mu_full"], self.ntt_qp.fwd_tw, self.ntt_qp.fwd_tw_sh)
        return outs[0]

    def _build_ksk(self, stream: str, g, s2_host) -> Tuple:
        """Route to the device builder when available and trace-clean
        (in-trace device builds would cache tracers); host numpy else."""
        if self._on_device:
            from abc_tpu.utils.tracing import trace_state_clean
            if trace_state_clean():
                return self._make_ksk_device(stream, g)
        return self._make_ksk(s2_host(), stream)

    # key plumbing for whole-program jit — see BfvContext.record_key_requests
    def record_key_requests(self, store) -> None:
        self._key_requests = store

    def set_key_overrides(self, overrides) -> None:
        self._key_overrides = overrides

    def materialize_key(self, key_id: str) -> Tuple:
        if key_id == "relin":
            return self.get_relin_key()
        assert key_id.startswith("galois_"), key_id
        return self.get_galois_key(int(key_id[len("galois_"):]))

    def get_relin_key(self) -> Tuple:
        req = getattr(self, "_key_requests", None)
        if req is not None:
            req.add("relin")
        ov = getattr(self, "_key_overrides", None)
        if ov and "relin" in ov:
            return ov["relin"]
        if self.relin_key is None:
            self.relin_key = self._build_ksk(
                "relin", None,
                lambda: self.hqp.pointwise_mul(self.s_ntt_full,
                                               self.s_ntt_full))
        return self.relin_key

    def get_galois_key(self, g: int) -> Tuple:
        req = getattr(self, "_key_requests", None)
        if req is not None:
            req.add(f"galois_{g}")
        ov = getattr(self, "_key_overrides", None)
        if ov and f"galois_{g}" in ov:
            return ov[f"galois_{g}"]
        if g not in self.galois_keys:
            # τ_g applied in the EVALUATION domain as a pure permutation of
            # s_ntt_full (same identity as BfvContext._ksk_target_host:
            # τ_g(s)'s eval at ψ^e is s's eval at ψ^{e·g}) — bit-identical
            # to coefficient-automorphism + forward NTT, minus the NTT.
            self.galois_keys[g] = self._build_ksk(
                f"galois_{g}", g,
                lambda: np.ascontiguousarray(
                    self.s_ntt_full[..., self._galois_perm_eval(g)]))
        return self.galois_keys[g]

    def _galois_perm_host(self, g: int):
        # vectorized (see BfvContext._galois_perm_host)
        n = self.params.n
        j = np.arange(n, dtype=np.int64)
        jg = (j * g) % (2 * n)
        wrap = jg >= n
        idx = np.where(wrap, jg - n, jg)
        gather = np.empty(n, dtype=np.int64)
        sign_pos = np.empty(n, dtype=bool)
        gather[idx] = j
        sign_pos[idx] = ~wrap
        return gather, sign_pos

    def _galois_perm(self, g: int):
        if g not in self._perm_cache:
            self._perm_cache[g] = self._galois_perm_host(g)
        return self._perm_cache[g]

    # ------------------------------------------------------------------ encoding
    def encode(self, values: Sequence[complex], level: Optional[int] = None,
               scale: Optional[float] = None) -> CkksPlaintext:
        """Canonical-embedding encode of ≤ n/2 complex (or real) values."""
        n = self.params.n
        level = level if level is not None else self.params.L
        scale = scale if scale is not None else self.params.scale
        half = n // 2
        if len(values) > half:
            raise RuntimeExecutionError(f"too many values: {len(values)} > {half}")
        z = np.zeros(half, dtype=np.complex128)
        z[:len(values)] = np.asarray(values, dtype=np.complex128)
        # full evaluation vector over exponents 2k+1: A[(e-1)/2] = value
        A = np.zeros(n, dtype=np.complex128)
        for i in range(half):
            e = self._slot_exponents[i]
            A[(e - 1) // 2] = z[i]
            A[(2 * n - e - 1) // 2] = np.conj(z[i])
        # A = n·ifft(m ⊙ ψ⁺)  ⇒  m = (fft(A)/n) ⊙ ψ⁻,  ψ± = e^{±iπj/n}
        psi = np.exp(-1j * np.pi * np.arange(n) / n)
        m = np.fft.fft(A) / n * psi
        m_real = np.real(m) * scale
        coeffs = np.rint(m_real).astype(object)
        return CkksPlaintext(self._lift_signed(coeffs, list(range(level))),
                             level, scale)

    def decode(self, pt: CkksPlaintext) -> np.ndarray:
        """Decode to n/2 complex values (host, exact CRT + float)."""
        n = self.params.n
        half = n // 2
        qs = self.params.data_primes[:pt.level]
        q_big = 1
        for q in qs:
            q_big *= q
        acc = np.zeros(n, dtype=object)
        for l, ql in enumerate(qs):
            qhat = q_big // ql
            c = qhat * modinv(qhat % ql, ql)
            acc = (acc + pt.coeffs_rns[l].astype(object) * c) % q_big
        m = np.array([centered(int(v), q_big) for v in acc], dtype=np.float64)
        m /= pt.scale
        psi_plus = np.exp(1j * np.pi * np.arange(n) / n)
        A = np.fft.ifft(m * psi_plus) * n
        z = np.empty(half, dtype=np.complex128)
        for i in range(half):
            e = self._slot_exponents[i]
            z[i] = A[(e - 1) // 2]
        return z

    # ------------------------------------------------------------------ encrypt
    def encrypt(self, pt: CkksPlaintext) -> CkksCiphertext:
        L = self.params.L
        if pt.level != L:
            raise RuntimeExecutionError("encrypt expects a full-level plaintext")
        hq = self._hq
        u_ntt = hq.fwd(self._lift_signed(self._sample_ternary(), list(range(L))))
        e0 = self._lift_signed(self._sample_error(), list(range(L)))
        e1 = self._lift_signed(self._sample_error(), list(range(L)))
        c0 = hq.engine.add(hq.inv(hq.pointwise_mul(self.pk_b_ntt, u_ntt)), e0, hq.q)
        c1 = hq.engine.add(hq.inv(hq.pointwise_mul(self.pk_a_ntt, u_ntt)), e1, hq.q)
        c0 = hq.engine.add(c0, pt.coeffs_rns, hq.q)
        return CkksCiphertext(self._dev(np.stack([c0, c1])), L, pt.scale)

    def decrypt(self, ct: CkksCiphertext) -> CkksPlaintext:
        """c₀ + c₁·s (+ c₂·s² …) via NTT-domain dot + inverse transform.
        jx32 contexts run the whole computation ON DEVICE (one jitted
        call; only the [level, n] coefficient residues cross the boundary
        — round 5, matching BfvContext._decrypt_device); host engines use
        the np64 path. Decode (exact CRT + float embedding) stays host."""
        if self._on_device:
            return self._decrypt_device(ct)
        idx = list(range(ct.level))
        h = self.hqp.subset(idx)
        data = np.asarray(ct.data).astype(np.uint32)
        v_ntt = h.fwd(data[0])
        s_pow = None
        for k in range(1, ct.size):
            s_pow = self.s_ntt_full[idx] if s_pow is None else \
                h.pointwise_mul(s_pow, self.s_ntt_full[idx])
            v_ntt = h.add(v_ntt, h.pointwise_mul(h.fwd(data[k]), s_pow))
        return CkksPlaintext(h.inv(v_ntt), ct.level, ct.scale)

    def _decrypt_device(self, ct: CkksCiphertext) -> CkksPlaintext:
        import jax.numpy as jnp

        from abc_tpu.crypto.bfv import _mjit
        level, size = ct.level, ct.size
        ntt = self._ntt_at(level)            # precomputed jx32 view
        q, mu = self._tabs_at(level)

        def make():
            def dec(data, s_full, qv, muv, fwd_tw, fwd_tw_sh, inv_tw,
                    inv_tw_sh, n_inv, n_inv_sh):
                from abc_tpu.crypto.ntt import _fwd_stages, _inv_stages
                from abc_tpu.ops.modarith import jx32 as e
                s = s_full[:level]           # in-jit slice (no dispatch)
                f = _fwd_stages(e, data, fwd_tw, fwd_tw_sh, qv)
                v = f[0]
                sp = None
                for k in range(1, size):
                    sp = s if sp is None else e.mul(sp, s, qv, muv)
                    v = e.add(v, e.mul(f[k], sp, qv, muv), qv)
                return _inv_stages(e, v, inv_tw, inv_tw_sh, qv, n_inv,
                                   n_inv_sh)
            return dec

        fn = _mjit(("ckks_dec", self.params.n,
                    tuple(self.params.coeff_modulus), level, size), make)
        data = ct.data if not isinstance(ct.data, np.ndarray) \
            else jnp.asarray(ct.data)
        out = fn(data, self._dev_s_ntt_full, q, mu,
                 ntt.fwd_tw, ntt.fwd_tw_sh, ntt.inv_tw, ntt.inv_tw_sh,
                 ntt.n_inv, ntt.n_inv_sh)
        return CkksPlaintext(np.asarray(out), level, ct.scale)

    # ------------------------------------------------------------- homomorphic ops
    def _ntt_at(self, level: int) -> NttContext:
        return self.ntt_qp.subset(list(range(level)))

    def _tabs_at(self, level: int):
        q = self._tab["q_full"][:level]
        mu = self._tab["mu_full"][:level]
        return q, mu

    def add(self, a: CkksCiphertext, b: CkksCiphertext) -> CkksCiphertext:
        a, b = self._align(a, b)
        q, _ = self._tabs_at(a.level)
        return CkksCiphertext(self.engine.add(a.data, b.data, q), a.level, a.scale)

    def sub(self, a: CkksCiphertext, b: CkksCiphertext) -> CkksCiphertext:
        a, b = self._align(a, b)
        q, _ = self._tabs_at(a.level)
        return CkksCiphertext(self.engine.sub(a.data, b.data, q), a.level, a.scale)

    def _align(self, a: CkksCiphertext, b: CkksCiphertext,
               match_scale: bool = True):
        """Level AND scale alignment for add/sub (round-5, VERDICT weak 6 —
        previously a scale mismatch raised 'rescale first', pushing the
        choreography onto every caller):

        1. A side carrying a raw-product scale (≥1.5× both the other side
           and the base scale) is rescaled down — never past the other
           side's scale (over-rescaling drives the scales further apart).
        2. A larger-scale side that sits at a HIGHER level than the other
           is bridged DOWN through one of the levels the alignment is
           about to drop anyway: ct · round(target·q_drop/scale) then
           rescale — so the common scale is the SMALLER one. Lifting the
           small side up instead (the pre-fix behavior) can exceed the
           few limbs left at the common level: at one 30-bit limb a
           2^28-lifted sum leaves <2 bits of coefficient headroom, the
           DC coefficient wraps q0 and every slot shifts by q0/scale
           (found live by tests/test_auto_params_fuzz.py, +4.0 on every
           lane).
        3. Levels are aligned by exact modulus reduction (mod_drop_to).
        4. A remaining ≥1.5× ratio (scale drift from prime≠2^scale_bits
           accumulating per rescale) is closed by an exact integer lift of
           the smaller-scale side: ct·m with scale·m — message AND noise
           scale together, so relative precision is unchanged.
        5. Residual sub-10% drift is absorbed by relabeling to the common
           scale — the standard approximate-arithmetic resolution; beyond
           10% we raise rather than silently distort.

        Equal-scale pairs (in particular two lazy un-rescaled products —
        the deferred-rescale fast path) are untouched."""
        if match_scale and not (2 / 3 < a.scale / b.scale < 1.5):
            base = self.params.scale
            while a.scale >= 1.5 * max(b.scale, base) and a.level > 1:
                a = self.rescale(a)
            while b.scale >= 1.5 * max(a.scale, base) and b.level > 1:
                b = self.rescale(b)
        if match_scale:
            a, b = self._bridge_down(a, b)
            b, a = self._bridge_down(b, a)
        if a.level != b.level:
            target = min(a.level, b.level)
            a = self.mod_drop_to(a, target)
            b = self.mod_drop_to(b, target)
        if match_scale and a.scale != b.scale:
            r = a.scale / b.scale
            if r >= 1.5:
                b = self._scale_lift(b, round(r))
            elif r <= 2 / 3:
                a = self._scale_lift(a, round(1.0 / r))
            r = a.scale / b.scale
            if not (0.9 < r < 1.1):
                raise RuntimeExecutionError(
                    f"unresolvable scale mismatch: {a.scale} vs {b.scale} "
                    f"(ratio {r:.3g})")
            b = CkksCiphertext(b.data, b.level, a.scale)
        return a, b

    def _bridge_down(self, hi: CkksCiphertext, lo: CkksCiphertext):
        """_align step 2: when `hi` carries ≥1.5× `lo`'s scale AND a spare
        level that the coming level-alignment would drop regardless, lower
        hi's scale to ≈lo.scale by an exact integer multiply through that
        level: hi · round(lo.scale·q_drop/hi.scale), rescale. Returns the
        (possibly bridged) pair in the original order."""
        while (hi.scale >= 1.5 * lo.scale and hi.level > lo.level
               and hi.level > 1):
            q_drop = self.params.data_primes[hi.level - 1]
            m = round(lo.scale * q_drop / hi.scale)
            if m < 2:       # scales too far apart for one bridge level —
                break       # fall back to the step-4 lift
            hi = self.rescale(self._scale_lift(hi, m))
        return hi, lo

    def _scale_lift(self, ct: CkksCiphertext, m: int) -> CkksCiphertext:
        """Exact multiplication by the integer m ≥ 1: every RNS component
        times m mod q_j, scale·m. Message and noise both scale by m, so the
        ciphertext's relative precision is preserved — the cheap half of
        scale alignment (no level consumed)."""
        if m <= 1:
            return ct
        level = ct.level
        q, mu = self._tabs_at(level)
        mv = np.asarray([m % int(p) for p in
                         self.params.data_primes[:level]],
                        dtype=np.uint32).reshape(-1, 1)
        out = self.engine.mul(ct.data, self._dev(mv), q, mu)
        return CkksCiphertext(out, level, ct.scale * m)

    def mod_drop_to(self, ct: CkksCiphertext, level: int) -> CkksCiphertext:
        """Drop limbs WITHOUT scaling (modulus reduction, exact)."""
        if level == ct.level:
            return ct
        if level > ct.level:
            raise RuntimeExecutionError("cannot raise a ciphertext's level")
        return CkksCiphertext(ct.data[:, :level], level, ct.scale)

    def multiply(self, a: CkksCiphertext, b: CkksCiphertext,
                 relinearize: bool = True, rescale: bool = True) -> CkksCiphertext:
        # multiplication composes scales; only levels need aligning
        a, b = self._align(a, b, match_scale=False)
        level = a.level
        ntt = self._ntt_at(level)
        q, mu = self._tabs_at(level)
        self.counters["mult"] += 1
        fa, fb = ntt.fwd(a.data), ntt.fwd(b.data)
        e = self.engine
        d0 = e.mul(fa[0], fb[0], q, mu)
        d1 = e.add(e.mul(fa[0], fb[1], q, mu), e.mul(fa[1], fb[0], q, mu), q)
        d2 = e.mul(fa[1], fb[1], q, mu)
        data = ntt.inv(_stack([d0, d1, d2]))
        ct = CkksCiphertext(data, level, a.scale * b.scale)
        if relinearize:
            ct = self.relinearize(ct)
        if rescale:
            ct = self.rescale(ct)
        return ct

    def multiply_plain(self, ct: CkksCiphertext,
                       pt: CkksPlaintext) -> CkksCiphertext:
        """ct × plaintext: pointwise NTT product of every component with the
        encoded coefficients — no relinearization needed (size preserved),
        scale composes. The plaintext half of the BSGS matvec
        (crypto/linalg.matvec_bsgs_ckks)."""
        level = min(ct.level, pt.level)
        ct = self.mod_drop_to(ct, level)
        ntt = self._ntt_at(level)
        q, mu = self._tabs_at(level)
        m = self._dev(np.ascontiguousarray(pt.coeffs_rns[:level]))
        prod = self.engine.mul(ntt.fwd(ct.data), ntt.fwd(m), q, mu)
        return CkksCiphertext(ntt.inv(prod), level, ct.scale * pt.scale)

    def relinearize(self, ct: CkksCiphertext) -> CkksCiphertext:
        if ct.size == 2:
            return ct
        self.counters["relin"] += 1
        k0, k1 = self._key_switch(ct.data[2], self.get_relin_key(), ct.level)
        q, _ = self._tabs_at(ct.level)
        xp = _xp(ct.data)
        c0 = self.engine.add(ct.data[0], k0, q)
        c1 = self.engine.add(ct.data[1], k1, q)
        return CkksCiphertext(xp.stack([c0, c1]), ct.level, ct.scale)

    def rescale(self, ct: CkksCiphertext) -> CkksCiphertext:
        """Exact RNS rescale: drop the last data limb and divide by its prime
        (centered), scale /= q_dropped."""
        level = ct.level
        if level <= 1:
            raise RuntimeExecutionError("no level left to rescale into")
        drop = level - 1
        q_drop = self.params.data_primes[drop]
        xp = _xp(ct.data)
        q, mu = self._tabs_at(drop)
        x_q = ct.data[:, :drop]                    # [k, drop, n]
        x_l = ct.data[:, drop]                     # [k, n]
        x_l_red = xp.where(x_l[:, None, :] >= q, x_l[:, None, :] - q,
                           x_l[:, None, :])
        over = x_l[:, None, :] > _u32(xp, q_drop >> 1)
        drop_mod = self._tab["drop_mod"][drop][:drop]
        drop_inv = self._tab["drop_inv"][drop][:drop]
        corr = xp.where(over, self.engine.sub(x_l_red, drop_mod, q), x_l_red)
        diff = self.engine.sub(x_q, corr, q)
        out = self.engine.mul(diff, drop_inv, q, mu)
        return CkksCiphertext(out, drop, ct.scale / q_drop)

    # ------------------------------------------------------------- key switching
    def _ksk_device(self, ksk, level: int, cols_idx) -> Tuple:
        """Per-level device slices of a switching key, cached trace-aware
        (numpy slicing inside a jit trace re-creates the ~10 MB constants
        on every trace and measurably slows the compiled loop body)."""
        ksk_b_full, ksk_a_full = ksk
        ck = (id(ksk_b_full), level)
        cache = getattr(self, "_ksk_dev_cache", None)
        if cache is None:
            cache = self._ksk_dev_cache = {}
        hit = cache.get(ck)
        if hit is not None and hit[0] is ksk_b_full:   # ids recycle: verify
            return hit[1]
        alpha = self._alpha_at(level)
        if isinstance(ksk_b_full, np.ndarray):
            dev = (self._dev(ksk_b_full[:alpha][:, cols_idx]),
                   self._dev(ksk_a_full[:alpha][:, cols_idx]))
        else:
            # device-BUILT key (round 4): cols_idx is always the two
            # contiguous ranges [0, level) ∪ [L, L+k) (_ks_cols), so basic
            # slices + concat replace the eager fancy-index gather, which
            # cost a first-use XLA compile per (key, level)
            import jax.numpy as jnp
            L, k = self.params.L, self.params.ks_digits
            assert np.array_equal(
                cols_idx, np.concatenate([np.arange(level),
                                          np.arange(L, L + k)]))

            def cut(arr):
                a = arr[:alpha]
                if level == L:
                    return a
                return jnp.concatenate([a[:, :level], a[:, L:L + k]],
                                       axis=1)
            dev = (cut(ksk_b_full), cut(ksk_a_full))
        from abc_tpu.utils.tracing import trace_state_clean
        if trace_state_clean():            # in-trace values are tracers
            cache[ck] = (ksk_b_full, dev)
        return dev

    def _ks_cols(self, level: int) -> np.ndarray:
        """Extended-base limb indices at `level`: active data ∪ all specials."""
        L, k = self.params.L, self.params.ks_digits
        return np.asarray(list(range(level)) + list(range(L, L + k)),
                          dtype=np.int64)

    def _alpha_at(self, level: int) -> int:
        """Number of hybrid digits intersecting the active limbs."""
        return -(-level // self.params.ks_digits)

    def _decompose_ntt(self, d, level: int):
        """RNS-decompose d ([level, n]) into α(level) = ⌈level/k⌉ hybrid
        digits and lift each to base q^(level)∪P in NTT domain:
        [α, level+k, n]. The expensive half of a key switch —
        hoisted_rotations computes it once per ciphertext."""
        n, k = self.params.n, self.params.ks_digits
        cols_idx = self._ks_cols(level)
        cols = list(cols_idx)
        ncols = level + k
        xp = _xp(d)
        q_cols = self._tab["q_full"][cols_idx].reshape(1, ncols, 1)
        if k == 1:
            # single-limb digits: the lift is a conditional subtract
            # (uniform 30-bit primes), no multiplies needed
            lifted = xp.broadcast_to(d[:, None, :], (level, ncols, n))
            lifted = xp.where(lifted >= q_cols, lifted - q_cols, lifted)
            return self.ntt_qp.subset(cols).fwd(lifted)
        # k ≥ 2: fast base conversion of each active digit [d]_{Q_j^(l)}
        tabs = self._dec_tabs[level]
        alpha = tabs["alpha"]
        mu_cols = self._tab["mu_full"][cols_idx].reshape(1, ncols, 1)
        y_src = d[tabs["gather"].reshape(-1)].reshape(alpha, k, n)
        y = self.engine.mul(y_src, tabs["inv_qhat"],
                            tabs["q_src"], tabs["mu_src"])
        D = None
        for i in range(k):
            term = self.engine.mul(
                xp.broadcast_to(y[:, i:i + 1, :], (alpha, ncols, n)),
                tabs["qhat_ext"][:, i], q_cols, mu_cols)
            D = term if D is None else self.engine.add(D, term, q_cols)
        return self.ntt_qp.subset(cols).fwd(D)

    def _ks_inner(self, D, ksk_b, ksk_a, level: int) -> Tuple:
        cols_idx = self._ks_cols(level)
        ncols = len(cols_idx)
        ntt = self.ntt_qp.subset(list(cols_idx))
        xp = _xp(D)
        q_cols = self._tab["q_full"][cols_idx].reshape(1, ncols, 1)
        mu_cols = self._tab["mu_full"][cols_idx].reshape(1, ncols, 1)
        tb = self.engine.mul(D, ksk_b, q_cols, mu_cols)
        ta = self.engine.mul(D, ksk_a, q_cols, mu_cols)
        acc_b = _acc_mod(tb, self._tab["q_full"][cols_idx], self.engine)
        acc_a = _acc_mod(ta, self._tab["q_full"][cols_idx], self.engine)
        acc = ntt.inv(xp.stack([acc_b, acc_a]))     # one batched inverse
        return (self._mod_switch_down(acc[0], level),
                self._mod_switch_down(acc[1], level))

    def _key_switch(self, d, ksk, level: int) -> Tuple:
        """Hybrid key switch at `level`: α(level) digit rows, limbs
        {0..level-1} ∪ specials."""
        ksk_b, ksk_a = self._ksk_device(ksk, level, self._ks_cols(level))
        return self._ks_inner(self._decompose_ntt(d, level),
                              ksk_b, ksk_a, level)

    def _mod_switch_down(self, x, level: int):
        """[level+k, n] over q^(level)∪P → [level, n]: k successive exact
        centered divisions (x − centered([x]_{p_s}))·p_s^{-1}, last special
        first (rows ordered [active data..., specials...])."""
        L, k = self.params.L, self.params.ks_digits
        xp = _xp(x)
        for s in reversed(range(k)):
            rows = level + s
            idx = np.asarray(list(range(level)) + list(range(L, L + s)),
                             dtype=np.int64)
            qv = self._tab["q_full"][idx]
            muv = self._tab["mu_full"][idx]
            x_rest, x_p = x[:rows], x[rows]
            x_p_red = xp.where(x_p >= qv, x_p - qv, x_p)
            over = x_p > _u32(xp, self._msd_half[s])
            corr = xp.where(over,
                            self.engine.sub(x_p_red,
                                            self._tab[f"msd_p_mod_{s}"][idx],
                                            qv),
                            x_p_red)
            diff = self.engine.sub(x_rest, corr, qv)
            x = self.engine.mul(diff, self._tab[f"msd_p_inv_{s}"][idx],
                                qv, muv)
        return x

    # ------------------------------------------------------------------ rotations
    def _galois_perm_eval(self, g: int) -> np.ndarray:
        """Automorphism x → x^g as a PURE permutation of NTT positions
        (same convention as BfvContext._galois_perm_eval: position p holds
        the eval at ψ^{2·brv(p)+1}). Enables hoisting."""
        key = ("eval", g)
        if key not in self._perm_cache:
            from abc_tpu.crypto.ntt import eval_perm_tables
            n = self.params.n
            e, pos_of_exp = eval_perm_tables(n)      # module-cached per n
            self._perm_cache[key] = pos_of_exp[(e * g) % (2 * n)]
        return self._perm_cache[key]

    def _decompose_cached(self, ct_data, level: int):
        """Key-switch decomposition with an identity-keyed cache — repeated
        rotations of the SAME ciphertext share the forward NTTs (same
        transparent hoisting as BfvContext._decompose_cached; level is part
        of the validity check since the decomposition shape depends on it)."""
        from abc_tpu.utils.tracing import trace_token
        cache = getattr(self, "_dec_cache", None)
        if cache is None:
            from collections import OrderedDict
            cache = self._dec_cache = OrderedDict()
        tok = trace_token()   # see BfvContext._decompose_cached: entries
        key = id(ct_data)     # from one trace must not serve another
        hit = cache.get(key)
        if hit is not None and hit[0] is ct_data and hit[1] == level \
                and hit[3] == tok:
            cache.move_to_end(key)
            self.counters["decomp_hit"] += 1
            return hit[2]
        self.counters["decomp"] += 1
        D = self._decompose_ntt(ct_data[1], level)
        cache[key] = (ct_data, level, D, tok)
        while len(cache) > 8:
            cache.popitem(last=False)
        return D

    def hoisted_rotations(self, ct: CkksCiphertext,
                          steps_list: Sequence[int]) -> List[CkksCiphertext]:
        """Rotate ONE ciphertext by MANY step counts sharing the key-switch
        decomposition (the L·(L+1) forward NTTs run once); see
        BfvContext.hoisted_rotations."""
        n = self.params.n
        level = ct.level
        xp = _xp(ct.data)
        cols_idx = self._ks_cols(level)
        D = self._decompose_cached(ct.data, level)
        q, _ = self._tabs_at(level)
        out = []
        for steps in steps_list:
            s = steps % (n // 2)
            if s == 0:
                out.append(CkksCiphertext(ct.data, level, ct.scale))
                continue
            g = pow(3, s, 2 * n)   # same slot generator as rotate()
            self.counters["galois"] += 1
            perm = self._galois_perm_eval(g)
            ksk_b, ksk_a = self._ksk_device(self.get_galois_key(g), level,
                                            cols_idx)
            k0, k1 = self._ks_inner(D[..., perm], ksk_b, ksk_a, level)
            gather, sign_pos = self._galois_perm(g)
            c0g = ct.data[0][..., gather]
            sp = xp.asarray(sign_pos) if hasattr(xp, "asarray") else sign_pos
            c0g = xp.where(sp, c0g, self.engine.neg(c0g, q))
            out.append(CkksCiphertext(
                xp.stack([self.engine.add(c0g, k0, q), k1]),
                level, ct.scale))
        return out

    def rotate(self, ct: CkksCiphertext, steps: int) -> CkksCiphertext:
        """Rotate the n/2 complex slots by `steps` (positive = left), in
        the HOISTED formulation: decompose the untouched c1 (cacheable
        across rotations of the same ciphertext), permute the decomposition
        in the NTT domain — mirrors BfvContext.apply_galois."""
        n = self.params.n
        steps = steps % (n // 2)
        if steps == 0:
            return ct
        self.counters["galois"] += 1
        g = pow(3, steps, 2 * n)
        level = ct.level
        xp = _xp(ct.data)
        q, _ = self._tabs_at(level)
        cols_idx = self._ks_cols(level)
        D = self._decompose_cached(ct.data, level)
        perm = self._galois_perm_eval(g)
        ksk_b, ksk_a = self._ksk_device(self.get_galois_key(g), level,
                                        cols_idx)
        k0, k1 = self._ks_inner(D[..., perm], ksk_b, ksk_a, level)
        gather, sign_pos = self._galois_perm(g)
        c0g = ct.data[0][..., gather]
        sp = xp.asarray(sign_pos) if hasattr(xp, "asarray") else sign_pos
        c0g = xp.where(sp, c0g, self.engine.neg(c0g, q))
        c0 = self.engine.add(c0g, k0, q)
        return CkksCiphertext(xp.stack([c0, k1]), level, ct.scale)


# --------------------------------------------------------------------- helpers

def _xp(arr):
    if isinstance(arr, np.ndarray):
        return np
    import jax.numpy as jnp
    return jnp


def _u32(xp, v: int):
    return xp.uint32(v)


def _stack(parts):
    return _xp(parts[0]).stack(parts)


def _acc_mod(terms, q, engine):
    if isinstance(terms, np.ndarray):
        s = terms.astype(np.uint64).sum(axis=0)
        return (s % np.asarray(q).astype(np.uint64)).astype(np.uint32)
    acc = terms[0]
    for k in range(1, terms.shape[0]):
        acc = engine.add(acc, terms[k], q)
    return acc
