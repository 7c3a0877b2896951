"""BFV runtime backend: the SealCiphertextFactory/SealCiphertext equivalent.

Reference: src/runtime/SealCiphertextFactory.cpp (factory owning context +
keys, createCiphertext/decryptCiphertext, last-element expandVector padding
:102-115) and SealCiphertext.cpp (op dispatch; every multiply followed by
relinearization :102-124; rotateRows via Galois keys :52-61). Here the crypto
engine is abc_tpu.crypto (JAX on the device) instead of SEAL (CPU).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from abc_tpu.crypto.bfv import BfvCiphertext, BfvContext, Plaintext
from abc_tpu.crypto.params import BfvParams
from abc_tpu.ops.modarith import default_engine
from abc_tpu.runtime.backend import AbstractCiphertextFactory
from abc_tpu.runtime.values import AbstractCiphertext, Cleartext
from abc_tpu.utils.errors import RuntimeExecutionError


def _zero_pad(data, size: int):
    """Pad a [k, L, n] ciphertext component stack with zero components."""
    import numpy as np
    if isinstance(data, np.ndarray):
        xp = np
    else:
        import jax.numpy as xp
    pad = xp.zeros((size - data.shape[0],) + data.shape[1:], dtype=data.dtype)
    return xp.concatenate([data, pad])


class BfvRuntimeCiphertext(AbstractCiphertext):
    """Ciphertext handle dispatching to the BFV context (pure ops).

    Relinearization is LAZY: multiply returns the raw size-3 BEHZ product
    (the reference relinearizes after every multiply,
    SealCiphertext.cpp:121-124 — here that key switch is deferred).
    Size-3 ciphertexts flow freely through add/subtract (the shorter
    operand is zero-padded) and plaintext ops, and decrypt/noise read them
    directly (c0 + c1·s + c2·s²). The key switch runs only when a later
    rotation or ciphertext multiply actually needs a size-2 operand — so an
    accumulation tree of products costs at most ONE relinearization instead
    of one per multiply (tests/test_lazy_relin.py asserts the counts)."""

    __slots__ = ("ct", "factory")

    def __init__(self, ct: BfvCiphertext, factory: "BfvCiphertextFactory"):
        self.ct = ct
        self.factory = factory

    def _ctx(self) -> BfvContext:
        return self.factory.context

    def _relin(self) -> BfvCiphertext:
        """The size-2 form of this ciphertext (key switch if deferred)."""
        return self._ctx().relinearize(self.ct)

    def _aligned(self, other) -> tuple:
        """Zero-pad the smaller of (self.ct, other.ct) so both have the
        same size — adding a zero c2 component is exact and free compared
        to relinearizing early."""
        a, b = self.ct.data, other.ct.data
        if a.shape[0] < b.shape[0]:
            a = _zero_pad(a, b.shape[0])
        elif b.shape[0] < a.shape[0]:
            b = _zero_pad(b, a.shape[0])
        return BfvCiphertext(a), BfvCiphertext(b)

    def add(self, other):
        a, b = self._aligned(other)
        return BfvRuntimeCiphertext(self._ctx().add(a, b), self.factory)

    def subtract(self, other):
        a, b = self._aligned(other)
        return BfvRuntimeCiphertext(self._ctx().sub(a, b), self.factory)

    def multiply(self, other):
        a = self._relin()
        b = other._relin() if other is not self else a
        return BfvRuntimeCiphertext(
            self._ctx().multiply(a, b, relinearize=False), self.factory)

    # ctxt ⊕ plain
    def _encode(self, cleartext: Cleartext) -> Plaintext:
        return self.factory.encode_cleartext(cleartext)

    def add_plain(self, other):
        return BfvRuntimeCiphertext(self._ctx().add_plain(self.ct, self._encode(other)),
                                self.factory)

    def subtract_plain(self, other):
        return BfvRuntimeCiphertext(self._ctx().sub_plain(self.ct, self._encode(other)),
                                self.factory)

    def subtract_from_plain(self, other):
        return BfvRuntimeCiphertext(
            self._ctx().sub_from_plain(self.ct, self._encode(other)), self.factory)

    def multiply_plain(self, other):
        return BfvRuntimeCiphertext(
            self._ctx().multiply_plain(self.ct, self._encode(other)), self.factory)

    def rotate_rows(self, steps: int):
        return BfvRuntimeCiphertext(
            self._ctx().rotate_rows(self._relin(), steps), self.factory)

    def rotate_columns(self):
        return BfvRuntimeCiphertext(
            self._ctx().rotate_columns(self._relin()), self.factory)

    def clone(self):
        return BfvRuntimeCiphertext(self.ct, self.factory)  # immutable: share

    def noise_bits(self) -> int:
        """ref: SealCiphertext::noiseBits (SealCiphertext.cpp:80-83)."""
        return self._ctx().noise_budget(self.ct)


class BfvCiphertextFactory(AbstractCiphertextFactory):
    """Factory owning the BFV context + keys (ref: SealCiphertextFactory.h:12-40;
    default n = 16384 there, configurable like SealCiphertextFactory(slots))."""

    def __init__(self, slots: int = 8192, engine: Optional[str] = None,
                 seed: Optional[int] = None, plain_bits: int = 20,
                 context: Optional[BfvContext] = None):
        if context is not None:
            # pre-built context (e.g. an explicit-limb-count chain for the
            # mesh-sharded JIT, parallel/dryrun.py:build_context)
            self.context = context
            self.params = context.params
            return
        if engine is None:
            engine = default_engine()
        self.params = BfvParams.create(slots, engine=engine, seed=seed,
                                       plain_bits=plain_bits)
        self.context = BfvContext(self.params)

    @property
    def slot_count(self) -> int:
        return self.params.slot_count

    def encode_cleartext(self, cleartext: Cleartext) -> Plaintext:
        """Cleartext → plaintext with last-element padding to all slots
        (ref: expandVector, SealCiphertextFactory.cpp:102-115)."""
        vals = [int(v) for v in cleartext.values]
        return self.context.encode(self.expand_vector(vals))

    def create_ciphertext(self, value: Union[Cleartext, Sequence[int], int]
                          ) -> BfvRuntimeCiphertext:
        return self.create_many([value])[0]

    def create_many(self, values: Sequence) -> List[BfvRuntimeCiphertext]:
        """Encrypt a batch of inputs in one device call (BfvContext
        .encrypt_many) — used by the whole-program JIT to encrypt all
        secret inputs together."""
        pts = []
        for value in values:
            if isinstance(value, Cleartext):
                vals = [int(v) for v in value.values]
            elif isinstance(value, (int,)):
                vals = [int(value)]
            else:
                vals = [int(v) for v in value]
            pts.append(self.context.encode(self.expand_vector(vals)))
        return [BfvRuntimeCiphertext(ct, self)
                for ct in self.context.encrypt_many(pts)]

    def decrypt(self, ciphertext: AbstractCiphertext) -> List[int]:
        if not isinstance(ciphertext, BfvRuntimeCiphertext):
            raise RuntimeExecutionError(
                "BfvCiphertextFactory can only decrypt its own ciphertexts")
        return self.context.decode(self.context.decrypt(ciphertext.ct))

    # --- whole-program jit protocol (runtime/jit_executor.py) ---------------
    def jit_pack(self, handle):
        """(traced array, static metadata) for a ciphertext handle."""
        return handle.ct.data, None

    def jit_unpack(self, array, meta=None) -> BfvRuntimeCiphertext:
        return BfvRuntimeCiphertext(BfvCiphertext(array), self)
