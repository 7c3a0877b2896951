"""The CUDA NTT kernel's CPU-side checks (the kernel has no interpret mode).

* The kernel's schedule (ntt_cuda.cu: column pass + row pass, or one pass
  per row) replayed in NumPy with the kernel's own index formulas, against
  the np64 NttContext at every split.
* The wrapper (ops/cuda_ntt.py): one custom call per transform whatever the
  leading batch dims, tables as operands, vmap keeping tables unbatched.
* NttContext's choice of transform per platform, subset() views, and the
  raise when a GPU has no kernel library.
* The jx32 stage loop against np64 over every preset's full chain.
* `gpu`-marked: the kernel itself against np64, run on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abc_tpu.crypto.ntt import NttContext, _jx_fwd, _jx_inv
from abc_tpu.crypto.numthy import gen_ntt_primes
from abc_tpu.crypto.params import BfvParams
from abc_tpu.ops import cuda_ntt
from abc_tpu.ops.modarith import np64


def _rand(moduli, n, batch=(), seed=0):
    rng = np.random.default_rng(seed)
    q = np.asarray(moduli, dtype=np.uint64)[:, None]
    x = rng.integers(0, 1 << 62, size=batch + (len(moduli), n),
                     dtype=np.uint64)
    return (x % q).astype(np.uint32)


# --------------------------------------------------------------- schedule
def _stage(tile, loglanes, logt, widx0, tw, twsh, q, inverse):
    """ntt_cuda.cu stage() on tiles [L, blocks, E]; widx0 [L, blocks]."""
    b = np.arange(tile.shape[-1] // 2)
    lane = b & ((1 << loglanes) - 1)
    j = b >> loglanes
    i = j >> logt
    k = j & ((1 << logt) - 1)
    iu = ((((i << 1) << logt) + k) << loglanes) + lane
    iv = iu + (1 << (logt + loglanes))
    widx = np.broadcast_to(widx0, tile.shape[:2])[..., None] + i
    w = np.take_along_axis(tw[:, None, :], widx, axis=-1)
    wsh = np.take_along_axis(twsh[:, None, :], widx, axis=-1)
    u, v = tile[..., iu], tile[..., iv]
    if not inverse:
        vw = np64.mul_shoup(v, w, wsh, q)
        tile[..., iu], tile[..., iv] = np64.add(u, vw, q), np64.sub(u, vw, q)
    else:
        tile[..., iu] = np64.add(u, v, q)
        tile[..., iv] = np64.mul_shoup(np64.sub(u, v, q), w, wsh, q)


def _replay(x, ctx, log_block, inverse):
    """The kernel's launch plan on [L, n] (one row per limb), with ctx's
    tables: column pass then row pass forward, the reverse for inverse."""
    L, n = x.shape
    logn = n.bit_length() - 1
    loge = min(log_block, logn)
    logn1 = logn - loge
    assert loge >= logn1
    E, n1 = 1 << loge, 1 << logn1
    logc, logn2 = loge - logn1, logn - logn1
    q = ctx.q.reshape(L, 1, 1)
    tw, twsh = (ctx.inv_tw, ctx.inv_tw_sh) if inverse else \
        (ctx.fwd_tw, ctx.fwd_tw_sh)
    order = (lambda k: range(k - 1, -1, -1)) if inverse else range

    def scale(tile):
        return np64.mul_shoup(tile, ctx.n_inv.reshape(L, 1, 1),
                              ctx.n_inv_sh.reshape(L, 1, 1), q)

    def column(a):
        e = np.arange(E)
        idx = (np.arange(n1) << logc)[:, None] + (e & ((1 << logc) - 1)) \
            + ((e >> logc) << logn2)
        tile = a[:, idx]
        for logm in order(logn1):
            _stage(tile, logc, logn1 - 1 - logm, 1 << logm, tw, twsh, q,
                   inverse)
        out = np.empty_like(a)
        out[:, idx] = scale(tile) if inverse else tile
        return out

    def row(a, with_scale):
        tile = a.reshape(L, n1, E).copy()
        g = n1 + np.arange(n1)
        for logm in order(loge):
            _stage(tile, 0, loge - 1 - logm, g << logm, tw, twsh, q, inverse)
        return (scale(tile) if with_scale else tile).reshape(L, n)

    if not inverse:
        return row(column(x) if logn1 else x, False)
    return row(x, True) if logn1 == 0 else column(row(x, False))


@pytest.mark.parametrize("n,log_block", [
    (16, 4), (16, 2), (64, 3), (256, 8), (256, 4), (256, 6), (1024, 5),
    (4096, 11), (4096, 6)])
def test_kernel_schedule_replay_matches_np64(n, log_block):
    """Every split n = n1·n2 the kernel can take gives np64's bits."""
    moduli = gen_ntt_primes(30, 3, n)
    ctx = NttContext(n, moduli, engine="np64")
    x = _rand(moduli, n, seed=n + log_block)
    np.testing.assert_array_equal(_replay(x, ctx, log_block, False),
                                  ctx.fwd(x))
    np.testing.assert_array_equal(_replay(x, ctx, log_block, True),
                                  ctx.inv(x))


# ---------------------------------------------------------------- wrapper
def _tables(L=3, n=64):
    moduli = gen_ntt_primes(30, L, n)
    return NttContext(n, moduli, engine="jx32"), moduli


@pytest.mark.parametrize("shape", [(3, 64), (5, 3, 64), (2, 5, 3, 64)])
def test_wrapper_folds_any_batch_into_one_call(shape):
    ctx, _ = _tables()
    x = jnp.zeros(shape, jnp.uint32)
    jaxpr = jax.make_jaxpr(lambda a: cuda_ntt.fwd(
        a, ctx.fwd_tw, ctx.fwd_tw_sh, ctx.q))(x)
    calls = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "ffi_call"]
    assert len(calls) == 1
    assert calls[0].params["target_name"] == "abc_ntt_fwd"
    assert calls[0].outvars[0].aval.shape == shape
    assert dict(calls[0].params["attributes"])["log_block"] == \
        cuda_ntt.LOG_BLOCK


def test_wrapper_tables_are_operands_and_stay_unbatched_under_vmap():
    ctx, _ = _tables()
    f = lambda a, tw, twsh, q, ni, nish: cuda_ntt.inv(a, tw, twsh, q, ni,
                                                      nish)
    tabs = (ctx.inv_tw, ctx.inv_tw_sh, ctx.q, ctx.n_inv, ctx.n_inv_sh)
    xb = jnp.zeros((4, 2, 3, 64), jnp.uint32)
    jaxpr = jax.make_jaxpr(jax.vmap(f, in_axes=(0,) + (None,) * 5))(xb,
                                                                    *tabs)
    (call,) = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "ffi_call"]
    shapes = [v.aval.shape for v in call.invars]
    assert shapes == [(4, 2, 3, 64), (1, 3, 64), (1, 3, 64), (1, 3, 1),
                      (1, 3, 1), (1, 3, 1)]
    assert call.params["vmap_method"] == "expand_dims"


def test_wrapper_lowers_to_cuda_custom_call():
    ctx, _ = _tables()
    f = jax.jit(lambda a: cuda_ntt.fwd(a, ctx.fwd_tw, ctx.fwd_tw_sh, ctx.q,
                                       log_block=5))
    text = f.trace(jnp.zeros((2, 3, 64), jnp.uint32)).lower(
        lowering_platforms=("cuda",)).as_text()
    (line,) = [ln for ln in text.splitlines() if "custom_call" in ln]
    assert "@abc_ntt_fwd" in line and "log_block = 5" in line
    assert "(tensor<2x3x64xui32>, tensor<3x64xui32>, tensor<3x64xui32>, " \
           "tensor<3x1xui32>)" in line


# ------------------------------------------------------- platform choice
@pytest.fixture
def fake_gpu(monkeypatch):
    """jax reports "gpu"; the kernel library 'loads' and each call is
    recorded, then served by the stage loop."""
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda_ntt, "load", lambda: None)

    def fwd(a, tw, twsh, q, log_block=cuda_ntt.LOG_BLOCK):
        calls.append(("fwd", np.shape(tw)))
        return _jx_fwd(a, tw, twsh, q)

    def inv(a, tw, twsh, q, ni, nish, log_block=cuda_ntt.LOG_BLOCK):
        calls.append(("inv", np.shape(tw)))
        return _jx_inv(a, tw, twsh, q, ni, nish)

    monkeypatch.setattr(cuda_ntt, "fwd", fwd)
    monkeypatch.setattr(cuda_ntt, "inv", inv)
    return calls


def test_cpu_platform_uses_the_stage_loop():
    ctx, _ = _tables()
    assert ctx.fwd is ctx.fwd_xla and ctx.inv is ctx.inv_xla


def test_gpu_platform_routes_transforms_and_subsets_to_the_kernel(fake_gpu):
    ctx, moduli = _tables(L=4)
    x = _rand(moduli, 64)
    ref = NttContext(64, moduli, engine="np64")
    np.testing.assert_array_equal(np.asarray(ctx.fwd(x)), ref.fwd(x))
    np.testing.assert_array_equal(np.asarray(ctx.inv(x)), ref.inv(x))
    sub = ctx.subset([1, 3])
    np.testing.assert_array_equal(np.asarray(sub.fwd(x[[1, 3]])),
                                  ref.subset([1, 3]).fwd(x[[1, 3]]))
    assert fake_gpu == [("fwd", (4, 64)), ("inv", (4, 64)), ("fwd", (2, 64))]


def test_gpu_without_kernel_library_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda_ntt, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(cuda_ntt, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_ntt, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        NttContext(64, gen_ntt_primes(30, 2, 64), engine="jx32")


def test_library_name_tracks_the_source(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("a")
    monkeypatch.setattr(cuda_ntt, "SRC", str(src))
    first = cuda_ntt.library_path()
    src.write_text("b")
    assert cuda_ntt.library_path() != first
    assert first.startswith(cuda_ntt.BUILD_DIR)


# ------------------------------------------- stage loop vs np64, presets
@pytest.mark.parametrize("n", [2048, 8192, 16384, 32768])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_stage_loop_matches_np64_on_full_preset_chain(n, direction):
    moduli = list(BfvParams.create(n).coeff_modulus)
    c64 = NttContext(n, moduli, engine="np64")
    c32 = NttContext(n, moduli, engine="jx32")
    x = _rand(moduli, n, seed=n)
    got = getattr(c32, f"{direction}_xla")(x)
    np.testing.assert_array_equal(np.asarray(got), getattr(c64, direction)(x))


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("n,log_block", [(256, 8), (4096, 8), (8192, 11),
                                         (16384, 16), (32768, 12),
                                         (32768, 0)])
def test_kernel_matches_np64_on_gpu(n, log_block):
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
    moduli = list(BfvParams.create(max(n, 1024)).coeff_modulus) \
        if n >= 1024 else gen_ntt_primes(30, 3, n)
    c64 = NttContext(n, moduli, engine="np64")
    c32 = NttContext(n, moduli, engine="jx32")
    x = _rand(moduli, n, batch=(3,), seed=n)
    f = lambda a: cuda_ntt.fwd(a, c32.fwd_tw, c32.fwd_tw_sh, c32.q,
                               log_block=log_block)
    i = lambda a: cuda_ntt.inv(a, c32.inv_tw, c32.inv_tw_sh, c32.q,
                               c32.n_inv, c32.n_inv_sh, log_block=log_block)
    np.testing.assert_array_equal(np.asarray(jax.jit(f)(x)), c64.fwd(x))
    np.testing.assert_array_equal(np.asarray(jax.jit(i)(x)), c64.inv(x))
    np.testing.assert_array_equal(np.asarray(jax.jit(jax.vmap(f))(x)),
                                  c64.fwd(x))
