"""What the program chooses from the platform: the engine a factory or the
CLI uses when none is named, and where the compile cache lives."""

import importlib
import os

import pytest

import jax

from abc_tpu.crypto.ntt import _jx_fwd, _jx_inv
from abc_tpu.ops import cuda_ntt
from abc_tpu.ops.modarith import default_engine


@pytest.fixture
def on_gpu(monkeypatch):
    """jax reports "gpu"; the kernel's calls are served by the stage loop."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda_ntt, "load", lambda: None)
    monkeypatch.setattr(cuda_ntt, "fwd",
                        lambda a, tw, twsh, q, **_: _jx_fwd(a, tw, twsh, q))
    monkeypatch.setattr(cuda_ntt, "inv",
                        lambda a, tw, twsh, q, ni, nish, **_:
                        _jx_inv(a, tw, twsh, q, ni, nish))


@pytest.mark.parametrize("platform,engine", [
    ("cpu", "np64"), ("gpu", "jx32"), ("cuda", "jx32")])
def test_default_engine_per_platform(monkeypatch, platform, engine):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert default_engine() == engine


def test_bfv_factory_defaults_to_np64_on_cpu():
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    assert BfvCiphertextFactory(slots=1024, seed=1).params.engine == "np64"


def test_bfv_factory_defaults_to_jx32_on_gpu(on_gpu):
    from abc_tpu.runtime.bfv_backend import BfvCiphertextFactory
    f = BfvCiphertextFactory(slots=1024, seed=1)
    assert f.params.engine == "jx32"
    ct = f.create_ciphertext([3, 4, 5])
    assert f.decrypt(ct)[:3] == [3, 4, 5]


def test_ckks_factory_defaults_per_platform(monkeypatch, on_gpu):
    from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory
    assert CkksCiphertextFactory(n=256, levels=2, seed=1).params.engine == \
        "jx32"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert CkksCiphertextFactory(n=256, levels=2, seed=1).params.engine == \
        "np64"


class _Stop(Exception):
    pass


@pytest.mark.parametrize("platform,engine", [("cpu", "np64"),
                                             ("gpu", "jx32")])
def test_cli_engine_default_per_platform(monkeypatch, platform, engine):
    """`--engine` unset: the bfv backend gets the platform's engine."""
    from abc_tpu import cli
    from abc_tpu.runtime import bfv_backend
    seen = {}

    def stub(**kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(bfv_backend, "BfvCiphertextFactory", stub)
    with pytest.raises(_Stop):
        cli.main(["hamming", "-", "--backend", "bfv", "--slots", "1024"])
    assert seen["engine"] == engine


def test_compile_cache_honours_the_env_var(monkeypatch, tmp_path):
    from abc_tpu.utils import compcache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compcache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_is_fixed_inside_the_checkout(monkeypatch):
    from abc_tpu.utils import compcache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fresh = importlib.reload(compcache)
    try:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = fresh.enable_persistent_cache()
        assert path == os.path.join(repo, ".jax_cache")
        assert fresh.enable_persistent_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
