"""Rehearsal of chip_smoke.py on the CPU: its phase functions at n=256 (and
the jit path at the smallest preset), the four-device mesh phase on four
virtual CPU devices, and the refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

from abc_tpu.crypto.numthy import gen_ntt_primes  # noqa: E402
from abc_tpu.crypto.params import BfvParams  # noqa: E402


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_script_refuses_the_cpu():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


def test_phase_device_raises_without_gpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.phase_device(1)


def test_phase_ntt_rehearsal(capsys):
    chip_smoke.phase_ntt({256: gen_ntt_primes(30, 3, 256)}, batches=(1, 2))
    assert "bit-equal to np64" in capsys.readouterr().out


def test_preset_chains_are_the_full_production_chains():
    chains = chip_smoke.preset_chains()
    assert sorted(chains) == [2048, 8192, 16384, 32768]
    assert [len(c) for c in chains.values()] == [6, 7, 14, 28]


def test_phase_bfv_ops_rehearsal(capsys):
    t = gen_ntt_primes(20, 1, 256)[0]
    primes = gen_ntt_primes(30, 4, 256, exclude=[t])
    chip_smoke.phase_bfv_ops(BfvParams(n=256, coeff_modulus=primes,
                                       plain_modulus=t, engine="jx32",
                                       seed=1))
    assert "decrypt-equal" in capsys.readouterr().out


def test_phase_ckks_ops_rehearsal(capsys):
    chip_smoke.phase_ckks_ops(256, 4, 2)
    assert "bit-identical to np64" in capsys.readouterr().out


def test_float_check_sees_nested_jaxprs():
    import jax.numpy as jnp
    inner = jax.jit(lambda x: x.astype(jnp.float32) * 2)
    jaxpr = jax.make_jaxpr(lambda x: inner(x).astype(jnp.uint32))(
        jnp.zeros(4, jnp.uint32)).jaxpr
    assert chip_smoke._float_outputs(jaxpr)
    jaxpr = jax.make_jaxpr(lambda x: x * 2)(jnp.zeros(4, jnp.uint32)).jaxpr
    assert not chip_smoke._float_outputs(jaxpr)


def test_phase_main_path_rehearsal(capsys):
    chip_smoke.phase_main_path(1024, engine="jx32")
    out = capsys.readouterr().out
    assert "decrypt-equal to the oracle" in out
    assert "memory_analysis" in out and "auto_params float" in out


def test_phase_four_gpu_rehearsal_on_virtual_devices(capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    chip_smoke.phase_four_gpu(jax.devices()[:4], n_bfv=256, n_ckks=256,
                              batch=2)
    out = capsys.readouterr().out
    assert "equal to single-device runs" in out and "bit-equal" in out


def test_ckks_tolerance_matches_the_ckks_tests():
    assert chip_smoke.CKKS_TOL == {"rtol": 1e-3, "atol": 1e-3}
    np.testing.assert_allclose([1.0005], [1.0], **chip_smoke.CKKS_TOL)
