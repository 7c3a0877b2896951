"""bench.py harness plumbing — the driver-facing artifact format.

The device measurements themselves run on the GPU (bench.py); these tests
pin worker-template syntax, the compact-line digest (a line that overflows
the driver's capture is unparseable; a unit must not be truncated), the
suite registry, and that any failed phase is a non-zero exit.
"""

import ast
import json

import bench


def test_worker_templates_are_valid_python():
    ast.parse(bench._WORKER)
    ast.parse(bench._SUITE_WORKER)


def test_compact_suite_digest_keeps_units_and_errors():
    suite = {
        "config4": {"value": 6,
                    "unit": "mult-depth (sorting_gt16)",
                    "vs_baseline": 2.67},
        "config6": {"value": 55.3, "unit": "ms t_computation",
                    "csv_schema": {"t_keygen": 345.1}},
        "config2": {"value": 0.0, "unit": "-", "error": "x" * 200},
    }
    d = bench._compact_suite(suite)
    # round-3 verdict nit: the unit must not be truncated mid-word
    assert d["config4"]["unit"] == "mult-depth (sorting_gt16)"
    assert d["config6"]["csv"] == {"t_keygen": 345.1}
    assert len(d["config2"]["error"]) <= 60
    assert bench._compact_suite(None) == "suite worker failed/timed out"


def test_compact_line_fits_driver_capture():
    """A representative compact line must stay under the 1500-char guard
    bench.py enforces (the driver tails stdout)."""
    line = {
        "metric": "rns_ntt_butterflies_per_s_n16384_L14",
        "value": 55.151123456789, "unit": "Gbutterflies/s",
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
        "spread": [54.24123456789, 56.83123456789],
        "ntt_Gbf_s_by_batch": {str(b): 60.0 for b in (1, 8, 16, 64)},
        "mult_relin_ops_s_by_batch": {str(b): 4000.0
                                      for b in (1, 8, 16, 64)},
        "suite": bench._compact_suite(
            {f"config{i}": {"value": 1.0, "unit": "ops/s"}
             for i in range(1, 7)}),
        "full": "build/bench_suite.json",
    }
    assert len(json.dumps(line)) < 1500


def test_suite_registry_covers_six_configs():
    from abc_tpu.benchsuite import CONFIGS
    assert sorted(CONFIGS) == [1, 2, 3, 4, 5, 6]


def test_mult_relin_sol_model():
    """The mult+relin census passes through platform-free: NTT rows and
    elementwise u32 ops of one multiply, priced against no peak rate."""
    result = {
        "mult_relin_census": {"ntt_rows": 154, "elem_ops": 142_843_904},
        "mult_relin_curve": {"1": {"ops_per_s": 3631.0}},
    }
    census = bench._mult_relin_census(result)
    assert census == {"ntt_rows": 154, "elem_u32_ops": 142_843_904,
                      "ntt_rows_per_s": 154 * 3631.0}
    # missing census → explicit error, not a crash
    assert "error" in bench._mult_relin_census({})


_CURVES = {
    "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
               "count": 1},
    "timing_protocol": "median of 5 two-point chain estimates",
    "ntt_curve": {"1": {"Gbf_s": 1.0, "Gbf_s_min": 0.9, "Gbf_s_max": 1.1,
                        "us_per_fwd": 1.0, "fixed_call_ms": 0.1}},
    "mult_relin_curve": {"1": {"ops_per_s": 10.0}},
    "ntt_rows": 14,
    "mult_relin_census": {"ntt_rows": 154, "elem_ops": 1},
}


def _fake_workers(monkeypatch, curves, suite):
    results = iter([curves, suite])
    monkeypatch.setattr(bench, "_run_worker", lambda code, timeout:
                        next(results))


def test_bench_fails_when_the_device_worker_fails(monkeypatch, capsys):
    _fake_workers(monkeypatch, "exit 1: no accelerator", None)
    assert bench.main([]) == 1
    assert "curves worker failed" in capsys.readouterr().err


def test_bench_fails_when_a_suite_config_fails(monkeypatch, tmp_path,
                                               capsys):
    suite = {"config1": {"metric": "m", "value": 1.0, "unit": "ms"},
             "config5": {"metric": "config5 (failed)", "value": 0.0,
                         "unit": "-", "error": "boom"}}
    _fake_workers(monkeypatch, _CURVES, suite)
    assert bench.main(["--out", str(tmp_path / "b.json")]) == 1
    out = capsys.readouterr()
    assert "config5" in out.err
    assert json.loads(out.out.splitlines()[-1])["failed"] == ["config5"]


def test_bench_passes_and_names_the_device(monkeypatch, tmp_path, capsys):
    suite = {"config1": {"metric": "m", "value": 1.0, "unit": "ms"},
             "device": _CURVES["device"]}
    _fake_workers(monkeypatch, _CURVES, suite)
    assert bench.main(["--out", str(tmp_path / "b.json")]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["device"] == _CURVES["device"]
    assert list(line["suite"]) == ["config1"]
    full = json.loads((tmp_path / "b.json").read_text())
    assert full["device"]["platform"] == "gpu"


def test_suite_mode_exit_code_reflects_failures(monkeypatch):
    from abc_tpu import benchsuite
    monkeypatch.setattr(benchsuite, "run_suite_dict", lambda configs:
                        {"config1": {"value": 1.0}})
    assert bench.main(["--suite", "1"]) == 0
    monkeypatch.setattr(benchsuite, "run_suite_dict", lambda configs:
                        {"config1": {"error": "x"}})
    assert bench.main(["--suite", "1"]) == 1
