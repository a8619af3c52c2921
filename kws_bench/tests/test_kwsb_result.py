"""The result line: the cell's metrics by the trace flag, the compared
numbers last, and the per-layer readers on a run's counters."""

import json

import pytest

from kws_bench import harness


def _run(checks, failed=0):
    layers = {"kind": "train", "cell": "flagship.train_bank", "batch": 384,
              "steps": 100, "window_s": 2.0, "step_ms": [20.0] * 100,
              "flops_step": 124_861_464_576,
              "trace": {"steps": 20, "window_s": 0.5,
                        "decode_augment_bytes": [40_000_000] * 20,
                        "summary": {"busy_s": 0.25, "activities": 12_800,
                                    "ops": {"normalization": 0.04},
                                    "kernels": {"decode_augment_i64": (
                                        4e-4, 20), "gemm": (0.1, 100)}}}}
    return harness.Run(e2e={"train_clips_per_s": 19200.0,
                            "train_step_ms_p95": 20.0},
                       window_start=0.0, attempted=100, failed=failed,
                       checks=checks, memory_peak_bytes=123,
                       layers=layers)


def test_untraced_line_has_the_cells_end_to_end_metrics():
    spec = harness.load_spec()
    run = _run([harness.Check("loss_gap", 1e-3, 1e-2)])
    line = harness.result_line(spec, "flagship.train_bank", run, 12.5,
                               False, {"platform": "gpu"}, {}, None)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_clips_per_s", "setup_s"}
    line = harness.result_line(spec, "steffenet.train_bank", run, 12.5,
                               False, {"platform": "gpu"}, {}, None)
    assert set(line["metrics"]) == {"train_clips_per_s",
                                    "train_step_ms_p95", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    json.dumps(line)


def test_a_number_over_its_limit_or_a_failure_is_not_correct():
    spec = harness.load_spec()
    for run in (_run([harness.Check("loss_gap", 0.1, 1e-2)]),
                _run([harness.Check("loss_gap", float("nan"), 1e-2)]),
                _run([harness.Check("loss_gap", 0.0, 1e-2)], failed=1)):
        assert not harness.result_line(spec, "flagship.train_bank", run,
                                       1.0, False, {}, {}, None)["correct"]


def test_traced_line_reads_the_layers():
    spec = harness.load_spec()
    run = _run([])
    values = harness.read_layers(spec, "flagship.train_bank", run.layers)
    assert values["train_kernels_per_step"] == 640.0
    assert values["train_device_ms_per_step"] == pytest.approx(12.5)
    assert values["train_idle_share"] == pytest.approx(37.5)
    assert values["bn_device_ms_per_step"] == pytest.approx(2.0)
    # 40 MB at 3.35 TB/s over 20 us
    assert values["decode_augment_roofline"] == pytest.approx(
        100 * 40e6 / 3.35e12 / 20e-6)
    assert values["train_mfu"] == pytest.approx(
        100 * 124_861_464_576 / 0.02 / 989e12)
    line = harness.result_line(spec, "flagship.train_bank", run, 1.0, True,
                               {}, values, {"device_ops": []})
    assert set(line["metrics"]) == set(values)
    assert list(line)[-2:] == ["breakdown", "checks"]
