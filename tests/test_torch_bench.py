"""The port's bench entry point against the root bench.py: the scale
ladder, the accuracy configuration and its verdict, the gate on the seed
mean, the order and budget rules (simulated children on a fake clock),
and the refusal to run without a card.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import bench as jax_bench
from speech_recognition_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
METRIC = json.dumps({"metric": "train_clips_per_sec", "value": 1234.5,
                     "unit": "clips/s", "vs_baseline": 2.74})


def test_configuration_matches_the_root_bench():
    assert bench.SCALES == jax_bench.SCALES
    assert bench.ACC_ARGS == jax_bench.ACC_ARGS
    assert bench.ACC_BAND == jax_bench.ACC_BAND
    assert bench.ACC_SEEDS == jax_bench.ACC_SEEDS
    assert bench.K80_BASELINE_CLIPS_PER_SEC \
        == jax_bench.K80_BASELINE_CLIPS_PER_SEC == 450.0
    assert bench.SCALES["full_corpus"][:3] == (64_727, 6_798, 4_096)


@pytest.mark.parametrize("bests", [
    [0.815, 0.80], [0.816, 0.50], [0.8159, 0.8159], [0.911, 0.92],
    [0.910, 0.95], [0.9101, 0.9101], [0.50, 0.95], [0.85, 0.86], [0.0],
    [1.0]])
def test_band_verdict_matches_the_root_bench(bests):
    assert bench.acc_band_verdict(bests, bench.ACC_BAND) \
        == jax_bench.acc_band_verdict(bests, jax_bench.ACC_BAND)


def test_seed_mean_gate():
    assert bench.ACC_GATE == 0.8309
    assert bench.ACC_GATE == round(0.8571 - 2 * 0.0131, 4)
    assert bench.acc_gate_passes([0.8309, 0.8309])
    assert bench.acc_gate_passes([0.80, 0.8618])
    assert not bench.acc_gate_passes([0.83, 0.8317])
    # one seed below the band's floor does not fail a good mean, and a
    # mean below the gate fails though no seed leaves the band
    assert bench.acc_gate_passes([0.80, 0.87])
    assert not bench.acc_gate_passes([0.82, 0.83])
    assert not bench.acc_band_verdict([0.82, 0.83], bench.ACC_BAND)


class _Clock:
    def __init__(self, start=1000.0):
        self.now = start

    def time(self):
        return self.now


def _install(monkeypatch, children, budget=1500.0, env=None):
    """Simulated children: ('hang',), ('ok', seconds, stdout, rc)."""
    clock, calls = _Clock(), []

    def fake_run(cmd, env=None, capture_output=None, text=None,
                 timeout=None):
        child = children[len(calls)]
        calls.append({"cmd": cmd, "env": env, "timeout": timeout})
        if child[0] == "hang":
            clock.now += timeout
            raise subprocess.TimeoutExpired(cmd, timeout)
        clock.now += child[1]
        return types.SimpleNamespace(returncode=child[3], stdout=child[2],
                                     stderr="")

    monkeypatch.setattr(bench, "time", clock)
    monkeypatch.setattr(bench, "_T0", clock.now)
    monkeypatch.setattr(bench, "BUDGET_SECS", budget)
    monkeypatch.setattr(subprocess, "run", fake_run)
    for k in ("BENCH_SCALE_ORDER", "BENCH_SMALL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    return calls


@pytest.mark.parametrize("env,order", [
    ({}, ["small", "tiny"]), ({"BENCH_SMALL": "1"}, ["tiny"]),
    ({"BENCH_SCALE_ORDER": "full_corpus,half_corpus", "BENCH_SMALL": "1"},
     ["full_corpus", "half_corpus"])])
def test_scale_order_rules(monkeypatch, env, order):
    calls = _install(monkeypatch, [("ok", 60.0, "", 1)] * 3, env=env)
    assert bench._scale_subprocess() is None
    assert [c["env"]["BENCH_SCALE"] for c in calls] == order
    assert all(c["cmd"][1:] == ["-m", "speech_recognition_tpu_torch.bench"]
               for c in calls)


def test_hung_child_cannot_consume_the_fallbacks_budget(monkeypatch):
    calls = _install(monkeypatch, [("hang",),
                                   ("ok", 120.0, "noise\n" + METRIC, 0)])
    assert bench._scale_subprocess() == METRIC
    # the first child: min(1800, 1500 - 60 - 300 reserved) = 1140 s; the
    # fallback still gets 1500 - 1140 - 60 = 300 s
    assert [c["timeout"] for c in calls] == [1140.0, 300.0]


def test_a_dead_childs_json_is_not_the_metric(monkeypatch):
    calls = _install(monkeypatch, [("ok", 60.0, METRIC, 1),
                                   ("ok", 60.0, METRIC, 0)])
    assert bench._scale_subprocess() == METRIC
    assert len(calls) == 2


def test_too_little_budget_launches_nothing(monkeypatch):
    calls = _install(monkeypatch, [], budget=230.0)
    assert bench._scale_subprocess() is None
    assert calls == []


def test_accuracy_signal_reports_band_and_gate(monkeypatch, capsys):
    rec = {"val_acc_best": 0.86, "val_acc_final": 0.85,
           "compute_dtype": "bfloat16"}
    calls = _install(monkeypatch, [
        ("ok", 100.0, json.dumps(rec), 0),
        ("ok", 100.0, json.dumps(dict(rec, val_acc_best=0.82)), 0)])
    out = bench._accuracy_signal()
    assert [c["cmd"][1:5] for c in calls] == [
        ["-m", "speech_recognition_tpu_torch.tools.calibrate_accuracy",
         "--seed", str(s)] for s in (0, 1)]
    assert all(c["cmd"][5:] == bench.ACC_ARGS for c in calls)
    assert out["val_acc_best_per_seed"] == [0.86, 0.82]
    assert out["seed_mean"] == pytest.approx(0.84)
    assert out["gate_passed"] and not out["accuracy_regression"]
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert line.startswith("accuracy: ")
    assert json.loads(line[len("accuracy: "):]) == out


def test_bench_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "speech_recognition_tpu_torch.bench"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "train_clips_per_sec" not in proc.stdout
    assert "no CUDA device" in proc.stderr
