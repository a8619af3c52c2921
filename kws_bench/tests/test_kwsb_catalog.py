"""The benchmark's pieces are found by name, and a new configuration,
traffic mix, cell or metric is taken from new files and new
``BENCHMARK.json`` entries alone."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from kws_bench import harness
from kws_bench.traffic import _train as T

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_every_cell_finds_its_files(spec):
    for cell in spec["workloads"]:
        cfg = harness.load_config(cell["config"])
        mix = harness.load_traffic(cell["traffic"])
        assert harness.driver(mix["kind"]).run
        assert harness.reference(cfg).param_shapes(cfg["num_classes"])
        assert harness.load_limits(cell["name"])
        e2e = [m["name"] for m in harness.metrics_of(
            spec, cell["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(spec, cell["name"], "per_layer")
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_the_file_keeps_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]]
    cells = [c["name"] for c in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in spec["configs"]:
        assert c["file"].startswith("kws_bench/configs/")
        assert os.path.exists(harness.ROOT / c["file"])
        assert c["name"] in {w["config"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in harness.metrics_of(
                spec, cell, "end_to_end")]
    assert all(w["chips"] == 1 for w in spec["workloads"])
    assert len(json.dumps(spec)) < 64 * 1024


NEW_CONFIG = {"name": "flagship_b192", "reference": "flagship"}
NEW_MIX = {"kind": "train_bank", "num_train": 32, "num_val": 4,
           "num_pseudo": 4, "amplitude": 100, "background_clips": 2,
           "background_seconds": 2, "warmup_steps": 1, "trace_steps": 2}
NEW_READER = '''
def read(layers):
    return float(layers["steps"])
'''


def _copy(tmp_path):
    """A checkout of the benchmark beside the program, for new files."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.PACKAGE, root / "kws_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    os.symlink(harness.ROOT / "speech_recognition_tpu_torch",
               root / "speech_recognition_tpu_torch")
    return root, root / "kws_bench"


def _run_in(root, cell: str):
    """One run of ``cell`` on the CPU in the checkout ``root``: its
    window's steps, per-layer metrics and compared numbers by name."""
    code = (
        "import json, tempfile, torch\n"
        "from kws_bench import harness\n"
        "spec = harness.load_spec()\n"
        f"run = harness.run_cell(spec, {cell!r}, 7, 0.05,"
        " False, torch.device('cpu'), tempfile.mkdtemp())\n"
        "print(json.dumps({'steps': run.attempted, 'layers': "
        f"harness.read_layers(spec, {cell!r}, run.layers),"
        " 'checks': {c.name: c.value for c in run.checks}}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _add_cell(spec, config: str, traffic: str, source: str = "x"):
    """``spec`` with a configuration and its cell on ``traffic``, the
    cell reporting ``train_clips_per_s``."""
    spec["configs"].append({"name": config, "source": source,
                            "file": f"kws_bench/configs/{config}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": f"{config}.{traffic}",
                              "config": config, "traffic": traffic,
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_clips_per_s":
            m["workloads"].append(f"{config}.{traffic}")
    return spec


def test_new_entries_are_taken_from_new_files(tmp_path):
    """In a copy of the benchmark, a configuration, a mix, a cell, its
    limits and a per-layer metric added as new files and new entries
    alone are found and run (on the CPU, at a tiny size)."""
    root, pkg = _copy(tmp_path)
    cfg = dict(harness.load_config("flagship"), **NEW_CONFIG, batch_size=4,
               compute_dtype="float32")
    (pkg / "configs" / "flagship_b192.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "tiny_bank.json").write_text(json.dumps(NEW_MIX))
    (pkg / "limits" / "flagship_b192.tiny_bank.json").write_text(
        json.dumps({"numbers": {k: {"limit": 1e9} for k in
                                T.NUMBERS}}))
    (pkg / "metrics" / "window_steps.py").write_text(NEW_READER)
    spec = _add_cell(json.loads((root / "BENCHMARK.json").read_text()),
                     "flagship_b192", "tiny_bank")
    spec["per_layer"].append({"name": "window_steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "train_clips_per_s",
                              "workloads": ["flagship_b192.tiny_bank"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    got = _run_in(root, "flagship_b192.tiny_bank")
    assert got["steps"] >= 1
    assert got["layers"]["window_steps"] == got["steps"]
    assert list(got["checks"]) == list(T.NUMBERS)


# the feature geometry of the test's MFCC cell: 98 frames of 13 MFCCs
# from 40 mel bins (the port's names: ``dct_coefficient_count`` is the
# mel count, ``num_log_mel_features`` the MFCCs kept)
MFCC_SETTINGS = {"window_size_ms": 30.0, "window_stride_ms": 10.0,
                 "dct_coefficient_count": 40, "num_log_mel_features": 13,
                 "output_representation": "mfcc"}
MFCC_REFERENCE = f'''
"""A test's reference of the zoo's ``simple``: MFCCs (here the port's CPU
Frontend's: the test checks the harness's plumbing, not the frontend),
the reference's MFCC normalisation, one Dense."""
import torch

from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.ops.frontend import Frontend

SETTINGS = prepare_model_settings(label_count=12, **{MFCC_SETTINGS!r})


def features(wav):
    return Frontend(SETTINGS, "highest").features(wav, "mfcc")


def param_shapes(num_classes):
    return [("Dense_0.weight", (num_classes, 98 * 13), "kernel"),
            ("Dense_0.bias", (num_classes,), "bias")]


def dropout_shapes(batch):
    return []


def forward(p, x, train, keep=None, q=lambda t: t):
    x = torch.clamp((x + 0.8) / 7.0, -5.0, 5.0)
    return q(x) @ q(p["Dense_0.weight"]).t() + p["Dense_0.bias"]
'''
# float32 on both sides on the CPU, the same arithmetic in another
# order: every gap is rounding, far under this
ROUNDING = 1e-4


def test_a_feature_model_trained_with_sgd_comes_from_new_files(tmp_path):
    """In a copy, an MFCC model trained with SGD with momentum and without
    BatchNorm (the zoo's ``simple``), its feature geometry in the
    configuration, is added as new files and entries alone and runs:
    it compares ``feature_gap`` beside the four numbers, the waveform
    exactly, every number by rounding alone."""
    root, pkg = _copy(tmp_path)
    cfg = dict(harness.load_config("flagship"), name="simple_sgd",
               model="simple", reference="simple_sgd", batch_size=4,
               compute_dtype="float32", optimizer="sgd",
               learning_rate=0.01, momentum=0.9, label_smoothing=0.0,
               model_settings=MFCC_SETTINGS)
    for k in ("rho", "epsilon", "parameters", "forward_flops_per_clip"):
        del cfg[k]
    (pkg / "configs" / "simple_sgd.json").write_text(json.dumps(cfg))
    (pkg / "reference" / "simple_sgd.py").write_text(MFCC_REFERENCE)
    (pkg / "traffic" / "tiny_bank.json").write_text(json.dumps(NEW_MIX))
    checks = T.NUMBERS + ("feature_gap",)
    (pkg / "limits" / "simple_sgd.tiny_bank.json").write_text(
        json.dumps({"numbers": {k: {"limit": 1e9} for k in checks}}))
    spec = _add_cell(json.loads((root / "BENCHMARK.json").read_text()),
                     "simple_sgd", "tiny_bank")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    got = _run_in(root, "simple_sgd.tiny_bank")["checks"]
    assert tuple(got) == checks
    assert got["input_gap"] == 0.0
    assert got["bn_gap"] == 0.0                 # no BatchNorm to compare
    for k, v in got.items():
        assert math.isfinite(v) and v < ROUNDING, (k, v)
