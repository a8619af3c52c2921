"""The benchmark's pieces are found by name, and a new configuration,
traffic mix, cell or metric is taken from new files and new
``BENCHMARK.json`` entries alone."""

import json
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


def test_new_entries_are_taken_from_new_files(tmp_path):
    """In a copy of the benchmark, a configuration, a mix, a cell, its
    limits and a per-layer metric added as new files and new entries
    alone are found and run (on the CPU, at a tiny size)."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.PACKAGE, root / "kws_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    os.symlink(harness.ROOT / "speech_recognition_tpu_torch",
               root / "speech_recognition_tpu_torch")
    pkg = root / "kws_bench"
    cfg = dict(harness.load_config("flagship"), **NEW_CONFIG, batch_size=4,
               compute_dtype="float32")
    (pkg / "configs" / "flagship_b192.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "tiny_bank.json").write_text(json.dumps(NEW_MIX))
    (pkg / "limits" / "flagship_b192.tiny_bank.json").write_text(
        json.dumps({"numbers": {k: {"limit": 1e9} for k in
                                T.NUMBERS}}))
    (pkg / "metrics" / "window_steps.py").write_text(NEW_READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "flagship_b192", "source": "x",
                            "file": "kws_bench/configs/flagship_b192.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "flagship_b192.tiny_bank",
                              "config": "flagship_b192",
                              "traffic": "tiny_bank", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_clips_per_s":
            m["workloads"].append("flagship_b192.tiny_bank")
    spec["per_layer"].append({"name": "window_steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "train_clips_per_s",
                              "workloads": ["flagship_b192.tiny_bank"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, tempfile, torch\n"
        "from kws_bench import harness\n"
        "spec = harness.load_spec()\n"
        "run = harness.run_cell(spec, 'flagship_b192.tiny_bank', 7, 0.05,"
        " False, torch.device('cpu'), tempfile.mkdtemp())\n"
        "print(json.dumps({'steps': run.attempted, 'layers': "
        "harness.read_layers(spec, 'flagship_b192.tiny_bank', run.layers),"
        " 'checks': [c.name for c in run.checks]}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["steps"] >= 1
    assert got["layers"]["window_steps"] == got["steps"]
    assert got["checks"] == list(T.NUMBERS)
