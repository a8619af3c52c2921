"""The port runs without jax, flax, optax or the JAX package, and its
kernel build logic.

The no-jax check runs in a subprocess with ``JAX_PLATFORMS`` removed and
``sys.modules`` entries for jax, flax, optax, speech_recognition_tpu and
h5py set to None, so that any import of them raises: the card's machine
has no h5py, and every module of the port must import there.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from speech_recognition_tpu_torch.ops.kernels import build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

NO_JAX_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "speech_recognition_tpu", "h5py"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import speech_recognition_tpu_torch as pkg
walked = set()
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    walked.add(info.name[len(pkg.__name__) + 1:])
new = {"bench", "labels", "data.wav", "data.index", "data.hard_corpus",
       "ops.frontend", "train.checkpoint", "tools.calibrate_accuracy",
       "infer.tta", "infer.submission", "ops.stretch", "tools.tta_set",
       "tools.pseudo", "tools.vote", "tools.blend", "tools.convert",
       "tools.make_submission", "tools.create_tta_set",
       "tools.pseudo_labels", "tools.evaluate", "tools.bench_infer",
       "models.zoo", "models.layers", "models.convert", "ops.kernels.build",
       "ops.kernels.launch",
       "models.keras_order", "models.keras_order_manifest",
       "export.keras_import", "export.aot", "data.prefetch",
       "utils.tb_events", "tools.import_checkpoint", "tools.freeze",
       "tools.run_edge_inference", "tools.bench_streaming", "tools.train",
       "utils.profiling", "tools.profile_step", "tools.model_info",
       "tools.bench_zoo", "data.noise", "tools.generate_noise", "compat",
       "tools.prepare_dataset", "tools.seed_sweep", "tools.zoo_calibration"}
assert new <= walked, new - walked
import chip_smoke  # noqa: F401
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset)
from speech_recognition_tpu_torch.ops.kernels import decode_augment as K
from speech_recognition_tpu_torch.ops.kernels import launch
from speech_recognition_tpu_torch.train.loop import Trainer

plain_calls = []
plain = K.decode_augment_reference
def counting(*args):
    plain_calls.append(1)
    return plain(*args)
K.decode_augment_reference = counting

cpu = torch.device("cpu")
ds = synthetic_device_dataset(cpu, num_train=8, num_val=4, num_pseudo=2)
trainer = Trainer("conv_1d_time_sliced_with_attention",
                  prepare_model_settings(label_count=12), ds, batch_size=4)
state = trainer.init_state()
loss = trainer.train_step(state)["loss"]
assert torch.isfinite(loss), loss
assert plain_calls == [1] and launch.runs() == {}, (plain_calls,
                                                   launch.runs())

# the native WAV decoder and a zoo model of the raw-waveform slice
import os, tempfile
import numpy as np
from speech_recognition_tpu_torch.data import wav
from speech_recognition_tpu_torch.models.zoo import build_model
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "a.wav")
    wav.save_wav_file(path, np.linspace(-0.5, 0.5, 100), 16000)
    rows = wav.decode_batch_int16([path], 16000)
    assert (rows == wav.decode_batch_int16_numpy([path], 16000)).all()
    assert list(launch._LOADED) == ["wavio"], launch._LOADED
model, _ = build_model("conv_1d_top_down", num_classes=12)
assert model.eval()(torch.zeros(2, 16000)).shape == (2, 12)
loaded = [n for n in sys.modules if sys.modules[n] is not None
          and n.split(".")[0] in ("jax", "flax", "optax",
                                  "speech_recognition_tpu", "h5py")]
assert not loaded, loaded
print("NO_JAX_OK")
"""


def _env_without_jax_platforms():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_trains_on_cpu_without_jax():
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=REPO,
                          env=_env_without_jax_platforms(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def _run_smoke(cwd):
    env = _env_without_jax_platforms()
    env["CUDA_VISIBLE_DEVICES"] = ""      # no card, even on a GPU host
    if cwd != REPO:
        env.pop("PYTHONPATH")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """build.py pointed at a scratch csrc/ and _build/, with an ``nvcc``
    that logs its arguments and writes the -o file."""
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    return csrc, out, log, str(nvcc)


def test_build_compiles_once_per_source(fake_build):
    csrc, out, log, nvcc = fake_build
    lib = build.build("k", compiler=nvcc)
    assert lib.parent == out and lib.read_text() == "built\n"
    assert build.build("k", compiler=nvcc) == lib          # cached
    assert len(log.read_text().splitlines()) == 1
    args = log.read_text().split()
    for flag in ("arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-fPIC"):
        assert flag in args
    (csrc / "k.cu").write_text("// v2\n")              # edited source
    lib2 = build.build("k", compiler=nvcc)
    assert lib2 != lib and len(log.read_text().splitlines()) == 2
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [lib.name, lib2.name])                         # no temp files


def test_build_reports_compiler_errors(fake_build, tmp_path):
    bad = tmp_path / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho 'error: no such thing' >&2\nexit 3\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="no such thing"):
        build.build("k", compiler=str(bad))
    _, out, _, _ = fake_build
    assert list(out.iterdir()) == []
