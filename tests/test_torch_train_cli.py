"""The port's training CLI (``tools/train.py``, the twin of
scripts/train.py) in-process on the CPU, on tests/synth_corpus.py's
corpus, and its TensorBoard events against the JAX writer's.

The CLI runs the flagship at batch 8 for 2 epochs of 2 steps: in bank
mode, in ``--stream`` mode with BN re-estimation, and resumed from the
bank run's best checkpoint. Its TensorBoard callback runs with the wall
time and the host name fixed, and the JAX package's callback, fed the
same epoch logs with the same fixes, must write the same bytes.
"""

import json
import os
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from speech_recognition_tpu.train import metrics as JM
from speech_recognition_tpu.utils import tb_events as JTB
from speech_recognition_tpu_torch.tools import train
from speech_recognition_tpu_torch.train import metrics as M
from speech_recognition_tpu_torch.utils import tb_events as TB

from synth_corpus import build_corpus

torch.set_num_threads(1)

WALL_TIME = 1_760_000_000.25
HOST = "testhost"


def _fixed(module):
    """Patches of ``module``'s clock and host name."""
    return (mock.patch.object(module, "time",
                              types.SimpleNamespace(time=lambda: WALL_TIME)),
            mock.patch.object(module, "socket", types.SimpleNamespace(
                gethostname=lambda: HOST)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three CLI runs, in a working directory of their own; the logs
    each epoch gave the TensorBoard callback."""
    work = tmp_path_factory.mktemp("train_cli")
    build_corpus(work / "audio", clips_per_word=6, seed=11)
    common = ["--data_dirs", str(work / "audio"), "--batch_size", "8",
              "--epochs", "2", "--steps_per_epoch", "2", "--device", "cpu",
              "--silence_percentage", "10", "--unknown_percentage", "30",
              "--validation_percentage", "20"]
    seen = []
    on_epoch_end = M.TensorBoardCallback.on_epoch_end

    def recording(self, epoch, state, logs):
        seen.append((epoch, dict(logs)))
        return on_epoch_end(self, epoch, state, logs)

    cwd = os.getcwd()
    os.chdir(work)
    time_patch, host_patch = _fixed(TB)
    try:
        with time_patch, host_patch, mock.patch.object(
                M.TensorBoardCallback, "on_epoch_end", recording):
            out = {"bank": train.main(common + ["--experiment", "bank"])}
            out["bank_logs"], seen[:] = list(seen), []
            out["stream"] = train.main(
                common + ["--experiment", "stream", "--stream",
                          "--bn_recalibration_batches", "2"])
            best = Path("checkpoints_bank/BEST").read_text()
            out["best_step"] = torch.load(best, weights_only=True)["step"]
            out["resume"] = train.main(
                common + ["--experiment", "resume", "--resume", best])
    finally:
        os.chdir(cwd)
    out["work"] = work
    return out


@pytest.mark.parametrize("mode", ["bank", "stream"])
def test_trains_and_evaluates(runs, mode):
    r = runs[mode]
    assert r["state"].step == 4
    assert np.isfinite(r["val_loss"])
    assert 0.0 <= r["val_categorical_accuracy"] <= 1.0
    assert r["trainer"].compute_dtype == "float32"     # auto on the CPU


def test_stream_mode_stages_only_validation(runs):
    partitions = runs["stream"]["trainer"].dataset.partitions
    assert set(partitions) == {"validation"}
    assert runs["stream"]["trainer"].dataset.background is not None
    assert set(runs["bank"]["trainer"].dataset.partitions) >= {
        "training", "validation"}


def test_resume_continues_from_the_saved_step(runs):
    assert runs["best_step"] in (2, 4)
    assert runs["resume"]["state"].step == runs["best_step"] + 4


@pytest.mark.parametrize("mode", ["bank", "stream", "resume"])
def test_reports_logs_and_checkpoints_are_written(runs, mode):
    work = runs["work"]
    for name in ("confusion_matrix.txt", "wanted_confusion_matrix.txt"):
        text = (work / name).read_text()
        assert "[001]: val_categorical_accuracy" in text
    lines = (work / f"logs_{mode}.jsonl").read_text().splitlines()
    assert len(lines) == 2
    for line in lines:
        logs = json.loads(line)
        for key in ("loss", "categorical_accuracy", "val_loss",
                    "val_categorical_accuracy",
                    "val_mean_categorical_accuracy_wanted", "epoch_time_s",
                    "clips_per_sec"):
            assert np.isfinite(logs[key]), key
    best = (work / f"checkpoints_{mode}" / "BEST").read_text()
    assert os.path.exists(best)
    events = list((work / f"logs_{mode}").glob("events.out.tfevents.*"))
    assert [p.name for p in events] == [
        f"events.out.tfevents.{int(WALL_TIME)}.{HOST}"]
    steps = [s for s, _ in TB.read_scalar_events(str(events[0]))]
    assert steps == [0, 1]


def test_tensorboard_bytes_equal_the_jax_writers(runs, tmp_path):
    port_file = next((runs["work"] / "logs_bank").glob("events.*"))
    time_patch, host_patch = _fixed(JTB)
    with time_patch, host_patch:
        cb = JM.TensorBoardCallback(str(tmp_path))
        for epoch, logs in runs["bank_logs"]:
            cb.on_epoch_end(epoch, None, logs)
        cb.close()
    jax_file = next(tmp_path.glob("events.*"))
    assert jax_file.name == port_file.name
    assert port_file.read_bytes() == jax_file.read_bytes()
    # every numeric log of each epoch is in its event
    events = dict(TB.read_scalar_events(str(port_file)))
    for epoch, logs in runs["bank_logs"]:
        numeric = {k for k, v in logs.items()
                   if isinstance(v, (int, float))}
        assert set(events[epoch]) == numeric
        np.testing.assert_allclose(events[epoch]["val_loss"],
                                   logs["val_loss"], rtol=1e-6)


def test_crc32c_known_vectors():
    # RFC 3720 B.4 check values, as tests/test_tb_events.py
    assert TB.crc32c(b"") == 0x00000000
    assert TB.crc32c(bytes(range(32))) == 0x46DD794E
    assert TB.crc32c(b"123456789") == 0xE3069283
    assert TB.masked_crc32c(b"123456789") == JTB.masked_crc32c(b"123456789")


def test_writer_bytes_equal_the_jax_writer(tmp_path):
    scalars = [(1, {"loss": 2.5, "accuracy": 0.125}),
               (2, {"loss": 2.25, "lr": 1e-3, "none": None}), (3, {})]
    files = []
    for module, sub in ((TB, "port"), (JTB, "jax")):
        time_patch, host_patch = _fixed(module)
        with time_patch, host_patch:
            with module.TBEventWriter(str(tmp_path / sub)) as w:
                for step, s in scalars:
                    w.add_scalars(step, s)
        files.append(Path(w.path).read_bytes())
    assert files[0] == files[1]
    events = list(TB.read_scalar_events(str(tmp_path / "port" / Path(
        w.path).name)))
    assert [s for s, _ in events] == [1, 2]
    np.testing.assert_allclose(events[1][1]["lr"], 1e-3, rtol=1e-6)
