"""The port's training and submission CLIs over two ranks under
``torchrun`` on the CPU (``--device cpu``, gloo), as a user launches them.

- ``tools.train``: the flagship at global batch 8 (4 rows per rank) for 2
  epochs of 2 steps on tests/synth_corpus.py's corpus, in bank mode, in
  ``--stream`` mode with BN re-estimation, and resumed from the bank
  run's best checkpoint. Both ranks print the same losses and validation
  figures, bit for bit; only rank 0 writes the checkpoints, the reports,
  the jsonl log and the TensorBoard events, and its checkpoint loads.
- ``tools.make_submission --data_parallel on``: ``conv_2d_fast`` (MFCC)
  over 13 WAVs at batch 8 (a tail of 5 padded to 8). Its probability CSV
  matches one process's (``main`` in-process) and the JAX ``Predictor``'s
  on an 8-device mesh (tests/test_infer_tools.py) on the same decoded,
  padded batches, 1e-5 absolute (the JAX test's); only rank 0 writes.
- ``--data_parallel``'s choice: ``on`` without a process group raises,
  a batch that does not split over the ranks predicts whole batches and
  says so.
"""

import csv
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.infer.tta import (
    Predictor as JaxPredictor, TTAConfig as JaxTTAConfig,
)
from speech_recognition_tpu.models import build_model as jax_build_model
from speech_recognition_tpu.parallel.mesh import make_mesh as jax_make_mesh
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.data.wav import (
    decode_batch_int16, save_wav_file,
)
from speech_recognition_tpu_torch.models.convert import to_flax
from speech_recognition_tpu_torch.models.zoo import build_model
from speech_recognition_tpu_torch.parallel.mesh import Mesh
from speech_recognition_tpu_torch.tools import make_submission
from speech_recognition_tpu_torch.train.checkpoint import restore_checkpoint
from speech_recognition_tpu_torch.train.loop import Trainer

from synth_corpus import build_corpus

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
WORLD = 2
EPOCHS = 2
T = 16000
TREE_FILES, BATCH = 13, 8
PROB_ATOL = 1e-5
TRAIN = ["--batch_size", "8", "--epochs", str(EPOCHS), "--steps_per_epoch",
         "2", "--device", "cpu", "--silence_percentage", "10",
         "--unknown_percentage", "30", "--validation_percentage", "20"]
SUBMIT = ["--model", "conv_2d_fast", "--output_representation", "mfcc",
          "--window_size_ms", "30", "--window_stride_ms", "10",
          "--dct_coefficient_count", "80", "--num_log_mel_features", "40",
          "--batch_size", str(BATCH), "--wanted_only", "--device", "cpu"]
RANK_LINE = re.compile(r"^\[rank (\d)/2\] epoch (\d+): (.*)$", re.M)


def _torchrun(module, args, cwd):
    """``torchrun --standalone --nproc_per_node 2 -m module args`` in
    ``cwd`` (torchrun's own store, on a port it finds free); returns the
    ranks' standard outputs, rank 0's first. torchrun writes each rank's
    streams to files of their own (``--redirects 3``), so that no rank's
    line lands inside another's, as it can in one shared pipe. Each rank
    uses one CPU thread."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = Path(cwd) / f"torchrun_logs_{module.rsplit('.', 1)[-1]}"
    shutil.rmtree(logs, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "--redirects", "3", "--log-dir",
         str(logs), "-m", module, *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    streams = {kind: ["".join(
        p.read_text() for p in logs.glob(f"*/attempt_*/{r}/{kind}.log"))
        for r in range(WORLD)] for kind in ("stdout", "stderr")}
    shutil.rmtree(logs)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:],
                                  [e[-3000:] for e in streams["stderr"]])
    return "".join(streams["stdout"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The three 2-rank runs of tools.train, in one working directory."""
    work = tmp_path_factory.mktemp("dp_train_cli")
    build_corpus(work / "audio", clips_per_word=6, seed=11)
    common = ["--data_dirs", str(work / "audio"), *TRAIN]
    module = "speech_recognition_tpu_torch.tools.train"
    out = {"bank": _torchrun(module, common + ["--experiment", "bank"],
                             work)}
    out["stream"] = _torchrun(module, common + [
        "--experiment", "stream", "--stream", "--bn_recalibration_batches",
        "2"], work)
    best = (work / "checkpoints_bank" / "BEST").read_text()
    out["best_step"] = torch.load(best, weights_only=True)["step"]
    out["resume"] = _torchrun(module, common + [
        "--experiment", "resume", "--resume", best], work)
    out["work"] = work
    return out


def _rank_lines(stdout):
    lines = {}
    for rank, epoch, rest in RANK_LINE.findall(stdout):
        lines.setdefault(int(epoch), {})[int(rank)] = rest
    return lines


@pytest.mark.parametrize("mode", ["bank", "stream", "resume"])
def test_both_ranks_report_the_same_figures(trained, mode):
    lines = _rank_lines(trained[mode])
    assert sorted(lines) == list(range(EPOCHS))
    first = trained["best_step"] if mode == "resume" else 0
    for epoch, by_rank in lines.items():
        assert sorted(by_rank) == [0, 1]
        assert by_rank[0] == by_rank[1], by_rank
        assert f"step={first + 2 * (epoch + 1)} " in by_rank[0]
        loss = float(re.search(r"loss=([^ ]+)", by_rank[0]).group(1))
        assert np.isfinite(loss)
    assert len(re.findall(r"\[rank [01]/2\] final: ", trained[mode])) == 2


@pytest.mark.parametrize("mode", ["bank", "stream", "resume"])
def test_only_rank_0_writes(trained, mode):
    work = trained["work"]
    # one jsonl line and one printed report per epoch: rank 0's
    assert len((work / f"logs_{mode}.jsonl").read_text().splitlines()) \
        == EPOCHS
    assert len(re.findall(r"^\[ep \d{3}\] ", trained[mode], re.M)) == EPOCHS
    ckpts = list((work / f"checkpoints_{mode}").glob("*.pt"))
    assert 1 <= len(ckpts) <= EPOCHS
    assert not list(work.glob(f"checkpoints_{mode}/*.tmp"))
    assert len(list((work / f"logs_{mode}").iterdir())) == 1


def test_rank_0s_checkpoint_loads(trained):
    work = trained["work"]
    best = (work / "checkpoints_stream" / "BEST").read_text()
    trainer = Trainer("conv_1d_time_sliced_with_attention",
                      prepare_model_settings(label_count=12),
                      synthetic_device_dataset(CPU, num_train=8, num_val=4),
                      batch_size=8)
    state = restore_checkpoint(best, trainer.init_state())
    assert state.step in (2, 4)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert trained["best_step"] in (2, 4)


# -- make_submission -----------------------------------------------------

@pytest.fixture(scope="module")
def submitted(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_submit")
    rng = np.random.default_rng(5)
    (work / "test").mkdir()
    for i in range(TREE_FILES):
        save_wav_file(str(work / "test" / f"clip_{i:02d}.wav"),
                      rng.uniform(-0.4, 0.4, T).astype(np.float32), T)
    model, _ = build_model("conv_2d_fast", num_classes=12,
                           generator=torch.Generator().manual_seed(3),
                           spectrogram_length=98, num_log_mel_features=40)
    torch.save({"model": model.state_dict()}, work / "ckpt.pt")
    args = ["--checkpoint", str(work / "ckpt.pt"), "--test_dir",
            str(work / "test"), *SUBMIT]
    two = _torchrun("speech_recognition_tpu_torch.tools.make_submission",
                    args + ["--data_parallel", "on", "--out_prefix",
                            str(work / "two")], work)
    one = make_submission.main(args + ["--out_prefix", str(work / "one")])
    return dict(work=work, two=two, one=one, model=model)


def _probs(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return [r[0] for r in rows[1:]], np.array(
        [[float(v) for v in r[2:]] for r in rows[1:]])


def _jax_mesh_probs(model, paths):
    """The JAX Predictor with TTA on an 8-device mesh, on the decoded
    batches of 8, the tail padded with zero rows."""
    params, stats = to_flax(model.state_dict(), model="conv_2d_fast")
    module, _ = jax_build_model("conv_2d_fast", num_classes=12,
                                spectrogram_length=98,
                                num_log_mel_features=40)
    settings = jax_prepare_model_settings(
        label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=40,
        output_representation="mfcc")
    p = JaxPredictor(module, settings, "mfcc", JaxTTAConfig(),
                     mesh=jax_make_mesh(jax.devices("cpu")[:8]))
    out = []
    for i in range(0, len(paths), BATCH):
        wav = decode_batch_int16(paths[i:i + BATCH], T)
        pad = BATCH - wav.shape[0]
        wav = np.pad(wav, ((0, pad), (0, 0)))
        probs = np.asarray(p.predict({"params": params,
                                      "batch_stats": stats},
                                     jnp.asarray(wav)))
        out.append(probs[:BATCH - pad])
    return np.concatenate(out)


def test_submission_over_ranks_matches_one_process_and_jax(submitted):
    work = submitted["work"]
    assert "data parallel: on, 2 ranks of 4 clips per batch" \
        in submitted["two"]
    names, two = _probs(work / "two_all_labels_probs.csv")
    names_one, one = _probs(submitted["one"]["probs"])
    assert names == names_one and len(names) == TREE_FILES
    np.testing.assert_allclose(two, one, rtol=0, atol=PROB_ATOL)
    paths = sorted(str(p) for p in (work / "test").glob("*.wav"))
    np.testing.assert_allclose(
        two, _jax_mesh_probs(submitted["model"], paths), rtol=0,
        atol=PROB_ATOL)


def test_submission_over_ranks_writes_once(submitted):
    work = submitted["work"]
    for suffix in (".csv", "_all_labels.csv", "_all_labels_probs.csv",
                   "_probs.uint8.memmap"):
        assert (work / f"two{suffix}").read_bytes() \
            == (work / f"one{suffix}").read_bytes(), suffix
    assert submitted["two"].count("wrote:") == 1


def test_data_parallel_choice():
    with pytest.raises(ValueError, match="torchrun"):
        make_submission.predictor_mesh("on", Mesh(), 8)
    assert make_submission.predictor_mesh("auto", Mesh(), 8) == (
        None, "data parallel: off")
    two = Mesh(0, 2, CPU)
    assert make_submission.predictor_mesh("off", two, 8)[0] is None
    assert make_submission.predictor_mesh("auto", two, 8)[0] is two
    mesh, line = make_submission.predictor_mesh("on", two, 7)
    assert mesh is None and "does not split over 2 ranks" in line
