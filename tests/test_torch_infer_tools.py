"""The port's submission writers and host tools against the JAX package's,
byte for byte on the same probabilities, CSVs and WAV trees; the speed-TTA
set builder against the JAX one; and the five command-line tools of the
serving path on the CPU.

* the three CSVs and the uint8 memmap, ``to_audio_names_order``,
  ``read_uint8_memmap``, agreement and threshold pseudo-labels (the file
  trees and the stats), ``majority_vote`` (with the split-decision
  copies), ``blend_memmaps`` in both modes and ``convert_32_to_12``:
  identical;
* ``build_tta_set`` on broadband clips: every sample within 2 int16 LSB
  of the JAX tool's (the two stretches differ by float32 rounding);
* ``tools.make_submission``, ``create_tta_set``, ``pseudo_labels`` (its
  four subcommands), ``evaluate`` and ``bench_infer`` run on a tiny tree;
  the ones that reach a device take ``--device cpu``, and
  ``make_submission`` without it raises when there is no card.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from speech_recognition_tpu.infer import submission as JS
from speech_recognition_tpu.labels import get_int2label as jax_get_int2label
from speech_recognition_tpu.tools import blend as JB
from speech_recognition_tpu.tools import convert as JC
from speech_recognition_tpu.tools import pseudo as JP
from speech_recognition_tpu.tools import tta_set as JT
from speech_recognition_tpu.tools import vote as JV
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.data.hard_corpus import build_hard_corpus
from speech_recognition_tpu_torch.data.wav import (
    decode_batch_int16, save_wav_file,
)
from speech_recognition_tpu_torch.infer import submission as S
from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig
from speech_recognition_tpu_torch.labels import get_int2label
from speech_recognition_tpu_torch.tools import blend as B
from speech_recognition_tpu_torch.tools import bench_infer
from speech_recognition_tpu_torch.tools import convert as C
from speech_recognition_tpu_torch.tools import create_tta_set
from speech_recognition_tpu_torch.tools import evaluate
from speech_recognition_tpu_torch.tools import make_submission
from speech_recognition_tpu_torch.tools import pseudo as P
from speech_recognition_tpu_torch.tools import pseudo_labels
from speech_recognition_tpu_torch.tools import tta_set as TS
from speech_recognition_tpu_torch.tools import vote as V
from speech_recognition_tpu_torch.train.checkpoint import save_checkpoint
from speech_recognition_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

CPU = torch.device("cpu")
FLAGSHIP = "conv_1d_time_sliced_with_attention"


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _probs(rng, n, c):
    logits = rng.normal(0, 2.5, (n, c))
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _wavs(root, names, rng, samples=1600):
    os.makedirs(root, exist_ok=True)
    for fn in names:
        save_wav_file(os.path.join(root, fn),
                      rng.uniform(-0.5, 0.5, samples).astype(np.float32),
                      16000)


@pytest.mark.parametrize("wanted_only", [True, False])
def test_submission_files_match_jax(tmp_path, wanted_only):
    rng = np.random.default_rng(0)
    int2label = get_int2label(wanted_only=wanted_only)
    assert int2label == jax_get_int2label(wanted_only=wanted_only)
    probs = _probs(rng, 9, len(int2label))
    names = [f"clip_{i}.wav" for i in range(9)]
    got = S.write_submission_csvs(str(tmp_path / "t"), names, probs,
                                  int2label)
    want = JS.write_submission_csvs(str(tmp_path / "j"), names, probs,
                                    int2label)
    assert got.keys() == want.keys() == {"wanted", "all", "probs"}
    for k in got:
        assert open(got[k], "rb").read() == open(want[k], "rb").read()
    if wanted_only:
        ordered = S.to_audio_names_order(probs, int2label)
        assert np.array_equal(ordered,
                              JS.to_audio_names_order(probs, int2label))
        S.write_uint8_memmap(str(tmp_path / "t.mm"), ordered)
        JS.write_uint8_memmap(str(tmp_path / "j.mm"), ordered)
        assert (tmp_path / "t.mm").read_bytes() \
            == (tmp_path / "j.mm").read_bytes()
        assert np.array_equal(S.read_uint8_memmap(str(tmp_path / "t.mm"), 9),
                              JS.read_uint8_memmap(str(tmp_path / "j.mm"), 9))


def _submissions(tmp_path, names, rng, count=3):
    """``count`` wanted-label CSVs that agree on about half the clips."""
    base = rng.choice(S.AUDIO_NAMES, len(names))
    paths = []
    for k in range(count):
        labels = np.where(rng.uniform(size=len(names)) < 0.4,
                          rng.choice(S.AUDIO_NAMES, len(names)), base)
        p = tmp_path / f"sub{k}.csv"
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["fname", "label"])
            w.writerows(zip(names, labels))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("min_agree", [None, 2])
def test_pseudo_by_agreement_matches_jax(tmp_path, min_agree):
    rng = np.random.default_rng(1)
    names = [f"clip_{i:02d}.wav" for i in range(20)]
    _wavs(tmp_path / "audio", names, rng)
    subs = _submissions(tmp_path, names, rng)
    assert P.read_submission_csv(subs[0]) == JP.read_submission_csv(subs[0])
    got = P.pseudo_by_agreement(subs, str(tmp_path / "audio"),
                                str(tmp_path / "t"), min_agree)
    want = JP.pseudo_by_agreement(subs, str(tmp_path / "audio"),
                                  str(tmp_path / "j"), min_agree)
    assert got == want > 0
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_pseudo_by_threshold_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    names = [f"clip_{i:02d}.wav" for i in range(24)]
    _wavs(tmp_path / "audio", names, rng)
    probs = _probs(rng, len(names), 12)
    probs[::3] = np.eye(12, dtype=np.float32)[0] * 0.9 + 0.1 / 12  # silence
    kw = dict(prob_thresh=0.5, silence_group=3)
    got = P.pseudo_by_threshold(names, probs, str(tmp_path / "audio"),
                                str(tmp_path / "t"), **kw)
    want = JP.pseudo_by_threshold(names, probs, str(tmp_path / "audio"),
                                  str(tmp_path / "j"), **kw)
    assert got == want and got["created"] > 0 and got["low_prob"] > 0
    tree = _tree(tmp_path / "t")
    assert tree == _tree(tmp_path / "j")
    assert any(k.startswith("_background_noise_") for k in tree)


def test_majority_vote_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    names = [f"clip_{i:02d}.wav" for i in range(20)]
    _wavs(tmp_path / "audio", names, rng)
    subs = _submissions(tmp_path, names, rng, count=4)
    audio = str(tmp_path / "audio")
    got = V.majority_vote(subs, str(tmp_path / "t.csv"), 3, audio,
                          str(tmp_path / "t_split"))
    want = JV.majority_vote(subs, str(tmp_path / "j.csv"), 3, audio,
                            str(tmp_path / "j_split"))
    assert got == want and 0 < got[0] < got[1]
    assert (tmp_path / "t.csv").read_bytes() \
        == (tmp_path / "j.csv").read_bytes()
    assert _tree(tmp_path / "t_split") == _tree(tmp_path / "j_split")


@pytest.mark.parametrize("mode", ["arithmetic", "geometric"])
def test_blend_memmaps_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(4)
    n = 15
    paths = []
    for k in range(3):
        p = str(tmp_path / f"m{k}.mm")
        JS.write_uint8_memmap(p, _probs(rng, n, 12))
        paths.append(p)
    names = [f"clip_{i:02d}.wav" for i in range(n)]
    weights = [1.0, 2.0, 0.5]
    got = B.blend_memmaps(paths, names, str(tmp_path / "t.csv"),
                          str(tmp_path / "t.mm"), weights, mode)
    want = JB.blend_memmaps(paths, names, str(tmp_path / "j.csv"),
                            str(tmp_path / "j.mm"), weights, mode)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    for ext in ("csv", "mm"):
        assert (tmp_path / f"t.{ext}").read_bytes() \
            == (tmp_path / f"j.{ext}").read_bytes()


@pytest.mark.parametrize("extend_reversed", [False, True])
def test_convert_32_to_12_matches_jax(tmp_path, extend_reversed):
    rng = np.random.default_rng(5)
    int2label = get_int2label(extend_reversed=extend_reversed)
    probs = _probs(rng, 11, len(int2label))
    got = C.convert_32_to_12(probs, extend_reversed=extend_reversed)
    want = JC.convert_32_to_12(probs, extend_reversed=extend_reversed)
    assert got.shape == (11, 12) and np.array_equal(got, want)
    csv_path = JS.write_submission_csvs(
        str(tmp_path / "s"), [f"c{i}.wav" for i in range(11)], probs,
        int2label)["probs"]
    got = C.convert_probs_csv_to_memmap(csv_path, str(tmp_path / "t.mm"),
                                        extend_reversed=extend_reversed)
    want = JC.convert_probs_csv_to_memmap(csv_path, str(tmp_path / "j.mm"),
                                          extend_reversed=extend_reversed)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert (tmp_path / "t.mm").read_bytes() == (tmp_path / "j.mm").read_bytes()


def test_build_tta_set_within_two_lsb_of_jax(tmp_path):
    rng = np.random.default_rng(6)
    names = [f"clip_{i}.wav" for i in range(5)]
    _wavs(tmp_path / "audio", names, rng, samples=16000)
    audio = str(tmp_path / "audio")
    assert TS.build_tta_set(audio, str(tmp_path / "t"), batch_size=3,
                            device=CPU) == 5
    assert JT.build_tta_set(audio, str(tmp_path / "j"), batch_size=3) == 5
    assert sorted(os.listdir(tmp_path / "t")) == sorted(names)
    paths = lambda d: [str(tmp_path / d / n) for n in names]  # noqa: E731
    got = decode_batch_int16(paths("t"), 16000).astype(np.int32)
    want = decode_batch_int16(paths("j"), 16000).astype(np.int32)
    assert np.abs(got - want).max() <= 2
    assert np.abs(want).max() > 1000           # not silence


@pytest.fixture(scope="module")
def flagship_checkpoint(tmp_path_factory):
    """A checkpoint of the flagship (12 classes, random weights)."""
    trainer = Trainer(FLAGSHIP, prepare_model_settings(12),
                      synthetic_device_dataset(CPU), batch_size=4)
    state = trainer.init_state()
    path = str(tmp_path_factory.mktemp("ckpt") / "flagship.pt")
    save_checkpoint(path, state)
    return path, state.model


def test_make_submission_and_create_tta_set_clis(tmp_path,
                                                 flagship_checkpoint):
    ckpt, model = flagship_checkpoint
    rng = np.random.default_rng(7)
    names = [f"clip_{i}.wav" for i in range(5)]
    test_dir, tta_dir = str(tmp_path / "test"), str(tmp_path / "tta")
    _wavs(test_dir, names, rng, samples=16000)
    assert create_tta_set.main(["--test_dir", test_dir, "--out_dir", tta_dir,
                                "--batch_size", "4", "--device", "cpu"]) == 5
    common = ["--checkpoint", ckpt, "--test_dir", test_dir, "--wanted_only",
              "--batch_size", "4", "--device", "cpu"]
    plain = make_submission.main(
        common + ["--no_tta", "--out_prefix", str(tmp_path / "plain")])
    speed = make_submission.main(
        common + ["--tta_dir", tta_dir, "--out_prefix", str(tmp_path / "sp")])
    int2label = get_int2label(wanted_only=True)
    wav = decode_batch_int16([os.path.join(test_dir, n) for n in names],
                             16000)
    pad = np.zeros((3, 16000), np.int16)
    pred = Predictor(model, prepare_model_settings(12), "raw",
                     TTAConfig(use_tta=False), CPU)
    want = np.concatenate([pred.predict(wav[:4]).numpy(),
                           pred.predict(np.concatenate([wav[4:], pad]))
                           .numpy()[:1]])
    for paths, check in ((plain, want), (speed, None)):
        with open(paths["probs"], newline="") as f:
            rows = list(csv.DictReader(f))
        assert [r["fname"] for r in rows] == names
        probs = np.array([[float(r[int2label[i]]) for i in range(12)]
                          for r in rows], np.float32)
        np.testing.assert_allclose(probs.sum(1), 1.0 if check is not None
                                   else 0.6, atol=1e-5)
        if check is not None:
            assert np.array_equal(probs, check)
        mm = np.fromfile(paths["memmap"], np.uint8).reshape(5, 12)
        assert np.array_equal(mm, (S.to_audio_names_order(probs, int2label)
                                   * 255).astype(np.uint8))


def test_make_submission_needs_a_card_unless_given_the_cpu(
        tmp_path, flagship_checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_submission.main(["--checkpoint", flagship_checkpoint[0],
                              "--test_dir", str(tmp_path)])


def test_pseudo_labels_cli(tmp_path, capsys):
    rng = np.random.default_rng(8)
    names = [f"clip_{i:02d}.wav" for i in range(12)]
    audio = str(tmp_path / "audio")
    _wavs(audio, names, rng)
    subs = _submissions(tmp_path, names, rng)
    int2label = get_int2label(wanted_only=True)
    probs = _probs(rng, 12, 12)
    mm = str(tmp_path / "p.mm")
    S.write_uint8_memmap(mm, S.to_audio_names_order(probs, int2label))
    all32 = get_int2label()
    probs_csv = S.write_submission_csvs(
        str(tmp_path / "s32"), names, _probs(rng, 12, len(all32)),
        all32)["probs"]
    n = pseudo_labels.main(["agreement", "--submissions", *subs,
                            "--test_dir", audio,
                            "--out_dir", str(tmp_path / "agree")])
    assert n == JP.pseudo_by_agreement(subs, audio, str(tmp_path / "ja"))
    stats = pseudo_labels.main(["threshold", "--submission_csv", subs[0],
                                "--memmap", mm, "--test_dir", audio,
                                "--out_dir", str(tmp_path / "thr"),
                                "--prob_thresh", "0.3"])
    assert stats == JP.pseudo_by_threshold(
        names, S.read_uint8_memmap(mm, 12), audio, str(tmp_path / "jt"),
        prob_thresh=0.3)
    assert _tree(tmp_path / "thr") == _tree(tmp_path / "jt")
    clear, total = pseudo_labels.main(["vote", "--submissions", *subs,
                                       "--out", str(tmp_path / "v.csv")])
    assert total == 12 and (tmp_path / "v.csv").exists()
    fnames, mapped = pseudo_labels.main(["convert", "--probs_csv", probs_csv,
                                         "--memmap", str(tmp_path / "c.mm")])
    assert fnames == names and mapped.shape == (12, 12)
    out = capsys.readouterr().out
    assert "pseudo labels created" in out and "clear majority" in out


def test_evaluate_cli(tmp_path, flagship_checkpoint, capsys):
    root = tmp_path / "corpus"
    build_hard_corpus(root, clips_per_word=6, seed=0)
    result = evaluate.main(["--checkpoint", flagship_checkpoint[0],
                            "--data_dirs", str(root),
                            "--validation_percentage", "30",
                            "--batch_size", "16", "--device", "cpu"])
    conf = result["confusion"]
    assert conf.shape == (12, 12) and conf.sum() > 0
    assert np.isfinite(result["loss"]) and 0 <= result["accuracy"] <= 1
    assert "validation: loss=" in capsys.readouterr().out


def test_bench_infer_cli_on_the_cpu(tmp_path, capsys):
    record = bench_infer.main(["--num_files", "5", "--batch_size", "4",
                               "--keep_dir", str(tmp_path), "--device",
                               "cpu"])
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert next(iter(line)) == "end_to_end_clips_per_sec"
    assert line["end_to_end_clips_per_sec"] > 0
    assert line["device_clips_per_sec"] is None and line["tta"]
    assert line["k80_no_tta_minutes"] == 4.0
    assert "diagnostics:" in captured.err
    shares = record["diagnostics"]["end_to_end_host_share"]
    assert set(shares) == {"decode", "decode_wait", "h2d", "predict",
                           "readback_wait"}
    assert len(os.listdir(tmp_path / "audio")) == 5      # kept
