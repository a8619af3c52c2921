"""The port's data path against the JAX package's: labels, the SHA1
partition split, the dataset index, the WAV codec, the device bank built
from files and the hard-corpus generator. All of it is deterministic, so
every comparison is exact.
"""

import hashlib
import random
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import hard_corpus as jax_hard_corpus
from speech_recognition_tpu import labels as JL
from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.data import index as JI
from speech_recognition_tpu.data import wav as JW
from speech_recognition_tpu.data.device_bank import (
    build_device_dataset as jax_build_device_dataset,
)
from speech_recognition_tpu_torch import labels as L
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data import hard_corpus
from speech_recognition_tpu_torch.data import index as I
from speech_recognition_tpu_torch.data import wav as W
from speech_recognition_tpu_torch.data.device_bank import build_device_dataset

torch.set_num_threads(1)

CPU = torch.device("cpu")
INDEX_ARGS = dict(silence_percentage=13.0, unknown_percentage=60.0,
                  wanted_words=hard_corpus.WANTED, validation_percentage=20.0,
                  testing_percentage=10.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small hard corpus (6 clips per word), written by the port."""
    root = tmp_path_factory.mktemp("corpus") / "audio"
    hard_corpus.build_hard_corpus(root, clips_per_word=6, seed=0)
    return root


@pytest.mark.parametrize("wanted_only,extend_reversed",
                         [(False, False), (True, False), (False, True)])
def test_label_catalogs_match_jax(wanted_only, extend_reversed):
    kw = dict(wanted_only=wanted_only, extend_reversed=extend_reversed)
    assert L.get_classes(**kw) == JL.get_classes(**kw)
    assert L.get_int2label(**kw) == JL.get_int2label(**kw)
    assert L.get_label2int(**kw) == JL.get_label2int(**kw)
    words = L.get_classes(**kw)
    assert L.prepare_words_list(words) == JL.prepare_words_list(words)
    everything = L.get_classes(extend_reversed=True) + ["cat", "_silence_"]
    assert (L.build_word_to_index(everything, words)
            == JL.build_word_to_index(everything, words))
    for label in everything + ["_unknown_", "silence", "unknown"]:
        assert L.map_to_valid(label) == JL.map_to_valid(label)
        assert (L.map_to_wanted(label, words)
                == JL.map_to_wanted(label, words))
    with pytest.raises(ValueError):
        L.get_classes(wanted_only=True, extend_reversed=True)


def test_which_set_matches_jax_on_hundreds_of_names():
    rng = random.Random(7)
    names = []
    for i in range(400):
        word = rng.choice(["yes", "no", "unknown_unknown", "bed", "_x_"])
        speaker = "%08x" % rng.getrandbits(32)
        tail = rng.choice([f"_nohash_{i % 5}", f"_nohash_{i}_extra", ""])
        names.append(f"/data/{word}/{speaker}{tail}.wav")
    splits = [(10.0, 10.0), (20.0, 0.0), (0.0, 0.0), (50.0, 49.0)]
    got = [I.which_set(n, v, t) for n in names for v, t in splits]
    want = [JI.which_set(n, v, t) for n in names for v, t in splits]
    assert got == want
    assert set(got) == {"training", "validation", "testing", "pseudo"}
    # a speaker's clips share a partition: everything from _nohash_ on
    # is ignored
    assert I.which_set("/d/yes/ab12_nohash_0.wav", 10, 10) \
        == I.which_set("/d/no/ab12_nohash_3.wav", 10, 10)


def test_dataset_index_matches_jax(corpus):
    got = I.build_dataset_index([str(corpus)], **INDEX_ARGS)
    want = JI.build_dataset_index([str(corpus)], **INDEX_ARGS)
    assert sorted(got.data_index) == sorted(want.data_index)
    for mode in want.data_index:
        assert ([(e.label, e.file) for e in got.data_index[mode]]
                == [(e.label, e.file) for e in want.data_index[mode]])
        np.testing.assert_array_equal(got.labels_array(mode),
                                      want.labels_array(mode))
        np.testing.assert_array_equal(got.is_silence_array(mode),
                                      want.is_silence_array(mode))
    assert got.word_to_index == want.word_to_index
    assert got.words_list == want.words_list
    assert got.background_files == want.background_files
    assert got.summary() == want.summary()
    assert got.set_size("validation") > 0 and got.set_size("testing") > 0


def _wav_bytes(samples: np.ndarray, channels: int = 1,
               odd_chunk: bool = False) -> bytes:
    raw = samples.astype("<i2").tobytes()
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, 16000,
                                32000 * channels, 2 * channels, 16)
    extra = b"LIST" + struct.pack("<I", 3) + b"abc\x00" if odd_chunk else b""
    body = b"WAVE" + fmt + extra + b"data" + struct.pack("<I", len(raw)) + raw
    return b"RIFF" + struct.pack("<I", len(body)) + body


def test_decode_batch_int16_matches_jax(corpus, tmp_path):
    rng = np.random.default_rng(0)
    paths = [str(p) for p in sorted(corpus.glob("*/*.wav"))[:20]]
    cases = {"short": _wav_bytes(rng.integers(-3e4, 3e4, 900)),
             "long": _wav_bytes(rng.integers(-3e4, 3e4, 17000)),
             "stereo": _wav_bytes(rng.integers(-3e4, 3e4, 2 * 1000 + 1), 2),
             "odd_chunk": _wav_bytes(rng.integers(-3e4, 3e4, 500),
                                     odd_chunk=True)}
    for name, data in cases.items():
        (tmp_path / f"{name}.wav").write_bytes(data)
        paths.append(str(tmp_path / f"{name}.wav"))
    got = W.decode_batch_int16(paths, 16000)
    want = JW.decode_batch_int16(paths, 16000)
    assert got.dtype == np.int16 and got.shape == (len(paths), 16000)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(W.decode_files_variable(paths),
                    JW.decode_files_variable(paths)):
        np.testing.assert_array_equal(a, b)
    for p in paths[-4:]:
        np.testing.assert_array_equal(W.load_wav_file(p, 16000),
                                      JW.load_wav_file(p, 16000))
    (tmp_path / "bad.wav").write_bytes(b"RIFF0000WAVEjunk")
    with pytest.raises(ValueError, match="bad.wav"):
        W.decode_batch_int16([str(tmp_path / "bad.wav")], 16000)


def test_encode_wav_bytes_matches_jax():
    x = np.random.default_rng(1).uniform(-1.2, 1.2, 3001).astype(np.float32)
    assert W.encode_wav_bytes(x, 16000) == JW.encode_wav_bytes(x, 16000)


def test_device_dataset_from_files_matches_jax(corpus):
    index = I.build_dataset_index([str(corpus)], **INDEX_ARGS)
    jax_index = JI.build_dataset_index([str(corpus)], **INDEX_ARGS)
    got = build_device_dataset(index, prepare_model_settings(12), CPU)
    want = jax_build_device_dataset(jax_index, jax_prepare_model_settings(12),
                                    chunked=False)
    np.testing.assert_array_equal(got.wav_bank.numpy(),
                                  np.asarray(want.wav_bank))
    assert got.num_clips == want.num_clips
    assert got.num_classes == want.num_classes == 12
    assert sorted(got.partitions) == sorted(want.partitions)
    for mode, part in want.partitions.items():
        mine = got.partitions[mode]
        for field in ("file_ids", "labels", "is_silence"):
            np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                          np.asarray(getattr(part, field)))
        assert mine.file_ids.device == CPU
    # duplicate references (the silence entries) share one bank row
    silence = got.partitions["training"].is_silence
    assert silence.any()
    assert got.partitions["training"].file_ids[silence].unique().numel() == 1
    for field in ("flat", "starts", "lengths"):
        np.testing.assert_array_equal(
            getattr(got.background, field).numpy(),
            np.asarray(getattr(want.background, field)))


def test_device_dataset_decodes_through_the_native_library(corpus,
                                                           monkeypatch):
    """The bank's clips are decoded in one call of the native decoder
    (``csrc/wavio.cc``), and give the numpy decoder's rows."""
    lib, calls = W._library(), []

    class Counting:
        def wavio_decode_batch(self, *args):
            calls.append(args[1])
            return lib.wavio_decode_batch(*args)

    monkeypatch.setattr(W, "_library", Counting)
    index = I.build_dataset_index([str(corpus)], **INDEX_ARGS)
    ds = build_device_dataset(index, prepare_model_settings(12), CPU)
    assert calls == [ds.num_clips]
    paths = list(dict.fromkeys(
        e.file for mode in ("training", "validation", "testing", "pseudo")
        for e in index.data_index[mode]))
    np.testing.assert_array_equal(ds.wav_bank.numpy(),
                                  W.decode_batch_int16_numpy(paths, 16000))


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*.wav"))}


def test_hard_corpus_files_are_byte_identical(tmp_path):
    kw = dict(clips_per_word=3, seed=5, snr_db_range=(1.0, 9.0),
              pitch_span_l=1.2)
    hard_corpus.build_hard_corpus(tmp_path / "port", **kw)
    jax_hard_corpus.build_hard_corpus(tmp_path / "jax", **kw)
    port, jax = _digest(tmp_path / "port"), _digest(tmp_path / "jax")
    assert len(port) == 12 * 3 + 2
    assert port == jax
    assert hard_corpus.WORD_SEQS == jax_hard_corpus.WORD_SEQS
    assert hard_corpus.WANTED == jax_hard_corpus.WANTED
