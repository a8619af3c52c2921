"""The port's native batch WAV decoder (``csrc/wavio.cc`` through
``data/wav.py::decode_batch_int16``) against its numpy version and the
JAX package's decoder.

The decoder is host C++, built with the host compiler at first use, so
these run on the CPU. Rows must be equal, not close: the decode is exact.
A file the decoder cannot read raises ``ValueError`` naming it, and a
library that does not build raises instead of falling back to numpy.
"""

import os
import struct

import numpy as np
import pytest

import synth_corpus
from speech_recognition_tpu.data import wav as JW
from speech_recognition_tpu_torch.data import wav as W
from speech_recognition_tpu_torch.ops.kernels import build, launch


def _wav_bytes(n=64, channels=1, seed=0, extra_pcm=b""):
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32767, n * channels,
                       endpoint=True).astype("<i2").tobytes() + extra_pcm
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, 16000,
                                16000 * channels * 2, channels * 2, 16)
    body = b"WAVE" + fmt + b"data" + struct.pack("<I", len(pcm)) + pcm
    return b"RIFF" + struct.pack("<I", len(body)) + body


# the malformed inputs of tests/test_wav_robustness.py, and a fmt chunk
# shorter than 16 bytes, which the numpy parser refuses
CORRUPT = {
    "empty": b"",
    "random_bytes": bytes(np.random.default_rng(1).integers(
        0, 256, 200).astype(np.uint8)),
    "riff_only": b"RIFF\x00\x00\x00\x00WAVE",
    "no_data_chunk": _wav_bytes()[:20],
    "bad_magic": b"XIFF" + _wav_bytes()[4:],
    "float_format": _wav_bytes().replace(
        struct.pack("<IHH", 16, 1, 1), struct.pack("<IHH", 16, 3, 1), 1),
    "chunk_size_overflow": (b"RIFF\xff\xff\xff\xffWAVE"
                            b"junk" + struct.pack("<I", 0xFFFFFFF0)),
    "short_fmt": _wav_bytes().replace(b"fmt \x10\x00\x00\x00",
                                      b"fmt \x0e\x00\x00\x00", 1),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    synth_corpus.build_corpus(root, clips_per_word=2, seed=3)
    return sorted(str(p) for p in root.rglob("*.wav"))


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def _edge_files(tmp_path):
    """Valid files at the decoder's edges: pad, exact, crop, stereo with
    a partial trailing frame, an odd-sized chunk before the data, and a
    data chunk that claims more bytes than the file holds."""
    odd = _wav_bytes(500, seed=5)
    odd = odd[:12] + b"LIST" + struct.pack("<I", 3) + b"abc\x00" + odd[12:]
    return [
        _write(tmp_path, "pad.wav", _wav_bytes(100, seed=1)),
        _write(tmp_path, "exact.wav", _wav_bytes(16000, seed=2)),
        _write(tmp_path, "crop.wav", _wav_bytes(20000, seed=3)),
        _write(tmp_path, "stereo.wav",
               _wav_bytes(1000, channels=2, seed=4, extra_pcm=b"\x07\x00")),
        _write(tmp_path, "odd_chunk.wav", odd),
        _write(tmp_path, "truncated.wav", _wav_bytes(900, seed=6)[:-40]),
    ]


def test_native_rows_equal_numpy_and_jax_on_the_synthetic_corpus(corpus):
    got = W.decode_batch_int16(corpus, 16000)
    assert got.dtype == np.int16 and got.shape == (len(corpus), 16000)
    np.testing.assert_array_equal(got,
                                  W.decode_batch_int16_numpy(corpus, 16000))
    np.testing.assert_array_equal(got, JW.decode_batch_int16(corpus, 16000))


@pytest.mark.parametrize("desired", [16000, 1000, 20001])
@pytest.mark.parametrize("num_threads", [1, 8])
def test_native_rows_equal_numpy_and_jax_at_the_edges(tmp_path, desired,
                                                      num_threads):
    paths = _edge_files(tmp_path)
    got = W.decode_batch_int16(paths, desired, num_threads=num_threads)
    np.testing.assert_array_equal(got,
                                  W.decode_batch_int16_numpy(paths, desired))
    np.testing.assert_array_equal(got, JW.decode_batch_int16(
        paths, desired, num_threads=num_threads))


def test_stereo_keeps_channel_0_of_complete_frames(tmp_path):
    pcm = np.arange(1, 8, dtype="<i2").tobytes()    # 3 frames + 1 sample
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 16000, 64000, 4, 16)
    body = b"WAVE" + fmt + b"data" + struct.pack("<I", len(pcm)) + pcm
    p = _write(tmp_path, "partial.wav",
               b"RIFF" + struct.pack("<I", len(body)) + body)
    np.testing.assert_array_equal(W.decode_batch_int16([p], 5)[0],
                                  np.array([1, 3, 5, 0, 0], np.int16))


def test_truncated_data_chunk_is_clamped_and_zero_padded(tmp_path):
    full = _wav_bytes(64, seed=7)
    p = _write(tmp_path, "trunc.wav", full[:-40])   # 20 samples short
    got = W.decode_batch_int16([p], 64)[0]
    np.testing.assert_array_equal(
        got[:44], np.frombuffer(full[44:44 + 88], dtype="<i2"))
    np.testing.assert_array_equal(got[44:], np.zeros(20, np.int16))


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_a_bad_file_raises_with_its_path(tmp_path, name):
    good = _write(tmp_path, "good.wav", _wav_bytes())
    bad = _write(tmp_path, f"bad_{name}.wav", CORRUPT[name])
    with pytest.raises(ValueError, match=f"bad_{name}.wav"):
        W.decode_batch_int16([good, bad], 64)
    with pytest.raises(ValueError, match=f"bad_{name}.wav"):
        W.decode_batch_int16_numpy([good, bad], 64)


def test_a_missing_file_raises_as_numpy_does(tmp_path):
    with pytest.raises(FileNotFoundError):
        W.decode_batch_int16([str(tmp_path / "absent.wav")], 64)


def test_rows_go_into_the_callers_buffer(tmp_path):
    paths = _edge_files(tmp_path)
    out = np.full((len(paths) + 2, 1000), 99, dtype=np.int16)
    assert W.decode_batch_int16(paths, 1000, out=out) is out
    np.testing.assert_array_equal(out[:len(paths)],
                                  W.decode_batch_int16_numpy(paths, 1000))
    assert (out[len(paths):] == 99).all()           # rows past N untouched
    for bad in (np.zeros((len(paths), 1000), np.int32),
                np.zeros((len(paths) - 1, 1000), np.int16),
                np.zeros((len(paths), 999), np.int16),
                np.zeros((1000, len(paths)), np.int16).T):
        with pytest.raises(ValueError, match="out must be"):
            W.decode_batch_int16(paths, 1000, out=bad)
    assert W.decode_batch_int16([], 10).shape == (0, 10)


def test_many_threads_over_many_files(tmp_path):
    """More decoder threads than cores, each file its own content: a row
    written to the wrong place or twice would show."""
    paths = [_write(tmp_path, f"{i}.wav", _wav_bytes(50 + i, seed=i))
             for i in range(300)]
    got = W.decode_batch_int16(paths, 200, num_threads=64)
    np.testing.assert_array_equal(got,
                                  W.decode_batch_int16_numpy(paths, 200))
    assert W.default_threads() == min(32, 4 * (os.cpu_count() or 1))


class _CountingLibrary:
    def __init__(self, lib):
        self.lib, self.calls = lib, 0

    def wavio_decode_batch(self, *args):
        self.calls += 1
        return self.lib.wavio_decode_batch(*args)


def test_the_batch_goes_through_the_library(tmp_path, monkeypatch):
    counting = _CountingLibrary(W._library())
    monkeypatch.setattr(W, "_library", lambda: counting)
    paths = _edge_files(tmp_path)
    W.decode_batch_int16(paths, 16000)
    assert counting.calls == 1


@pytest.fixture
def no_library(tmp_path, monkeypatch):
    """No build of the decoder at hand: the builder writes to an empty
    directory, and the libraries loaded so far are set aside until the
    test ends."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(launch, "_LOADED", {})
    return tmp_path


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_a_failed_build_raises_and_returns_no_rows(no_library, monkeypatch,
                                                   compiler):
    tmp_path = no_library
    if compiler == "missing":
        monkeypatch.setattr(build, "HOST_CXX", str(tmp_path / "no" / "g++"))
        match = "cannot run"
    else:
        cxx = tmp_path / "bad_cxx"
        cxx.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\n"
                       "exit 1\n")
        cxx.chmod(0o755)
        monkeypatch.setattr(build, "HOST_CXX", str(cxx))
        match = "no compiler here"
    p = _write(tmp_path, "ok.wav", _wav_bytes())
    out = np.full((1, 64), 7, np.int16)
    with pytest.raises(RuntimeError, match=match):
        W.decode_batch_int16([p], 64, out=out)
    assert (out == 7).all()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_the_build_is_named_by_its_source_and_host_flags():
    path = build.library_path("wavio")
    assert path.name.startswith("libwavio-") and path.suffix == ".so"
    assert build.source("wavio").name == "wavio.cc"
    assert path == build.library_path("wavio")
