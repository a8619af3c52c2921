"""The port's ``Frontend`` against the JAX package's and against the
goldens TensorFlow itself produced.

Both sides run in float32: the JAX side at ``Precision.HIGHEST``, the
port at ``'highest'`` (TF32 off, which on the CPU changes nothing).
Bounds against the JAX frontend: spectrogram max abs err <= 1e-5 of
max |ref|; log-mel <= 1e-4 where mel > 1e-3 (below that, log of float32
rounding noise); mfcc <= 1e-4 of max |ref| on clips of non-trivial
energy. Against TF: the bounds of tests/test_tf_parity_goldens.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import (
    prepare_model_settings as jax_prepare_model_settings,
)
from speech_recognition_tpu.ops import frontend as JF
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.ops import frontend as F

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "tf_frontend_goldens.npz")
GEOMETRIES = {
    "main": dict(window_size_ms=30.0, dct_coefficient_count=80,
                 num_log_mel_features=60),
    "alt": dict(window_size_ms=25.0, dct_coefficient_count=40,
                num_log_mel_features=40),
}
ENERGETIC_CLIPS = [0, 1, 2]     # tones, impulses, noise


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _pair(name):
    kw = dict(label_count=12, window_stride_ms=10.0,
              output_representation="mfcc", **GEOMETRIES[name])
    return (F.Frontend(prepare_model_settings(**kw)),
            JF.Frontend(jax_prepare_model_settings(**kw)))


def _clips(n=6, seed=0):
    """Speech-like clips of non-trivial energy: tones with harmonics,
    amplitude-modulated, over white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000) / 16000.0
    out = []
    for _ in range(n):
        f0 = rng.uniform(150, 900)
        sig = sum(rng.uniform(0.1, 0.4) * np.sin(2 * np.pi * h * f0 * t
                                                 + rng.uniform(0, 6))
                  for h in (1, 2, 3))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        out.append(sig * env + rng.normal(0, 0.02, t.shape))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_constants_match_jax(name):
    front, jfront = _pair(name)
    s = front.settings
    for fn, args in (
            ("hann_window_periodic", (s.window_size_samples,)),
            ("linear_to_mel_weight_matrix", (s.dct_coefficient_count, 257,
                                             16000, 80.0, 7600.0)),
            ("dct2_matrix", (s.dct_coefficient_count,
                             s.num_log_mel_features)),
            ("legacy_mel_filterbank_matrix", (257, 16000)),
            ("legacy_dct_matrix", (40, 40)),
            ("frame_indices", (16000, s.window_size_samples,
                               s.window_stride_samples))):
        np.testing.assert_array_equal(getattr(F, fn)(*args),
                                      getattr(JF, fn)(*args))
    for a, b in zip(F.dft_bases(s.window_size_samples, s.fft_length),
                    JF.dft_bases(s.window_size_samples, s.fft_length)):
        np.testing.assert_array_equal(a, b)
    # the strided view the port frames with is the JAX gather grid
    wav = torch.arange(16000.0)[None]
    idx = F.frame_indices(16000, s.window_size_samples,
                          s.window_stride_samples)
    frames = wav.unfold(-1, s.window_size_samples, s.window_stride_samples)
    np.testing.assert_array_equal(frames[0].numpy(), idx.astype(np.float32))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_frontend_matches_jax(name):
    front, jfront = _pair(name)
    wav = _clips()
    x, jx = torch.from_numpy(wav), jnp.asarray(wav)

    spec = front.spectrogram(x).numpy()
    ref = np.asarray(jfront.spectrogram(jx))
    assert spec.shape == ref.shape == (6, front.settings.spectrogram_length,
                                       257)
    assert np.abs(spec - ref).max() <= 1e-5 * np.abs(ref).max()

    lm = front.log_mel(x).numpy()
    ref = np.asarray(jfront.log_mel(jx))
    energetic = np.exp(ref.astype(np.float64)) - 1e-6 > 1e-3
    assert energetic.mean() > 0.5
    assert np.abs(lm - ref)[energetic].max() <= 1e-4 * np.abs(ref).max()

    m = front.mfcc(x).numpy()
    ref = np.asarray(jfront.mfcc(jx))
    assert m.shape == ref.shape
    assert np.abs(m - ref).max() <= 1e-4 * np.abs(ref).max()

    lg = front.legacy_mfcc(x).numpy()
    ref = np.asarray(jfront.legacy_mfcc(jx))
    assert lg.shape == ref.shape
    assert np.abs(lg - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("rep", ["raw", "spec", "mfcc", "mfcc_and_raw"])
def test_features_match_jax(rep):
    kw = dict(label_count=12, output_representation=rep)
    front = F.Frontend(prepare_model_settings(**kw))
    jfront = JF.Frontend(jax_prepare_model_settings(**kw))
    wav = _clips(3, seed=1)
    got = front.features(torch.from_numpy(wav))
    want = jfront.features(jnp.asarray(wav))
    if rep == "mfcc_and_raw":
        assert got[1].shape == want[1].shape
        got, want = got[0], want[0]
    want = np.asarray(want)
    assert got.shape == want.shape == (3, front.settings.fingerprint_size)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_spec_features_are_frames_major():
    front = F.Frontend(prepare_model_settings(12, output_representation="spec"))
    x = torch.from_numpy(_clips(2))
    flat = front.features(x)
    np.testing.assert_array_equal(flat.reshape(2, 98, 257).numpy(),
                                  front.spectrogram(x).numpy())


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_frontend_matches_tf_goldens(goldens, name):
    front, _ = _pair(name)
    x = torch.from_numpy(goldens["waveforms"])
    spec = front.spectrogram(x).numpy()
    np.testing.assert_allclose(spec, goldens[f"{name}_spec"], atol=5e-5)

    lm = front.log_mel(x).numpy()
    ref = goldens[f"{name}_log_mel"]
    err = np.abs(lm - ref)
    mel_ref = np.exp(ref.astype(np.float64)) - 1e-6
    assert err[mel_ref > 1e-3].max() < 5e-3
    assert err.max() < 2.0
    np.testing.assert_allclose(np.exp(lm.astype(np.float64)) - 1e-6,
                               mel_ref, atol=2e-4, rtol=3e-3)

    m = front.mfcc(x).numpy()
    ref = goldens[f"{name}_mfcc"]
    np.testing.assert_allclose(m[ENERGETIC_CLIPS], ref[ENERGETIC_CLIPS],
                               atol=5e-3)
    assert np.abs(m - ref).max() < 0.25
    np.testing.assert_allclose(
        F.linear_to_mel_weight_matrix(*goldens[f"{name}_mel_matrix"].shape[::-1],
                                      16000, 80.0, 7600.0),
        goldens[f"{name}_mel_matrix"], atol=2e-5)


def test_legacy_frontend_matches_tf_goldens(goldens):
    front, _ = _pair("main")
    x = torch.from_numpy(goldens["waveforms"])
    m = front.legacy_mfcc(x).numpy()
    ref = goldens["legacy_mfcc"]
    np.testing.assert_allclose(m[ENERGETIC_CLIPS], ref[ENERGETIC_CLIPS],
                               atol=1e-3)
    assert np.abs(m - ref).max() < 1.0
    mag = front.spectrogram(x).numpy()
    np.testing.assert_allclose(mag ** 2, goldens["legacy_spec"], atol=1e-3,
                               rtol=1e-4)


def test_precision_flags_are_local():
    front = F.Frontend(prepare_model_settings(12))
    fast = F.Frontend(prepare_model_settings(12), precision="fastest")
    x = torch.from_numpy(_clips(2))
    before = torch.backends.cuda.matmul.allow_tf32
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        front.mfcc(x)
        fast.mfcc(x)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    torch.backends.cuda.matmul.allow_tf32 = before
    # 'highest' keeps float64 and leaves autocast
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert front.mfcc(x).dtype == torch.float32
        assert front.spectrogram(x.double()).dtype == torch.float64
        assert fast.spectrogram(x).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="precision"):
        F.Frontend(prepare_model_settings(12), precision="high")
