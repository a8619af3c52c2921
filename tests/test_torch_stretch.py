"""The port's phase-vocoder time stretch (``ops/stretch.py``) against the
JAX package's and against the independent numpy phase vocoder of
tests/test_phase_vocoder_independent.py (a frame-by-frame loop from
librosa's conventions), stage by stage, with that file's bounds, each
relative to max |want|:

* STFT 2e-5; the vocoder core on the same spectrum 2e-4; iSTFT 2e-5;
* end to end 5e-5 on broadband noise, and 0.15 on tonal signals, where
  the phase of near-silent bins is float32 noise that the accumulation
  keeps (that file's docstring);
* the keep-tail transform 5e-4 absolute;

at rates 0.9, 1.1 and 0.8.
"""

import numpy as np
import pytest
import torch

from speech_recognition_tpu.ops import stretch as J
from speech_recognition_tpu_torch.ops import stretch as S
from test_phase_vocoder_independent import (
    _ref_istft, _ref_phase_vocoder, _ref_stft, _ref_time_stretch, _signals,
)

torch.set_num_threads(1)

N_FFT, HOP, SR = 2048, 512, 16000
RATES = [0.9, 1.1, 0.8]
REFS = ["numpy", "jax"]
SIGNALS = _signals()


def _rel(got, want):
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", ["chirp", "tones", "noise", "burst"])
def test_stft(name, ref):
    y = SIGNALS[name]
    want = (_ref_stft(y, N_FFT, HOP) if ref == "numpy"
            else np.asarray(J._stft(y[None], N_FFT, HOP))[0])
    assert _rel(S.stft(_t(y), N_FFT, HOP).numpy()[0], want) < 2e-5


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name", ["chirp", "noise", "burst"])
def test_phase_vocoder_core_on_the_same_spectrum(name, rate, ref):
    spec = _ref_stft(SIGNALS[name], N_FFT, HOP)
    c64 = spec.astype(np.complex64)
    want = (_ref_phase_vocoder(spec, rate, HOP) if ref == "numpy"
            else np.asarray(J.phase_vocoder(c64[None], rate, HOP))[0])
    assert _rel(S.phase_vocoder(_t(c64), rate, HOP).numpy()[0], want) < 2e-4


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("name", ["chirp", "noise"])
def test_istft(name, ref):
    spec = _ref_phase_vocoder(_ref_stft(SIGNALS[name], N_FFT, HOP), 0.9, HOP)
    length = int(round(SR / 0.9))
    c64 = spec.astype(np.complex64)
    want = (_ref_istft(spec, N_FFT, HOP, length) if ref == "numpy"
            else np.asarray(J._istft(c64[None], N_FFT, HOP, length))[0])
    assert _rel(S.istft(_t(c64), N_FFT, HOP, length).numpy()[0], want) < 2e-5


def _want_stretch(y, rate, ref):
    if ref == "numpy":
        return _ref_time_stretch(y, rate)
    return np.asarray(J.time_stretch(y[None], rate=rate))[0]


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("rate", RATES)
def test_end_to_end_broadband(rate, ref):
    y = SIGNALS["noise"]
    got = S.time_stretch(_t(y), rate=rate).numpy()[0]
    assert got.shape == (int(round(SR / rate)),)
    assert _rel(got, _want_stretch(y, rate, ref)) < 5e-5


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name", ["chirp", "tones", "burst"])
def test_end_to_end_tonal(name, rate, ref):
    y = SIGNALS[name]
    got = S.time_stretch(_t(y), rate=rate).numpy()[0]
    assert _rel(got, _want_stretch(y, rate, ref)) < 0.15


@pytest.mark.parametrize("ref", REFS)
def test_keep_tail(ref):
    y = SIGNALS["noise"]
    want = (_ref_time_stretch(y, 0.9)[-SR:] if ref == "numpy"
            else np.asarray(J.slow_variant_keep_tail(y[None], rate=0.9))[0])
    got = S.slow_variant_keep_tail(_t(y), rate=0.9).numpy()[0]
    assert got.shape == (SR,)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_rows_are_stretched_independently():
    batch = np.stack([SIGNALS[n] for n in ("chirp", "tones", "noise")])
    together = S.time_stretch(torch.from_numpy(batch), rate=0.9).numpy()
    for row, y in zip(together, batch):
        alone = S.time_stretch(_t(y), rate=0.9).numpy()[0]
        assert _rel(row, alone) < 1e-6


def test_identity_rate_reconstructs_the_interior():
    y = SIGNALS["tones"]
    out = S.time_stretch(_t(y), rate=1.0).numpy()[0]
    assert np.abs(out[N_FFT:-N_FFT] - y[N_FFT:-N_FFT]).max() < 2e-2
