"""Audio feature frontend (port of speech_recognition_tpu/ops/frontend.py).

The reference's per-sample TF graph (input_data.py:360-381)::

    tf.contrib.signal.stft(frame_length=W, frame_step=S, fft_length=None)
    -> abs -> linear_to_mel_weight_matrix(n_mels, 257, sr, 80, 7600)
    -> log(mel + 1e-6) -> mfccs_from_log_mel_spectrograms[..., :n_mfcc]

becomes constant matrices applied with batched matmuls, as in the JAX
package: framing (98 frames of 480 samples at stride 160, no padding),
the rFFT as real and imaginary DFT bases with the periodic Hann window
folded in, the mel filterbank and the DCT-II. The constants are built in
numpy in float64, rounded to float32 once, and cached per geometry and
device. Numerics follow tf.signal: fft_length = next_pow2(W) -> 257
bins, HTK mel scale 1127 ln(1 + f/700) with the DC bin zeroed, DCT-II
scaled by 1/sqrt(2 n_mels).

``precision`` is the JAX ``Precision`` pair: ``'highest'`` runs the
products in float32 with TF32 off and autocast off (the float32 parity
of the tf.signal goldens), ``'fastest'`` lets them run in TF32, or in
bf16 under an enclosing autocast. Either way the setting holds for the
frontend's own products only: the process-wide flags are restored.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.config import ModelSettings

LOG_OFFSET = 1e-6  # input_data.py:378
PRECISIONS = ("highest", "fastest")


def hann_window_periodic(length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (tf.signal.hann_window(periodic=True))."""
    n = np.arange(length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(dtype)


def hertz_to_mel(freq_hz):
    """HTK mel scale used by tf.signal: 1127 * ln(1 + f/700)."""
    return 1127.0 * np.log1p(np.asarray(freq_hz, dtype=np.float64) / 700.0)


def linear_to_mel_weight_matrix(num_mel_bins: int,
                                num_spectrogram_bins: int,
                                sample_rate: float,
                                lower_edge_hertz: float,
                                upper_edge_hertz: float,
                                dtype=np.float32) -> np.ndarray:
    """Triangular mel filterbank [bins, n_mels], parity with tf.signal
    (input_data.py:369-373): the DC bin is left out of the triangles and
    comes back as a zero row."""
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[1:]
    spectrogram_bins_mel = hertz_to_mel(linear_freqs)[:, None]
    band_edges_mel = np.linspace(hertz_to_mel(lower_edge_hertz),
                                 hertz_to_mel(upper_edge_hertz),
                                 num_mel_bins + 2)
    lower = band_edges_mel[None, 0:num_mel_bins]
    center = band_edges_mel[None, 1:num_mel_bins + 1]
    upper = band_edges_mel[None, 2:num_mel_bins + 2]
    lower_slopes = (spectrogram_bins_mel - lower) / (center - lower)
    upper_slopes = (upper - spectrogram_bins_mel) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    return np.pad(weights, [[1, 0], [0, 0]]).astype(dtype)


def dct2_matrix(n_in: int, n_out: int, dtype=np.float32) -> np.ndarray:
    """Unnormalised DCT-II basis [n_in, n_out] scaled by 1/sqrt(2 n_in),
    the first ``n_out`` coefficients of
    tf.signal.mfccs_from_log_mel_spectrograms (input_data.py:379-381)."""
    n = np.arange(n_in, dtype=np.float64)[:, None]
    k = np.arange(n_out, dtype=np.float64)[None, :]
    basis = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    return (basis / np.sqrt(2.0 * n_in)).astype(dtype)


def legacy_mel_filterbank_matrix(input_length: int,
                                 sample_rate: float,
                                 channels: int = 40,
                                 lower_frequency: float = 20.0,
                                 upper_frequency: float = 4000.0,
                                 dtype=np.float32) -> np.ndarray:
    """The legacy ``contrib_audio.mfcc`` filterbank [input_length,
    channels] (TF's C++ ``MfccMelFilterbank``, reference audio.py:20-23):
    each FFT bin is split between its two surrounding channel centres by
    linear interpolation in mel space, bins are limited to ``int(1.5 +
    lower/hz_per_bin) .. int(upper/hz_per_bin)``, and it applies to
    |STFT| magnitudes."""
    mel_low = hertz_to_mel(lower_frequency)
    mel_hi = hertz_to_mel(upper_frequency)
    spacing = (mel_hi - mel_low) / (channels + 1)
    center = mel_low + spacing * (np.arange(channels + 1) + 1)
    hz_per_sbin = 0.5 * sample_rate / (input_length - 1)
    start_index = int(1.5 + lower_frequency / hz_per_sbin)
    end_index = int(upper_frequency / hz_per_sbin)
    weights = np.zeros((input_length, channels))
    channel = 0
    for i in range(input_length):
        melf = float(hertz_to_mel(i * hz_per_sbin))
        if i < start_index or i > end_index:
            continue
        while channel < channels and center[channel] < melf:
            channel += 1
        ch = channel - 1  # -1 means "below the first center"
        if ch >= 0:
            w = (center[ch + 1] - melf) / (center[ch + 1] - center[ch])
            weights[i, ch] += w
        else:
            w = (center[0] - melf) / (center[0] - mel_low)
        if ch + 1 < channels:
            weights[i, ch + 1] += 1.0 - w
    return weights.astype(dtype)


def legacy_dct_matrix(n_in: int, n_out: int, dtype=np.float32) -> np.ndarray:
    """TF ``MfccDct`` basis: sqrt(2/N) * cos(k * pi/N * (n + 0.5))."""
    n = np.arange(n_in, dtype=np.float64)[:, None]
    k = np.arange(n_out, dtype=np.float64)[None, :]
    basis = np.cos(k * (np.pi / n_in) * (n + 0.5)) * np.sqrt(2.0 / n_in)
    return basis.astype(dtype)


def dft_bases(frame_length: int, fft_length: int,
              window: Optional[np.ndarray] = None,
              dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Real and imaginary rFFT bases [frame_length, fft_length // 2 + 1]:
    ``frames @ cos == Re(rfft(frames * window, fft_length))`` and
    ``frames @ sin == Im(...)``; the zero-padding to ``fft_length`` is
    implicit and the window is folded in."""
    num_bins = fft_length // 2 + 1
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(num_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    cos_b, sin_b = np.cos(ang), -np.sin(ang)
    if window is not None:
        cos_b = cos_b * window[:, None].astype(np.float64)
        sin_b = sin_b * window[:, None].astype(np.float64)
    return cos_b.astype(dtype), sin_b.astype(dtype)


def frame_indices(num_samples: int, frame_length: int,
                  frame_step: int) -> np.ndarray:
    """[num_frames, frame_length] sample index grid (no pad_end, like tf
    stft). ``Frontend`` frames with the equal strided view ``unfold``."""
    num_frames = 1 + (num_samples - frame_length) // frame_step
    return (np.arange(num_frames)[:, None] * frame_step +
            np.arange(frame_length)[None, :]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _constants(settings: ModelSettings, device: torch.device) -> dict:
    """The frontend's float32 matrices for one geometry on one device:
    ``dft`` [W, 2 bins] (cos then sin columns), ``mel``, ``dct``,
    ``legacy_mel`` and ``legacy_dct``."""
    s = settings
    bins = s.fft_length // 2 + 1
    cos_b, sin_b = dft_bases(s.window_size_samples, s.fft_length,
                             hann_window_periodic(s.window_size_samples))
    arrays = dict(
        dft=np.concatenate([cos_b, sin_b], axis=1),
        mel=linear_to_mel_weight_matrix(
            s.dct_coefficient_count, bins, s.sample_rate,
            s.lower_edge_hertz, s.upper_edge_hertz),
        dct=dct2_matrix(s.dct_coefficient_count, s.num_log_mel_features),
        legacy_mel=legacy_mel_filterbank_matrix(bins, s.sample_rate, 40,
                                                20.0, 4000.0),
        legacy_dct=legacy_dct_matrix(40, 40))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@contextlib.contextmanager
def _matmul_precision(precision: str, device_type: str):
    """TF32 on or off for the products inside, autocast off for
    'highest'; the previous flags come back on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "fastest"
    try:
        if precision == "highest":
            with torch.autocast(device_type=device_type, enabled=False):
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@dataclasses.dataclass(frozen=True)
class Frontend:
    """Batched feature extractor for one ``ModelSettings`` geometry.

    Every method takes float32 waveforms [B, desired_samples] on any
    device and returns float32 features on it (``'highest'`` keeps a
    float64 input in float64; ``'fastest'`` under bf16 autocast returns
    the products' bf16).
    """

    settings: ModelSettings
    precision: str = "highest"

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{self.precision!r}")

    def _matmul(self, a: torch.Tensor, name: str, cols: int = None):
        c = _constants(self.settings, a.device)[name]
        if cols is not None:
            c = c[:, :cols]
        with _matmul_precision(self.precision, a.device.type):
            if self.precision == "highest":     # float32, or float64 kept
                a = a.to(torch.promote_types(a.dtype, torch.float32))
            return torch.matmul(a, c.to(a.dtype))

    def spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        """|STFT| magnitude [B, frames, fft_bins] (input_data.py:361-366)."""
        s = self.settings
        frames = wav.unfold(-1, s.window_size_samples,
                            s.window_stride_samples)
        re_im = self._matmul(frames, "dft")
        re, im = re_im.chunk(2, dim=-1)
        return torch.sqrt(re * re + im * im)

    def log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """log(mel + 1e-6) [B, frames, n_mels] (input_data.py:374-378)."""
        return torch.log(self._matmul(self.spectrogram(wav), "mel")
                         + LOG_OFFSET)

    def mfcc(self, wav: torch.Tensor) -> torch.Tensor:
        """MFCCs [B, frames, num_log_mel_features] (input_data.py:379-381)."""
        return self._matmul(self.log_mel(wav), "dct")

    def legacy_mfcc(self, wav: torch.Tensor,
                    dct_coefficient_count: int = 40) -> torch.Tensor:
        """Tutorial-era MFCC (reference audio.py AudioConverter):
        ``audio_spectrogram(magnitude_squared=True)`` then the legacy
        ``mfcc`` op, whose filterbank runs on |STFT| magnitudes (40
        channels, 20-4000 Hz), log floored at 1e-12, and the MfccDct
        sqrt(2/N) basis."""
        mel = self._matmul(self.spectrogram(wav), "legacy_mel")
        logmel = torch.log(torch.clamp_min(mel, 1e-12))
        return self._matmul(logmel, "legacy_dct", dct_coefficient_count)

    def features(self, wav: torch.Tensor,
                 representation: Optional[str] = None):
        """Model input for ``representation`` (default: the settings'),
        flattened frames-major like the reference: 'raw' -> [B, T];
        'spec' -> [B, frames * 257]; 'mfcc' -> [B, frames * n_mfcc];
        'mfcc_and_raw' -> (mfcc_flat, raw) (input_data.py:437-448,
        517-531)."""
        rep = representation or self.settings.output_representation
        if rep == "raw":
            return wav
        if rep == "spec":
            return self.spectrogram(wav).flatten(1)
        if rep == "mfcc":
            return self.mfcc(wav).flatten(1)
        if rep == "mfcc_and_raw":
            return self.mfcc(wav).flatten(1), wav
        raise ValueError(f"unknown representation {rep!r}")
