"""Typed configuration (port of speech_recognition_tpu/config.py).

The same frozen dataclasses and derivation as the JAX package, so that
the port and its smoke run need nothing from that package;
``tests/test_torch_augment.py`` holds the two field for field.
``ModelSettings`` carries the feature geometry of the reference's
``prepare_model_settings`` (model.py:1785-1829); ``AugmentConfig`` the
augmentation policy (defaults = reference utils.py:8-12 / train.py:40-47).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

OUTPUT_REPRESENTATIONS = ("raw", "spec", "mfcc", "mfcc_and_raw")


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    """Derived audio/feature geometry shared by data, frontend, and models."""

    label_count: int
    sample_rate: int = 16000
    desired_samples: int = 16000
    window_size_samples: int = 480
    window_stride_samples: int = 160
    spectrogram_length: int = 98
    # fft_length 512 -> 257 rFFT bins (reference model.py:1804)
    spectrogram_frequencies: int = 257
    # mel bins (the reference names them 'dct_coefficient_count')
    dct_coefficient_count: int = 80
    num_log_mel_features: int = 60
    output_representation: str = "raw"
    fingerprint_size: int = 16000
    lower_edge_hertz: float = 80.0
    upper_edge_hertz: float = 7600.0

    @property
    def fft_length(self) -> int:
        """Smallest power of two >= window (tf.signal.stft fft_length=None)."""
        n = 1
        while n < self.window_size_samples:
            n *= 2
        return n


def prepare_model_settings(label_count: int,
                           sample_rate: int = 16000,
                           clip_duration_ms: int = 1000,
                           window_size_ms: float = 30.0,
                           window_stride_ms: float = 10.0,
                           dct_coefficient_count: int = 80,
                           num_log_mel_features: int = 60,
                           output_representation: str = "raw") -> ModelSettings:
    """Compute derived settings (parity: reference model.py:1785-1829)."""
    if output_representation not in OUTPUT_REPRESENTATIONS:
        raise ValueError(f"invalid output_representation "
                         f"{output_representation!r}")
    desired_samples = int(sample_rate * clip_duration_ms / 1000)
    window_size_samples = int(sample_rate * window_size_ms / 1000)
    window_stride_samples = int(sample_rate * window_stride_ms / 1000)
    length_minus_window = desired_samples - window_size_samples
    spectrogram_frequencies = 257
    spectrogram_length = (0 if length_minus_window < 0 else
                          1 + length_minus_window // window_stride_samples)
    if output_representation in ("mfcc", "mfcc_and_raw"):
        fingerprint_size = num_log_mel_features * spectrogram_length
    elif output_representation == "raw":
        fingerprint_size = desired_samples
    else:  # spec
        fingerprint_size = spectrogram_frequencies * spectrogram_length
    return ModelSettings(
        label_count=label_count,
        sample_rate=sample_rate,
        desired_samples=desired_samples,
        window_size_samples=window_size_samples,
        window_stride_samples=window_stride_samples,
        spectrogram_length=spectrogram_length,
        spectrogram_frequencies=spectrogram_frequencies,
        dct_coefficient_count=dct_coefficient_count,
        num_log_mel_features=num_log_mel_features,
        output_representation=output_representation,
        fingerprint_size=fingerprint_size,
    )


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Per-batch augmentation policy (the per-sample draw policy of
    input_data.py:457-514, drawn for a whole batch at once)."""

    background_frequency: float = 0.3
    background_volume_range: float = 0.15
    foreground_frequency: float = 0.3
    foreground_volume_range: float = 0.15
    time_shift_frequency: float = 0.3
    time_shift_range: Tuple[int, int] = (-500, 0)
    flip_frequency: float = 0.0
    silence_volume_range: float = 0.3
    # Probability that a silence clip still gets background mixed in even
    # when the background draw failed (input_data.py:493-496).
    silence_background_frequency: float = 0.9
    pseudo_frequency: float = 0.0
