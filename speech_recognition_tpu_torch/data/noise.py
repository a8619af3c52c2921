"""Colored-noise synthesis (port of speech_recognition_tpu/data/noise.py;
parity: generate_noise.py + acoustics.generator).

Spectrum-shaped white noise: draw white Gaussian samples, shape the rFFT
magnitude by f^(exponent/2), normalize to unit std. Exponents follow the
acoustics package the reference uses (generate_noise.py:1,16): white 0,
pink -1, blue +1, brown -2, violet +2 (power-spectrum slopes). numpy
only, the JAX package's arithmetic as it is: one
``np.random.default_rng`` seed gives the same samples bit for bit.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

COLOR_EXPONENTS = {
    "white": 0.0,
    "pink": -1.0,
    "blue": 1.0,
    "brown": -2.0,
    "violet": 2.0,
}


def colored_noise(num_samples: int, color: str = "white",
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Unit-std colored noise, float32 [num_samples]."""
    if color not in COLOR_EXPONENTS:
        raise ValueError(f"unknown color {color!r}; "
                         f"choose from {sorted(COLOR_EXPONENTS)}")
    rng = rng or np.random.default_rng()
    white = rng.standard_normal(num_samples)
    spec = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(num_samples)
    freqs[0] = freqs[1]  # avoid div-by-zero at DC
    spec = spec * freqs ** (COLOR_EXPONENTS[color] / 2.0)
    out = np.fft.irfft(spec, n=num_samples)
    out = out / max(out.std(), 1e-12)
    return out.astype(np.float32)


def generate_background_noise_files(noise_dir: str,
                                    colors: Sequence[str] = (
                                        "blue", "brown", "violet"),
                                    seconds: int = 60,
                                    sample_rate: int = 16000,
                                    gain: float = 1.0 / 3.0,
                                    seed: int = 0) -> List[str]:
    """Write ``custom_<color>_noise.wav`` files into a
    ``_background_noise_`` dir (generate_noise.py:7-17: 60 s clips scaled
    by 1/3); returns their paths."""
    from speech_recognition_tpu_torch.data.wav import save_wav_file

    os.makedirs(noise_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for color in colors:
        data = colored_noise(seconds * sample_rate, color, rng) * gain
        path = os.path.join(noise_dir, f"custom_{color}_noise.wav")
        save_wav_file(path, np.clip(data, -1.0, 1.0), sample_rate)
        paths.append(path)
    return paths
