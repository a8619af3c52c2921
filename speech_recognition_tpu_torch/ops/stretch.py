"""Batched phase-vocoder time stretch (port of
speech_recognition_tpu/ops/stretch.py, librosa's ``time_stretch``).

The speed-TTA transform of the reference's offline builder
(create_tta_set.py:19: ``effects.time_stretch(data, 0.9)``): STFT ->
phase-vocoder frame resampling -> iSTFT, with librosa's conventions
(n_fft 2048, hop 512, centred periodic Hann, reflect padding, overlap-add
normalised by the window's summed squares).

The JAX package writes the transforms as DFT-basis matmuls and the
overlap-add as padded sums, because FFTs and scatters are slow on a TPU.
Here they are ``torch.fft.rfft``/``irfft`` (cuFFT on the card) and an
explicit overlap-add (``torch.nn.functional.fold``). The phase arithmetic
is the JAX package's, step for step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    """Periodic Hann, as librosa takes it (scipy's ``get_window('hann',
    n)``, ``fftbins=True``): 0.5 - 0.5 cos(2 pi k / n)."""
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_sum_squares(n_fft: int, hop: int, num_frames: int) -> np.ndarray:
    """The summed squared window over ``num_frames`` frames, in float32."""
    window = _hann(n_fft)
    wss = np.zeros(n_fft + hop * (num_frames - 1), np.float32)
    for i in range(num_frames):
        wss[i * hop:i * hop + n_fft] += window ** 2
    return wss


def stft(x: torch.Tensor, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """Centred STFT of [B, T] float32 waveforms: complex [B, bins, frames]
    (librosa's layout)."""
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    window = torch.from_numpy(_hann(n_fft)).to(x.device)
    frames = x.unfold(-1, n_fft, hop) * window          # [B, frames, n_fft]
    return torch.fft.rfft(frames, dim=-1).transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop: int,
          length: int) -> torch.Tensor:
    """Inverse STFT of complex [B, bins, frames]: windowed frames,
    overlap-added and divided by max(summed squared window, 1e-8), then
    trimmed to ``length`` samples after the centring pad."""
    window = torch.from_numpy(_hann(n_fft)).to(spec.device)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * window
    b, num_frames, _ = frames.shape
    out_len = n_fft + hop * (num_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop)).reshape(b, out_len)
    wss = torch.from_numpy(_window_sum_squares(n_fft, hop, num_frames))
    out = out / torch.clamp_min(wss.to(out.device), 1e-8)
    pad = n_fft // 2
    return out[:, pad:pad + length]


def _wrap(phase: torch.Tensor) -> torch.Tensor:
    """The principal value: ``phase`` less the nearest multiple of 2 pi
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    return phase - 2.0 * np.pi * torch.round(phase / (2.0 * np.pi))


def phase_vocoder(spec: torch.Tensor, rate: float,
                  hop: int = 512) -> torch.Tensor:
    """Batched ``librosa.phase_vocoder``: complex [B, bins, frames] ->
    [B, bins, ceil(frames / rate)].

    All phase arithmetic is mod 2 pi, as in the JAX package: the expected
    advance per frame (``linspace(0, pi hop, bins)``) is wrapped to its
    principal value in float64 before it becomes float32, and so is each
    step before the cumulative sum. Unwrapped, the sum reaches ~5e4 rad,
    where float32 resolves only ~4e-3 rad, and late frames drift. Only
    ``exp(i phase)`` is used, so wrapping changes nothing exact.
    """
    _, num_bins, n_frames = spec.shape
    dev = spec.device
    time_steps = np.arange(0, n_frames, rate, dtype=np.float64)
    phi64 = np.linspace(0, np.pi * hop, num_bins, dtype=np.float64)
    phi64 -= 2.0 * np.pi * np.round(phi64 / (2.0 * np.pi))
    phi_advance = torch.from_numpy(phi64.astype(np.float32)).to(dev)[:, None]
    spec = F.pad(spec, (0, 2))            # two zero frames: idx + 1 is valid
    idx = np.floor(time_steps).astype(np.int64)
    alpha = torch.from_numpy(
        (time_steps - idx).astype(np.float32)).to(dev)
    idx_t = torch.from_numpy(idx).to(dev)
    s0 = spec[:, :, idx_t]
    s1 = spec[:, :, idx_t + 1]
    mag = (1.0 - alpha) * s0.abs() + alpha * s1.abs()
    dphase = _wrap(torch.angle(s1) - torch.angle(s0) - phi_advance)
    steps = _wrap(dphase + phi_advance)   # [B, bins, out_frames]
    phase0 = torch.angle(s0[:, :, :1])
    phase_acc = phase0 + torch.cat(
        [torch.zeros_like(steps[:, :, :1]),
         torch.cumsum(steps[:, :, :-1], dim=-1)], dim=-1)
    return mag * torch.exp(1j * phase_acc)


def time_stretch(x: torch.Tensor, rate: float = 0.9, n_fft: int = 2048,
                 hop: int = 512, output_length: int = 0) -> torch.Tensor:
    """Stretch [B, T] float32 waveforms by ``rate`` (< 1 slows down), on
    their device. The output has ``round(T / rate)`` samples, as
    librosa's, unless ``output_length`` is given."""
    out_len = output_length or int(round(x.shape[-1] / rate))
    stretched = phase_vocoder(stft(x, n_fft, hop), rate, hop)
    return istft(stretched, n_fft, hop, out_len)


def slow_variant_keep_tail(x: torch.Tensor, rate: float = 0.9,
                           num_samples: int = 16000) -> torch.Tensor:
    """The reference's speed-TTA transform (create_tta_set.py:19-21):
    slow [B, T] clips down by ``rate`` and keep the last ``num_samples``
    samples."""
    return time_stretch(x, rate=rate)[:, -num_samples:]
