"""WAV codec: host-side RIFF parse and emit in numpy (port of
speech_recognition_tpu/data/wav.py).

Semantics follow TF's ``decode_wav``: 16-bit PCM -> float32 by division
by 32768, optional pad or crop to ``desired_samples``, first channel
only (input_data.py:117-156, audio.py:13-14). The JAX package's native
multithreaded batch decoder (``native/wavio.cc``) is host C++ and is not
ported yet (ROADMAP A); ``decode_batch_int16`` here is its numpy
fallback, which gives the same int16 rows.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

INT16_DECODE_SCALE = 32768.0  # decode_wav semantics
INT16_ENCODE_SCALE = 32767.0


def _parse_riff(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Parse a RIFF/WAVE byte string.

    Returns (int16 interleaved samples, sample_rate, num_channels).
    Only PCM-16 is supported (the only format in Speech Commands).
    """
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    n = len(data)
    while pos + 8 <= n:
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if chunk_id == b"fmt ":
            if chunk_size < 16 or body + 16 > n:
                raise ValueError("malformed fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", data, body)
        elif chunk_id == b"data":
            raw = data[body:body + chunk_size]
        # Chunks are word-aligned.
        pos = body + chunk_size + (chunk_size & 1)
        if fmt is not None and raw is not None:
            break
    if fmt is None or raw is None:
        raise ValueError("missing fmt or data chunk")
    audio_format, num_channels, sample_rate, _, _, bits = fmt
    if audio_format != 1 or bits != 16:
        raise ValueError(
            f"unsupported WAV encoding (format={audio_format}, bits={bits})")
    samples = np.frombuffer(raw[: (len(raw) // 2) * 2], dtype="<i2")
    return samples, sample_rate, max(num_channels, 1)


def _channel0(samples: np.ndarray, num_channels: int) -> np.ndarray:
    """Channel 0 of interleaved samples, complete frames only: a trailing
    partial frame is dropped (decode_wav counts frames as
    data_bytes // (channels * 2))."""
    frames = samples.shape[0] // num_channels
    return samples[: frames * num_channels : num_channels]


def decode_wav_bytes(data: bytes,
                     desired_channels: int = 1,
                     desired_samples: Optional[int] = None,
                     scale: float = INT16_DECODE_SCALE,
                     ) -> Tuple[np.ndarray, int]:
    """Decode WAV bytes to float32 in [-1, 1).

    Mirrors TF ``decode_wav(desired_channels=1, desired_samples=N)``
    (input_data.py:335-336): channel 0 is taken, output is zero-padded or
    cropped to ``desired_samples``.

    Returns (float32 [num_samples] array, sample_rate).
    """
    samples, sample_rate, num_channels = _parse_riff(data)
    if desired_channels != 1:
        raise NotImplementedError("only mono decoding is supported")
    if num_channels > 1:
        samples = _channel0(samples, num_channels)
    audio = samples.astype(np.float32) / np.float32(scale)
    if desired_samples is not None:
        if audio.shape[0] >= desired_samples:
            audio = audio[:desired_samples]
        else:
            audio = np.pad(audio, (0, desired_samples - audio.shape[0]))
    return audio, sample_rate


def decode_wav_to_int16(data: bytes,
                        desired_samples: Optional[int] = None) -> np.ndarray:
    """Decode WAV bytes to raw int16 (pad/crop), for the packed bank."""
    samples, _, num_channels = _parse_riff(data)
    if num_channels > 1:
        samples = _channel0(samples, num_channels)
    if desired_samples is not None:
        if samples.shape[0] >= desired_samples:
            samples = samples[:desired_samples]
        else:
            samples = np.pad(samples, (0, desired_samples - samples.shape[0]))
    return np.asarray(samples, dtype=np.int16)


def load_wav_file(filename: str,
                  desired_samples: Optional[int] = None,
                  scale: float = INT16_DECODE_SCALE) -> np.ndarray:
    """Load a WAV as float PCM in [-1, 1) (parity: input_data.py:117-133)."""
    with open(filename, "rb") as f:
        audio, _ = decode_wav_bytes(
            f.read(), desired_samples=desired_samples, scale=scale)
    return audio


def encode_wav_bytes(wav_data: np.ndarray, sample_rate: int) -> bytes:
    """Encode float PCM [-1, 1] to 16-bit mono WAV bytes."""
    wav_data = np.asarray(wav_data, dtype=np.float32).reshape(-1)
    ints = np.clip(np.round(wav_data * INT16_ENCODE_SCALE),
                   -32768, 32767).astype("<i2")
    raw = ints.tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                sample_rate * 2, 2, 16)
    data_chunk = b"data" + struct.pack("<I", len(raw)) + raw
    return header + fmt + data_chunk


def save_wav_file(filename: str, wav_data: np.ndarray,
                  sample_rate: int) -> None:
    """Save float PCM to a .wav file (parity: input_data.py:135-156)."""
    with open(filename, "wb") as f:
        f.write(encode_wav_bytes(wav_data, sample_rate))


def decode_batch_int16(paths: Sequence[str], desired_samples: int,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode many WAV files into a packed int16 array [N, desired_samples]
    (each padded or cropped); a file that does not decode raises with its
    path. ``out`` (int16, at least N rows) receives the rows in place of
    a new array, and is returned."""
    if out is None:
        out = np.zeros((len(paths), desired_samples), dtype=np.int16)
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            try:
                out[i] = decode_wav_to_int16(f.read(), desired_samples)
            except ValueError as e:
                raise ValueError(f"cannot decode {p}: {e}") from e
    return out


def decode_files_variable(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode WAV files keeping their native lengths (background bank)."""
    result = []
    for p in paths:
        with open(p, "rb") as f:
            samples, _, num_channels = _parse_riff(f.read())
        if num_channels > 1:
            samples = _channel0(samples, num_channels)
        result.append(np.asarray(samples, dtype=np.int16))
    return result
