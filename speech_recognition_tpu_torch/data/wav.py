"""WAV codec: host-side RIFF parse and emit in numpy (port of
speech_recognition_tpu/data/wav.py).

Semantics follow TF's ``decode_wav``: 16-bit PCM -> float32 by division
by 32768, optional pad or crop to ``desired_samples``, first channel
only (input_data.py:117-156, audio.py:13-14).

``decode_batch_int16`` decodes many files at once through the port's
multithreaded C++ decoder (``csrc/wavio.cc``, built with the host
compiler at first use and loaded with ``ctypes``; the JAX package's
``native/wavio.cc``). It never falls back quietly: a library that does
not build or load raises. ``decode_batch_int16_numpy`` is its plain
version, the same rows from the numpy parser.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from speech_recognition_tpu_torch.ops.kernels import build

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


def _batch_out(n: int, desired_samples: int,
               out: Optional[np.ndarray]) -> np.ndarray:
    if out is None:
        return np.zeros((n, desired_samples), dtype=np.int16)
    if out.dtype != np.int16 or out.ndim != 2 or out.shape[0] < n \
            or out.shape[1] != desired_samples:
        raise ValueError(f"out must be int16 [>= {n}, {desired_samples}], "
                         f"got {out.dtype} {out.shape}")
    return out


def _decode_file_int16(path: str, desired_samples: int) -> np.ndarray:
    with open(path, "rb") as f:
        try:
            return decode_wav_to_int16(f.read(), desired_samples)
        except ValueError as e:
            raise ValueError(f"cannot decode {path}: {e}") from e


def decode_batch_int16_numpy(paths: Sequence[str], desired_samples: int,
                             out: Optional[np.ndarray] = None) -> np.ndarray:
    """``decode_batch_int16``'s plain version: one file at a time through
    the numpy parser, the same rows and errors."""
    out = _batch_out(len(paths), desired_samples, out)
    for i, p in enumerate(paths):
        out[i] = _decode_file_int16(p, desired_samples)
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build ``csrc/wavio.cc`` (at first use) and load it; raises if the
    build or the load fails."""
    lib = ctypes.CDLL(str(build.build("wavio")))
    lib.wavio_decode_batch.restype = ctypes.c_int
    lib.wavio_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),    # paths
        ctypes.c_int,                       # number of files
        ctypes.c_int,                       # desired samples
        ctypes.POINTER(ctypes.c_int16),     # out [n, desired], C order
        ctypes.POINTER(ctypes.c_int32),     # lengths [n]
        ctypes.c_int,                       # threads
    ]
    return lib


def default_threads() -> int:
    """The decoder's threads when none are asked for: four per core, at
    most 32 (the JAX package's choice)."""
    return min(32, max(1, (os.cpu_count() or 1) * 4))


def decode_batch_int16(paths: Sequence[str], desired_samples: int,
                       num_threads: int = 0,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode many WAV files into a packed int16 array [N, desired_samples]
    (each padded or cropped) with the native decoder on ``num_threads``
    threads (0: ``default_threads()``). ctypes releases the GIL for the
    call. A file the decoder marks unreadable is decoded again by the
    numpy parser, so that a corrupt file raises ``ValueError`` naming its
    path. ``out`` (int16, C-contiguous, at least N rows) receives the rows
    in place of a new array, and is returned."""
    n = len(paths)
    out = _batch_out(n, desired_samples, out)
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous")
    lib = _library()
    if n == 0:
        return out
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lengths = np.zeros(n, dtype=np.int32)
    rc = lib.wavio_decode_batch(
        names, n, desired_samples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_threads if num_threads > 0 else default_threads())
    if rc != 0:
        raise RuntimeError(f"wavio_decode_batch returned {rc}")
    for i in np.flatnonzero(lengths < 0):
        out[i] = _decode_file_int16(paths[i], desired_samples)
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
