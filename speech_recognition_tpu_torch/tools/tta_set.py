"""Speed-TTA set builder (port of speech_recognition_tpu/tools/tta_set.py;
parity: create_tta_set.py).

Writes a parallel directory of 0.9x time-stretched test clips. Clips are
stretched a batch at a time on the device (``ops/stretch.py``), rather
than one file at a time as the reference's librosa loop does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from speech_recognition_tpu_torch.data.wav import (
    INT16_ENCODE_SCALE, decode_batch_int16, save_wav_file,
)
from speech_recognition_tpu_torch.device import require_cuda
from speech_recognition_tpu_torch.infer.submission import list_test_files
from speech_recognition_tpu_torch.ops.stretch import slow_variant_keep_tail


def build_tta_set(test_dir: str, out_dir: str, rate: float = 0.9,
                  batch_size: int = 256, sample_rate: int = 16000,
                  num_samples: int = 16000,
                  device: Optional[torch.device] = None) -> int:
    """Write a slowed copy of every test WAV, under the same name, to
    ``out_dir``; returns the count. Runs on ``device`` (default: the
    card)."""
    device = require_cuda() if device is None else torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    fns = list_test_files(test_dir)
    for start in range(0, len(fns), batch_size):
        chunk = fns[start:start + batch_size]
        # legacy 1/32767 scaling, as create_tta_set.py:17 reads
        wav = decode_batch_int16(chunk, num_samples).astype(np.float32) \
            / np.float32(INT16_ENCODE_SCALE)
        wav = np.pad(wav, ((0, batch_size - len(chunk)), (0, 0)))
        slowed = slow_variant_keep_tail(
            torch.from_numpy(wav).to(device), rate, num_samples)
        slowed = torch.clamp(slowed, -1.0, 1.0).cpu().numpy()
        for i, fn in enumerate(chunk):
            save_wav_file(os.path.join(out_dir, os.path.basename(fn)),
                          slowed[i], sample_rate)
    return len(fns)
