"""Feature frontend (port of speech_recognition_tpu/ops/frontend.py).

Only the ``raw`` representation, which the flagship trains on, is
ported; spectrogram and MFCC features come with ROADMAP A7.
"""

from __future__ import annotations

import torch


def features(wav: torch.Tensor, representation: str) -> torch.Tensor:
    """[B, T] waveforms -> model input for ``representation``."""
    if representation == "raw":
        return wav
    raise NotImplementedError(
        f"representation {representation!r} is not ported yet (ROADMAP A7)")
