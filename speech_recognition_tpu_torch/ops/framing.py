"""Signal framing (port of speech_recognition_tpu/ops/framing.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pad_amount(length: int, ksize: int, stride: int):
    """TF 'SAME' asymmetric padding (left, right) for a 1-D window.

    The smaller half goes on the left (total // 2), as TensorFlow does;
    torch's ``padding='same'`` is symmetric and rejects stride > 1, so
    callers pad explicitly with this.
    """
    out = -(-length // stride)  # ceil
    pad_total = max((out - 1) * stride + ksize - length, 0)
    left = pad_total // 2
    return left, pad_total - left


def overlapping_frames(x: torch.Tensor, ksize: int, stride: int,
                       padding: str = "SAME") -> torch.Tensor:
    """[B, T] -> [B, frames, ksize] overlapping frames.

    tf.extract_image_patches semantics for SAME and VALID padding, e.g.
    [B, 16000] -> [B, 800, 40] at (40, 20, SAME). The result is a strided
    view of the (padded) input.
    """
    if padding.upper() == "SAME":
        left, right = same_pad_amount(x.shape[-1], ksize, stride)
        x = F.pad(x, (left, right))
    return x.unfold(-1, ksize, stride)
