"""Validation metrics (port of speech_recognition_tpu/train/metrics.py)."""

from __future__ import annotations

import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[C, C] int64 counts on the labels' device; rows true, cols predicted.

    A scatter-add, which (unlike ``bincount`` on CUDA) does not wait for
    the device.
    """
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=labels.device)
    ones = torch.ones(labels.shape, dtype=torch.int64, device=labels.device)
    return conf.index_put_((labels.long(), preds.long()), ones,
                           accumulate=True)
