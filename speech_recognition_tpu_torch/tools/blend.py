"""Probability blending across uint8 memmaps, the team-ensemble workflow
(port of speech_recognition_tpu/tools/blend.py).

The reference team exchanged per-model probabilities as uint8 memmaps
(convert_from_see_v3_bugfix.py:107-110) and blended them offline; the
in-repo artifact of that workflow is `submit_50_probs.uint8.memmap`.
This tool implements the blend: weighted arithmetic or geometric mean
over N memmaps -> submission CSV + blended memmap.
"""

from __future__ import annotations

import csv
from typing import List, Optional, Sequence, Tuple

import numpy as np

from speech_recognition_tpu_torch.infer.submission import (
    AUDIO_NAMES, read_uint8_memmap, write_uint8_memmap,
)


def blend_probs(prob_sets: Sequence[np.ndarray],
                weights: Optional[Sequence[float]] = None,
                mode: str = "arithmetic") -> np.ndarray:
    """Weighted mean of probability matrices [N, C]."""
    if weights is None:
        weights = [1.0] * len(prob_sets)
    if len(weights) != len(prob_sets):
        raise ValueError("one weight per probability set")
    total = float(sum(weights))
    if mode == "arithmetic":
        out = sum(w * p for w, p in zip(weights, prob_sets)) / total
    elif mode == "geometric":
        log_sum = sum(w * np.log(np.maximum(p, 1e-12))
                      for w, p in zip(weights, prob_sets)) / total
        out = np.exp(log_sum)
        out = out / out.sum(axis=1, keepdims=True)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out.astype(np.float32)


def blend_memmaps(memmap_paths: Sequence[str], fnames: Sequence[str],
                  out_csv: str,
                  out_memmap: Optional[str] = None,
                  weights: Optional[Sequence[float]] = None,
                  mode: str = "arithmetic",
                  class_names: Sequence[str] = AUDIO_NAMES,
                  ) -> Tuple[List[str], np.ndarray]:
    """Blend memmaps and write the voted submission CSV."""
    n = len(fnames)
    probs = blend_probs(
        [read_uint8_memmap(p, n, len(class_names)) for p in memmap_paths],
        weights=weights, mode=mode)
    labels = [class_names[i] for i in probs.argmax(axis=1)]
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "label"])
        w.writerows(zip(fnames, labels))
    if out_memmap:
        write_uint8_memmap(out_memmap, probs)
    return labels, probs
