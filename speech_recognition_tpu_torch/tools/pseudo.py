"""Pseudo-label construction (port of
speech_recognition_tpu/tools/pseudo.py; parity: REPR_106_pseudo.py,
create_pseudo_with_thresh.py).

Two strategies from the reference:
  * **agreement** — copy test clips where N submissions agree on the label
    into ``<out>/<label>/`` (REPR_106_pseudo.py:8-28).
  * **threshold** — from an ensemble uint8 probability memmap, copy clips
    whose max prob >= 0.7; ``silence`` clips are concatenated 30 at a time,
    amplified by /0.35, and written as synthetic ``_background_noise_``
    WAVs (create_pseudo_with_thresh.py:19,46-59).
"""

from __future__ import annotations

import csv
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from speech_recognition_tpu_torch.data.wav import (
    load_wav_file, save_wav_file,
)
from speech_recognition_tpu_torch.infer.submission import AUDIO_NAMES


def read_submission_csv(path: str) -> Tuple[List[str], List[str]]:
    fnames, labels = [], []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            fnames.append(row["fname"])
            labels.append(row["label"])
    return fnames, labels


def pseudo_by_agreement(submission_paths: Sequence[str],
                        test_audio_dir: str,
                        out_dir: str,
                        min_agree: Optional[int] = None) -> int:
    """Copy clips where all (or >= min_agree) submissions agree.

    The reference uses 3-way full agreement (REPR_106_pseudo.py:13).
    Returns the number of pseudo-labeled clips.
    """
    subs = [read_submission_csv(p) for p in submission_paths]
    fnames = subs[0][0]
    for fn_list, _ in subs[1:]:
        if fn_list != fnames:
            raise ValueError("submission filename order mismatch "
                             "(REPR_106_pseudo.py:17-19 contract)")
    if min_agree is None:
        min_agree = len(subs)
    count = 0
    for i, fn in enumerate(fnames):
        labels = [labels_list[i] for _, labels_list in subs]
        top = max(set(labels), key=labels.count)
        if labels.count(top) >= min_agree:
            dst_dir = os.path.join(out_dir, top)
            os.makedirs(dst_dir, exist_ok=True)
            shutil.copy(os.path.join(test_audio_dir, fn),
                        os.path.join(dst_dir, fn))
            count += 1
    return count


def pseudo_by_threshold(fnames: Sequence[str],
                        probs: np.ndarray,
                        test_audio_dir: str,
                        out_dir: str,
                        prob_thresh: float = 0.7,
                        silence_group: int = 30,
                        silence_gain: float = 1.0 / 0.35,
                        class_names: Sequence[str] = AUDIO_NAMES,
                        sample_rate: int = 16000) -> Dict[str, int]:
    """Threshold-based pseudo labels (create_pseudo_with_thresh.py:29-66).

    ``probs`` are float probabilities [N, C] (e.g. from
    ``read_uint8_memmap``). Word clips are copied under their label;
    silence clips are concatenated ``silence_group`` at a time, amplified
    by ``silence_gain``, and written to ``_background_noise_``.
    """
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    preds = probs.argmax(axis=-1)
    max_probs = probs.max(axis=-1)
    stats = {"created": 0, "low_prob": 0}
    silence_count = 0
    silence_data: List[np.ndarray] = []
    for i, fn in enumerate(fnames):
        label = class_names[preds[i]]
        dir_name = os.path.join(
            out_dir, "_background_noise_" if label == "silence" else label)
        os.makedirs(dir_name, exist_ok=True)
        if max_probs[i] < prob_thresh:
            stats["low_prob"] += 1
            continue
        src = os.path.join(test_audio_dir, fn)
        if label == "silence":
            # legacy 1/32767 scaling (create_pseudo_with_thresh.py:47)
            silence_data.append(load_wav_file(src, scale=32767.0))
            silence_count += 1
            if silence_count % silence_group == 0:
                dst = os.path.join(
                    out_dir, "_background_noise_",
                    "custom_silence_%06d.wav" % (silence_count
                                                 // silence_group))
                loud = np.concatenate(silence_data) * silence_gain
                save_wav_file(dst, loud, sample_rate)
                stats["created"] += 1
                silence_data = []
        else:
            shutil.copy(src, os.path.join(dir_name, fn))
            stats["created"] += 1
    return stats
