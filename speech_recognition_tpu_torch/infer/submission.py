"""Submission generation and the probability exchange formats (port of
speech_recognition_tpu/infer/submission.py).

Parity with make_submission.py:34-213 and the team's ensemble formats:

* the wanted-label CSV, the all-label CSV and the all-probability CSV
  (make_submission.py:198-212);
* the uint8 memmap of probabilities, shape (N, 12), values prob * 255
  truncated to uint8 as the reference's memmap assignment does
  (convert_from_see_v3_bugfix.py:107-110).

``predict_directory`` runs a ``Predictor`` over a directory of WAVs: a
worker thread decodes one to two batches ahead into pinned host buffers,
each batch goes to the device as int16 by a non-blocking copy, and the
probabilities come back by non-blocking copies, at most 8 batches behind.
With a Predictor over W ranks each rank decodes and predicts only its
B/W rows of each batch, and every rank gets all the probabilities.
"""

from __future__ import annotations

import csv
import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from speech_recognition_tpu_torch.data.prefetch import Slot
from speech_recognition_tpu_torch.labels import (
    get_classes, map_to_valid, map_to_wanted, prepare_words_list,
)

# Heng's 12-class submission order (create_pseudo_with_thresh.py:10-11)
AUDIO_NAMES = ["silence", "unknown", "yes", "no", "up", "down",
               "left", "right", "on", "off", "stop", "go"]

# batches decoded ahead of the device, and batches in flight before the
# oldest one is read back
DECODE_AHEAD = 2
MAX_IN_FLIGHT = 8


def list_test_files(test_dir: str) -> List[str]:
    """Sorted test WAVs (make_submission.py:35)."""
    return sorted(glob.glob(os.path.join(test_dir, "*.wav")))


class _Readback:
    """A batch's probabilities on their way back to the host: a
    non-blocking copy into pinned memory and its event, on a card."""

    def __init__(self, probs: torch.Tensor, pad: int):
        self.pad = pad
        if probs.device.type == "cuda":
            self.host = torch.empty(probs.shape, dtype=probs.dtype,
                                    pin_memory=True)
            self.host.copy_(probs, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = probs, None

    def result(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        probs = self.host.numpy()
        return probs[:-self.pad] if self.pad else probs


def predict_directory(predictor, test_dir: str, batch_size: int = 384,
                      tta_dir: Optional[str] = None,
                      desired_samples: int = 16000,
                      progress: bool = False,
                      timings: Optional[Dict[str, float]] = None):
    """Run ``predictor`` over the sorted WAVs of ``test_dir``; with
    ``tta_dir``, the slow clip of each is the file of the same name there.

    Returns (basenames, probs [N, C] numpy). The tail batch is padded with
    zero rows to a full batch, one shape for every call, and trimmed.
    Over a Predictor's W ranks (``batch_size`` a multiple of W, so the
    padded batch is too) each rank reads only its rows ``[r B/W, (r + 1)
    B/W)`` of every batch, zero rows where the files run out; the
    probabilities come back whole on every rank.
    ``timings``, if given, receives host seconds: ``decode_s`` (the
    worker's decoding), ``decode_wait_s`` (the caller waiting for the
    worker), ``h2d_s`` (issuing the copies to the device), ``predict_s``
    (issuing the predictions), ``readback_wait_s`` (waiting for results)
    and ``total_s``.
    """
    t_start = time.perf_counter()
    fns = list_test_files(test_dir)
    lists = [fns]
    if tta_dir is not None:
        lists.append([os.path.join(tta_dir, os.path.basename(f))
                      for f in fns])
    starts = list(range(0, len(fns), batch_size))
    mine = predictor.mesh.rows(batch_size)
    slots = [Slot(len(lists), mine.stop - mine.start, desired_samples,
                  predictor.device) for _ in range(DECODE_AHEAD + 1)]
    clock = dict.fromkeys(("decode_s", "decode_wait_s", "h2d_s",
                           "predict_s", "readback_wait_s"), 0.0)

    def decode(i: int):
        t0 = time.perf_counter()
        slot = slots[i % len(slots)]
        start = starts[i]
        slot.fill([paths[start + mine.start:start + mine.stop]
                   for paths in lists], desired_samples)
        clock["decode_s"] += time.perf_counter() - t0
        return slot, batch_size - len(fns[start:start + batch_size])

    pending: List[_Readback] = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        futures = [pool.submit(decode, i)
                   for i in range(min(DECODE_AHEAD, len(starts)))]
        for i, start in enumerate(starts):
            t0 = time.perf_counter()
            slot, pad = futures[i].result()
            t1 = time.perf_counter()
            if i + DECODE_AHEAD < len(starts):
                futures.append(pool.submit(decode, i + DECODE_AHEAD))
            wav, *slow = slot.upload()
            t2 = time.perf_counter()
            pending.append(_Readback(
                predictor.predict(wav, slow[0] if slow else None), pad))
            t3 = time.perf_counter()
            if i >= MAX_IN_FLIGHT:
                pending[i - MAX_IN_FLIGHT].result()
            clock["decode_wait_s"] += t1 - t0
            clock["h2d_s"] += t2 - t1
            clock["predict_s"] += t3 - t2
            clock["readback_wait_s"] += time.perf_counter() - t3
            if progress:
                print(f"  {min(start + batch_size, len(fns))}/{len(fns)}")
    t0 = time.perf_counter()
    all_probs = [p.result() for p in pending]
    clock["readback_wait_s"] += time.perf_counter() - t0
    clock["total_s"] = time.perf_counter() - t_start
    if timings is not None:
        timings.update(clock)
    basenames = [os.path.basename(f) for f in fns]
    return basenames, (np.concatenate(all_probs, axis=0)
                       if all_probs else np.zeros((0, 0)))


def write_submission_csvs(prefix: str, basenames: Sequence[str],
                          probs: np.ndarray, int2label: Dict[int, str],
                          wanted_words: Optional[Sequence[str]] = None,
                          ) -> Dict[str, str]:
    """Write the three reference CSVs (make_submission.py:198-212).

    Returns {kind: path}. ``prefix`` is a path prefix without extension.
    """
    if wanted_words is None:
        wanted_words = prepare_words_list(get_classes(wanted_only=True))
    preds = probs.argmax(axis=-1)
    labels_all = [map_to_valid(int2label[int(p)]) for p in preds]
    labels_wanted = [map_to_wanted(l, list(wanted_words))
                     for l in labels_all]
    paths = {}

    paths["wanted"] = f"{prefix}.csv"
    with open(paths["wanted"], "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "label"])
        w.writerows(zip(basenames, labels_wanted))

    paths["all"] = f"{prefix}_all_labels.csv"
    with open(paths["all"], "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "label"])
        w.writerows(zip(basenames, labels_all))

    paths["probs"] = f"{prefix}_all_labels_probs.csv"
    with open(paths["probs"], "w", newline="") as f:
        w = csv.writer(f)
        class_names = [int2label[i] for i in range(probs.shape[1])]
        w.writerow(["fname", "label"] + class_names)
        for bn, lab, row in zip(basenames, labels_all, probs):
            w.writerow([bn, lab] + [repr(float(v)) for v in row])
    return paths


def to_audio_names_order(probs: np.ndarray,
                         int2label: Dict[int, str]) -> np.ndarray:
    """Reorder model-order [N, 12] probabilities into the AUDIO_NAMES
    order of the uint8 memmap.

    The 12-class model order follows the reference's wanted-word list
    ('stop down off right up go on yes left no', classes.py:7), which is
    not the exchange order of Heng's tools (AUDIO_NAMES,
    create_pseudo_with_thresh.py:10-11): only silence, unknown and 'on'
    coincide. A memmap written without this reorder permutes the labels
    of every consumer downstream (pseudo threshold, blending).
    """
    model_labels = [map_to_valid(int2label[i])
                    for i in range(probs.shape[1])]
    idx = [model_labels.index(name) for name in AUDIO_NAMES]
    return probs[:, idx]


def write_uint8_memmap(path: str, probs: np.ndarray) -> None:
    """Team probability exchange format: uint8 memmap of prob * 255
    (convert_from_see_v3_bugfix.py:107-110). Columns must already be in
    AUDIO_NAMES order: reorder model outputs with
    ``to_audio_names_order`` first."""
    mm = np.memmap(path, dtype="uint8", mode="w+", shape=probs.shape)
    mm[...] = (probs * 255).astype(np.uint8)
    mm.flush()


def read_uint8_memmap(path: str, num_rows: int,
                      num_classes: int = 12) -> np.ndarray:
    """Read back to float probabilities in [0, 1]
    (create_pseudo_with_thresh.py:15-18)."""
    mm = np.memmap(path, dtype="uint8", mode="r",
                   shape=(num_rows, num_classes))
    return np.asarray(mm, dtype=np.float32) / 255.0
