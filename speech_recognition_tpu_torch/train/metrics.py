"""Validation metrics (port of speech_recognition_tpu/train/metrics.py).

Confusion matrices accumulate on the device (scatter-add) and render to
the same two text reports the reference writes (``confusion_matrix.txt``
for all words, ``wanted_confusion_matrix.txt`` for the wanted-collapsed
view, callbacks.py:45-83), and ``TensorBoardCallback`` writes each
epoch's numeric metrics to a TensorBoard event file through the port's
copy of the pure-Python event writer (``utils/tb_events.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch


def log_loss_from_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy from logits (the reference computes it from
    clipped probabilities, callbacks.py:6-10; from logits it is exact)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


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


def per_class_accuracies(conf: np.ndarray) -> np.ndarray:
    """Row-normalised diagonal; empty rows count 0 (callbacks.py:27-37)."""
    sums = conf.sum(axis=1)
    accs = np.where(sums > 0, np.diag(conf) / np.maximum(sums, 1), 0.0)
    return accs.astype(np.float32)


def accuracy(conf: np.ndarray) -> float:
    return float(np.trace(conf)) / max(1, int(conf.sum()))


def collapse_to_wanted(conf: np.ndarray, int2label: Dict[int, str],
                       wanted_words: Sequence[str]) -> np.ndarray:
    """Merge all non-wanted classes into ``_unknown_`` (callbacks.py:63-65).

    Returns a confusion matrix over ``wanted_words``' order (_silence_,
    _unknown_, wanted...).
    """
    kept_index = {w: i for i, w in enumerate(wanted_words)}
    remap = [kept_index.get(int2label[i], kept_index["_unknown_"])
             for i in range(conf.shape[0])]
    out = np.zeros((len(kept_index), len(kept_index)), dtype=conf.dtype)
    np.add.at(out, (np.array(remap)[:, None], np.array(remap)[None, :]),
              conf)
    return out


def render_confusion(conf: np.ndarray, names: List[str]) -> str:
    """Plain-text table comparable to pandas_ml's output."""
    width = max(8, max(len(n) for n in names) + 1)
    header = " " * width + "".join(f"{n:>{width}}" for n in names)
    lines = [header]
    for i, n in enumerate(names):
        row = f"{n:<{width}}" + "".join(
            f"{int(conf[i, j]):>{width}d}" for j in range(len(names)))
        lines.append(row)
    return "\n".join(lines)


class TensorBoardCallback:
    """Writes every finite numeric epoch metric to a TensorBoard event
    file in ``logdir`` (the reference's TensorBoard callback,
    train.py:64), one event per epoch, its step the epoch, as Keras
    writes its per-epoch scalars."""

    def __init__(self, logdir: str):
        from speech_recognition_tpu_torch.utils.tb_events import (
            TBEventWriter,
        )
        self.writer = TBEventWriter(logdir)

    def on_epoch_end(self, epoch, state, logs):
        scalars = {k: float(v) for k, v in logs.items()
                   if isinstance(v, (int, float)) and np.isfinite(v)}
        self.writer.add_scalars(epoch, scalars)
        self.writer.flush()
        return None

    def close(self):
        self.writer.close()


class ConfusionReport:
    """Per-epoch validation report writer (parity: ConfusionMatrixCallback
    callbacks.py:13-83). Call ``write(epoch, conf, val_loss)`` after each
    validation sweep; the metric dict it returns feeds checkpointing and
    ReduceLROnPlateau as the reference's logs injection does
    (callbacks.py:80-83)."""

    def __init__(self, int2label: Dict[int, str],
                 wanted_words: Sequence[str],
                 all_words: Sequence[str],
                 out_dir: str = "."):
        self.int2label = dict(int2label)
        self.wanted_words = list(wanted_words)
        self.all_words = list(all_words)
        self.all_path = os.path.join(out_dir, "confusion_matrix.txt")
        self.wanted_path = os.path.join(out_dir,
                                        "wanted_confusion_matrix.txt")
        for p in (self.all_path, self.wanted_path):
            open(p, "w").close()

    def write(self, epoch: int, conf: np.ndarray,
              val_loss: float) -> Dict[str, float]:
        accs = per_class_accuracies(conf)
        acc = accuracy(conf)
        wanted_conf = collapse_to_wanted(conf, self.int2label,
                                         self.wanted_words)
        wanted_accs = per_class_accuracies(wanted_conf)
        acc_line = ("\n[%03d]: val_categorical_accuracy: %.2f, "
                    "val_mean_categorical_accuracy_wanted: %.2f"
                    % (epoch, acc, wanted_accs.mean()))
        names = [self.int2label[i] for i in range(conf.shape[0])]
        with open(self.all_path, "a") as f:
            f.write(acc_line + "\n")
            f.write(render_confusion(conf, names))
        with open(self.wanted_path, "a") as f:
            f.write(acc_line + "\n")
            f.write(render_confusion(wanted_conf, self.wanted_words))
        return {
            "val_loss": float(val_loss),
            "val_categorical_accuracy": float(acc),
            "val_mean_categorical_accuracy_all": float(accs.mean()),
            "val_mean_categorical_accuracy_wanted": float(wanted_accs.mean()),
        }
