"""32-class -> 12-class probability conversion for team ensembling
(port of speech_recognition_tpu/tools/convert.py; parity:
convert_from_see_v3_bugfix.py:61-110).

Maps an all-labels probability CSV (this framework's or the reference's
column order: _silence_, _unknown_, 30 known words) into Heng's 12-class
AUDIO_NAMES order, with unknown = max over all unknown-class
probabilities (NOT the sum — freeze_graph_32_classes.py:53-54 documents
the same deliberate choice), followed by a softmax renormalization, and
writes the uint8 memmap exchange format.
"""

from __future__ import annotations

import csv
from typing import List, Sequence, Tuple

import numpy as np

from speech_recognition_tpu_torch.infer.submission import (
    AUDIO_NAMES, write_uint8_memmap,
)
from speech_recognition_tpu_torch.labels import (
    SILENCE_LABEL, get_int2label, prepare_words_list,
)


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def read_probs_csv(path: str, class_names: Sequence[str],
                   ) -> Tuple[List[str], np.ndarray]:
    """Read an all-labels-probs CSV (fname, label, <class columns>)."""
    fnames, rows = [], []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            fnames.append(row["fname"])
            rows.append([float(row[c]) for c in class_names])
    return fnames, np.asarray(rows, dtype=np.float32)


def convert_32_to_12(all_probs: np.ndarray,
                     wanted_only: bool = False,
                     extend_reversed: bool = False) -> np.ndarray:
    """[N, 32/49] probs in words-list order -> [N, 12] in AUDIO_NAMES order.

    unknown = max over every non-wanted class (incl. ``_unknown_``),
    then a softmax renorm (convert_from_see_v3_bugfix.py:99-100).
    """
    int2label = get_int2label(wanted_only=wanted_only,
                              extend_reversed=extend_reversed)
    out = np.zeros((all_probs.shape[0], len(AUDIO_NAMES)), np.float32)
    unknown_cols = []
    for i, name in int2label.items():
        if name == SILENCE_LABEL:
            out[:, 0] = all_probs[:, i]
        elif name in AUDIO_NAMES:
            out[:, AUDIO_NAMES.index(name)] = all_probs[:, i]
        else:
            unknown_cols.append(all_probs[:, i])
    out[:, 1] = np.stack(unknown_cols, axis=0).max(axis=0)
    return softmax(out)


def convert_probs_csv_to_memmap(probs_csv: str, memmap_path: str,
                                wanted_only: bool = False,
                                extend_reversed: bool = False,
                                ) -> Tuple[List[str], np.ndarray]:
    """End-to-end: read probs CSV, map to 12 classes, write memmap."""
    from speech_recognition_tpu_torch.labels import get_classes
    names = prepare_words_list(get_classes(
        wanted_only=wanted_only, extend_reversed=extend_reversed))
    fnames, probs = read_probs_csv(probs_csv, names)
    mapped = convert_32_to_12(probs, wanted_only=wanted_only,
                              extend_reversed=extend_reversed)
    write_uint8_memmap(memmap_path, mapped)
    return fnames, mapped
