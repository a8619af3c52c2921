"""Deterministic dataset indexing and partitioning (port of
speech_recognition_tpu/data/index.py).

The reference's SHA1 filename-hash split (input_data.py:61-114) and index
construction (input_data.py:182-272): silence replication, unknown
subsampling and the seed-59185 shuffles, with Python's
``random.Random(seed)``, so that partitions, their order and their labels
are the JAX package's exactly. Pure Python and numpy.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import math
import os
import random
import re
from typing import Dict, List, Optional, Sequence

from speech_recognition_tpu_torch.labels import (
    BACKGROUND_NOISE_DIR_NAME,
    RANDOM_SEED,
    SILENCE_INDEX,
    SILENCE_LABEL,
    UNKNOWN_WORD_INDEX,
    build_word_to_index,
    prepare_words_list,
)

MAX_NUM_WAVS_PER_CLASS = 2 ** 27 - 1  # ~134M (input_data.py:40)

PARTITIONS = ("validation", "testing", "training", "pseudo")


def which_set(filename: str, validation_percentage: float,
              testing_percentage: float) -> str:
    """Stable partition assignment by SHA1 of the filename.

    Parity with input_data.py:61-114 including its special cases:
    files under an ``unknown_unknown/`` directory always train; files
    without ``_nohash_`` in the basename are pseudo-labeled; everything
    after ``_nohash_`` is ignored so a speaker's clips co-locate.
    """
    dir_name = os.path.basename(os.path.dirname(filename))
    if dir_name == "unknown_unknown":
        return "training"
    base_name = os.path.basename(filename)
    if "_nohash_" not in base_name:
        return "pseudo"
    hash_name = re.sub(r"_nohash_.*$", "", base_name)
    hash_hex = hashlib.sha1(hash_name.encode("utf-8")).hexdigest()
    percentage_hash = ((int(hash_hex, 16) % (MAX_NUM_WAVS_PER_CLASS + 1)) *
                       (100.0 / MAX_NUM_WAVS_PER_CLASS))
    if percentage_hash < validation_percentage:
        return "validation"
    if percentage_hash < testing_percentage + validation_percentage:
        return "testing"
    return "training"


@dataclasses.dataclass
class Example:
    label: str
    file: str


@dataclasses.dataclass
class DatasetIndex:
    """Partitioned example lists plus label maps.

    ``data_index`` mirrors the reference's ``AudioProcessor.data_index``;
    ``word_to_index`` maps every encountered word to its class index.
    """

    data_index: Dict[str, List[Example]]
    word_to_index: Dict[str, int]
    words_list: List[str]
    background_files: List[str]

    def set_size(self, mode: str) -> int:
        return len(self.data_index[mode])

    def labels_array(self, mode: str):
        import numpy as np
        return np.array(
            [self.word_to_index[e.label] for e in self.data_index[mode]],
            dtype=np.int32)

    def files(self, mode: str) -> List[str]:
        return [e.file for e in self.data_index[mode]]

    def is_silence_array(self, mode: str):
        import numpy as np
        return np.array(
            [e.label == SILENCE_LABEL for e in self.data_index[mode]],
            dtype=bool)

    def summary(self) -> str:
        """Label distribution per partition (input_data.py:591-610)."""
        lines = [f"There are {len(self.word_to_index)} classes.",
                 "1%% <-> %d samples in 'training'"
                 % (self.set_size("training") // 100)]
        header = "%-13s%-6s%-6s%-6s%-6s" % ("", "Train", "Val", "Test",
                                            "Pseudo")
        lines.append(header)
        order = ("training", "validation", "testing", "pseudo")
        counts = {p: {} for p in order}
        for p in order:
            total = max(1, self.set_size(p))
            for e in self.data_index[p]:
                counts[p][e.label] = counts[p].get(e.label, 0) + 100.0 / total
        for label in sorted(self.word_to_index, key=self.word_to_index.get):
            row = "%02d %-12s: " % (self.word_to_index[label], label)
            row += " ".join("%.1f%%" % counts[p].get(label, 0.0)
                            for p in order)
            lines.append(row)
        return "\n".join(lines)


def build_dataset_index(data_dirs: Sequence[str],
                        silence_percentage: float,
                        unknown_percentage: float,
                        wanted_words: Sequence[str],
                        validation_percentage: float,
                        testing_percentage: float,
                        seed: int = RANDOM_SEED,
                        file_lists: Optional[Dict[str, List[str]]] = None,
                        ) -> DatasetIndex:
    """Build the partitioned index (parity: input_data.py:182-272).

    Files are globbed as ``<dir>/*/*.wav`` (sorted for reproducibility —
    the reference relies on filesystem glob order), hashed into partitions,
    silence entries are replicated to ``silence_percentage`` of each
    partition, and a seeded shuffle subsamples unknowns to
    ``unknown_percentage``.

    Args:
      file_lists: optional {data_dir: [wav paths]} override for tests.
    """
    rng = random.Random(seed)
    wanted_words_index = {w: i + 2 for i, w in enumerate(wanted_words)}
    data_index: Dict[str, List[Example]] = {p: [] for p in PARTITIONS}
    unknown_index: Dict[str, List[Example]] = {p: [] for p in PARTITIONS}
    all_words: Dict[str, bool] = {}

    for data_dir in data_dirs:
        if file_lists is not None and data_dir in file_lists:
            wav_paths = list(file_lists[data_dir])
        else:
            wav_paths = sorted(
                glob.glob(os.path.join(data_dir, "*", "*.wav")))
        for wav_path in wav_paths:
            m = re.search(r".*/([^/]+)/.*\.wav", wav_path)
            if not m:
                continue
            word = m.group(1).lower()
            if word == BACKGROUND_NOISE_DIR_NAME:
                continue
            all_words[word] = True
            set_index = which_set(wav_path, validation_percentage,
                                  testing_percentage)
            entry = Example(label=word, file=wav_path)
            if word in wanted_words_index:
                data_index[set_index].append(entry)
            else:
                unknown_index[set_index].append(entry)
        if not all_words:
            raise ValueError("No .wavs found in " + data_dir)
        for wanted in wanted_words:
            if wanted not in all_words:
                raise ValueError(
                    f"Expected to find {wanted} in labels but only found "
                    + ", ".join(sorted(all_words)))

    if not data_index["training"]:
        raise ValueError("no training files found")
    # Arbitrary file used for silence entries; its audio is muted by the
    # augmentation policy (input_data.py:244-254).
    silence_wav_path = data_index["training"][0].file
    for set_index in PARTITIONS:
        set_size = len(data_index[set_index])
        silence_size = int(math.ceil(set_size * silence_percentage / 100))
        for _ in range(silence_size):
            data_index[set_index].append(
                Example(label=SILENCE_LABEL, file=silence_wav_path))
        rng.shuffle(unknown_index[set_index])
        unknown_size = int(math.ceil(set_size * unknown_percentage / 100))
        data_index[set_index].extend(unknown_index[set_index][:unknown_size])
    for set_index in PARTITIONS:
        rng.shuffle(data_index[set_index])

    words_list = prepare_words_list(list(wanted_words))
    word_to_index = build_word_to_index(list(all_words), list(wanted_words))
    assert word_to_index[SILENCE_LABEL] == SILENCE_INDEX
    assert UNKNOWN_WORD_INDEX == 1

    background_files = sorted(glob.glob(
        os.path.join(data_dirs[0], BACKGROUND_NOISE_DIR_NAME, "*.wav")))
    return DatasetIndex(
        data_index=data_index,
        word_to_index=word_to_index,
        words_list=words_list,
        background_files=background_files,
    )
