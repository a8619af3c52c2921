"""Label and class-space catalogs (port of speech_recognition_tpu/labels.py).

A copy of the JAX package's module, which imports no jax itself but
cannot be imported without running ``speech_recognition_tpu/__init__.py``
(which does). The fixed special tokens ``_silence_`` (index 0) and
``_unknown_`` (index 1) are prepended to a task-specific word list
(reference classes.py:5-41, input_data.py:41-58); catalogs exist for the
12-class (10 wanted words), 32-class (30 known words) and 49-class
(30 + 17 reversed pseudo-words) variants.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

SILENCE_LABEL = "_silence_"
SILENCE_INDEX = 0
UNKNOWN_WORD_LABEL = "_unknown_"
UNKNOWN_WORD_INDEX = 1
BACKGROUND_NOISE_DIR_NAME = "_background_noise_"

# Deterministic seed used for dataset-index shuffling (reference
# input_data.py:46).
RANDOM_SEED = 59185

_WANTED_WORDS = "stop down off right up go on yes left no".split()

_KNOWN_WORDS = (
    "sheila nine stop bed four six down bird marvin cat off right seven "
    "eight up three happy go zero on wow dog yes five one tree house two "
    "left no"
).split()

# Reversed-audio pseudo-classes for the 49-class experiment
# (reference classes.py:16-20).
_REVERSED_WORDS = [
    "new_owt", "new_yppah", "new_xis", "new_esuoh",
    "new_neves", "new_thgie", "new_ruof", "new_tac",
    "new_nivram", "new_enin", "new_aliehs", "new_eert",
    "new_orez", "new_eerht", "new_evif", "new_deb",
    "new_drib",
]


def prepare_words_list(wanted_words: List[str]) -> List[str]:
    """Prepend the standard silence and unknown tokens (input_data.py:49-58)."""
    return [SILENCE_LABEL, UNKNOWN_WORD_LABEL] + list(wanted_words)


def get_classes(wanted_only: bool = False,
                extend_reversed: bool = False) -> List[str]:
    """Return the word catalog for a task variant (classes.py:5-23).

    Args:
      wanted_only: 10 competition words only (12-class task).
      extend_reversed: append the 17 reversed pseudo-words (49-class task);
        only valid with ``wanted_only=False``.
    """
    if wanted_only:
        if extend_reversed:
            raise ValueError("extend_reversed requires wanted_only=False")
        classes = list(_WANTED_WORDS)
        assert len(classes) == 10
        return classes
    classes = list(_KNOWN_WORDS)
    assert len(classes) == 30
    if extend_reversed:
        assert len(_REVERSED_WORDS) == 17
        classes = classes + list(_REVERSED_WORDS)
    return classes


def get_int2label(wanted_only: bool = False,
                  extend_reversed: bool = False) -> "OrderedDict[int, str]":
    """Index -> label map incl. the two special tokens (classes.py:26-32)."""
    words = prepare_words_list(
        get_classes(wanted_only=wanted_only, extend_reversed=extend_reversed))
    return OrderedDict((i, w) for i, w in enumerate(words))


def get_label2int(wanted_only: bool = False,
                  extend_reversed: bool = False) -> "OrderedDict[str, int]":
    """Label -> index map incl. the two special tokens (classes.py:35-41)."""
    words = prepare_words_list(
        get_classes(wanted_only=wanted_only, extend_reversed=extend_reversed))
    return OrderedDict((w, i) for i, w in enumerate(words))


def map_to_valid(label: str) -> str:
    """Map internal special tokens to submission names (make_submission.py:16-23)."""
    if label == SILENCE_LABEL:
        return "silence"
    if label == UNKNOWN_WORD_LABEL:
        return "unknown"
    return label


def map_to_wanted(label: str, wanted_words: List[str]) -> str:
    """Collapse non-wanted words to 'unknown' (make_submission.py:26-31)."""
    if label in wanted_words or label == "silence":
        return label
    return "unknown"


def build_word_to_index(all_words: List[str],
                        wanted_words: List[str]) -> Dict[str, int]:
    """Map every dataset word to its class index.

    Wanted words get indices 2..N+1 in catalog order; everything else maps
    to the unknown index; silence maps to 0 (input_data.py:264-272).
    """
    wanted_index = {w: i + 2 for i, w in enumerate(wanted_words)}
    word_to_index = {}
    for word in all_words:
        word_to_index[word] = wanted_index.get(word, UNKNOWN_WORD_INDEX)
    word_to_index[SILENCE_LABEL] = SILENCE_INDEX
    return word_to_index
