"""What the readers of the program's spans share: the program's span
records, read in the process that ran the window (the reference records
none), and the selection of the window's tail.

A step's records are the program's ``train.step`` span and the phases'
spans inside it, which carry its step id. Steps that a ``torch.profiler``
capture recorded are flagged ``profiled`` and left out: the readers take
the last ``TAIL`` unprofiled steps (at most the window's), sum each
phase's records in each, and report the median. A program that records
no spans gives nothing to read, and each reader returns None.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

# steps of the window's tail that the readers take
TAIL = 256


def records() -> List[Any]:
    """The program's span ring, oldest first (empty where the program
    has no recorder)."""
    try:
        from speech_recognition_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def first(name: str) -> Optional[Any]:
    """The process's first span named ``name``, or None."""
    try:
        from speech_recognition_tpu_torch.utils.profiling import first as f
    except ImportError:
        return None
    return f(name)


def phase_ms(layers: Dict[str, Any], name: str,
             recs: Optional[List[Any]] = None) -> Optional[float]:
    """The median over the window's last ``min(steps, TAIL)`` unprofiled
    ``train.step`` records of ``name``'s host ms a step: the step's own
    duration for ``train.step``, else the sum of the step's records of
    ``name``. None outside a training cell, or where there is none."""
    if layers.get("kind") != "train":
        return None
    recs = records() if recs is None else recs
    n = min(layers["steps"], TAIL)
    steps = [r for r in recs if r.name == "train.step" and not r.profiled]
    if n <= 0 or not steps:
        return None
    per = {r.step: r.end_ns - r.start_ns for r in steps[-n:]}
    if name != "train.step":
        per = dict.fromkeys(per, 0)
        phase = [r for r in recs
                 if r.name == name and r.step in per and not r.profiled]
        if not phase:
            return None
        for r in phase:
            per[r.step] += r.end_ns - r.start_ns
    return statistics.median(per.values()) / 1e6


def first_s(layers: Dict[str, Any], name: str,
            rec: Optional[Any] = None) -> Optional[float]:
    """The seconds of the process's first span named ``name``; None
    outside a training cell, or where there is none."""
    if layers.get("kind") != "train":
        return None
    rec = first(name) if rec is None else rec
    return None if rec is None else (rec.end_ns - rec.start_ns) / 1e9
