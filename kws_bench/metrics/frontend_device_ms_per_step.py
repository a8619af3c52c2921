"""Data path, frontend: the card's ms a step in the program's device span
``frontend.forward`` (CUDA events around the feature frontend of a model
that takes features, which a replayed CUDA graph records too), median
over the window tail's unprofiled ``train.step`` records that have a
reading. None outside a training cell, and where the program records no
such reading (a raw model, or a program without the span).
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

from kws_bench.metrics._spans import TAIL, records

NAME = "frontend.forward"


def per_step(layers: Dict[str, Any], recs: List[Any]) -> Optional[float]:
    """The median over the last ``min(steps, TAIL)`` unprofiled
    ``train.step`` records of ``recs`` of the step's ``NAME`` readings'
    ``device_ms``, summed; only steps with a reading."""
    if layers.get("kind") != "train":
        return None
    n = min(layers["steps"], TAIL)
    steps = [r.step for r in recs if r.name == "train.step"
             and not r.profiled]
    if n <= 0 or not steps:
        return None
    window = set(steps[-n:])
    got: Dict[Any, float] = {}
    for r in recs:
        if r.name == NAME and not r.profiled and r.step in window \
                and hasattr(r, "device_ms"):
            got[r.step] = got.get(r.step, 0.0) + r.device_ms
    return statistics.median(got.values()) if got else None


def read(layers):
    return per_step(layers, records())
