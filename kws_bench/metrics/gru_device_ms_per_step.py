"""Model forward and backward, BiGRU: the card's ms a step in the
program's device spans ``gru.forward`` and ``gru.backward`` (CUDA
events around the BiGRU's forward and its backward, which a replayed
CUDA graph records too), summed within a step, median over the window
tail's unprofiled ``train.step`` records that have both. None outside a
training cell, and where the program records no such reading (a model
without a GRU, or a program without device spans).
"""

from __future__ import annotations

import collections
import statistics
from typing import Any, Dict, List, Optional

from kws_bench.metrics._spans import TAIL, records

NAMES = ("gru.forward", "gru.backward")


def per_step(layers: Dict[str, Any], recs: List[Any]) -> Optional[float]:
    """The median over the last ``min(steps, TAIL)`` unprofiled
    ``train.step`` records of ``recs`` of the step's ``NAMES`` readings'
    ``device_ms``, summed; only steps with a reading of each name."""
    if layers.get("kind") != "train":
        return None
    n = min(layers["steps"], TAIL)
    steps = [r.step for r in recs if r.name == "train.step"
             and not r.profiled]
    if n <= 0 or not steps:
        return None
    window = set(steps[-n:])
    got: Dict[Any, Dict[str, float]] = collections.defaultdict(dict)
    for r in recs:
        if r.name in NAMES and not r.profiled and r.step in window \
                and hasattr(r, "device_ms"):
            got[r.step][r.name] = got[r.step].get(r.name, 0.0) + r.device_ms
    sums = [sum(v.values()) for v in got.values() if len(v) == len(NAMES)]
    return statistics.median(sums) if sums else None


def read(layers):
    return per_step(layers, records())
