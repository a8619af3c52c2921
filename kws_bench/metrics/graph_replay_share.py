"""Host dispatch: the share (%) of the window tail's unprofiled
``train.step`` records that hold a ``train.replay`` record, the steps
the program ran as one replay of its captured CUDA graph. None outside a
training cell, and where the program never tried a capture (no
``train.capture`` span in the process, as in a program without the
graph step); a capture that failed leaves its steps eager and reads 0.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from kws_bench.metrics._spans import TAIL, first, records


def share(layers: Dict[str, Any], recs: List[Any],
          captured: bool) -> Optional[float]:
    """The share over the last ``min(steps, TAIL)`` unprofiled
    ``train.step`` records of ``recs``; ``captured``: whether the
    process recorded a ``train.capture`` span."""
    if layers.get("kind") != "train" or not captured:
        return None
    n = min(layers["steps"], TAIL)
    steps = [r for r in recs if r.name == "train.step" and not r.profiled]
    if n <= 0 or not steps:
        return None
    steps = steps[-n:]
    held = {id(r.parent) for r in recs if r.name == "train.replay"}
    return 100.0 * sum(id(r) in held for r in steps) / len(steps)


def read(layers):
    return share(layers, records(), first("train.capture") is not None)
