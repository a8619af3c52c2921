"""The arithmetic of the end-to-end metrics, apart from any device."""

from __future__ import annotations

import math
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank over every value: the
    smallest value that at least 95 % of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
