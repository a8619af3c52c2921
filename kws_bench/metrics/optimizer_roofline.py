"""Optimizer update: the least time the update's bytes allow (at
3.35 TB/s) over the card's ms a step in the program's
``optimizer.step`` device span (``optimizer_device_ms_per_step``), in
%. The bytes follow from the configuration's optimizer and parameter
count alone, not from how the program computes the update, so no
update can read above 100 %. None where the span has no reading.
"""

from __future__ import annotations

from typing import Any, Dict

from kws_bench import harness
from kws_bench.metrics import optimizer_device_ms_per_step
from kws_bench.peaks import HBM_BYTES_PER_S


def bytes_per_parameter(cfg: Dict[str, Any]) -> int:
    """Bytes one float32 master parameter's update must move: its value,
    gradient and each state read once, its value and each state written
    once. Adam keeps two states (m, v): 28; RMSprop one (its
    accumulator) and SGD with momentum one (its buffer): 20; SGD
    without momentum none: 12."""
    if cfg["optimizer"] == "adam":
        states = 2
    elif cfg["optimizer"] == "rmsprop" or cfg.get("momentum", 0.0) > 0.0:
        states = 1
    else:
        states = 0
    return 4 * (3 + 2 * states)


def optimizer_bytes(cfg: Dict[str, Any]) -> int:
    """Bytes the configuration's update must move a step."""
    return cfg["parameters"] * bytes_per_parameter(cfg)


def read(layers):
    ms = optimizer_device_ms_per_step.read(layers)
    if not ms:
        return None
    cfg = harness.load_config(harness.find_cell(
        harness.load_spec(), layers["cell"])["config"])
    return 100.0 * optimizer_bytes(cfg) / HBM_BYTES_PER_S / (ms / 1e3)
