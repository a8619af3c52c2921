"""Data path, frontend: the least time the frontend's bytes allow (the
batch's waveform read once and its MFCCs written once, both float32, at
3.35 TB/s) over the card's ms a step in the program's
``frontend.forward`` device span (``frontend_device_ms_per_step``), in
%. The bytes follow from the cell's configuration alone, not from how
the program computes the features, so no frontend can read above 100 %.
None where the span has no reading.
"""

from __future__ import annotations

from typing import Any, Dict

from kws_bench import harness
from kws_bench.metrics import frontend_device_ms_per_step
from kws_bench.peaks import HBM_BYTES_PER_S


def frontend_bytes(cfg: Dict[str, Any], batch: int) -> int:
    """Bytes the configuration's frontend must move for ``batch`` clips:
    each float32 sample read once, each float32 MFCC (frames x
    ``num_log_mel_features``; frames of the VALID window and stride
    over the clip) written once."""
    s = cfg["model_settings"]
    rate, samples = cfg["sample_rate"], cfg["clip_samples"]
    window = int(rate * s["window_size_ms"] / 1000)
    stride = int(rate * s["window_stride_ms"] / 1000)
    frames = 1 + (samples - window) // stride
    return 4 * batch * (samples + frames * s["num_log_mel_features"])


def read(layers):
    ms = frontend_device_ms_per_step.read(layers)
    if not ms:
        return None
    cfg = harness.load_config(harness.find_cell(
        harness.load_spec(), layers["cell"])["config"])
    return 100.0 * frontend_bytes(cfg, layers["batch"]) / HBM_BYTES_PER_S \
        / (ms / 1e3)
