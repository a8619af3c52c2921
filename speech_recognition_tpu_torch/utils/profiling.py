"""Tracing and profiling (port of speech_recognition_tpu/utils/profiling.py).

``trace_context`` captures a ``torch.profiler`` trace of the enclosed
block (the card's kernels, copies and memsets by CUPTI, and the host's
operators) into a Chrome trace, ``<log_dir>/<host>.<pid>.<ns>.pt.trace.
json.gz``, which Perfetto or ``chrome://tracing`` open. ``summarize_trace``
reads the newest such file back into device time: the union of the
device's busy intervals, the time per kernel and per class of operation,
and the largest kernels with the operator that launched each, under the
JAX summary's keys. It is the port's one parser of device time: the
traced timings of ``export/benchmark.py`` use it too. ``StepTimer`` is a
host clock of steps.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import socket
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

# Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel name -> class of operation, first match wins
OP_CLASSES = (
    ("decode_augment", re.compile(r"decode_augment", re.I)),
    ("separable_block", re.compile(r"separable|ddw_dx|dwpw", re.I)),
    ("convolution", re.compile(r"conv|cudnn|implicit|winograd|fft", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|xmma|cublas|sm\d+_", re.I)),
    ("normalization", re.compile(r"norm|welford", re.I)),
    ("reduction", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


@contextlib.contextmanager
def trace_context(log_dir: str) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace of the enclosed block into a
    Chrome trace under ``log_dir``; yields the profiler.

    The block's device work is waited for before the capture closes, so
    every kernel it launched lands inside it::

        with trace_context("traces/step100"):
            trainer.train_step(state)
        summary = summarize_trace("traces/step100", num_steps=1)
    """
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}."
                 f"{time.time_ns()}.pt.trace.json.gz"))


def op_class(name: str, category: str = "kernel") -> str:
    """The class of operation of a device activity: ``copy`` and
    ``memset`` by category, a kernel by its name (``OP_CLASSES``), else
    ``other``."""
    if category == "gpu_memcpy":
        return "copy"
    if category == "gpu_memset":
        return "memset"
    for cls, pattern in OP_CLASSES:
        if pattern.search(name):
            return cls
    return "other"


def read_trace(path: str) -> List[Dict[str, Any]]:
    """The ``traceEvents`` of a Chrome trace, ``.json`` or ``.json.gz``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


# trace_context's file name: <host>.<pid>.<ns>.pt.trace.json.gz (a host
# name may hold dots)
_TRACE_NAME = re.compile(r"\.\d+\.(\d+)\.pt\.trace\.json(\.gz)?$")


def _written_ns(path: str) -> int:
    """When a trace was written, in ns since the epoch: the time in
    ``trace_context``'s file name, else the file's mtime."""
    m = _TRACE_NAME.search(os.path.basename(path))
    return int(m.group(1)) if m else os.stat(path).st_mtime_ns


def summarize_trace(log_dir: str, num_steps: Optional[int] = None) -> Dict:
    """Device time in the newest ``trace_context`` capture under
    ``log_dir`` (or in the trace file ``log_dir`` itself).

    The device's activities are the trace's complete events of the
    categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``. Returns the
    JAX summary's keys::

        {"modules": {kernel: {"total_ms", "count", "ms_per_exec"}},
         "ops": {op class: total_ms}, "detail": [the 15 largest kernels:
         {"op", "total_ms", "source", "category", "flops"}],
         "device_busy_ms": the union of the activities' intervals,
         "ms_per_step": device_busy_ms / num_steps (if num_steps given)}

    A kernel stands where the JAX summary has an XLA module (the unit
    the device runs); ``source`` is the host operator that launched it
    (matched by the trace's ``External id``), ``category`` its op class
    (``op_class``), ``flops`` empty (the trace counts none). Besides:
    ``activities`` (their number) and ``memcpy_htod_ms`` (host-to-device
    copies).
    """
    if os.path.isfile(log_dir):
        path = log_dir
    else:
        paths = glob.glob(os.path.join(log_dir, "**", "*.trace.json*"),
                          recursive=True)
        if not paths:
            raise FileNotFoundError(f"no Chrome trace under {log_dir}")
        path = max(paths, key=_written_ns)
    events = read_trace(path)
    launched_by = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                launched_by.setdefault(ext, e["name"])
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    busy_us, end = 0.0, float("-inf")
    total = collections.Counter()
    count = collections.Counter()
    ops = collections.Counter()
    meta: Dict[str, Dict[str, str]] = {}
    htod_us = 0.0
    for start, stop, e in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        name, dur = e["name"], stop - start
        total[name] += dur
        count[name] += 1
        cls = op_class(name, e["cat"])
        ops[cls] += dur
        if "HtoD" in name:
            htod_us += dur
        if name not in meta:
            meta[name] = {"source": launched_by.get(
                e.get("args", {}).get("External id"), ""),
                "category": cls, "flops": ""}
    out = {
        "modules": {n: {"total_ms": us / 1e3, "count": count[n],
                        "ms_per_exec": us / 1e3 / count[n]}
                    for n, us in total.items()},
        "ops": {k: v / 1e3 for k, v in ops.most_common(20)},
        "detail": [dict(op=n, total_ms=us / 1e3, **meta[n])
                   for n, us in total.most_common(15)],
        "device_busy_ms": busy_us / 1e3,
        "activities": len(spans),
        "memcpy_htod_ms": htod_us / 1e3,
    }
    if num_steps:
        out["ms_per_step"] = out["device_busy_ms"] / num_steps
    return out


class StepTimer:
    """Rolling step timing on the host clock -> clips/s, and clips/s per
    card (the global batch over the ranks of the process group, one card
    each)."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        return {
            "ms_per_step": 1000.0 * mean,
            "clips_per_sec": self.batch_size / mean,
            "clips_per_sec_per_chip": self.batch_size / mean / ranks,
        }
