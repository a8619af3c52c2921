"""Device time from a ``torch.profiler`` capture (a frozen copy of the
port's ``utils/profiling.py::trace_context`` and ``summarize_trace``,
kept here so that a change to the program cannot change how the
benchmark reads a trace), and the longest idle gaps of the device by
what the host was doing meanwhile."""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import re
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel name -> class of operation, first match wins (BatchNorm's cuDNN
# kernels carry "bn_" and "cudnn", so normalization comes first)
OP_CLASSES = (
    ("decode_augment", re.compile(r"decode_augment", re.I)),
    ("normalization", re.compile(r"norm|welford|bn_fw|bn_bw", re.I)),
    ("convolution", re.compile(r"conv|cudnn|implicit|winograd|fft", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|xmma|cublas|sm\d+_", re.I)),
    ("reduction", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def op_class(name: str, category: str = "kernel") -> str:
    if category == "gpu_memcpy":
        return "copy"
    if category == "gpu_memset":
        return "memset"
    for cls, pattern in OP_CLASSES:
        if pattern.search(name):
            return cls
    return "other"


def capture(fn: Callable[[], Any], path: str) -> Tuple[Any, float]:
    """Run ``fn`` under ``torch.profiler`` (host and card), wait for the
    card, write the Chrome trace to ``path``; returns (fn's result, the
    host seconds of the capture)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return out, window


def read_events(path: str) -> List[Dict[str, Any]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Device time of a capture's events: ``busy_s`` (the union of the
    device activities' intervals), ``activities`` (their number),
    ``kernels`` {name: (seconds, count)}, ``ops`` {op class: seconds},
    ``htod_s`` (host-to-device copies) and ``idle_gaps`` [(host op,
    seconds)]: the gaps between device activities, each put down to the
    outermost host operator running at its middle (or ``no host
    operator`` where none was), summed by that name, largest first."""
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    busy_us, end = 0.0, float("-inf")
    kernels: Dict[str, List[float]] = {}
    ops: collections.Counter = collections.Counter()
    htod_us = 0.0
    gaps: List[Tuple[float, float]] = []
    for start, stop, e in spans:
        if end > float("-inf") and start > end:
            gaps.append((end, start))
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        dur = stop - start
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += dur
        k[1] += 1
        ops[op_class(e["name"], e["cat"])] += dur
        if "HtoD" in e["name"]:
            htod_us += dur
    return {
        "busy_s": busy_us / 1e6,
        "activities": len(spans),
        "kernels": {n: (us / 1e6, c) for n, (us, c) in kernels.items()},
        "ops": {k: v / 1e6 for k, v in ops.items()},
        "htod_s": htod_us / 1e6,
        "idle_gaps": _gaps_by_host_op(events, gaps),
    }


def _gaps_by_host_op(events, gaps) -> List[Tuple[str, float]]:
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in (
                      "cpu_op", "python_function", "user_annotation"))
    outer: List[Tuple[float, float, str]] = []   # outermost host spans
    for start, stop, name in host:
        if outer and start < outer[-1][1]:
            continue
        outer.append((start, stop, name))
    starts = [s for s, _, _ in outer]
    by_name: collections.Counter = collections.Counter()
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = (outer[i][2] if i >= 0 and outer[i][1] >= mid
                else "no host operator")
        by_name[name] += (b - a) / 1e6
    return by_name.most_common()


def short(name: str) -> str:
    """A kernel's name without its parameter list and template
    arguments: ``void at::native::f<float, 4>(...)`` -> ``at::native::f``."""
    base = re.sub(r"<[^<>]*>", "", name.replace("(anonymous namespace)::",
                                                ""))
    while base != (base := re.sub(r"<[^<>]*>", "", base)):
        pass
    base = base.split("(")[0].split("<")[0].strip()
    if base.startswith("void "):
        base = base[5:]
    return base or name[:120]


def top(items: Dict[str, float], n: int = 10) -> List[List[Any]]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])
            [:n]]


def breakdown(summary: Dict[str, Any]) -> Dict[str, List[List[Any]]]:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten longest idle gaps by host operator."""
    by_short: collections.Counter = collections.Counter()
    for n, (s, _) in summary["kernels"].items():
        by_short[short(n)] += s
    return {"device_ops": top(by_short),
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"][:10]]}
