"""Tracing and profiling (port of speech_recognition_tpu/utils/profiling.py).

``span`` records a named interval of the host's clock into a bounded
in-memory ring (``spans``, ``clear``; the first record of each name also
stays for the life of the process, ``first``). The train step opens one
at each of its phases (``train/loop.py``), or, replayed as a CUDA graph,
``train.replay`` alone. While a ``torch.profiler``
capture records, a span that is a profiler range also enters
``torch.profiler.record_function``, which puts it on the capture's
timeline beside the card's kernels; outside a capture it never does.

``device_spans`` times a part of the step on the card's clock instead,
forward and backward, by CUDA timing events that a CUDA graph's capture
keeps as nodes, so that every replay times it again; each reading joins
the ring as a ``reading`` once its events have completed.
``device_span`` does the same for the block it encloses.

``trace_context`` captures a ``torch.profiler`` trace of the enclosed
block (the card's kernels, copies and memsets by CUPTI, and the host's
operators) into a Chrome trace, ``<log_dir>/<host>.<pid>.<ns>.pt.trace.
json.gz``, which Perfetto or ``chrome://tracing`` open. ``summarize_trace``
reads the newest such file back into device time: the union of the
device's busy intervals, the time per kernel and per class of operation,
the largest kernels with the operator that launched each, under the JAX
summary's keys, and the device's busy and idle time under each profiler
range. It is the port's one parser of device time: the traced timings of
``export/benchmark.py`` use it too.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import gzip
import json
import os
import re
import socket
import statistics
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from speech_recognition_tpu_torch.ops.kernels.launch import capturing

# Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel name -> class of operation, first match wins
OP_CLASSES = (
    ("decode_augment", re.compile(r"decode_augment", re.I)),
    ("separable_block", re.compile(r"separable|ddw_dx|dwpw", re.I)),
    ("convolution", re.compile(r"conv|cudnn|implicit|winograd|fft", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|xmma|cublas|sm\d+_", re.I)),
    ("normalization", re.compile(r"norm|welford|bn_fw|bn_bw", re.I)),
    ("reduction", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


# records the span ring holds: a 10 s window of the flagship's steps, at
# 8 records a step, passes about 6,000 through it
RING_SPANS = 4096

_ring: "collections.deque[span]" = collections.deque(maxlen=RING_SPANS)
_first: Dict[str, "span"] = {}
_open: Optional["span"] = None     # the innermost open span
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class span:
    """A named interval of the host's clock, recorded when it closes::

        with span("train.step", state.step, profiler_range=False):
            with span("train.forward"):
                ...

    The closed span is its own record: ``name``; ``step``, the step id
    given, else its parent's; ``parent``, the span open around it (None
    at the top); ``start_ns`` and ``end_ns`` from
    ``time.perf_counter_ns``; ``profiled``, whether a ``torch.profiler``
    capture was recording when it opened. With ``profiler_range`` (the
    default) it also enters ``torch.profiler.record_function(name)``,
    but only while a capture records: outside one, a range costs several
    microseconds, and the check a fraction of one. Spans nest by the order they open in,
    so they are opened by one thread, the one that steps the trainer.
    """

    __slots__ = ("name", "step", "parent", "start_ns", "end_ns",
                 "profiled", "_range")

    def __init__(self, name: str, step: Optional[int] = None,
                 profiler_range: bool = True):
        self.name = name
        self.step = step
        self._range = profiler_range

    def __enter__(self) -> "span":
        global _open
        parent = self.parent = _open
        if self.step is None and parent is not None:
            self.step = parent.step
        _open = self
        if _profiling():
            self.profiled = True
            if self._range:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        else:
            self.profiled = False
        if parent is None and _armed:
            _mark_step(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> None:
        global _open
        self.end_ns = _clock()
        if self.profiled and self._range:
            self._range.__exit__(*exc)
        _open = self.parent
        _ring.append(self)
        if self.name not in _first:
            _first[self.name] = self


def spans() -> List[span]:
    """The ring's records, oldest first (a span after the spans it
    holds: records are kept as they close; a ``reading`` once its
    events have completed, which this call looks at first)."""
    if _armed:
        _poll()
    return list(_ring)


def clear() -> None:
    """Empty the ring (``first``'s records stay)."""
    _ring.clear()


def first(name: str) -> Optional[span]:
    """The process's first closed span named ``name``, or None."""
    return _first.get(name)


def step_medians(records: List[span]) -> Dict[str, float]:
    """Each name's host ms a step, the median over the steps of the
    unprofiled ``train.step`` records among ``records``: ``train.step``'s
    own duration, and each other name's summed over its records of the
    step. Device spans' ``reading`` records are left out."""
    steps = {r.step for r in records
             if r.name == "train.step" and not r.profiled}
    per: Dict[str, Dict[int, int]] = collections.defaultdict(
        lambda: dict.fromkeys(steps, 0))
    for r in records:
        if not isinstance(r, reading) and r.step in steps \
                and not r.profiled:
            per[r.name][r.step] += r.end_ns - r.start_ns
    return {name: statistics.median(v.values()) / 1e6
            for name, v in per.items()}


# -- device spans -------------------------------------------------------
#
# A pair of CUDA timing events on the current stream times a device span.
# Recorded eagerly, a pair belongs to the step whose top-level span was
# open. Recorded while a CUDA graph is captured, its events are
# ``external``, so the capture keeps each record as a node of the graph
# and every replay records them again, with no Python of the model
# running; such a pair is put down to the step whose top-level span
# last recorded a marker event (each does, once a device span exists)
# if the pair's start comes after that marker on the card's clock. A
# pair is never waited for: it is read once its end event has completed
# (``query``), at the start of a top-level span and by ``spans()``. A
# replay records over its graph's pairs, so where the host keeps ahead
# of the card a replayed step is read only before a wait for the card.

# pairs of captured graphs kept for reading (older captures' drop out)
BAKED_PAIRS = 16
# eagerly recorded pairs waiting for their end event
PENDING_PAIRS = 256

_armed = False                 # a device span has run in this process
_pending: "collections.deque[_Pair]" = collections.deque(
    maxlen=PENDING_PAIRS)
_baked: "collections.deque[_Pair]" = collections.deque(maxlen=BAKED_PAIRS)
# the latest top-level span's marker: (event, step id, profiled)
_marker: Optional[Tuple[Any, Optional[int], bool]] = None


class reading:
    """A device span's record in the ring: ``name``, the ``step`` id and
    ``profiled`` flag of the step that ran it, no ``parent``, and
    ``device_ms``, the card's time from its start event to its end."""

    __slots__ = ("name", "step", "parent", "profiled", "device_ms")

    def __init__(self, name: str, step: Optional[int], profiled: bool,
                 device_ms: float):
        self.name = name
        self.step = step
        self.parent = None
        self.profiled = profiled
        self.device_ms = device_ms


class _Pair:
    __slots__ = ("name", "start", "end", "step", "profiled", "read")


def _event():
    """A timing event recorded on the current stream; ``external``, so
    that a graph capture keeps it as a node."""
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


def _begin(name: str) -> _Pair:
    global _armed
    _armed = True
    p = _Pair()
    p.name, p.read, p.start = name, None, _event()
    return p


def _end(p: _Pair) -> None:
    p.end = _event()
    if capturing():
        _baked.append(p)
        return
    root = _open
    while root is not None and root.parent is not None:
        root = root.parent
    p.step = None if root is None else root.step
    p.profiled = _profiling() if root is None else root.profiled
    _pending.append(p)


def _mark_step(top: span) -> None:
    """At the start of top-level span ``top``: read what has completed,
    then record the marker that a replay inside ``top`` comes after."""
    global _marker
    if capturing():
        return
    _poll()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    _marker = (ev, top.step, top.profiled)


def _poll() -> None:
    """Move every pair whose end event has completed into the ring."""
    while _pending and _pending[0].end.query():
        p = _pending.popleft()
        _ring.append(reading(p.name, p.step, p.profiled,
                             p.start.elapsed_time(p.end)))
    if _marker is None:
        return
    ev, step, profiled = _marker
    for p in _baked:
        if p.read is ev or not p.end.query() or not ev.query():
            continue
        try:            # a start before the marker reads below 0
            fresh = ev.elapsed_time(p.start) >= 0.0
            ms = p.start.elapsed_time(p.end)
        except RuntimeError:        # its graph has not run
            continue
        p.read = ev
        if fresh:
            _ring.append(reading(p.name, step, profiled, ms))


class _OnBackward(torch.autograd.Function):
    """``x`` as it is (a view: no kernel), calling ``fn`` when its
    gradient arrives in the backward, which passes through unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.fn()
        return grad, None


def on_backward(x: torch.Tensor, fn: Callable[[], None]) -> torch.Tensor:
    """``x``, with ``fn`` called when the backward reaches it."""
    return _OnBackward.apply(x, fn)


def device_spans(name: str, fn: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, timed on the card as two device spans:
    ``<name>.forward`` from the call's start to its end and, where ``x``
    needs a gradient, ``<name>.backward`` from the arrival of the
    output's gradient in the backward to that of ``x``'s. Where ``x`` is
    not on a CUDA device, ``fn(x)`` alone."""
    if x.device.type != "cuda":
        return fn(x)
    forward = _begin(f"{name}.forward")
    backward: List[_Pair] = []

    def backward_begins() -> None:
        backward.append(_begin(f"{name}.backward"))

    def backward_ends() -> None:
        if backward:
            _end(backward.pop())

    track = torch.is_grad_enabled() and x.requires_grad
    if track:
        x = on_backward(x, backward_ends)
    y = fn(x)
    if track:
        y = on_backward(y, backward_begins)
    _end(forward)
    return y


@contextlib.contextmanager
def device_span(name: str, device: torch.device) -> Iterator[None]:
    """The enclosed block timed on the card as the device span ``name``,
    for work that no tensor flows through (an optimizer's update in
    place, say)::

        with device_span("optimizer.step", params[0].device):
            optimizer.step()

    Where ``device`` is not a CUDA device, the block alone."""
    if device.type != "cuda":
        yield
        return
    pair = _begin(name)
    yield
    _end(pair)


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
    ``activities`` (their number), ``memcpy_htod_ms`` (host-to-device
    copies) and ``spans``, the device's time under each profiler range
    (``span``'s, and any other ``record_function``): {outermost range:
    {"device_busy_ms", "idle_ms", "count"}}. An activity is put down to
    the outermost range running on the host when the operator that
    launched it began, matched by ``External id``, whatever the thread,
    else (a kernel launched outside PyTorch's operators, as
    decode+augment's through ``ctypes``) when its launch call ran,
    matched by ``correlation``; ``count`` is the number of such activities,
    ``device_busy_ms`` the union of their intervals. An idle gap between
    activities is put down to the outermost range running at its
    middle. What falls under no range is put down to ``NO_RANGE``.
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
    # by start and end only: two kernels on two streams can tie on both
    acts = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
         for e in events
         if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES),
        key=lambda a: a[:2])
    busy_us, end = 0.0, float("-inf")
    total = collections.Counter()
    count = collections.Counter()
    ops = collections.Counter()
    meta: Dict[str, Dict[str, str]] = {}
    htod_us = 0.0
    gaps: List[Tuple[float, float]] = []
    for start, stop, e in acts:
        if end > float("-inf") and start > end:
            gaps.append((end, start))
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
        "activities": len(acts),
        "memcpy_htod_ms": htod_us / 1e3,
        "spans": _by_range(events, acts, gaps),
    }
    if num_steps:
        out["ms_per_step"] = out["device_busy_ms"] / num_steps
    return out


# where summarize_trace puts what falls under no profiler range
NO_RANGE = "no range"


def _by_range(events, acts, gaps) -> Dict[str, Dict[str, float]]:
    """``summarize_trace``'s ``spans``: the device's activities ``acts``
    (sorted (start, stop, event)) and idle ``gaps`` by outermost profiler
    range."""
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")
    outer: List[Tuple[float, float, str]] = []
    for r in ranges:
        if not outer or r[0] >= outer[-1][1]:
            outer.append(r)
    starts = [r[0] for r in outer]

    def range_at(t: Optional[float]) -> str:
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        return outer[i][2] if i >= 0 and t <= outer[i][1] else NO_RANGE

    began: Dict[Any, float] = {}       # External id -> operator's start
    launched: Dict[Any, float] = {}    # correlation -> launch call's start
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        if e.get("cat") == "cpu_op" and "External id" in args:
            began.setdefault(args["External id"], float(e["ts"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launched[args["correlation"]] = float(e["ts"])
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: {"device_busy_ms": 0.0, "idle_ms": 0.0, "count": 0})
    ends: Dict[str, float] = {}
    for start, stop, e in acts:
        args = e.get("args", {})
        t = began.get(args.get("External id"))
        name = range_at(launched.get(args.get("correlation"))
                        if t is None else t)
        s = out[name]
        end = ends.get(name, float("-inf"))
        s["device_busy_ms"] += max(0.0, stop - max(start, end)) / 1e3
        ends[name] = max(end, stop)
        s["count"] += 1
    for a, b in gaps:
        out[range_at((a + b) / 2)]["idle_ms"] += (b - a) / 1e3
    return dict(out)
