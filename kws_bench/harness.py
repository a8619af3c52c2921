"""The benchmark's harness: cells, configurations, traffic mixes, limits
and per-layer metrics found by name, one run of one cell, and its
result line.

Everything that belongs to one configuration, traffic mix, cell or
metric sits in files of its own, found by the names in
``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration; its ``reference`` names
  the plain reference ``reference/<reference>.py``;
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the driver ``traffic/<kind>.py`` that runs it;
* ``limits/<cell>.json``: the limits of the cell's compared numbers;
* ``metrics/<metric>.py``: the reader of a per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import resource
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# whole top-level module names that no run may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "speech_recognition_tpu")
# fixed build and kernel caches inside the checkout
CACHE_DIR = ROOT / ".kws_bench_cache"


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; workloads: "
                     f"{[c['name'] for c in spec['workloads']]}")


def load_config(name: str) -> Dict[str, Any]:
    return _json(PACKAGE / "configs" / f"{name}.json")


def load_traffic(name: str) -> Dict[str, Any]:
    return _json(PACKAGE / "traffic" / f"{name}.json")


def load_limits(cell: str) -> Dict[str, float]:
    return {k: v["limit"] for k, v in
            _json(PACKAGE / "limits" / f"{cell}.json")["numbers"].items()}


def driver(kind: str):
    return importlib.import_module(f"kws_bench.traffic.{kind}")


def reference(config: Dict[str, Any]):
    return importlib.import_module(
        f"kws_bench.reference.{config['reference']}")


def reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    return importlib.import_module(f"kws_bench.metrics.{metric}").read


def metrics_of(spec: Dict[str, Any], cell: str, kind: str,
               ) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    that list it, and those with no list that every cell reports (an
    end-to-end one) or whose moved metric it reports (a per-layer one)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def derive_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream of draws of a run (data,
    weights, trainer, loader, ...), within torch's 64 bits."""
    return (seed * 1_000_003 + stream) % (2 ** 63)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Context:
    cell: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    workdir: str


@dataclasses.dataclass
class Run:
    """What a driver hands back: its end-to-end metrics (all but
    ``setup_s``), the host clock when the window opened, counts, the
    compared numbers, the peak memory, and what the per-layer readers
    read (``layers``: counters of the window and of the traced capture,
    with its trace summary under ``trace``)."""

    e2e: Dict[str, float]
    window_start: float
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    layers: Dict[str, Any]


def make_weights(shapes, seed: int, device) -> Dict[str, Any]:
    """Every parameter and BatchNorm statistic of ``shapes`` ((name, shape,
    kind), a reference's ``param_shapes``) from one draw of uniform
    numbers on ``device``: kernels glorot-uniform, biases and BatchNorm
    shifts in [-0.1, 0.1], BatchNorm scales in [0.8, 1.2], running means
    in [-0.1, 0.1] and running variances in [0.5, 1.5]."""
    import math

    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = [math.prod(s) for _, s, _ in shapes]
    u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out, start = {}, 0
    for (name, shape, kind), n in zip(shapes, sizes):
        v = u[start:start + n].view(shape)
        start += n
        if kind == "kernel":
            rf = math.prod(shape[2:])
            v = v * math.sqrt(6.0 / ((shape[0] + shape[1]) * rf))
        elif kind == "bn_scale":
            v = 1.0 + 0.2 * v
        elif kind == "running_var":
            v = 1.0 + 0.5 * v
        else:           # bias, bn_shift, running_mean
            v = 0.1 * v
        out[name] = v
    return out


def run_cell(spec: Dict[str, Any], cell_name: str, seed: int,
             seconds: float, trace: bool, device, workdir: str,
             overrides: Optional[Dict[str, Dict[str, Any]]] = None,
             ) -> Run:
    """One run of a cell (no look for a chip: ``device`` is given).
    ``overrides`` ({"config": {...}, "mix": {...}}) change sizes for the
    CPU tests."""
    cell = find_cell(spec, cell_name)
    overrides = overrides or {}
    ctx = Context(cell=cell,
                  config={**load_config(cell["config"]),
                          **overrides.get("config", {})},
                  mix={**load_traffic(cell["traffic"]),
                       **overrides.get("mix", {})},
                  limits=load_limits(cell_name), seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  workdir=workdir)
    return driver(ctx.mix["kind"]).run(ctx)


def correct(run: Run) -> bool:
    """Every compared number within its limit, and no attempt failed."""
    return all(c.ok for c in run.checks) and run.failed == 0


def result_line(spec, cell_name: str, run: Run, setup_s: float,
                trace: bool, device_info: Dict[str, Any],
                layer_values: Dict[str, float],
                breakdown: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    metrics = {}
    if trace:
        for m in metrics_of(spec, cell_name, "per_layer"):
            if m["name"] in layer_values:
                metrics[m["name"]] = {"value": layer_values[m["name"]],
                                      "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        for m in metrics_of(spec, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct(run),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in run.checks}
    return out


def read_layers(spec, cell_name: str, layers: Dict[str, Any],
                ) -> Dict[str, float]:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in metrics_of(spec, cell_name, "per_layer"):
        value = reader(m["name"])(layers)
        if value is not None:
            out[m["name"]] = value
    return out


def use_checkout_caches() -> None:
    """Point the build and kernel caches of anything the run loads at
    fixed directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)


def now() -> float:
    return time.perf_counter()


def pin_threads() -> Dict[str, Any]:
    """Pin the thread that dispatches to the card to one fixed core, the
    last one the process may use, and every other thread of the process
    (a loader's, the CUDA driver's) to the others, and keep PyTorch's
    CPU work to one thread, so that the dispatching thread neither
    migrates nor shares its core with the process's own workers. Returns
    the cores chosen."""
    import torch

    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        return {"dispatch": cores, "others": cores}
    main, rest = cores[-1], set(cores[:-1])
    me = threading.get_native_id()
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), {main} if int(tid) == me
                                 else rest)
        except OSError:         # the thread has ended meanwhile
            pass
    torch.set_num_threads(1)
    return {"dispatch": [main], "others": sorted(rest)}


def _python_seconds() -> float:
    """The least of five timings of a fixed piece of Python: the host's
    speed for the dispatching thread."""
    best = float("inf")
    for _ in range(5):
        t, s = time.perf_counter(), 0
        for i in range(100_000):
            s += i
        best = min(best, time.perf_counter() - t)
    return best


def host_state() -> Dict[str, Any]:
    """What the host is doing: this process's CPU seconds and context
    switches, and the Python probe's seconds."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime,
            "voluntary": ru.ru_nvcsw, "involuntary": ru.ru_nivcsw,
            "python_s": _python_seconds(), "clock": now()}


def host_record(before: Dict[str, Any], after: Dict[str, Any],
                step_ms: List[float]) -> Dict[str, Any]:
    """The host over a window, beside the spread of its steps: this
    process's CPU seconds over the window's, its voluntary and
    involuntary context switches (a dispatching thread that never waits
    for the card makes no voluntary ones), the Python probe before and
    after, and the steps' quartiles (ms)."""
    import statistics

    out = {"python_s": [before["python_s"], after["python_s"]],
           "cpu_per_s": (after["cpu_s"] - before["cpu_s"])
           / (after["clock"] - before["clock"]),
           "switches": [after["voluntary"] - before["voluntary"],
                        after["involuntary"] - before["involuntary"]]}
    if len(step_ms) >= 4:
        q1, q2, q3 = statistics.quantiles(step_ms, n=4)
        out["step_ms_quartiles"] = [q1, q2, q3]
        out["step_spread"] = (q3 - q1) / q2
    return out


class _HostEvent:
    """A CUDA event's stand-in on the CPU, where the CPU tests rehearse a
    run: the host clock when recorded (the CPU's work is synchronous)."""

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other: "_HostEvent") -> float:
        return (other.t - self.t) * 1e3


def event(device):
    """A timing event on ``device``'s current stream, recorded."""
    import torch

    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
    else:
        ev = _HostEvent()
        ev.record()
    return ev


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    """Forget the peak so far: called once the benchmark has made its
    inputs, so that the peak is the program's (with the inputs it
    holds)."""
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
