"""How the port calls its native code: ``library`` loads it, ``launch``
calls a CUDA entry and raises if it refuses, ``runs`` counts the runs.

A launch made while the current stream is not capturing counts as one
run at once. A launch made inside ``capture`` is held by that graph and
counts once at each ``replay`` of it (a capture made without ``capture``
holds nothing, so its launches never count).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import weakref
from typing import Dict, Optional, Sequence

import torch

from speech_recognition_tpu_torch.ops.kernels import build

# the argument types the entries take: a pointer, an int, an int64
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the libraries loaded in this process, by source name
_LOADED: Dict[str, ctypes.CDLL] = {}
# runs by kernel since the last ``reset_runs``
_RUNS: collections.Counter = collections.Counter()
# the launches of the capture in progress, None outside ``capture``
_held: Optional[collections.Counter] = None
# each captured graph's launches, which a replay runs
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def library(name: str, entries: Dict[str, Sequence],
            error: Optional[str] = None) -> ctypes.CDLL:
    """``csrc/<name>``'s library, built (at first use) and loaded once a
    process. ``entries`` maps each entry's name to its argument types; an
    entry returns a C ``int``. ``error`` names the source's
    ``const char* (int)`` that describes a nonzero code, which ``launch``
    reads as the library's ``error_string``."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build.build(name)))
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        if error is not None:
            lib.error_string = getattr(lib, error)
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def capturing() -> bool:
    """Whether the current stream records a CUDA graph capture."""
    return torch.cuda.is_current_stream_capturing()


def launch(lib, entry: str, device: torch.device, *args,
           kernel: str) -> None:
    """Call ``lib``'s ``entry`` with ``args`` and the current stream of
    ``device`` last; raise if it returns a nonzero code, else record one
    launch of ``kernel``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
        held = capturing()
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} ({err})")
    if not held:
        _RUNS[kernel] += 1
    elif _held is not None:
        _held[kernel] += 1


@contextlib.contextmanager
def capture(graph):
    """``torch.cuda.graph(graph)``, which holds the launches made inside
    it for ``graph``'s replays; a capture that raises holds none."""
    global _held
    outer, _held = _held, collections.Counter()
    try:
        with torch.cuda.graph(graph):
            yield
        _GRAPHS[graph] = _held
    finally:
        _held = outer


def replay(graph) -> None:
    """``graph.replay()``, counting a run of each launch its capture
    held."""
    graph.replay()
    _RUNS.update(_GRAPHS.get(graph, ()))


def runs() -> collections.Counter:
    """A copy of the runs by kernel (0 for a kernel that has not run)."""
    return collections.Counter(_RUNS)


def reset_runs() -> None:
    """Set every kernel's runs to 0."""
    _RUNS.clear()


def ptr(v: Optional[torch.Tensor]) -> Optional[int]:
    """``v``'s address, or None (a null pointer) for None."""
    return None if v is None else v.data_ptr()


def aligned(v: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``v`` contiguous and 16-byte aligned (a copy where it is not), or
    None for None: the kernels read their operands 4 to 16 bytes at a
    time."""
    if v is None:
        return None
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()
