"""The port's one way to call native code (``ops/kernels/launch.py``), on
the CPU with no device: the CUDA stream, the capture flag and the graph
are stand-ins.

- a launch outside a capture passes the stream last and counts one run;
- launches made during a capture count nothing then, and their number
  at each replay of the capture's graph; a capture that raises holds
  nothing;
- a refused launch raises ``"<entry> launch failed: <msg> (<code>)"``
  with the library's own string, and counts nothing;
- ``runs`` is a copy, ``reset_runs`` sets it to 0;
- ``library`` builds and loads a source once a process and types its
  entries (the host WAV decoder, built with the host compiler);
- ``aligned`` and ``ptr``.

On the card (marked ``cuda``; ``-m cuda --noconftest``): the
decode+augment kernel captured in a CUDA graph counts nothing at the
capture and one run at each replay.
"""

import contextlib
import ctypes
import types
import weakref

import pytest
import torch

from speech_recognition_tpu_torch.ops.kernels import build
from speech_recognition_tpu_torch.ops.kernels import launch as L

STREAM = 0xC0DA


class _Library:
    """A stand-in library: ``entry`` records its arguments and returns
    ``code``; ``error_string`` describes a code as a C string."""

    def __init__(self, code=0):
        self.code, self.calls = code, []

    def entry(self, *args):
        self.calls.append(args)
        return self.code

    def error_string(self, code):
        return f"stand-in error {code}".encode()


class _Graph:
    """A stand-in CUDA graph that counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def card(monkeypatch):
    """No counts, no held graphs, and a stand-in for the card: a device
    context, a current stream, and a capture flag that ``torch.cuda.graph``
    raises for as long as its block runs."""
    monkeypatch.setattr(L, "_RUNS", L.collections.Counter())
    monkeypatch.setattr(L, "_GRAPHS", weakref.WeakKeyDictionary())
    monkeypatch.setattr(L, "_held", None)
    state = types.SimpleNamespace(capturing=False)

    @contextlib.contextmanager
    def graph(g):
        state.capturing = True
        try:
            yield
        finally:
            state.capturing = False

    monkeypatch.setattr(L.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(L.torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=STREAM))
    monkeypatch.setattr(L.torch.cuda, "is_current_stream_capturing",
                        lambda: state.capturing)
    monkeypatch.setattr(L.torch.cuda, "graph", graph)
    return state


def test_a_launch_outside_a_capture_counts_once(card):
    lib = _Library()
    L.launch(lib, "entry", "cuda:0", 1, None, 3, kernel="k")
    assert lib.calls == [(1, None, 3, STREAM)]
    assert L.runs() == {"k": 1}
    L.launch(lib, "entry", "cuda:0", kernel="k")
    assert L.runs() == {"k": 2}


def test_captured_launches_count_at_each_replay(card):
    lib, g = _Library(), _Graph()
    L.launch(lib, "entry", "cuda:0", kernel="a")
    with L.capture(g):
        assert L.capturing()
        for kernel in ("a", "a", "b"):
            L.launch(lib, "entry", "cuda:0", kernel=kernel)
    assert not L.capturing()
    assert len(lib.calls) == 4
    assert L.runs() == {"a": 1}         # the capture ran nothing
    L.replay(g)
    assert L.runs() == {"a": 3, "b": 1}
    L.replay(g)
    assert g.replays == 2 and L.runs() == {"a": 5, "b": 2}
    # a graph of no capture of ours replays and counts nothing
    other = _Graph()
    L.replay(other)
    assert other.replays == 1 and L.runs() == {"a": 5, "b": 2}


def test_a_capture_that_raises_holds_nothing(card):
    lib, g = _Library(), _Graph()
    with pytest.raises(RuntimeError, match="host sync"):
        with L.capture(g):
            L.launch(lib, "entry", "cuda:0", kernel="a")
            raise RuntimeError("host sync in a capture")
    assert L._held is None
    L.replay(g)
    assert L.runs() == {}
    L.launch(lib, "entry", "cuda:0", kernel="a")
    assert L.runs() == {"a": 1}


def test_a_refused_launch_raises_with_the_library_string(card):
    lib = _Library(code=7)
    with pytest.raises(RuntimeError, match=r"^entry launch failed: "
                       r"stand-in error 7 \(7\)$"):
        L.launch(lib, "entry", "cuda:0", 5, kernel="k")
    assert lib.calls == [(5, STREAM)]
    assert L.runs() == {}


def test_runs_is_a_copy_and_reset_sets_it_to_zero(card):
    lib = _Library()
    L.launch(lib, "entry", "cuda:0", kernel="k")
    got = L.runs()
    got["k"] += 10
    assert L.runs() == {"k": 1} and L.runs()["never"] == 0
    L.reset_runs()
    assert L.runs() == {}


def test_a_library_is_built_and_loaded_once(monkeypatch):
    monkeypatch.setattr(L, "_LOADED", {})
    built, real_build = [], build.build

    def counting_build(name):
        built.append(name)
        return real_build(name)

    monkeypatch.setattr(build, "build", counting_build)
    p = ctypes.c_void_p
    lib = L.library("wavio", {"wavio_decode_batch": [p, ctypes.c_int]})
    assert L.library("wavio", {}) is lib and built == ["wavio"]
    fn = lib.wavio_decode_batch
    assert fn.argtypes == [p, ctypes.c_int] and fn.restype is ctypes.c_int
    assert not hasattr(lib, "error_string")


def test_aligned_and_ptr():
    assert L.ptr(None) is None and L.aligned(None) is None
    base = torch.zeros(64)
    assert L.ptr(base) == base.data_ptr()
    assert L.aligned(base) is base
    view = base[1:33]                   # 4 bytes past a 16-byte boundary
    got = L.aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    strided = base[::2]
    got = L.aligned(strided)
    assert got.is_contiguous() and torch.equal(got, strided)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_kernel_captured_on_the_card_counts_at_each_replay(cuda):
    from speech_recognition_tpu_torch.ops.kernels import decode_augment as K

    g = torch.Generator().manual_seed(0)
    bank = torch.randint(-2 ** 15, 2 ** 15, (4, 256), generator=g,
                         dtype=torch.int16).to(cuda)
    bg = torch.rand(1024, generator=g).to(cuda)
    ids, shifts, pos = (torch.tensor(v, device=cuda) for v in (
        [0, 3, 1], [5, -7, 0], [0, 100, 768]))
    vols = torch.tensor([0.5, 1.0, 0.25], device=cuda)
    args = (bank, bg, ids, shifts, vols, pos, vols)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the default stream
        want = K.decode_augment(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = L.runs()
    with L.capture(graph):
        got = K.decode_augment(*args)
    assert L.runs() == before
    for n in (1, 2, 3):
        got.zero_()
        L.replay(graph)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert L.runs() - before == {"decode_augment": n}
