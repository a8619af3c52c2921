"""The BiGRU's tracing (``models/layers.py::BiGRU``, ``GRU``) and the
device spans under it (``utils/profiling.py::device_spans``), with the
benchmark's readers of them (``kws_bench/metrics/gru_*``).

On the CPU:

- ``device_spans`` is ``fn(x)`` alone off a CUDA device: the BiGRU's
  output and every gradient are bit-identical to its two directions run
  by hand, and no reading is recorded;
- the pass-through that marks the backward (``on_backward``) leaves the
  gradients bit-identical and calls back at the output's gradient first
  and at the input's last;
- the bookkeeping of the readings, on stand-in events with a device
  clock of the test's: an eager pair is read once its end has completed,
  a captured pair at each replay is put down to the step whose marker it
  follows, a replay that a later one recorded over is lost, and a step
  that replayed nothing reads nothing;
- the readers, on synthetic records.

On the card (marked ``cuda``; ``-m cuda --noconftest``), the cell's
model at batch 384: a replayed step's ``gru.forward`` + ``gru.backward``
against the BiGRU's forward and backward in a CUDA graph of their own,
and the replay's time with and without the spans.
"""

import copy
import statistics
import types

import pytest
import torch

from kws_bench.metrics import gru_device_ms_per_step, gru_step_share
from speech_recognition_tpu_torch.models import layers as ML
from speech_recognition_tpu_torch.utils import profiling as P

torch.set_num_threads(1)


def _bigru(seed=0):
    gru = ML.BiGRU(384, 192, dropout=0.2, recurrent_dropout=0.2).double()
    ML.init_parameters(gru, torch.Generator().manual_seed(seed))
    return gru


def _x(b=2):
    x = torch.randn(b, 384, 50, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    return x.requires_grad_()


def _grads(gru, x, y):
    y.square().sum().backward()
    return [x.grad] + [p.grad for p in gru.parameters()]


def _by_hand(gru, x, generator):
    return torch.cat([d(x, generator) for d in gru.directions], dim=1)


def _readings():
    return [r for r in P.spans() if isinstance(r, P.reading)]


def test_device_spans_are_a_no_op_on_the_cpu():
    before = len(_readings())
    gru = _bigru()
    x = _x()
    y = gru(x, torch.Generator().manual_seed(2))
    got = _grads(gru, x, y)
    gru.zero_grad()
    x2 = _x()
    y2 = _by_hand(gru, x2, torch.Generator().manual_seed(2))
    want = _grads(gru, x2, y2)
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(_readings()) == before
    assert [r.name for r in P.spans()][-1:] == ["model.gru"]


def test_the_backward_marks_pass_the_gradient_and_call_back_in_order():
    calls = []
    gru = _bigru()
    x = _x()
    xm = P.on_backward(x, lambda: calls.append("input"))
    y = P.on_backward(_by_hand(gru, xm, torch.Generator().manual_seed(2)),
                      lambda: calls.append("output"))
    got = _grads(gru, x, y)
    assert calls == ["output", "input"]
    gru.zero_grad()
    x2 = _x()
    want = _grads(gru, x2, _by_hand(gru, x2,
                                    torch.Generator().manual_seed(2)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


class _Device:
    """A stand-in for the card: ``clock`` stamps each record, events up
    to ``done`` have completed."""

    def __init__(self):
        self.clock, self.done, self.capturing = 0.0, -1.0, False

    def stamp(self):
        self.clock += 1.0
        return self.clock


def _events(dev):
    class Event:
        def __init__(self, enable_timing=False, external=False):
            self.t = None

        def record(self, stream=None):
            self.t = dev.stamp()

        def query(self):
            return self.t is None or self.t <= dev.done

        def elapsed_time(self, other):
            if self.t is None or other.t is None or not (
                    self.query() and other.query()):
                raise RuntimeError("not recorded or not complete")
            return other.t - self.t
    return Event


@pytest.fixture
def device(monkeypatch):
    dev = _Device()
    monkeypatch.setattr(P.torch.cuda, "Event", _events(dev))
    monkeypatch.setattr(P.torch.cuda, "is_current_stream_capturing",
                        lambda: dev.capturing)
    for name, value in (("_armed", False), ("_marker", None)):
        monkeypatch.setattr(P, name, value)
    monkeypatch.setattr(P, "_pending", type(P._pending)(
        maxlen=P.PENDING_PAIRS))
    monkeypatch.setattr(P, "_baked", type(P._baked)(maxlen=P.BAKED_PAIRS))
    P.clear()
    yield dev
    P.clear()


def _replay(dev, pair, ms):
    pair.start.t = dev.stamp()
    dev.clock += ms
    pair.end.t = dev.stamp() - 1.0


def test_readings_follow_the_steps_that_ran_them(device):
    dev = device
    with P.span("train.step", 0, profiler_range=False):      # eager
        pair = P._begin("gru.forward")
        dev.clock += 2.0
        P._end(pair)
    assert _readings() == []                    # not complete yet
    dev.done = dev.clock
    (r,) = _readings()
    assert (r.name, r.step, r.profiled, r.device_ms) == (
        "gru.forward", 0, False, 3.0)
    with P.span("train.step", 1, profiler_range=False):      # capture
        dev.capturing = True
        baked = P._begin("gru.backward")
        P._end(baked)
        dev.capturing = False
        _replay(dev, baked, 5.0)                # its first replay
    with P.span("train.step", 2, profiler_range=False):
        _replay(dev, baked, 7.0)                # recorded over step 1's
    dev.done = dev.clock
    assert [(r.name, r.step, r.device_ms) for r in _readings()[1:]] == [
        ("gru.backward", 2, 7.0)]
    with P.span("train.step", 3, profiler_range=False):
        pass                                    # no replay
    dev.done = dev.clock
    assert len(_readings()) == 2
    with P.span("train.step", 4, profiler_range=False):
        _replay(dev, baked, 4.0)
    assert len(_readings()) == 2                # the host is ahead
    with P.span("train.step", 5, profiler_range=False):
        _replay(dev, baked, 6.0)
        dev.done = dev.clock                    # the host waits
    with P.span("train.step", 6, profiler_range=False):
        pass
    assert [(r.step, r.device_ms) for r in _readings()[2:]] == [(5, 6.0)]
    assert len(_readings()) == 3                # read once


def test_a_reading_under_a_capture_is_flagged_profiled(device,
                                                       monkeypatch):
    monkeypatch.setattr(P, "_profiling", lambda: True)
    with P.span("train.step", 7, profiler_range=False):
        P._end(P._begin("gru.forward"))
    device.done = device.clock
    (r,) = _readings()
    assert (r.step, r.profiled) == (7, True)


def _step(step, profiled=False):
    return types.SimpleNamespace(name="train.step", step=step,
                                 profiled=profiled, parent=None)


def _layers(steps=4, busy_s=2.0, traced=20):
    return {"kind": "train", "steps": steps,
            "trace": {"summary": {"busy_s": busy_s}, "steps": traced}}


def test_the_gru_readers():
    recs = [_step(s) for s in range(6)] + [
        P.reading("gru.forward", 3, False, 10.0),
        P.reading("gru.backward", 3, False, 20.0),
        P.reading("gru.forward", 4, False, 12.0),   # no backward: left out
        P.reading("gru.forward", 5, False, 11.0),
        P.reading("gru.backward", 5, False, 23.0),
        P.reading("gru.forward", 1, False, 1.0),    # before the tail
        P.reading("gru.backward", 1, False, 1.0),
        P.reading("gru.forward", 5, True, 99.0)]    # profiled
    assert gru_device_ms_per_step.per_step(_layers(), recs) == 32.0
    assert gru_device_ms_per_step.per_step(_layers(), recs[:6]) is None
    assert gru_device_ms_per_step.per_step({"kind": "predict"}, recs) \
        is None


def test_the_share_reads_the_spans_over_the_busy_time(monkeypatch):
    monkeypatch.setattr(gru_device_ms_per_step, "read", lambda l: 25.0)
    assert gru_step_share.read(_layers()) == pytest.approx(25.0)
    monkeypatch.setattr(gru_device_ms_per_step, "read", lambda l: None)
    assert gru_step_share.read(_layers()) is None


# -- on the card -------------------------------------------------------

BATCH = 384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _trainer(device):
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    ds = synthetic_device_dataset(device, num_train=2048, num_val=64,
                                  num_pseudo=256)
    tr = Trainer("xception_with_attention",
                 prepare_model_settings(label_count=12), ds,
                 augment=AugmentConfig(pseudo_frequency=0.6),
                 batch_size=BATCH, seed=3)
    return tr, tr.init_state()


def _gru_ms(steps):
    """gru.forward + gru.backward of each of ``steps`` read so far (the
    step's other device spans, ``optimizer.step``, left out)."""
    per = {}
    for r in _readings():
        if r.step in steps and r.name.startswith("gru."):
            per.setdefault(r.step, {})[r.name] = r.device_ms
    return [sum(v.values()) for v in per.values() if len(v) == 2]


def _gru_alone(bigru, device, batch=BATCH, n=10):
    """A function that times (card ms) the forward and backward of a
    copy of ``bigru``'s two directions (``BiGRU.run``: one kernel launch
    a pass, no spans) on a [batch, 384, 50] input under bf16 autocast,
    captured alone in a CUDA graph of its own, by events around ``n``
    replays."""
    gru = copy.deepcopy(bigru)
    for p in gru.parameters():
        p.grad = None
    x = torch.randn(batch, 384, 50, device=device, requires_grad=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def body():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = gru.run(x, gen)
        y.float().square().sum().backward()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        body()

    def ms():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n
    return ms


@pytest.mark.cuda
def test_a_replayed_reading_is_the_grus_own_time(cuda):
    """A replayed step's ``gru.forward`` + ``gru.backward``, waited for
    step by step, against the BiGRU's forward and backward captured alone
    and timed by events around its graph's replays, in turns: medians
    within 5 %. (An eager step is no yardstick: its spans read the
    host's pace, which was 4-44x the card's when the GRU launched ~80
    kernels a time step from Python.)"""
    tr, state = _trainer(cuda)
    P.clear()
    for _ in range(2):                          # eager, then the capture
        tr.train_step(state)
    alone = _gru_alone(state.model.BiGRU_0, cuda)
    spans, yardstick = [], []
    for _ in range(4):
        step = state.step
        tr.train_step(state)
        torch.cuda.synchronize()
        spans += _gru_ms({step})
        yardstick.append(alone())
    assert len(spans) == 4, spans
    ratio = statistics.median(spans) / statistics.median(yardstick)
    assert abs(ratio - 1) < 0.05, (spans, yardstick)


@pytest.mark.cuda
def test_the_spans_cost_a_replay_under_half_a_percent(cuda, monkeypatch):
    """Replays of a step captured without the spans against those of
    one captured with them, in turns on one card."""
    def ms_a_step(tr, state, n=20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            tr.train_step(state)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    with monkeypatch.context() as m:
        m.setattr(ML, "device_spans", lambda name, fn, x: fn(x))
        plain = _trainer(cuda)
        for _ in range(3):
            plain[0].train_step(plain[1])
    timed = _trainer(cuda)
    for _ in range(3):
        timed[0].train_step(timed[1])
    got = {"plain": [], "timed": []}
    for _ in range(3):
        got["plain"].append(ms_a_step(*plain))
        got["timed"].append(ms_a_step(*timed))
    ratio = statistics.median(got["timed"]) / statistics.median(
        got["plain"])
    assert abs(ratio - 1) < 0.005, got
