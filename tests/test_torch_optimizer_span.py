"""The optimizer's device span (``train/loop.py::Trainer._update_step``,
``optimizer.step``; ``utils/profiling.py::device_span``) and the
benchmark's readers of it (``kws_bench/metrics/optimizer_*``).

On the CPU:

- ``device_span`` off a CUDA device runs its block and records nothing;
- ``_update_step`` opens the span around the optimizer's update alone
  (the gradients cleared and the backward outside it), and a CPU step
  records no reading;
- the readers, on synthetic records: None without a reading, the
  median of the tail's readings, its share of the busy time, and the
  roofline from the configuration's optimizer and parameter count
  (28 B a parameter for Adam, 20 for RMSprop and SGD with momentum).

On the card (marked ``cuda``; ``-m cuda --noconftest``): a replayed step
of ``conv_1d_simple`` yields one ``optimizer.step`` reading a step,
against the same update captured alone in a CUDA graph of its own; the
flagship's replayed step runs the kernels it ran before the span
existed.
"""

import collections
import contextlib
import statistics
import types

import pytest
import torch

from kws_bench import harness
from kws_bench.metrics import (
    optimizer_device_ms_per_step, optimizer_roofline, optimizer_step_share,
)
from kws_bench.peaks import HBM_BYTES_PER_S
from speech_recognition_tpu_torch.config import prepare_model_settings
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.train import loop
from speech_recognition_tpu_torch.train.loop import Trainer
from speech_recognition_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

CELL = "conv_1d_simple.train_bank"
CELLS = ("flagship.train_bank", "steffenet.train_bank",
         "xception.train_bank", "mfcc_and_raw.train_bank", CELL)


def _trainer(model, device, batch, **data):
    ds = synthetic_device_dataset(device, **data)
    rep = "mfcc_and_raw" if model == "conv_1d_mfcc_and_raw" else "raw"
    return Trainer(model, prepare_model_settings(
        label_count=12, output_representation=rep), ds,
        batch_size=batch, seed=3)


def _readings(name="optimizer.step"):
    return [r for r in P.spans()
            if isinstance(r, P.reading) and r.name == name]


def test_off_the_card_the_span_runs_its_block_alone():
    before, ran = len(P.spans()), []
    with P.device_span("optimizer.step", torch.device("cpu")):
        ran.append(True)
    assert ran == [True] and len(P.spans()) == before


def test_the_span_holds_the_update_alone(monkeypatch):
    """The order of the step's calls: the gradients cleared, the
    backward, then the span around ``optimizer.step`` and nothing
    else."""
    events = []

    @contextlib.contextmanager
    def span(name, device):
        events.append(("open", name, device.type))
        yield
        events.append(("close", name))

    monkeypatch.setattr(loop, "device_span", span)
    tr = _trainer("conv_1d_simple", torch.device("cpu"), 4)
    state = tr.init_state()
    opt = state.optimizer

    def logged(name, fn):
        def call(*args, **kwargs):
            events.append(name)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(opt, "step", logged("step", opt.step))
    monkeypatch.setattr(opt, "zero_grad", logged("zero_grad", opt.zero_grad))
    for p in state.model.parameters():
        p.register_hook(lambda g: events.append("grad") or g)
    tr.train_step(state)
    first_grad = events.index("grad")
    assert events[:first_grad] == ["zero_grad"]
    assert events[-3:] == [("open", "optimizer.step", "cpu"), "step",
                           ("close", "optimizer.step")]
    assert events.count("step") == 1


def test_a_cpu_step_records_no_reading():
    tr = _trainer("conv_1d_simple", torch.device("cpu"), 4)
    state = tr.init_state()
    before = len(_readings())
    tr.train_step(state)
    assert len(_readings()) == before


def _step(step, profiled=False):
    return types.SimpleNamespace(name="train.step", step=step,
                                 profiled=profiled, parent=None)


def _layers(cell=CELL, steps=4, busy_s=2.0, traced=20):
    return {"kind": "train", "cell": cell, "steps": steps, "batch": 384,
            "trace": {"summary": {"busy_s": busy_s}, "steps": traced}}


RECORDS = [_step(s) for s in range(6)] + [
    P.reading("optimizer.step", 3, False, 0.30),
    P.reading("optimizer.step", 4, False, 0.20),
    P.reading("optimizer.step", 5, False, 0.25),
    P.reading("gru.forward", 5, False, 9.0),            # another span
    P.reading("optimizer.step", 1, False, 1.0),         # before the tail
    P.reading("optimizer.step", 5, True, 99.0)]         # profiled


def test_the_update_reader():
    per_step = optimizer_device_ms_per_step.per_step
    assert per_step(_layers(), RECORDS) == 0.25
    assert per_step(_layers(), RECORDS[:6]) is None
    assert per_step({"kind": "predict"}, RECORDS) is None
    assert per_step(_layers(steps=0), RECORDS) is None


@pytest.mark.parametrize("optimizer,extra,per_parameter", [
    ("adam", {}, 28), ("rmsprop", {}, 20), ("sgd", {"momentum": 0.9}, 20),
    ("sgd", {}, 12)])
def test_the_bytes_a_parameter(optimizer, extra, per_parameter):
    cfg = dict(optimizer=optimizer, parameters=1000, **extra)
    assert optimizer_roofline.bytes_per_parameter(cfg) == per_parameter
    assert optimizer_roofline.optimizer_bytes(cfg) == 1000 * per_parameter


@pytest.mark.parametrize("cell", CELLS)
def test_the_share_and_the_roofline_read_the_span(cell, monkeypatch):
    """Each cell's configuration gives its own bytes: conv_1d_simple's
    540,587 Adam parameters 15,136,436 B, steffeNet's 20,056,448
    RMSprop ones 401,128,960 B."""
    monkeypatch.setattr(optimizer_device_ms_per_step, "read",
                        lambda layers: 0.5)
    assert optimizer_step_share.read(_layers(cell)) == pytest.approx(0.5)
    cfg = harness.load_config(harness.find_cell(harness.load_spec(),
                                                cell)["config"])
    want = {"conv_1d_simple": 15_136_436,
            "steffenet": 401_128_960}.get(cfg["name"])
    got = optimizer_roofline.optimizer_bytes(cfg)
    assert want is None or got == want
    assert optimizer_roofline.read(_layers(cell)) == pytest.approx(
        100.0 * got / HBM_BYTES_PER_S / 0.5e-3)
    monkeypatch.setattr(optimizer_device_ms_per_step, "read",
                        lambda layers: None)
    for reader in (optimizer_step_share, optimizer_roofline):
        assert reader.read(_layers(cell)) is None


def test_every_cell_reports_the_three_metrics():
    spec = harness.load_spec()
    for cell in CELLS:
        names = {m["name"] for m in harness.metrics_of(spec, cell,
                                                       "per_layer")}
        assert {"optimizer_device_ms_per_step", "optimizer_step_share",
                "optimizer_roofline"} <= names, cell


# -- on the card -------------------------------------------------------

BATCH = 384


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_trainer(model, device):
    tr = _trainer(model, device, BATCH, num_train=2048, num_val=64,
                  num_pseudo=256)
    return tr, tr.init_state()


def _update_alone(opt):
    """A function that times (card ms) ``opt.step()`` on the gradients
    the last replay left, captured alone in a CUDA graph of its own: the
    median of events around each of 10 replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            opt.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step()

    def ms():
        out = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)
    return ms


@pytest.mark.cuda
def test_a_replayed_step_reads_the_updates_own_time(cuda):
    """Each replayed step, waited for, yields one ``optimizer.step``
    reading; their median against the same Adam update captured alone
    in a CUDA graph of its own and timed by events around its graph's
    replays, in turns: within 25 %. The update is some 20 foreach
    launches of microseconds each, so where it runs moves it: inside the
    step's graph it read 0.30-0.36 ms, alone 0.31 ms, eager (its
    launches queued behind a sleeping card) 0.43 ms; the backward it
    must leave out is ten times as long."""
    tr, state = _card_trainer("conv_1d_simple", cuda)
    assert isinstance(state.optimizer, torch.optim.Adam)
    P.clear()
    for _ in range(2):                          # eager, then the capture
        tr.train_step(state)
    torch.cuda.synchronize()
    alone = _update_alone(state.optimizer)
    steps, yardstick = [], []
    for _ in range(6):
        steps.append(state.step)
        tr.train_step(state)
        torch.cuda.synchronize()
        yardstick.append(alone())
    got = {}
    for r in _readings():
        if r.step in steps:
            got.setdefault(r.step, []).append(r.device_ms)
    assert sorted(got) == steps and all(len(v) == 1 for v in got.values()), got
    spans = [v[0] for v in got.values()]
    ratio = statistics.median(spans) / statistics.median(yardstick)
    print(f"optimizer.step {spans} ms; alone {yardstick} ms; ratio {ratio}")
    assert abs(ratio - 1) < 0.25, (spans, yardstick)


def _replay_kernels(tr, state, tmp_path):
    """{kernel name: count} of one replayed step under a profiler, the
    graph's copies under one name: the tracer reports a copy node of a
    graph as a copy or as a copy kernel (``memcpy32_post``), not always
    alike in one process."""
    from kws_bench.trace import capture, read_events, summarize

    for _ in range(3):                  # eager, capture, replay
        tr.train_step(state)
    assert tr.graph_error is None, tr.graph_error
    path = str(tmp_path / f"replay{id(tr)}.json")
    capture(lambda: tr.train_step(state), path)
    out = collections.Counter()
    for n, (_, c) in summarize(read_events(path))["kernels"].items():
        out["copy" if "memcpy" in n.lower() else n] += c
    return out


@pytest.mark.cuda
def test_the_flagships_step_runs_the_kernels_it_ran(cuda, tmp_path,
                                                    monkeypatch):
    """The flagship's replayed step against one whose update is not
    timed, as before the span: the same kernels, as many times each;
    the timed one reads the span."""
    model = "conv_1d_time_sliced_with_attention"
    with monkeypatch.context() as m:
        m.setattr(loop, "device_span",
                  lambda name, device: contextlib.nullcontext())
        P.clear()
        old = _replay_kernels(*_card_trainer(model, cuda), tmp_path)
        assert _readings() == []
    new = _replay_kernels(*_card_trainer(model, cuda), tmp_path)
    assert new == old
    assert _readings()
