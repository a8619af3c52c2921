"""The frontend's device span (``train/loop.py::Trainer.build_batch``,
``frontend.forward``) and the benchmark's readers of it
(``kws_bench/metrics/frontend_*``).

On the CPU:

- ``build_batch`` of a raw model hands the frontend the waveform and
  opens no device span; a model that takes features opens one,
  ``frontend``, around the frontend it is given (the harness's tap on
  ``tr.frontend`` among them), and off a CUDA device records nothing;
- the readers, on synthetic records: None without a reading, the
  median of the tail's readings, its share of the busy time, and the
  roofline from the configuration's bytes.

On the card (marked ``cuda``; ``-m cuda --noconftest``), the cell's
model at batch 384: a replayed step yields one ``frontend.forward``
reading a step, against the frontend captured alone in a CUDA graph of
its own; the span costs a replay under half a percent; the flagship's
replayed step runs the kernels it ran before the span existed.
"""

import collections
import statistics
import types

import pytest
import torch

from kws_bench import harness
from kws_bench.metrics import (
    frontend_device_ms_per_step, frontend_roofline, frontend_step_share,
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

CELL = "mfcc_and_raw.train_bank"
MODELS = {"conv_1d_time_sliced_with_attention": "raw",
          "conv_1d_mfcc_and_raw": "mfcc_and_raw"}


def _trainer(model, device, batch, **data):
    ds = synthetic_device_dataset(device, **data)
    return Trainer(model, prepare_model_settings(
        label_count=12, output_representation=MODELS[model]), ds,
        batch_size=batch, seed=3)


def _readings(prefix="frontend."):
    return [r for r in P.spans()
            if isinstance(r, P.reading) and r.name.startswith(prefix)]


class _Spy:
    """The frontend, counting its calls."""

    def __init__(self, frontend):
        self.frontend, self.calls = frontend, []

    def features(self, wav, representation=None):
        self.calls.append(representation)
        return self.frontend.features(wav, representation)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_only_a_model_that_takes_features_opens_the_span(model,
                                                        monkeypatch):
    opened = []

    def spans(name, fn, x):
        opened.append(name)
        return P.device_spans(name, fn, x)

    monkeypatch.setattr(loop, "device_spans", spans)
    tr = _trainer(model, torch.device("cpu"), 4)
    spy = tr.frontend = _Spy(tr.frontend)
    before = len(_readings())
    x = tr.build_batch(tr.draw_batch())
    assert spy.calls == [MODELS[model]]
    if MODELS[model] == "raw":
        assert opened == [] and x.shape == (4, 16000)
    else:
        assert opened == ["frontend"]
        assert [t.shape for t in x] == [(4, 98 * 60), (4, 16000)]
    assert len(_readings()) == before               # the CPU records none


def _step(step, profiled=False):
    return types.SimpleNamespace(name="train.step", step=step,
                                 profiled=profiled, parent=None)


def _layers(steps=4, busy_s=2.0, traced=20, batch=384):
    return {"kind": "train", "cell": CELL, "steps": steps, "batch": batch,
            "trace": {"summary": {"busy_s": busy_s}, "steps": traced}}


RECORDS = [_step(s) for s in range(6)] + [
    P.reading("frontend.forward", 3, False, 0.30),
    P.reading("frontend.forward", 4, False, 0.20),
    P.reading("frontend.forward", 5, False, 0.25),
    P.reading("gru.forward", 5, False, 9.0),            # another span
    P.reading("frontend.forward", 1, False, 1.0),       # before the tail
    P.reading("frontend.forward", 5, True, 99.0)]       # profiled


def test_the_frontend_reader():
    per_step = frontend_device_ms_per_step.per_step
    assert per_step(_layers(), RECORDS) == 0.25
    assert per_step(_layers(), RECORDS[:6]) is None
    assert per_step({"kind": "predict"}, RECORDS) is None
    assert per_step(_layers(steps=0), RECORDS) is None


def test_the_share_and_the_roofline_read_the_span(monkeypatch):
    monkeypatch.setattr(frontend_device_ms_per_step, "read",
                        lambda layers: 0.5)
    assert frontend_step_share.read(_layers()) == pytest.approx(0.5)
    cfg = harness.load_config("mfcc_and_raw")
    # the waveform read once, the 98 x 60 MFCCs written once, in f32
    assert frontend_roofline.frontend_bytes(cfg, 384) \
        == 384 * (16000 + 98 * 60) * 4 == 33_607_680
    assert frontend_roofline.read(_layers()) == pytest.approx(
        100.0 * 33_607_680 / HBM_BYTES_PER_S / 0.5e-3)
    assert frontend_roofline.read(_layers(batch=8)) == pytest.approx(
        100.0 * 8 * 21880 * 4 / HBM_BYTES_PER_S / 0.5e-3)
    monkeypatch.setattr(frontend_device_ms_per_step, "read",
                        lambda layers: None)
    for reader in (frontend_step_share, frontend_roofline):
        assert reader.read(_layers()) is None


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


def _frontend_alone(tr, device, n=10):
    """A function that times (card ms) the trainer's frontend on a
    [384, 16000] waveform, as the step runs it, captured alone in a CUDA
    graph of its own, by events around ``n`` replays."""
    wav = (torch.rand(BATCH, 16000, device=device) - 0.5) * 0.25

    def body():
        return tr.frontend.features(wav, "mfcc_and_raw")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
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
def test_a_replayed_step_reads_the_frontends_own_time(cuda):
    """Each replayed step, waited for, yields one ``frontend.forward``
    reading; their median against the frontend captured alone and timed
    by events around its graph's replays, in turns: within 5 %."""
    tr, state = _card_trainer("conv_1d_mfcc_and_raw", cuda)
    P.clear()
    for _ in range(2):                          # eager, then the capture
        tr.train_step(state)
    torch.cuda.synchronize()
    alone = _frontend_alone(tr, cuda)
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
    assert abs(ratio - 1) < 0.05, (spans, yardstick)


def _ms_a_step(tr, state, n=20):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        tr.train_step(state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@pytest.mark.cuda
def test_the_span_costs_a_replay_under_half_a_percent(cuda, monkeypatch):
    """Replays of a step captured without the span against those of one
    captured with it, in turns on one card."""
    with monkeypatch.context() as m:
        m.setattr(loop, "device_spans", lambda name, fn, x: fn(x))
        plain = _card_trainer("conv_1d_mfcc_and_raw", cuda)
        for _ in range(3):
            plain[0].train_step(plain[1])
    timed = _card_trainer("conv_1d_mfcc_and_raw", cuda)
    for _ in range(3):
        timed[0].train_step(timed[1])
    got = {"plain": [], "timed": []}
    for _ in range(3):
        got["plain"].append(_ms_a_step(*plain))
        got["timed"].append(_ms_a_step(*timed))
    ratio = statistics.median(got["timed"]) / statistics.median(
        got["plain"])
    assert abs(ratio - 1) < 0.005, got


def _replay_kernels(tr, state, tmp_path):
    """{kernel name: count} of one replayed step under a profiler, the
    graph's copies under one name: the tracer reports a copy node of a
    graph as a copy or as a copy kernel (``memcpy32_post``), not always
    alike in one process."""
    from kws_bench.trace import capture, read_events, summarize

    for _ in range(3):                  # eager, capture, replay
        tr.train_step(state)
    path = str(tmp_path / f"replay{id(tr)}.json")
    capture(lambda: tr.train_step(state), path)
    out = collections.Counter()
    for n, (_, c) in summarize(read_events(path))["kernels"].items():
        out["copy" if "memcpy" in n.lower() else n] += c
    return out


@pytest.mark.cuda
def test_the_flagships_step_runs_the_kernels_it_ran(cuda, tmp_path,
                                                    monkeypatch):
    """The flagship's replayed step against one whose ``build_batch``
    hands the waveform to the frontend as it did before the span: the
    same kernels, as many times each, and no frontend reading."""
    model = "conv_1d_time_sliced_with_attention"
    def before(self, d):
        wav = loop.decode_augment(self.dataset.wav_bank, self._bg_flat,
                                  d.file_ids, d.shifts, d.fg_vol, d.bg_pos,
                                  d.bg_vol)
        return self.frontend.features(wav, self.spec.representation)

    with monkeypatch.context() as m:
        m.setattr(Trainer, "build_batch", before)
        old = _replay_kernels(*_card_trainer(model, cuda), tmp_path)
    P.clear()
    new = _replay_kernels(*_card_trainer(model, cuda), tmp_path)
    assert new == old
    assert _readings() == []
