"""The port's span recorder (``utils/profiling.py::span``), the train
step's phase spans (``train/loop.py``), ``summarize_trace``'s device time
by profiler range, ``tools.profile_step``'s tables, and the benchmark's
readers of the spans (``kws_bench/metrics/``), on the CPU.

- One ``train_step`` (and one ``train_step_stream``) records
  ``train.step`` around the six phases, in order, all with its step id,
  the phases inside it and summing to no more than it.
- Outside a capture ``record_function`` is never entered; inside one the
  phases are ``user_annotation`` ranges of the trace and ``train.step``
  is not, and the records are flagged ``profiled``.
- The ring holds at most ``RING_SPANS`` records; ``first`` outlives it.
- Two steps give bit-identical losses, parameters and BatchNorm
  statistics with and without a capture.
- The readers, on synthetic records: the tail of unprofiled steps, the
  medians, and None where there is nothing to read.
- The CUDA graph step: the CPU's step stays eager, the choice of the
  graph (a CUDA device, one rank, no failed capture, no dispatch mode),
  ``Trainer.graph_key`` against each change a capture must follow, and
  ``graph_replay_share`` on synthetic records.
"""

import contextlib
import copy
import dataclasses
import gzip
import json
import types
from unittest import mock

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from kws_bench.metrics import _spans as KS
from kws_bench.metrics import (
    backward_host_ms, draw_host_ms, forward_host_ms, graph_replay_share,
    loss_host_ms, optimizer_host_ms, setup_first_step_s, setup_init_state_s,
    step_host_ms,
)
from speech_recognition_tpu_torch.config import (
    AugmentConfig, prepare_model_settings,
)
from speech_recognition_tpu_torch.data import device_bank
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.parallel.mesh import Mesh
from speech_recognition_tpu_torch.tools import profile_step
from speech_recognition_tpu_torch.train.loop import Trainer, TrainState
from speech_recognition_tpu_torch.train.optim import set_learning_rate
from speech_recognition_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

CPU = torch.device("cpu")
PHASES = ("train.draw", "train.build", "train.forward", "train.loss",
          "train.backward", "train.optimizer")
# the order the phases open in: the gradients are cleared before the
# backward, so train.optimizer opens twice
ORDER = ["train.draw", "train.build", "train.forward", "train.loss",
         "train.optimizer", "train.backward", "train.optimizer"]
CPU_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU]


def _trainer(seed=0):
    settings = prepare_model_settings(
        label_count=12, window_size_ms=30.0, window_stride_ms=10.0,
        dct_coefficient_count=80, num_log_mel_features=60,
        output_representation="raw")
    ds = synthetic_device_dataset(CPU, num_train=16, num_val=8,
                                  num_pseudo=4)
    tr = Trainer("conv_1d_time_sliced_with_attention", settings, ds,
                 augment=AugmentConfig(pseudo_frequency=0.6), batch_size=4,
                 seed=seed, compute_dtype="float32")
    return tr, tr.init_state()


@pytest.fixture(scope="module")
def trained():
    return _trainer()


def _step_records(records):
    """The last ``train.step`` record and the records it holds, in the
    order they opened."""
    step = [r for r in records if r.name == "train.step"][-1]
    inner = sorted((r for r in records if r.parent is step),
                   key=lambda r: r.start_ns)
    return step, inner


def _check_step(records, step_id):
    step, inner = _step_records(records)
    assert step.step == step_id and step.parent is None
    assert [r.name for r in inner] == ORDER
    assert {r.name for r in inner} == set(PHASES)
    assert all(r.step == step_id for r in inner)
    for r in inner:
        assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
    assert sum(r.end_ns - r.start_ns for r in inner) <= \
        step.end_ns - step.start_ns
    # nothing else nests in the step's phases
    assert not [r for r in records if r.parent in inner]


def test_train_step_records_its_phases(trained):
    tr, state = trained
    P.clear()
    step_id = state.step
    tr.train_step(state)
    _check_step(P.spans(), step_id)
    assert not any(r.profiled for r in P.spans())


def test_train_step_stream_records_the_same_phases(trained):
    tr, state = trained
    ds = tr.dataset
    part = ds.partitions["training"]
    ids = part.file_ids[:4]
    P.clear()
    step_id = state.step
    tr.train_step_stream(state, ds.wav_bank[ids], part.labels[:4],
                         part.is_silence[:4])
    _check_step(P.spans(), step_id)


def test_init_state_is_a_span():
    before = P.first("setup.init_state")
    P.clear()
    _trainer()
    (rec,) = [r for r in P.spans() if r.name == "setup.init_state"]
    assert rec.step is None and rec.parent is None and not rec.profiled
    assert rec.end_ns > rec.start_ns
    assert P.first("setup.init_state") is (before or rec)


def test_record_function_is_entered_only_in_a_capture(trained):
    tr, state = trained
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    with mock.patch.object(torch.profiler, "record_function", counting):
        tr.train_step(state)
        assert entered == []
        with torch.profiler.profile(activities=CPU_ACTIVITIES):
            tr.train_step(state)
    assert sorted(entered) == sorted(ORDER)


def test_a_capture_holds_the_phases_as_ranges(trained, tmp_path):
    tr, state = trained
    P.clear()
    step_id = state.step
    with torch.profiler.profile(activities=CPU_ACTIVITIES) as prof:
        tr.train_step(state)
    path = str(tmp_path / "capture.pt.trace.json")
    prof.export_chrome_trace(path)
    events = P.read_trace(path)
    ranges = [e["name"] for e in events
              if e.get("cat") == "user_annotation"]
    assert set(PHASES) <= set(ranges)
    assert "train.step" not in ranges
    assert sorted(r for r in ranges if r.startswith("train.")) == \
        sorted(ORDER)
    _check_step(P.spans(), step_id)
    assert all(r.profiled for r in P.spans())


def test_the_ring_is_bounded_and_first_outlives_it():
    with P.span("test.once", 7, profiler_range=False):
        pass
    once = P.first("test.once")
    for _ in range(P.RING_SPANS + 10):
        with P.span("test.fill"):
            pass
    records = P.spans()
    assert len(records) == P.RING_SPANS
    assert all(r.name == "test.fill" for r in records)
    assert P.first("test.once") is once and once.step == 7
    assert P.first("test.fill") is not records[0]
    P.clear()
    assert P.spans() == [] and P.first("test.once") is once


def test_spans_nest_and_survive_an_exception():
    P.clear()
    with pytest.raises(ValueError):
        with P.span("test.outer", 3):
            with P.span("test.inner"):
                raise ValueError("inside")
    with P.span("test.after"):
        pass
    inner, outer, after = P.spans()
    assert (inner.name, inner.step, inner.parent) == ("test.inner", 3,
                                                      outer)
    assert outer.parent is None and after.parent is None
    assert after.step is None
    P.clear()


def test_a_capture_leaves_the_steps_bit_identical():
    got = []
    for captured in (False, True):
        tr, state = _trainer(seed=5)
        if captured:
            with torch.profiler.profile(activities=CPU_ACTIVITIES):
                losses = [tr.train_step(state)["loss"] for _ in range(2)]
        else:
            losses = [tr.train_step(state)["loss"] for _ in range(2)]
        got.append((torch.stack(losses), state.model.state_dict()))
    (la, sa), (lb, sb) = got
    assert torch.equal(la, lb)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert any(k.endswith("running_var") for k in sa)


# -- summarize_trace by range ---------------------------------------------

def _ranged_trace():
    """Two phases as ranges on the main thread (tid 1), [0, 30] and
    [30, 60] us; an operator of the backward on autograd's thread (tid
    2); a kernel launched outside any operator (no ``External id``, its
    launch call matched by ``correlation``); one outside every range.
    Device: [10, 15] (forward), [40, 50] + [45, 48] + [55, 60]
    (backward), [70, 72] (no range). Gaps: [15, 40] (middle 27.5:
    forward), [50, 55] (backward), [60, 70] (no range)."""
    def x(name, cat, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
                "ts": ts, "dur": dur, "args": args}
    return {"traceEvents": [
        x("train.forward", "user_annotation", 0, 30, **{"External id": 100}),
        x("aten::mm", "cpu_op", 2, 3, **{"External id": 1}),
        x("inner", "user_annotation", 4, 2, **{"External id": 101}),
        x("train.backward", "user_annotation", 30, 30,
          **{"External id": 102}),
        x("MmBackward0", "cpu_op", 32, 2, tid=2, **{"External id": 2}),
        x("aten::add", "cpu_op", 61, 1, **{"External id": 3}),
        x("cudaLaunchKernel", "cuda_runtime", 40, 3, correlation=55),
        x("cudaLaunchKernel", "cuda_runtime", 62, 1, correlation=56),
        x("train.forward", "gpu_user_annotation", 10, 5),
        x("sm90_gemm", "kernel", 10, 5, tid=9, **{"External id": 1}),
        x("sm90_gemm_bwd", "kernel", 40, 10, tid=9, **{"External id": 2}),
        x("reduce_kernel", "kernel", 45, 3, tid=9, **{"External id": 2}),
        x("own_kernel", "kernel", 55, 5, tid=9, correlation=55),
        x("vectorized_elementwise_kernel", "kernel", 70, 2, tid=9,
          correlation=56, **{"External id": 3}),
    ]}


def test_summarize_trace_by_range(tmp_path):
    path = tmp_path / "h.1.1.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(_ranged_trace(), f)
    s = P.summarize_trace(str(path), num_steps=1)
    assert s["device_busy_ms"] == pytest.approx(22e-3)
    got = s["spans"]
    assert set(got) == {"train.forward", "train.backward", P.NO_RANGE}
    assert got["train.forward"] == {"device_busy_ms": pytest.approx(5e-3),
                                    "idle_ms": pytest.approx(25e-3),
                                    "count": 1}
    assert got["train.backward"] == {
        "device_busy_ms": pytest.approx(15e-3),
        "idle_ms": pytest.approx(5e-3), "count": 3}
    assert got[P.NO_RANGE] == {"device_busy_ms": pytest.approx(2e-3),
                               "idle_ms": pytest.approx(10e-3), "count": 1}
    assert sum(r["device_busy_ms"] for r in got.values()) == \
        pytest.approx(s["device_busy_ms"])


def test_summarize_trace_with_no_ranges(tmp_path):
    trace = _ranged_trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["cat"] != "user_annotation"]
    path = tmp_path / "plain.trace.json"
    path.write_text(json.dumps(trace))
    got = P.summarize_trace(str(path))["spans"]
    assert list(got) == [P.NO_RANGE]
    assert got[P.NO_RANGE]["count"] == 5
    assert got[P.NO_RANGE]["idle_ms"] == pytest.approx(40e-3)


def test_step_medians():
    recs = [_rec("train.draw", 0, 1), _rec("train.optimizer", 0, 2),
            _rec("train.optimizer", 0, 3), _rec("train.step", 0, 10),
            _rec("train.draw", 1, 3), _rec("train.optimizer", 1, 1),
            _rec("train.step", 1, 20),
            _rec("train.draw", 2, 100, True), _rec("train.step", 2, 900,
                                                   True)]
    assert P.step_medians(recs) == {"train.draw": pytest.approx(2e-6),
                                    "train.optimizer": pytest.approx(3e-6),
                                    "train.step": pytest.approx(15e-6)}


def _small_dataset(device, **kw):
    return synthetic_device_dataset(device, num_train=16, num_val=8,
                                    num_pseudo=4)


def test_profile_step_prints_the_spans(tmp_path, capsys):
    with mock.patch.object(device_bank, "synthetic_device_dataset",
                           _small_dataset):
        s = profile_step.main(["--device", "cpu", "--batch_size", "4",
                               "--steps", "1", "--warmup", "2",
                               "--trace_dir", str(tmp_path / "tr")])
    out = capsys.readouterr().out
    host = out.split("host ms a step by span (median over the 2 warm-up "
                     "steps):\n")[1].split("device busy")[0]
    assert [line.split()[0] for line in host.splitlines()] == [
        "train.draw", "train.build", "train.forward", "train.loss",
        "train.optimizer", "train.backward", "train.step"]
    assert "device by profiler range (a step):" in out
    assert s["spans"] == {}     # the CPU's trace holds no device time


# -- the benchmark's readers ------------------------------------------------

def _rec(name, step, ns, profiled=False, start=0):
    return types.SimpleNamespace(name=name, step=step, start_ns=start,
                                 end_ns=start + ns, profiled=profiled)


def _window(n_steps, profiled_after=0):
    """``n_steps`` unprofiled steps (step i: draw i+1 ns, forward 10
    ns, the optimizer 2 + 3 ns, the step 100 + i ns), then
    ``profiled_after`` profiled ones of 10^6 ns each phase."""
    recs = []
    for i in range(n_steps + profiled_after):
        p = i >= n_steps
        big = 10 ** 6 if p else 0
        recs += [_rec("train.draw", i, big or i + 1, p),
                 _rec("train.forward", i, big or 10, p),
                 _rec("train.optimizer", i, big or 2, p),
                 _rec("train.optimizer", i, big or 3, p),
                 _rec("train.step", i, big or 100 + i, p)]
    return recs


TRAIN = {"kind": "train", "steps": 600}


def test_readers_take_the_unprofiled_tail():
    recs = _window(600, profiled_after=20)
    # the last 256 unprofiled steps: 344 .. 599
    assert KS.phase_ms(TRAIN, "train.step", recs) == pytest.approx(
        (100 + (344 + 599) / 2) / 1e6)
    assert KS.phase_ms(TRAIN, "train.draw", recs) == pytest.approx(
        ((344 + 599) / 2 + 1) / 1e6)
    assert KS.phase_ms(TRAIN, "train.forward", recs) == pytest.approx(1e-5)
    assert KS.phase_ms(TRAIN, "train.optimizer", recs) == pytest.approx(
        5e-6)
    assert KS.phase_ms(TRAIN, "train.loss", recs) is None


def test_readers_take_at_most_the_window():
    recs = _window(10)
    # a window of 4 steps: steps 6 .. 9
    assert KS.phase_ms({"kind": "train", "steps": 4}, "train.step",
                       recs) == pytest.approx(107.5e-6)
    assert KS.phase_ms({"kind": "train", "steps": 0}, "train.step",
                       recs) is None


def test_readers_find_nothing_where_there_are_no_spans():
    assert KS.phase_ms(TRAIN, "train.step", []) is None
    assert KS.phase_ms(TRAIN, "train.draw", _window(0, 5)) is None
    assert KS.phase_ms({"kind": "predict", "steps": 5}, "train.step",
                       _window(5)) is None
    assert KS.first_s({"kind": "predict"}, "train.step",
                      _rec("train.step", 0, 10)) is None
    assert KS.first_s(TRAIN, "setup.none_such") is None
    assert KS.first_s(TRAIN, "train.step",
                      _rec("train.step", 0, 2 * 10 ** 9)) == 2.0
    for reader in (step_host_ms, draw_host_ms, forward_host_ms,
                   loss_host_ms, backward_host_ms, optimizer_host_ms,
                   setup_init_state_s, setup_first_step_s):
        assert reader.read({"kind": "predict"}) is None


def test_readers_return_none_without_a_recorder():
    """A program without the recorder (a parent commit's): the readers
    return None and raise nothing."""
    with mock.patch.dict("sys.modules", {
            "speech_recognition_tpu_torch.utils.profiling":
            types.ModuleType("profiling")}):
        assert KS.records() == [] and KS.first("train.step") is None
        assert step_host_ms.read(TRAIN) is None
        assert setup_first_step_s.read(TRAIN) is None


def test_readers_read_the_program(trained):
    tr, state = trained
    P.clear()
    for _ in range(3):
        tr.train_step(state)
    layers = {"kind": "train", "steps": 3}
    values = {m.__name__.rsplit(".", 1)[1]: m.read(layers) for m in (
        step_host_ms, draw_host_ms, forward_host_ms, loss_host_ms,
        backward_host_ms, optimizer_host_ms, setup_init_state_s,
        setup_first_step_s)}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["draw_host_ms"] < values["step_host_ms"]


# -- the CUDA graph step: where it engages, its key, its reader -----------

def test_a_cpu_step_is_eager(trained):
    tr, state = trained
    P.clear()
    tr.train_step(state)
    names = {r.name for r in P.spans()}
    assert set(PHASES) <= names
    assert not names & {"train.replay", "train.capture"}
    assert tr._graph is None and tr.graph_error is None


@pytest.mark.parametrize("device,world,error,watched,uses", [
    ("cuda", 1, None, False, True),
    ("cpu", 1, None, False, False),
    ("cuda", 2, None, False, False),
    ("cuda", 1, "RuntimeError('capture')", False, False),
    ("cuda", 1, None, True, False)])
def test_where_the_graph_engages(trained, device, world, error, watched,
                                 uses):
    """A CUDA device, one rank, no failed capture and no dispatch mode
    (``FlopCounterMode``) watching the operators. Nothing runs on a
    device: the choice alone."""
    tr = copy.copy(trained[0])
    tr.device, tr.mesh, tr.graph_error = (torch.device(device),
                                          Mesh(0, world), error)
    with (FlopCounterMode(display=False) if watched
          else contextlib.nullcontext()):
        assert tr._uses_graph() is uses


def _new_child(tr, state):
    name, child = next(iter(state.model.named_children()))
    setattr(state.model, name, copy.deepcopy(child))


def _new_buffer(tr, state):
    bn = next(m for m in state.model.modules()
              if hasattr(m, "running_mean"))
    bn.running_mean = bn.running_mean.clone()


def _new_parameter_data(tr, state):
    p = next(state.model.parameters())
    p.data = p.data.clone()


# name -> (what is done between two keys, whether the key changes); a
# dict it returns names the next key's state or pseudo frequency
KEY_CASES = {
    "nothing": (lambda tr, st: None, False),
    "evaluate": (lambda tr, st: tr.evaluate(st), False),
    "bn re-estimation": (
        lambda tr, st: tr.recalibrate_batch_stats(st, 2), False),
    "model state loaded in place": (
        lambda tr, st: st.model.load_state_dict(st.model.state_dict()),
        False),
    "the default pseudo frequency named": (
        lambda tr, st: {"pseudo_frequency": tr.augment.pseudo_frequency},
        False),
    "learning rate": (
        lambda tr, st: set_learning_rate(st.optimizer, 5e-4), True),
    "pseudo frequency": (lambda tr, st: {"pseudo_frequency": 0.2}, True),
    "batch size": (lambda tr, st: setattr(tr, "batch_size", 8), True),
    "augmentation": (lambda tr, st: setattr(tr, "augment", dataclasses.replace(
        tr.augment, background_frequency=0.5)), True),
    "optimizer state loaded": (
        lambda tr, st: st.optimizer.load_state_dict(
            copy.deepcopy(st.optimizer.state_dict())), True),
    "gradients cleared": (lambda tr, st: st.optimizer.zero_grad(), True),
    "a module swapped": (_new_child, True),
    "a buffer replaced": (_new_buffer, True),
    "a parameter's storage replaced": (_new_parameter_data, True),
    "a new generator": (lambda tr, st: setattr(
        tr, "generator", torch.Generator().manual_seed(1)), True),
    "another state": (lambda tr, st: {"state": TrainState(
        st.model, st.optimizer, st.step)}, True),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_the_graph_key_follows_what_a_capture_bakes_in(case):
    """``Trainer.graph_key``, on the CPU: equal while a replay would redo
    the eager step, different once a host value the capture baked in or
    the storage of a tensor it reads or writes has changed."""
    tr, state = _trainer(seed=2)
    tr.train_step(state)            # the optimizer's state exists
    before = tr.graph_key(state)
    assert tr.graph_key(state) == before
    change, moves = KEY_CASES[case]
    after = change(tr, state)
    after = after if isinstance(after, dict) else {}
    key = tr.graph_key(after.get("state", state),
                       after.get("pseudo_frequency"))
    assert (key != before) is moves


def _graph_steps(replayed, profiled=()):
    """A step record per entry of ``replayed``: one holding a
    ``train.replay`` record where it is true, else a ``train.draw``."""
    recs = []
    for i, r in enumerate(replayed):
        p = i in profiled
        step = _rec("train.step", i, 100, p)
        inner = _rec("train.replay" if r else "train.draw", i, 10, p)
        inner.parent = step
        recs += [inner, step]
    return recs


@pytest.mark.parametrize("replayed,want", [
    ([True] * 6, 100.0), ([False] * 6, 0.0),
    ([False, False, True, True, True, True, True, True], 75.0)])
def test_graph_replay_share(replayed, want):
    layers = {"kind": "train", "steps": len(replayed)}
    assert graph_replay_share.share(layers, _graph_steps(replayed),
                                    True) == pytest.approx(want)


def test_graph_replay_share_takes_the_unprofiled_tail():
    # 300 eager steps, 300 replayed, then 20 profiled eager ones: the
    # last 256 unprofiled steps all replayed; a 400-step window reads its
    # last 256 too; a 2-step window its last 2
    replayed = [False] * 300 + [True] * 300 + [False] * 20
    recs = _graph_steps(replayed, profiled=set(range(600, 620)))
    for steps in (600, 400, 2):
        assert graph_replay_share.share(
            {"kind": "train", "steps": steps}, recs, True) == 100.0
    recs = _graph_steps([False] * 200 + [True] * 200)
    assert graph_replay_share.share(
        {"kind": "train", "steps": 400}, recs, True) == pytest.approx(
        100.0 * 200 / 256)


def test_graph_replay_share_reads_nothing_without_a_capture():
    recs = _graph_steps([True] * 4)
    assert graph_replay_share.share(TRAIN, recs, False) is None
    assert graph_replay_share.share({"kind": "predict", "steps": 4}, recs,
                                    True) is None
    assert graph_replay_share.share({"kind": "train", "steps": 0}, recs,
                                    True) is None
    assert graph_replay_share.share(TRAIN, [], True) is None
    # a program without the recorder (a parent commit's), and this CPU
    # process, where no capture was tried
    with mock.patch.dict("sys.modules", {
            "speech_recognition_tpu_torch.utils.profiling":
            types.ModuleType("profiling")}):
        assert graph_replay_share.read(TRAIN) is None
    assert P.first("train.capture") is None
    assert graph_replay_share.read(TRAIN) is None
