"""The bank train step as a CUDA graph (``train/loop.py::Trainer.
_graph_step``) against the eager step, on the card, for the flagship and
steffeNet at a small batch. Marked ``cuda``; without a CUDA device they
skip. This file imports no jax:

    python -m pytest tests/test_torch_graph_step.py -m cuda --noconftest -q

The eager step is the step body itself (``Trainer._bank_step``), the
one a capture records. Two eager runs from one seed give the eager
path's own run-to-run gap; one eager step then replays from the same
seed must stay within it (twice it, where it is not 0: atomics in a
backward kernel can differ run to run). The draws of every step, read
from the ``Draws`` the step body made (for a replay, the capture's
tensors as the replay rewrote them), are bit-identical.
"""

import copy
import dataclasses

import pytest
import torch

from speech_recognition_tpu_torch.config import (
    AugmentConfig, prepare_model_settings,
)
from speech_recognition_tpu_torch.data.device_bank import (
    synthetic_device_dataset,
)
from speech_recognition_tpu_torch.ops.kernels import decode_augment as K
from speech_recognition_tpu_torch.train import loop as L
from speech_recognition_tpu_torch.train.optim import set_learning_rate
from speech_recognition_tpu_torch.utils import profiling as P

pytestmark = pytest.mark.cuda

MODELS = ("conv_1d_time_sliced_with_attention", "steffeNet")
BATCH = 32
STEPS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _trainer(device, name, seed=3):
    ds = synthetic_device_dataset(device, num_train=256, num_val=64,
                                  num_pseudo=32)
    tr = L.Trainer(name, prepare_model_settings(label_count=12), ds,
                   augment=AugmentConfig(pseudo_frequency=0.6),
                   batch_size=BATCH, seed=seed)
    assert tr.compute_dtype == "bfloat16"
    return tr, tr.init_state()


# (steps, what happens before them): the learning rate halved, a new
# pseudo frequency, the optimizer's state loaded from a copy
SCHEDULE = ((3, None), (3, ("lr", 5e-4)), (3, ("pf", 0.2)),
            (3, ("reload", None)))


def _run(device, name, graph, schedule=((STEPS, None),)):
    """Run ``schedule`` on a fresh trainer: through ``train_step`` (the
    graph) or the eager step body. Returns each step's loss (its own
    tensor), its draws, the last gradients, the state's tensors, the
    generator's state and the captures made."""
    tr, state = _trainer(device, name)
    seen = []
    draw = tr.draw_batch

    def recording(*a, **kw):
        d = draw(*a, **kw)
        seen.append(d)
        return d

    tr.draw_batch = recording
    P.clear()
    losses, draws, pf = [], [], None
    for steps, change in schedule:
        if change is not None:
            what, value = change
            if what == "lr":
                set_learning_rate(state.optimizer, value)
            elif what == "pf":
                pf = value
            else:
                state.optimizer.load_state_dict(
                    copy.deepcopy(state.optimizer.state_dict()))
        for _ in range(steps):
            m = (tr.train_step(state, pf) if graph
                 else tr._bank_step(state, pf))
            losses.append(m["loss"])
            draws.append([t.clone() for t in dataclasses.astuple(seen[-1])])
    model, opt = state.model, state.optimizer
    out = dict(
        losses=losses, draws=draws, step=state.step,
        grads={n: p.grad.clone() for n, p in model.named_parameters()},
        tensors={**{n: t.clone() for n, t in model.state_dict().items()},
                 **{f"{i}.{k}": v.clone() for i, s in
                    enumerate(opt.state.values()) for k, v in s.items()
                    if k != "step"}},
        generator=tr.generator.get_state(),
        captures=sum(r.name == "train.capture" for r in P.spans()),
        replays=sum(r.name == "train.replay" for r in P.spans()),
        graph_error=tr.graph_error)
    torch.cuda.synchronize()
    return out


def _gaps(a, b):
    """The largest absolute gap of each compared quantity."""
    out = {"loss": max(float((x - y).abs()) for x, y in
                       zip(a["losses"], b["losses"]))}
    for kind in ("grads", "tensors"):
        for k in a[kind]:
            out[f"{kind}.{k}"] = float(
                (a[kind][k].double() - b[kind][k].double()).abs().max())
    return out


def _assert_same_steps(eager, other, graph, label):
    assert graph["step"] == eager["step"]
    assert torch.equal(graph["generator"], eager["generator"]), label
    assert len(graph["draws"]) == len(eager["draws"])
    for i, (g, e) in enumerate(zip(graph["draws"], eager["draws"])):
        for x, y in zip(g, e):
            assert torch.equal(x, y), (label, i)
    own = _gaps(other, eager)
    got = _gaps(graph, eager)
    over = {k: (v, own[k]) for k, v in got.items() if v > 2 * own[k]}
    assert not over, (label, over)


@pytest.mark.parametrize("name", MODELS)
def test_replays_redo_the_eager_steps(cuda, name):
    eager, other = _run(cuda, name, False), _run(cuda, name, False)
    K.LAUNCHES, L.REPLAYS = 0, 0
    graph = _run(cuda, name, True)
    assert graph["graph_error"] is None
    assert (graph["captures"], graph["replays"]) == (1, STEPS - 1)
    # one decode+augment a step: the eager one launched, the others in
    # the replays (the capture's launch is not counted: it runs nothing)
    assert (K.LAUNCHES, L.REPLAYS) == (1, STEPS - 1)
    _assert_same_steps(eager, other, graph, name)
    # each step's loss a tensor of its own, still holding its value
    assert len({t.data_ptr() for t in graph["losses"]}) == STEPS
    assert torch.equal(torch.stack(graph["losses"]),
                       torch.stack([t.clone() for t in graph["losses"]]))
    assert all(torch.isfinite(t) for t in graph["losses"])


@pytest.mark.parametrize("name", MODELS)
def test_a_changed_key_captures_again(cuda, name):
    """A new learning rate, pseudo frequency or loaded optimizer state:
    one eager step under the new key, then a new capture; the steps stay
    the eager ones."""
    eager = _run(cuda, name, False, SCHEDULE)
    other = _run(cuda, name, False, SCHEDULE)
    graph = _run(cuda, name, True, SCHEDULE)
    assert graph["captures"] == len(SCHEDULE)
    # the capture's step replays too
    assert graph["replays"] == sum(s for s, _ in SCHEDULE) - len(SCHEDULE)
    _assert_same_steps(eager, other, graph, name)


def test_train_many_and_grads_after_replays(cuda):
    tr, state = _trainer(cuda, MODELS[0])
    out = tr.train_many(state, 5)
    assert out["loss"].shape == (5,) and torch.isfinite(out["loss"]).all()
    assert state.step == 5
    # the gradients a replay wrote are the parameters' .grad
    g = tr._graph
    assert g is not None and g.graph is not None
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert all(v is not None for v in grads.values())
    before = {n: v.clone() for n, v in grads.items()}
    tr.train_step(state)
    torch.cuda.synchronize()
    assert all(p.grad is grads[n]
               for n, p in state.model.named_parameters())
    assert any(not torch.equal(before[n], grads[n]) for n in grads)
    # evaluate between steps keeps the graph: its buffers are written in
    # place; the replay leaves the model in train mode, as a step does
    tr.evaluate(state)
    assert not state.model.training
    P.clear()
    tr.train_step(state)
    assert state.model.training
    names = [r.name for r in P.spans()]
    assert names == ["train.replay", "train.step"], names


def test_a_failed_capture_leaves_the_trainer_eager(cuda, monkeypatch,
                                                   capsys):
    """A host sync inside the step (here the L2 penalty read back): the
    capture fails, the error is printed and kept, and the steps are the
    eager ones, the generator's included."""
    penalty = L.l2_kernel_penalty

    def syncing(model, scale):
        value = penalty(model, scale)
        float(value)
        return value

    monkeypatch.setattr(L, "l2_kernel_penalty", syncing)
    name = MODELS[0]
    eager, other = _run(cuda, name, False), _run(cuda, name, False)
    graph = _run(cuda, name, True)
    assert graph["graph_error"] is not None
    assert "capture" in capsys.readouterr().out
    assert (graph["captures"], graph["replays"]) == (1, 0)
    _assert_same_steps(eager, other, graph, name)
