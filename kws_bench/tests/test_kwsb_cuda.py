"""On the card, at the cells' own sizes: the precision control fails
each cell's comparison, and a run whose timed path is broken underneath
comes out not correct (the harness's look for a chip is skipped).

    python -m pytest kws_bench/tests -m cuda -q -p no:cacheprovider
"""

import tempfile

import pytest
import torch

from kws_bench import harness

pytestmark = pytest.mark.cuda

SEED = 2 ** 31 + 4321


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    harness.use_checkout_caches()
    return torch.device("cuda", 0)


def _ctx(cell_name, device, workdir):
    spec = harness.load_spec()
    cell = harness.find_cell(spec, cell_name)
    return harness.Context(
        cell=cell, config=harness.load_config(cell["config"]),
        mix=harness.load_traffic(cell["traffic"]),
        limits=harness.load_limits(cell_name), seed=SEED, seconds=0.0,
        trace=False, device=device, workdir=workdir)


def _cells():
    return [c["name"] for c in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell_name", _cells())
def test_the_precision_control_fails(cell_name, device, tmp_path):
    ctx = _ctx(cell_name, device, str(tmp_path))
    got = harness.driver(ctx.mix["kind"]).readings(ctx, "control")
    (numbers,) = got.values()
    assert any(numbers[k] > limit for k, limit in ctx.limits.items()), \
        (numbers, ctx.limits)


def _broken_run(cell_name, device, monkeypatch, fault):
    from speech_recognition_tpu_torch.train import loop

    if fault == "unchanged":
        for optimizer in (torch.optim.RMSprop, torch.optim.Adam,
                          torch.optim.SGD):
            monkeypatch.setattr(optimizer, "step",
                                lambda self, closure=None: None)
    elif fault == "half_batch":
        update = loop.Trainer._update_step

        def half(self, state, x, labels):
            h = x.shape[0] // 2
            return update(self, state, x[:h], labels[:h])
        monkeypatch.setattr(loop.Trainer, "_update_step", half)
    elif fault == "wrong_roll":
        decode_augment = loop.decode_augment

        def wrong_roll(bank, bg, ids, shifts, *rest):
            return decode_augment(bank, bg, ids, -shifts, *rest)
        monkeypatch.setattr(loop, "decode_augment", wrong_roll)
    with tempfile.TemporaryDirectory() as wd:
        return harness.run_cell(harness.load_spec(), cell_name, SEED, 1.0,
                                False, device, wd)


FAULTS = {"train_bank": ("unchanged", "half_batch", "wrong_roll")}


@pytest.mark.parametrize("cell_name,fault", [
    (c["name"], f) for c in harness.load_spec()["workloads"]
    for f in FAULTS[harness.load_traffic(c["traffic"])["kind"]]])
def test_a_broken_timed_path_is_not_correct(cell_name, fault, device,
                                            monkeypatch):
    run = _broken_run(cell_name, device, monkeypatch, fault)
    assert not harness.correct(run), [(c.name, c.value, c.limit)
                                      for c in run.checks]


def test_a_sound_run_is_correct(device):
    with tempfile.TemporaryDirectory() as wd:
        run = harness.run_cell(harness.load_spec(), "flagship.train_bank",
                               SEED + 1, 1.0, False, device, wd)
    assert harness.correct(run), [(c.name, c.value, c.limit)
                                  for c in run.checks]
