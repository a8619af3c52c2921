"""The bank driver's whole run on the CPU at a tiny size (decode+augment's
plain version, no events): the window, the host record and the
comparison with the reference, and a planted fault that it catches."""

import torch

from kws_bench import harness
from kws_bench.traffic import _train as T
from kws_bench.traffic import train_bank

CPU = torch.device("cpu")
LIMITS = {"input_gap": 1e-6, "bn_gap": 1.0, "grad_gap": 1.0,
          "change_gap": 10.0}


def _bank_ctx(tmp_path):
    return harness.Context(
        cell={"name": "flagship.train_bank"},
        config=dict(harness.load_config("flagship"), batch_size=8,
                    compute_dtype="float32"),
        mix=dict(harness.load_traffic("train_bank"), num_train=32,
                 num_val=4, num_pseudo=4, background_clips=2,
                 background_seconds=2, warmup_steps=1),
        limits=LIMITS, seed=2 ** 31 + 77, seconds=0.2, trace=False,
        device=CPU, workdir=str(tmp_path))


def test_the_bank_driver(tmp_path):
    run = train_bank.run(_bank_ctx(tmp_path))
    assert run.attempted >= 1 and run.failed == 0
    assert run.e2e["train_clips_per_s"] > 0
    got = {c.name: c.value for c in run.checks}
    assert list(got) == list(T.NUMBERS)
    assert got["input_gap"] < 1e-6
    assert got["bn_gap"] < 1e-4 and got["grad_gap"] < 1e-4
    host = run.layers["host"]
    assert host["cpu_per_s"] >= 0.0 and len(host["python_s"]) == 2


def test_a_wrong_roll_moves_the_input_gap(tmp_path):
    """decode+augment's shifts turned the wrong way: the first step's
    input departs from the reference's by its own size, where a sound
    step's is the reference's to rounding."""
    ctx = _bank_ctx(tmp_path)
    (sound,) = train_bank.readings(ctx, "program").values()
    (broken,) = train_bank.readings(ctx, "wrong_roll").values()
    assert sound["input_gap"] < 1e-6
    assert broken["input_gap"] > 0.1


def test_a_planted_fault_is_removed_afterwards(tmp_path):
    from speech_recognition_tpu_torch.train import loop

    c = train_bank.Cell(_bank_ctx(tmp_path))
    decode_augment = loop.decode_augment
    for fault in T.FAULTS:
        with T.planted(c.tr, fault):
            pass
        assert "_update_step" not in vars(c.tr)
        assert loop.decode_augment is decode_augment


class _Recorder:
    """A trainer's stand-in whose update step records what it is given."""

    def __init__(self):
        self.seen = []

    def _update_step(self, state, x, labels):
        self.seen.append((x, labels))


def test_half_batch_halves_each_input_of_a_tuple():
    tr = _Recorder()
    mfcc, wav = torch.zeros(6, 40), torch.zeros(6, 16000)
    labels = torch.arange(6)
    with T.planted(tr, "half_batch"):
        tr._update_step(None, (mfcc, wav), labels)
        tr._update_step(None, wav, labels)
    assert "_update_step" not in vars(tr)
    (x, lab), (y, lab2) = tr.seen
    assert isinstance(x, tuple) and [t.shape[0] for t in x] == [3, 3]
    assert x[0].shape[1] == 40 and x[1].shape[1] == 16000
    assert y.shape == (3, 16000) and lab.tolist() == lab2.tolist() == [0, 1, 2]
