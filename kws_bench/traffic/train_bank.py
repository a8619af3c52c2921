"""Training from the device bank: ``Trainer.train_step`` of the port on a
bank of int16 clips that lives on the card (the corpus's size by the
mix), every batch drawn there, decode+augment in one kernel launch, then
forward, backward and the optimizer update.

Set-up makes the bank, its labels, the background and the weights on
the card from the seed, runs the first steps (checked afterwards against
the reference) and a warm-up. The window steps until ``--seconds``
have passed. With ``--trace 1`` a capture of ``trace_steps`` more steps
follows. After the peak memory is read and the program's state freed,
the reference follows the first steps from the same weights and draws.
"""

from __future__ import annotations

import torch

from kws_bench import harness
from kws_bench.reference import draws as D
from kws_bench.reference import train as RT
from kws_bench.traffic import _train as T


def make_data(ctx: harness.Context):
    """The bank [N, T] int16 (uniform in [-amplitude, amplitude)), the
    labels (uniform over the classes; class 0 is silence) and the
    partitions' row ranges, and the background, from the seed."""
    m, cfg = ctx.mix, ctx.config
    g = torch.Generator(device=ctx.device)
    g.manual_seed(harness.derive_seed(ctx.seed, 1))
    sizes = {"training": m["num_train"], "validation": m["num_val"],
             "pseudo": m["num_pseudo"]}
    n = sum(sizes.values())
    amp = m["amplitude"]
    bank = torch.randint(-amp, amp, (n, cfg["clip_samples"]),
                         generator=g, device=ctx.device, dtype=torch.int16)
    labels = torch.randint(0, cfg["num_classes"], (n,), generator=g,
                           device=ctx.device)
    parts, start = {}, 0
    for name, size in sizes.items():
        ids = torch.arange(start, start + size, device=ctx.device)
        parts[name] = (ids, labels[ids], labels[ids] == 0)
        start += size
    return bank, parts, T.background(ctx, g)


def dataset(ctx, bank, parts, bg):
    from speech_recognition_tpu_torch.data.device_bank import (
        DeviceDataset, Partition,
    )
    from speech_recognition_tpu_torch.ops.augment import BackgroundBank

    empty = torch.zeros(0, dtype=torch.int64, device=ctx.device)
    partitions = {k: Partition(*v) for k, v in parts.items()}
    partitions["testing"] = Partition(empty, empty, empty.bool())
    return DeviceDataset(wav_bank=bank, partitions=partitions,
                         background=BackgroundBank(*bg),
                         num_classes=ctx.config["num_classes"],
                         desired_samples=ctx.config["clip_samples"])


class Cell:
    """The cell's inputs and the program set up on them."""

    def __init__(self, ctx: harness.Context):
        cfg = ctx.config
        self.ctx = ctx
        self.model = harness.reference(cfg)
        self.bank, self.parts, self.bg = make_data(ctx)
        self.weights = T.training_weights(ctx, self.model)
        harness.reset_peak(ctx.device)
        self.tr, self.state = T.trainer(
            ctx, dataset(ctx, self.bank, self.parts, self.bg), self.weights)
        self.names = T.trained_names(self.model, cfg)
        self.trainer_seed = self.tr.seed

    def step(self):
        return self.tr.train_step(self.state)

    def draw(self, g: torch.Generator):
        cfg = self.ctx.config
        return D.bank_batch(g, self.parts, cfg["batch_size"], cfg["augment"],
                            self.bg[1], self.bg[2], cfg["clip_samples"])

    def free_program(self) -> None:
        del self.tr, self.state
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, q=None):
        return RT.steps(self.model, self.ctx.config, self.weights,
                        lambda i, g: self.draw(g), lambda i: self.bank,
                        self.bg[0], self.trainer_seed, T.CHECKED_STEPS, q)


def run(ctx: harness.Context) -> harness.Run:
    c = Cell(ctx)
    return T.run(ctx, c)


FAULTS = T.FAULTS


def readings(ctx: harness.Context, role: str):
    return T.readings(ctx, role, Cell)
