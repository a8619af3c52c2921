"""Checkpoint and resume (port of speech_recognition_tpu/train/checkpoint.py).

A checkpoint is one ``torch.save`` file holding the model's
``state_dict`` (parameters and BatchNorm running statistics), the
optimizer's, the step count and, when one is given, the state of the
trainer's ``torch.Generator``, which draws the batches, augmentation and
dropout masks. Restoring all four into a trainer built as the saved one
was continues the run bit for bit. The JAX package writes orbax
directories; the port has no counterpart of that format.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from speech_recognition_tpu_torch.train.loop import TrainState
from speech_recognition_tpu_torch.train.optim import (
    get_learning_rate, set_learning_rate,
)


def save_checkpoint(path: str, state: TrainState,
                    generator: Optional[torch.Generator] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` (and ``generator``'s state) to the file ``path``,
    through a temporary file, so that a reader never sees half of it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tree = {"step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}
    if generator is not None:
        tree["generator"] = generator.get_state()
    if extra:
        tree["extra"] = extra
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState,
                       generator: Optional[torch.Generator] = None,
                       ) -> TrainState:
    """Load the file ``path`` into ``state`` (from ``Trainer.init_state``)
    in place, and into ``generator`` if one is given; returns ``state``.
    The optimizer keeps its own ``capturable`` flags: they follow the
    device it runs on (``build_optimizer``), not the one that saved."""
    tree = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(tree["model"])
    saved = tree["optimizer"]
    for group, live in zip(saved["param_groups"],
                           state.optimizer.param_groups):
        if "capturable" in live:
            group["capturable"] = live["capturable"]
    state.optimizer.load_state_dict(saved)
    state.step = int(tree["step"])
    if generator is not None:
        if "generator" not in tree:
            raise KeyError(f"{path} holds no generator state")
        generator.set_state(tree["generator"])
    return state


class BestCheckpoint:
    """Best-only checkpoint callback (parity: ModelCheckpoint
    monitor=val_categorical_accuracy mode=max, train.py:65-68). Writes
    ``directory/ep-EEE-vl-L.LLLL.pt`` when the monitored value improves,
    and the path of the best into ``directory/BEST``."""

    def __init__(self, directory: str,
                 monitor: str = "val_categorical_accuracy",
                 mode: str = "max", verbose: bool = True,
                 generator: Optional[torch.Generator] = None):
        self.directory = directory
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None
        self.verbose = verbose
        self.generator = generator
        os.makedirs(directory, exist_ok=True)

    def on_epoch_end(self, epoch: int, state: TrainState,
                     logs: Dict[str, Any]):
        value = float(logs[self.monitor])
        improved = (self.best is None or
                    (value > self.best if self.mode == "max"
                     else value < self.best))
        if improved:
            self.best = value
            path = os.path.abspath(os.path.join(
                self.directory,
                "ep-%03d-vl-%.4f.pt" % (epoch,
                                        float(logs.get("val_loss", 0)))))
            save_checkpoint(path, state, self.generator)
            with open(os.path.join(self.directory, "BEST"), "w") as f:
                f.write(path)
            if self.verbose:
                print(f"checkpoint: {self.monitor}={value:.4f} -> {path}")
        return None


class PlateauCallback:
    """Wires a ``ReduceLROnPlateau`` controller into ``Trainer.fit``: it
    sets the optimizer's learning rate in place."""

    def __init__(self, controller,
                 monitor: str = "val_categorical_accuracy"):
        self.controller = controller
        self.monitor = monitor

    def on_epoch_end(self, epoch: int, state: TrainState,
                     logs: Dict[str, Any]):
        current = get_learning_rate(state.optimizer)
        new_lr = self.controller.update(float(logs[self.monitor]), current)
        if new_lr != current:
            set_learning_rate(state.optimizer, new_lr)
        return None
