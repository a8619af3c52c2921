"""Loss, optimizer and LR control (port of speech_recognition_tpu/train/optim.py).

``smooth_cross_entropy``, ``l2_kernel_penalty``, the three Keras-recipe
optimizers (SGD with momentum, Adam, RMSprop; each the same update as
the optax transform the JAX package builds), the LR accessors and the
host-side ``ReduceLROnPlateau`` controller.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn



def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean label-smoothed softmax CE from logits; ``labels`` are class ids."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) \
            + label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    return -(onehot * logp).sum(dim=-1).mean()


def l2_kernel_penalty(model: nn.Module, scale: float) -> torch.Tensor:
    """scale * sum(w**2) over every tensor flax names with ``kernel``
    (Keras l2(scale)): each layer's ``KERNELS`` (the weights of convs and
    dense layers, and the GRU's input and recurrent weights). BatchNorm
    weights and all biases are excluded, as in the JAX package.
    """
    weights = [getattr(m, name) for m in model.modules()
               for name in getattr(m, "KERNELS", ())]
    if scale == 0.0:
        return torch.zeros((), device=weights[0].device)
    return scale * sum(w.square().sum() for w in weights)


def build_optimizer(name: str, params, learning_rate: float,
                    momentum: float = 0.0) -> torch.optim.Optimizer:
    """Keras-equivalent optimizer over ``params`` (optim.py:93-111).

    * ``sgd``: ``optax.sgd(lr, momentum=m or None)``, i.e. t <- m t + g,
      p <- p - lr t; torch's SGD with dampening 0 and no Nesterov.
    * ``adam``: Keras 2.1.2's b1 0.9, b2 0.999, eps 1e-8 with optax's
      bias correction, eps added outside the sqrt of the corrected second
      moment; torch's Adam computes the same update.
    * ``rmsprop``: Keras 2.1.2's, rho 0.9, eps 1e-8 added *outside* the
      sqrt, zero-initialised accumulator; exactly torch's RMSprop with
      ``alpha=0.9, eps=1e-8``.

    On CUDA parameters Adam and RMSprop are ``capturable``: their step
    counters live on the device, so a CUDA graph of the train step can
    hold the update (RMSprop has no bias correction, and its update is
    unchanged).
    """
    name = name.lower()
    params = list(params)
    capturable = any(p.is_cuda for p in params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                               dampening=0.0, nesterov=False)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                capturable=capturable)
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=learning_rate, alpha=0.9,
                                   eps=1e-8, capturable=capturable)
    raise ValueError(f"unknown optimizer {name!r}")


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr


class ReduceLROnPlateau:
    """Host-side LR controller (optim.py:125-163; keras ReduceLROnPlateau
    as train.py:62-63 uses it: monitor val_categorical_accuracy, mode
    max, factor 0.5, patience 4, min_lr 1e-5)."""

    def __init__(self, factor: float = 0.5, patience: int = 4,
                 min_lr: float = 1e-5, mode: str = "max",
                 min_delta: float = 1e-4, verbose: bool = True):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.min_delta = min_delta
        self.verbose = verbose
        self.best: Optional[float] = None
        self.wait = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def update(self, value: float, current_lr: float) -> float:
        """Feed the monitored metric; returns the (possibly reduced) LR."""
        if self._improved(value):
            self.best = value
            self.wait = 0
            return current_lr
        self.wait += 1
        if self.wait >= self.patience:
            new_lr = max(current_lr * self.factor, self.min_lr)
            self.wait = 0
            if self.verbose and new_lr < current_lr:
                print(f"ReduceLROnPlateau: lr {current_lr:.2e} "
                      f"-> {new_lr:.2e}")
            return new_lr
        return current_lr
